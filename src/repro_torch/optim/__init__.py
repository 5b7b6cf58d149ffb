"""Optimisers of the port: AdamW and its schedule (``adamw``,
``schedule``), int8 error-feedback compression (``compress``) and the
Tier-3 bidder (``bidding``)."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.bidding import (
    BidConfig,
    BidEnsemble,
    BidResult,
    BidState,
    bids_for_batch,
    ensemble_objective,
    optimize_bids,
)
from repro_torch.optim.compress import (CompressionState, compress_init,
                                        compressed_psum, dequantize_int8,
                                        ef_compress, ef_decompress,
                                        quantize_int8, requantize_sum)
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "global_norm",
    "warmup_cosine",
    "CompressionState", "compress_init", "ef_compress", "ef_decompress",
    "quantize_int8", "dequantize_int8", "compressed_psum", "requantize_sum",
    "BidConfig", "BidEnsemble", "BidResult", "BidState", "bids_for_batch",
    "ensemble_objective", "optimize_bids",
]
