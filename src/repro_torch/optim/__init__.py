"""Optimisers of the port: the Tier-3 bidder (``bidding``)."""
from repro_torch.optim.bidding import (
    BidConfig,
    BidEnsemble,
    BidResult,
    BidState,
    bids_for_batch,
    ensemble_objective,
    optimize_bids,
)

__all__ = ["BidConfig", "BidEnsemble", "BidResult", "BidState",
           "bids_for_batch", "ensemble_objective", "optimize_bids"]
