"""Model zoo of the port: ``Model`` and ``build_model`` over every family
of the registry -- the decoder-only LM (dense, MoE, SSM, hybrid, VLM) and
the enc-dec model -- on the flash_attention and ssd_scan kernels."""
from repro_torch.models.api import Model, build_model

__all__ = ["Model", "build_model"]
