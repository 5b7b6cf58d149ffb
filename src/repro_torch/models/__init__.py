"""Model zoo of the port: the decoder-only LM (``Model``, ``build_model``)
of the dense, SSM and hybrid families, on the flash_attention and
ssd_scan kernels."""
from repro_torch.models.api import Model, build_model

__all__ = ["Model", "build_model"]
