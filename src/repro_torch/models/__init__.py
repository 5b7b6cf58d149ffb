"""Model zoo of the port: the dense decoder-only LM (``Model``,
``build_model``) on the flash_attention kernel."""
from repro_torch.models.api import Model, build_model

__all__ = ["Model", "build_model"]
