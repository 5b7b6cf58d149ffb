"""GridPilot in PyTorch: the port of ``repro`` for NVIDIA GPUs.

The package mirrors the layout of the JAX package (``core``, ``grid``,
``workload``, ``obs``, ``kernels``, ``models``, ``optim``, ``train``,
``ckpt``, ``data``, ``launch``) with the same function names, written
in PyTorch idiom: plain functions on tensors whose leading scenario axis
is written out where JAX used ``vmap``, Python loops where JAX used
``lax.scan``, and NamedTuple/dataclass state with tensor fields.

The device is explicit.  Every entry point takes ``device=`` and defaults
to ``"cuda"``; on a machine without a card that default raises instead of
quietly running on the CPU.  Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device=`` argument -> a usable ``torch.device``.

    ``None`` means the default, CUDA.  A CUDA device on a machine where
    ``torch.cuda.is_available()`` is false raises ``RuntimeError``: the
    port never falls back to the CPU on its own.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU")
    return dev
