"""Scalar-or-tensor helpers shared by the port's physics.

The physics functions take Python numbers as well as tensors, like the
reference's ``jnp`` functions do.  A Python number stays a Python float
(rounded to float32) and enters tensor ops as a kernel argument: turning
it into a device tensor would copy it from the host, and such a copy
waits for the device -- inside a tick loop that sets the loop's pace.
"""
from __future__ import annotations

import numpy as np
import torch


def float_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype a tensor computes in: its own if it is float32 or wider
    (float64 stays float64), else float32 -- ``jnp.result_type(dtype,
    float32)`` as the reference takes it."""
    return torch.promote_types(t.dtype, torch.float32)


def f32(x, device=None):
    """Tensors -> tensors of :func:`float_dtype` (moved to ``device`` when
    given); numbers -> Python floats holding a float32 value; arrays ->
    float32 tensors."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=float_dtype(x))
    a = np.asarray(x, np.float32)
    if a.ndim == 0:
        return float(a)
    return torch.from_numpy(a.copy()).to(device or "cpu")


def clip(x, lo=None, hi=None):
    """``jnp.clip`` for a tensor or a Python number."""
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, lo, hi)
    if lo is not None:
        x = max(x, lo)
    if hi is not None:
        x = min(x, hi)
    return x


def where(cond, a, b):
    """``jnp.where`` for a tensor or a Python condition."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return a if cond else b


def device_of(*xs, default=None):
    """The device of the first tensor among ``xs`` (else ``default``)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return default


def tensor(x, device=None, number_dtype=torch.float32) -> torch.Tensor:
    """``x`` as a tensor on ``device`` (a tensor keeps its device when
    ``device`` is None, and computes in :func:`float_dtype`).  A number
    becomes a filled 0-d tensor of ``number_dtype`` (float32 unless the
    caller computes in float64, where a number keeps its digits as the
    reference's weakly typed numbers do), which needs no copy from the
    host; an array is copied in float32 (set-up code only: the copy waits
    for the device)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=float_dtype(x))
    a = np.array(x, np.float64)
    if a.ndim == 0:
        return torch.full((), float(a), dtype=number_dtype, device=device)
    return torch.from_numpy(a.astype(np.float32)).to(device or "cpu")


_CONSTS: dict = {}


def const(table, device, dtype=torch.float32) -> torch.Tensor:
    """A small constant table as a tensor on ``device``, copied from the
    host once per device and process and reused after that."""
    a = np.asarray(table)
    key = (a.tobytes(), a.shape, a.dtype.str, str(dtype), str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(a, device=device).to(dtype)
    return t


def take(table, idx):
    """``table[idx]`` of a numpy table: a Python float for an int index,
    a float32 tensor on the index's device for a tensor index."""
    if isinstance(idx, torch.Tensor):
        return const(np.asarray(table, np.float32), idx.device)[idx.long()]
    return float(np.float32(np.asarray(table)[int(idx)]))


def override(x, shape, name: str, what: str, dev) -> torch.Tensor:
    """A caller's override of a draw or an input, as a tensor on ``dev``
    (:func:`tensor`), checked against the ``shape`` it replaces (``what``
    names that shape in the error)."""
    x = tensor(x, dev)
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} override must have shape {what} = "
                         f"{tuple(shape)}, got {tuple(x.shape)}")
    return x
