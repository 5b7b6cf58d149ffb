"""Blocked online-softmax attention forward: the CUDA kernel and its plain
version.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py`` (route:
CUDA C++ for sm_90a, ``csrc/flash_attention.cu``, bound with ctypes).  At
the prefill shape the kernel is bound by operations: the source's head
note says so and what its design does about it.

q is (B, Sq, H, D), k and v are (B, Sk, Hkv, D) with H % Hkv == 0 (GQA:
query head h reads kv head h // (H // Hkv)).  Masks: causal (row >= col)
and, for ``window > 0``, row - col < window.  The output is (B, Sq, H, D)
in q's dtype.  A query row that sees no key at all (possible only when
Sq > Sk + window) gets zeros from the kernel, where the plain version
averages every value row; the model never makes such a call (Sq == Sk).

:func:`flash_attention` launches the kernel on CUDA tensors and raises on
anything else; :func:`flash_attention_ref` is the same function as dense
masked softmax in float32 (``repro/kernels/ref.py::attention_ref``), the
CPU path and the card's yardstick.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_K = 128  # the TPU kernel's kv block, which sets its padding contract


def check_args(q, k, v, *, causal: bool, window: int) -> None:
    """Shape contract shared by both versions: 4-D (B, S, H, D) tensors of
    one dtype, H % Hkv == 0, and -- the TPU kernel's contract, kept --
    no non-causal call whose Sk its kv block would have to pad."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, S, H, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    sk = k.shape[1]
    block_k = min(BLOCK_K, max(sk, 8))
    if not causal and sk % block_k:
        raise NotImplementedError(
            "non-causal attention with Sk not a multiple of the kv block "
            f"({sk} % {block_k}) needs an explicit kv mask")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain torch version: dense masked softmax in float32, output in
    q.dtype."""
    check_args(q, k, v, causal=causal, window=window)
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    sk, rep = k.shape[1], h // k.shape[2]
    kk = k.float().repeat_interleave(rep, dim=2)
    vv = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(d)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= q_pos - k_pos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _launcher():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_layout(x, name: str, dev) -> None:
    align = 16 // x.element_size()
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if x.stride(3) != 1 or any(s % align for s in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError(
            f"flash_attention reads {name} through its strides with 16-byte "
            f"loads: the head dim must be contiguous and the other strides "
            f"multiples of {align} elements, got strides {x.stride()}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the CUDA kernel: q (B, Sq, H, D), k and v (B, Sk, Hkv, D),
    float32 or bfloat16 on one CUDA device, D in 16/32/64/80/128, the head
    dim contiguous.  Returns (B, Sq, H, D) in q's dtype.

    Adds one to ``flash_attention.launches`` for each launch.  Raises on
    a CPU tensor, another dtype, head dim or layout, or a launch the
    runtime refuses.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(
            f"flash_attention launches on CUDA tensors, got {dev}")
    check_args(q, k, v, causal=causal, window=window)
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_cuda_layout(x, name, dev)
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b == 0 or sq == 0 or h == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                DTYPES[q.dtype], b, sq, sk, h, hkv, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], int(causal), int(window),
                1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
