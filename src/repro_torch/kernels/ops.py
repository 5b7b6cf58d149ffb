"""Public entry points of the port's kernels.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain torch version.  Nothing falls
back from one to the other.

On the card the model kernels' outputs carry autograd through a
``torch.autograd.Function`` each: ``FlashAttentionFn``, whose backward
is the two hand-written backward kernels, and ``SsdScanFn``, whose
backward is the scan's backward kernels (``csrc/ssd_scan_bwd.cu``: five
on the tensor cores for bf16 inputs, four f32 ones otherwise).
Under ``no_grad``, or when no input needs a gradient, the forward is the
same launch as before, and the attention kernel writes no LSE.  On the
CPU autograd differentiates the plain versions as they are.

A ``meta`` tensor (the dry run's, ``launch/dryrun.py``) takes a
shape-only path: the output's shape and dtype, no work, and the FLOPs
the port's kernels do for the call -- forward and, when autograd runs
it, backward -- added to ``META_FLOPS`` by the formulas of their bounds
(``flash_flops``, ``ssd_flops``, ``ssd_bwd_flops``).  The plain versions
would instead hold the dense (B, H, Sq, Sk) scores: 4.4 TB in f32 at
yi-9b's 32k prefill.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_ref)
from repro_torch.kernels.pid_update import (DT_S, PIDGains, pid_update_ref,
                                            pid_update as _pid_cuda)
from repro_torch.kernels.ssd_scan import SsdScanFn, ssd_scan_ref


# FLOPs of the kernels' meta calls since the last clear, by kernel name
META_FLOPS: collections.Counter = collections.Counter()


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(row, column) pairs the attention mask keeps: column j of row i
    where j <= i (causal) and i - j < window (window > 0)."""
    i = torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(i, max=sk - 1) if causal else torch.full_like(i,
                                                                   sk - 1)
    lo = torch.clamp(i - window + 1, min=0) if window > 0 else \
        torch.zeros_like(i)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def flash_flops(q, k, *, causal: bool, window: int) -> float:
    """The forward's two products, 4 B H D flop per visible pair (the
    bound of ``flash_fwd_tma`` in ``PERF.md``)."""
    b, sq, h, d = q.shape
    return 4.0 * b * h * d * visible_pairs(sq, k.shape[1], causal, window)


def ssd_flops(x, B, chunk: int) -> float:
    """The scan's least work: C B^T once per (b, chunk), and per head the
    (L * S) dt x, B^T (w x) and C . state products, causal halves once
    (the bound of ``ssd_scan`` in ``PERF.md``)."""
    b, s, nh, hd = x.shape
    ds, nc = B.shape[-1], s // chunk
    tri = chunk * (chunk + 1) // 2
    return 2.0 * b * nc * (tri * ds + nh * (tri * hd + 2 * chunk * hd * ds))


def ssd_bwd_flops(x, B, chunk: int) -> float:
    """The least work of the scan's gradient (the bound of
    ``ssd_scan_bwd`` in ``PERF.md``)."""
    b, s, nh, hd = x.shape
    ds, nc = B.shape[-1], s // chunk
    tri = chunk * (chunk + 1) // 2
    return 2.0 * b * nc * (3 * tri * ds
                           + nh * (2 * tri * hd + 5 * chunk * hd * ds))


class _ShapeOnly(torch.autograd.Function):
    """A kernel call on ``meta`` tensors: an empty output like
    ``inputs[0]``, its forward FLOPs counted, and on the backward empty
    gradients of the inputs that need one and the backward's FLOPs."""

    @staticmethod
    def forward(ctx, name, fwd, bwd, *inputs):
        ctx.name, ctx.bwd = name, bwd
        ctx.like = [(t.shape, t.dtype) for t in inputs]
        META_FLOPS[name] += fwd
        return torch.empty_like(inputs[0])

    @staticmethod
    def backward(ctx, dout):
        META_FLOPS[ctx.name + "_bwd"] += ctx.bwd
        grads = [torch.empty(sh, dtype=dt, device="meta")
                 if need else None
                 for (sh, dt), need in zip(ctx.like,
                                           ctx.needs_input_grad[3:])]
        return (None, None, None, *grads)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Blocked attention forward: q (B, Sq, H, D), k and v (B, Sk, Hkv, D)
    -> (B, Sq, H, D) in q's dtype; ``causal=False`` takes any Sk."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type == "meta":
        f = flash_flops(q, k, causal=causal, window=window)
        # the backward pair: dq's 3 products and dk/dv's 4
        return _ShapeOnly.apply("flash_attention", f, 3.5 * f, q, k, v)
    return FlashAttentionFn.apply(q, k, v, causal, window,
                                  _needs_grad(q, k, v))


def pid_update(target, power, temp, integ, prev_err, gains: PIDGains, *,
               dt_s: float = DT_S):
    """Fused fleet PID tick over (N,) float32 tensors:
    returns (new_integ, new_prev_err, cap)."""
    if target.device.type == "cpu":
        return pid_update_ref(target, power, temp, integ, prev_err, gains,
                              dt_s=dt_s)
    return _pid_cuda(target, power, temp, integ, prev_err, gains, dt_s=dt_s)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256):
    """Chunked Mamba-2 SSD scan: x (b, s, nh, hd), dt (b, s, nh), A (nh,),
    B and C (b, s, ds) -> y (b, s, nh, hd) in x's dtype.  ``s % chunk``
    must be 0 on either device."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk)[0]
    if x.device.type == "meta":
        return _ShapeOnly.apply("ssd_scan", ssd_flops(x, B, chunk),
                                ssd_bwd_flops(x, B, chunk), x, dt, A, B, C)
    return SsdScanFn.apply(x, dt, A, B, C, chunk)
