"""Shared neural-net layers: the port of ``repro.models.layers``.

Parameters are plain nested dicts of tensors built from :class:`ParamSpec`
records, so shapes and parameter counts exist without allocating memory.
:func:`shard` is the reference's sharding constraint: it redistributes a
DTensor over its mesh and leaves a plain tensor as it is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.sharding import tp
from repro_torch.sharding.rules import (P, axis_sizes, entry_size,
                                        placements)

# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape + dtype + logical axis names + init."""

    shape: tuple
    axes: tuple  # logical axis name per dim (or None)
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # "normal" | "zeros" | "ones" | "conv"
    scale: float = 0.02

    def initialize(self, generator: torch.Generator,
                   device) -> torch.Tensor:
        """Draw the parameter on ``device`` from ``generator``, which must
        live on that device."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        fan_in = self.shape[0] if len(self.shape) > 1 else max(
            self.shape[0], 1)
        scale = self.scale if self.init == "normal" else 1.0 / math.sqrt(
            fan_in)
        x = torch.randn(self.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x.mul_(scale)).to(self.dtype)


class TensorSpec(NamedTuple):
    """Shape and dtype of a cache tensor, without allocating it."""
    shape: tuple
    dtype: torch.dtype


def init_tree(specs, generator: torch.Generator, device, *, mesh=None,
              placements=None):
    """Nested dict of ParamSpec -> the same dict of tensors, each drawn in
    turn from ``generator`` on ``device``.  With a ``mesh`` and a
    ``placements`` tree of the same structure, each tensor is placed on
    the mesh (``fsdp.place``: this rank's shard) as soon as it is drawn,
    so the whole leaves never exist together."""
    from repro_torch.sharding import fsdp
    out = {}
    for k, s in specs.items():
        if isinstance(s, ParamSpec):
            t = s.initialize(generator, device)
            out[k] = t if mesh is None else \
                fsdp.place(t, mesh, placements[k])
        else:
            out[k] = init_tree(s, generator, device, mesh=mesh,
                               placements=None if mesh is None
                               else placements[k])
    return out


def shapes_tree(specs):
    """Nested dict of ParamSpec -> the same dict of TensorSpec (no
    allocation)."""
    return {k: TensorSpec(tuple(s.shape), s.dtype)
            if isinstance(s, ParamSpec) else shapes_tree(s)
            for k, s in specs.items()}


# ---------------------------------------------------------------------------
# Sharding helper
# ---------------------------------------------------------------------------


def resolve_spec(spec, shape, sizes: dict) -> tuple:
    """The reference's resolution of a ``shard`` spec on a mesh whose axes
    have ``sizes`` (name -> size): an entry that is not a mesh axis (or a
    tuple of them), or whose devices do not divide the dimension, becomes
    None."""
    def keep(entry, dim) -> bool:
        if entry is None:
            return True
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        return all(a in sizes for a in axes) and \
            dim % entry_size(sizes, axes) == 0

    return tuple(e if keep(e, d) else None for e, d in zip(spec, shape))


def shard(x, *spec):
    """Redistribute a DTensor over its own mesh to ``spec`` (resolved by
    :func:`resolve_spec`); a plain tensor comes back unchanged.  The
    models call it where the reference does, with its specs, on
    activations: those are plain tensors of this rank's rows (sharded
    parameters are gathered before use, ``sharding/fsdp.py``), so the
    calls change no value -- as the reference's logical names
    (``"batch"``, ``"heads"``) are no mesh axes and resolve to
    replicated."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    clean = resolve_spec(spec, tuple(x.shape), axis_sizes(mesh))
    return x.redistribute(mesh, placements(mesh, P(*clean)))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps=1e-5):
    """RMS norm computed in float32, returned in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layernorm(x, scale, bias, eps=1e-5):
    """Layer norm computed in float32, returned in x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim / 2,) float32 inverse frequencies, bit for bit those the
    reference's models run: their frequencies depend on constants only,
    so XLA folds ``1 / theta ** e`` when it compiles the model, in float64
    from the float32 exponents e, and rounds once.  (Taken op by op,
    float32 pow and reciprocal round twice: at head dim 128 and theta 1e6
    25 of 64 frequencies then differ by an ulp, 0.03 rad of rotation at
    position 524,287.)"""
    e = torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=device) / head_dim
    return (1.0 / theta ** e.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate-half RoPE. x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (D/2,)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (S, d_model) float32, with
    the reference's divisor d_model / 2 - 1: computed in float64 with
    numpy, as the reference computes them, so both give the same bits."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    inv = 1.0 / (10_000 ** (dim / max(d_model // 2 - 1, 1)))
    ang = pos * inv
    return torch.as_tensor(np.concatenate([np.sin(ang), np.cos(ang)],
                                          axis=-1), dtype=torch.float32,
                           device=device)


# ---------------------------------------------------------------------------
# Blocked attention: the CPU counterpart of the reference's XLA path and of
# the flash_attention kernel.  Causal masking per KV block; with window > 0
# each q block slices only the KV positions it can see.
# ---------------------------------------------------------------------------


def _attn_one_q_block(q, k, v, q_pos, k_pos, causal, window, scale):
    """q: (B,bq,H,D) k/v: (B,Sk,Hkv,D). Returns (B,bq,H,D)."""
    rep = q.shape[2] // k.shape[2]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float().repeat_interleave(rep, dim=2)) * scale
    mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs,
                        v.repeat_interleave(rep, dim=2))


def blocked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0, k_offset: int = 0,
                      block_q: int = 1024):
    """Memory-bounded attention.

    q: (B, Sq, Hq, D);  k, v: (B, Sk, Hkv, D)  (GQA: Hq % Hkv == 0).
    q_offset / k_offset: absolute position of q[:, 0] / k[:, 0].
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    if sq <= block_q or sq % block_q != 0:
        # single-block fallback (short or non-multiple sequences)
        q_pos = q_offset + torch.arange(sq, device=dev)
        k_pos = k_offset + torch.arange(sk, device=dev)
        return _attn_one_q_block(q, k, v, q_pos, k_pos, causal, window,
                                 scale)

    use_slice = window > 0 and sk > 2 * (window + block_q)
    slice_len = math.ceil((window + block_q) / block_q) * block_q
    outs = []
    for i in range(sq // block_q):
        qi = q[:, i * block_q:(i + 1) * block_q]
        q_pos = q_offset + i * block_q + torch.arange(block_q, device=dev)
        if use_slice:
            start = min(max(q_offset + i * block_q + block_q - slice_len
                            - k_offset, 0), sk - slice_len)
            ki = k[:, start:start + slice_len]
            vi = v[:, start:start + slice_len]
            k_pos = k_offset + start + torch.arange(slice_len, device=dev)
        else:
            ki, vi = k, v
            k_pos = k_offset + torch.arange(sk, device=dev)
        outs.append(_attn_one_q_block(qi, ki, vi, q_pos, k_pos, causal,
                                      window, scale))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """Single-token attention against a (possibly ring-buffered) KV cache.

    q: (B, Hq, D); k_cache/v_cache: (B, S, Hkv, D); cache_len: (B,) int --
    number of valid entries.
    """
    s, hkv, d = k_cache.shape[1:]
    rep = q.shape[1] // hkv
    scores = torch.einsum(
        "bhd,bkhd->bhk", q.float(),
        k_cache.float().repeat_interleave(rep, dim=2)) / math.sqrt(d)
    idx = torch.arange(s, device=q.device)[None, :]
    valid = idx < cache_len[:, None]
    scores = torch.where(valid[:, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    return torch.einsum("bhk,bkhd->bhd", probs,
                        v_cache.repeat_interleave(rep, dim=2))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def gated_mlp(x, wi, wg, wo, ax=None):
    """SwiGLU: silu(x@wg) * (x@wi) @ wo.  Split over the ``model`` axis
    ``ax`` (``sharding/tp.py``), ``wi`` and ``wg`` are this rank's hidden
    columns and ``wo`` its rows, and the result is this rank's part of
    the output, which the caller sums (``tp.g``: outside a checkpointed
    block, so the recompute does not repeat the sum)."""
    x = tp.f(x, ax)
    h = x @ wi
    g = x @ wg
    return tp.row(torch.nn.functional.silu(g) * h, wo, ax)


def gelu_mlp(x, w1, b1, w2, b2, ax=None):
    """GELU MLP with biases; the reference's GELU is the tanh form
    (``jax.nn.gelu(approximate=True)``), not torch's default erf.  Split
    over the ``model`` axis ``ax``, ``w1``/``b1`` are this rank's hidden
    columns and ``w2`` its rows; the ranks' parts are summed and ``b2``
    added once, after the sum."""
    h = torch.nn.functional.gelu(tp.f(x, ax) @ w1 + b1, approximate="tanh")
    return tp.g(tp.row(h, w2, ax), ax, x.dtype) + b2
