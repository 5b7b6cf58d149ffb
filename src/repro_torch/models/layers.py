"""Shared neural-net layers: the port of ``repro.models.layers``.

Parameters are plain nested dicts of tensors built from :class:`ParamSpec`
records, so shapes and parameter counts exist without allocating memory.
The reference's ``shard`` (a sharding constraint inside a mesh) is the
identity on one card and has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

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


def init_tree(specs, generator: torch.Generator, device):
    """Nested dict of ParamSpec -> the same dict of tensors, each drawn in
    turn from ``generator`` on ``device``."""
    return {k: s.initialize(generator, device) if isinstance(s, ParamSpec)
            else init_tree(s, generator, device) for k, s in specs.items()}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps=1e-5):
    """RMS norm computed in float32, returned in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


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


def gated_mlp(x, wi, wg, wo):
    """SwiGLU: silu(x@wg) * (x@wi) @ wo."""
    h = x @ wi
    g = x @ wg
    return (torch.nn.functional.silu(g) * h) @ wo
