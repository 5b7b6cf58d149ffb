"""Error-feedback int8 gradient compression: the port of
``repro.optim.compress``.

Symmetric per-tensor int8 quantisation with the quantisation error kept
as a residual (error feedback), so the sum of what was sent plus the
residual equals the sum of the true gradients.  :func:`compressed_psum`
is the data-parallel all-reduce of the quantised gradients on a
``torch.distributed`` group; ``repro_torch.train.step.
make_compressed_train_step`` runs it once a step.  As in the reference,
the sum travels as int32 counts on a shared scale: 4 bytes an element on
the wire, not the int8 payload's one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch._tree import tree_map


class CompressionState(NamedTuple):
    residual: dict   # error feedback (float32), the gradients' structure


def compress_init(params) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params))


def quantize_int8(x):
    """Symmetric per-tensor int8 quantisation.  Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def ef_compress(grads, state: CompressionState):
    """Add the residual, quantise.  Returns (q_tree, scale_tree,
    new_state)."""
    comp = tree_map(lambda g, r: g.float() + r, grads, state.residual)
    qs = tree_map(quantize_int8, comp)
    q_tree = tree_map(lambda t: t[0], qs)
    s_tree = tree_map(lambda t: t[1], qs)
    residual = tree_map(lambda c, q, s: c - dequantize_int8(q, s), comp,
                        q_tree, s_tree)
    return q_tree, s_tree, CompressionState(residual=residual)


def ef_decompress(q_tree, s_tree):
    return tree_map(dequantize_int8, q_tree, s_tree)


def requantize_sum(q, s_local, group=None):
    """One leaf of :func:`compressed_psum`: the shared scale (the MAX of
    every rank's ``s_local``), this rank's payload requantised to it as
    int32, the SUM of those counts over ``group``, times the shared
    scale.  ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    s_sh = s_local.detach().clone()
    dist.all_reduce(s_sh, op=dist.ReduceOp.MAX, group=group)
    v = q.float() * s_local
    total = torch.clamp(torch.round(v / s_sh), -127, 127).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * s_sh


def compressed_psum(q_tree, s_tree, group=None):
    """All-reduce the quantised gradients over ``group`` (default: the
    world), leaf by leaf: a MAX of the scale, then a SUM of the int32
    counts on that shared scale (two collectives a leaf)."""
    return tree_map(lambda q, s: requantize_sum(q, s, group), q_tree,
                    s_tree)
