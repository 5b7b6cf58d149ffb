"""Error-feedback int8 gradient compression: the port of
``repro.optim.compress``.

Symmetric per-tensor int8 quantisation with the quantisation error kept
as a residual (error feedback), so the sum of what was sent plus the
residual equals the sum of the true gradients.  The pure functions are
here; the data-parallel all-reduce that sends the int8 payload
(``make_compressed_train_step``, ``compressed_psum``) needs a mesh and
waits for ROADMAP A11.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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
