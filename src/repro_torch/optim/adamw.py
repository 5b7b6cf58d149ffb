"""AdamW with decoupled weight decay and global-norm clipping: the port of
``repro.optim.adamw``.

The state mirrors the parameters: float32 first and second moments in
nested dicts of the parameters' shape, and the step count as a 0-d int32
tensor.  Where the reference returns new pytrees, the port updates the
parameters and both moments in place (under ``no_grad``) and returns
them: a step at full qwen2-1.5b width then needs no second copy of its
~25 GB of parameters, gradients and moments.  A large leaf is updated in
slices of ``UPDATE_SLICE`` elements, so the update's temporaries stay
small (zamba2-2.7b's largest leaf is 5.7 GB; whole, its temporaries
would take several times that); every element's arithmetic is the same.
The numbers are the reference's: moments in float32, the update computed
in float32 and cast back to each parameter's dtype.

Sharded state (``sharding/fsdp.py``): every leaf may be a DTensor, and
each rank updates its own shards.  Where the moments shard a parameter
that is replicated (ZeRO-1, the ``dp_only`` plans), each rank updates
the rows its moments cover and the parameter's rows are all-gathered
back.  ``global_norm`` of a sharded tree is the norm of the whole
gradient: each rank's shards summed, every element counted once however
many ranks hold it, and one all-reduce.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch._tree import leaves, tree_map
from repro_torch.sharding import fsdp


UPDATE_SLICE = 1 << 26    # elements of one slice of a leaf's update


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    mu: dict             # first moment, float32, the params' structure
    nu: dict             # second moment


def adamw_init(params) -> AdamWState:
    """Zero moments beside the parameters, on their devices (a DTensor
    parameter's placed as it is)."""
    def zeros(p):
        if fsdp.is_sharded(p):
            return fsdp.placed_zeros(p.shape, torch.float32, p.device_mesh,
                                     p.placements, fsdp.local(p).device)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = leaves(params)
    dev = fsdp.local(first[0]).device if first else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.  With any
    DTensor leaf, each rank sums its shards, each divided by how many
    ranks hold it (``fsdp.replicas``: a plain leaf, by the world), and
    one all-reduce adds the ranks' sums."""
    flat = leaves(tree)
    if not any(fsdp.is_sharded(g) for g in flat):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in flat))
    total = sum(torch.sum(torch.square(fsdp.local(g).float()))
                / fsdp.replicas(g) for g in flat)
    dist.all_reduce(total)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step.  ``lr`` may be a number or a 0-d tensor (from a
    schedule).  Updates ``params`` and the moments in place; returns
    (params, new_state, metrics) with ``grad_norm`` taken before the
    clip."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    b1c = 1.0 - b1 ** step.float()
    b2c = 1.0 - b2 ** step.float()

    def upd_slice(p, g, m, v):
        g = g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        pf = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps) + weight_decay * pf
        p.copy_(pf - lr * delta)

    def upd_local(p, g, m, v):
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            upd_slice(p, g, m, v)
            return
        flat = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
        for i in range(0, p.numel(), UPDATE_SLICE):
            upd_slice(*(t[i:i + UPDATE_SLICE] for t in flat))

    def upd(p, g, m, v):
        pl, gl, ml, vl = (fsdp.local(t) for t in (p, g, m, v))
        if ml.shape == pl.shape:
            upd_local(pl, gl, ml, vl)
            return p
        # ZeRO-1: this rank's rows of a replicated parameter, then every
        # rank's rows gathered back into it
        lo, hi = fsdp.row_range(m)
        upd_local(pl[lo:hi], gl[lo:hi], ml, vl)
        pl.copy_(fsdp.full(fsdp.from_local(pl[lo:hi], m.device_mesh,
                                           m.placements, pl.shape)))
        return p

    tree_map(upd, params, grads, state.mu, state.nu)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {
        "grad_norm": gnorm,
        "lr": torch.as_tensor(lr, dtype=torch.float32),
    }
