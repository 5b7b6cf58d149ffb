"""Tensor parallelism over the mesh's ``model`` axis: the products that the
reference's GSPMD computes sharded, written as explicit column- and
row-parallel regions (Megatron-LM's layout).

A leaf that the sharding rules split over ``model`` (``sharding/rules.py``
``_FSDP_TP``: ``q_feat``, ``kv_feat``, ``mlp``, ``moe_mlp``, ``experts``,
``ssm_inner``, ``ssm_heads``, ``vocab``) enters its layer as this rank's
``model`` shard, gathered over its other mesh dims only
(:func:`local`).  The layer computes its product on that shard:

- a column-parallel region (the q/k/v, MLP-in, SSM-in and vocabulary
  products) starts at :func:`f`, the identity forward whose backward
  sums the input's gradient over ``model`` -- each rank's columns give
  only their part of it;
- a row-parallel product (``wo``, the MLP's and the SSM's output, the
  MoE combine, the vocabulary lookup) ends at :func:`g`, a sum over
  ``model`` forward whose backward is the identity: every rank computes
  the same loss from the sum, so each takes the whole gradient.

The gradient of a local shard is then this rank's own, and is reduced
over the batch axes only, as ``fsdp.gather``'s is.  A leaf whose
``model`` shard is not what the rank's consumers read (the SSM's packed
``w_zx``, a kv projection a rank cuts whole heads from) is taken whole
with its gradient summed over ``model`` (:func:`whole`).  The sums of
16-bit partials are taken in float32.  :func:`stat_sum` sums a small
statistic over ``model``
both ways (the gated RMSNorm's sum of squares over the whole inner
width), and :func:`vocab_lookup`, :func:`vocab_logsumexp` and
:func:`vocab_pick` are the vocabulary-parallel embedding and
cross-entropy.

A layer reads its decision from its own leaves' placements
(:func:`axis_of`): ``fsdp_tp`` on a mesh whose
``model`` axis is wider than 1 is tensor parallelism; ``dp_only``
replicates every parameter and never gets here.  Every collective is
``torch.distributed``'s own call on the ``model`` dim's group, through
``fsdp``'s wrappers (timed into ``fsdp.COLLECTIVE_STATS``): no DTensor
redistribution.  With no axis (``ax`` None) every function here is the
identity, so a layer has one code path.

Importing this module initialises neither CUDA nor a process group.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.sharding import fsdp

MODEL = "model"


class Axis(NamedTuple):
    """The ``model`` mesh dim a layer splits over: its process group, its
    size and this rank's index on it."""

    group: object
    size: int
    rank: int


def model_axis(x) -> Axis | None:
    """The ``model`` axis of the mesh a sharded leaf ``x`` (a DTensor or
    an ``fsdp.LocalShard``) is placed on, where it is wider than 1; None
    for a plain leaf or a mesh without one."""
    if fsdp.is_plain(x) or not isinstance(x, (fsdp.LocalShard,
                                              torch.Tensor)):
        return None
    _, mesh, _, _ = fsdp._parts(x)
    names = mesh.mesh_dim_names or ()
    if MODEL not in names:
        return None
    i = names.index(MODEL)
    if mesh.size(i) == 1:
        return None
    return Axis(mesh.get_group(i), mesh.size(i), mesh.get_coordinate()[i])


def tree_axis(tree) -> Axis | None:
    """The ``model`` axis (:func:`model_axis`) of the first leaf of the
    (nested) dict ``tree`` placed on a mesh that has one wider than 1, or
    None: the axis a step over ``tree``'s parameters runs on."""
    for v in tree.values():
        ax = tree_axis(v) if isinstance(v, dict) else model_axis(v)
        if ax is not None:
            return ax
    return None


def kv_split(mode: str, m: int, n_heads: int, n_pos: int) -> str | None:
    """How a K/V cache of ``n_heads`` kv heads and ``n_pos`` positions
    splits over a ``model`` axis of ``m`` under the plan's
    ``decode_kv_shard`` ``mode`` (``train.step.cache_pspecs``' rule, which
    the decode step follows): ``"heads"`` where the heads divide, else
    ``"seq"`` where the positions do, else None (whole on every rank)."""
    if mode in ("heads", "auto") and n_heads % m == 0:
        return "heads"
    if mode in ("seq", "auto") and n_pos % m == 0:
        return "seq"
    return None


def splits(x, dim: int | None = None) -> bool:
    """Whether the leaf ``x``'s placements shard it over ``model`` (on
    tensor dim ``dim``, where given; a negative dim counts from the
    end)."""
    from torch.distributed.tensor import Shard
    if model_axis(x) is None:
        return False
    _, mesh, placements, shape = fsdp._parts(x)
    p = placements[mesh.mesh_dim_names.index(MODEL)]
    if not isinstance(p, Shard):
        return False
    return dim is None or p.dim == dim % len(shape)


def axis_of(x) -> Axis | None:
    """The ``model`` axis that the leaf ``x``'s placements shard it over,
    or None: the one test of whether a block splits over ``model``."""
    return model_axis(x) if splits(x) else None


def active(tree) -> bool:
    """Whether any leaf of the (nested) dict ``tree`` splits over a
    ``model`` axis."""
    return any(active(v) if isinstance(v, dict) else splits(v)
               for v in tree.values())


def local(x, dtype=None):
    """A leaf as a tensor-parallel region uses it: gathered over every
    mesh dim but ``model`` (``fsdp.gather(keep=("model",))``), so a leaf
    the rules split over ``model`` is this rank's shard, in ``dtype``."""
    return fsdp.gather(x, dtype, keep=(MODEL,))


def _sum(x, group):
    """The sum of the ranks' ``x`` over ``group``, taken in float32 for a
    16-bit ``x`` and rounded once: the ranks' partial products are each
    rounded already, and a 16-bit sum would round a third time where the
    whole product rounds once."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return fsdp._all_reduce(x.float(), group).to(x.dtype)
    return fsdp._all_reduce(x, group)


class _SumGrad(torch.autograd.Function):
    """The identity; the gradient is summed over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Sum(torch.autograd.Function):
    """The sum over ``group``; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def whole(x, dtype, ax: Axis | None):
    """The whole leaf, in ``dtype``, for a region whose rank-local
    consumers each give part of its gradient: gathered over every mesh
    dim, its gradient summed over ``model`` too (a reduce-scatter where
    the rules shard it over ``model``, an all-reduce where they
    replicate it).  Without ``ax``, ``fsdp.gather``."""
    if ax is None:
        return fsdp.gather(x, dtype)
    if fsdp.is_plain(x):
        return _SumGrad.apply(x, ax.group).to(dtype)
    return fsdp.gather(x, dtype, partial=(MODEL,))


def f(x, ax: Axis | None):
    """Where a column-parallel region begins: ``x`` (the same on every
    rank of ``ax``), its gradient summed over ``ax``."""
    return x if ax is None else _SumGrad.apply(x, ax.group)


def g(x, ax: Axis | None, dtype=None):
    """After a row-parallel product: the sum of the ranks' partial
    products over ``ax`` (in ``dtype``, where given: the row product's
    float32 part rounds once, after the sum); the gradient passes
    through."""
    out = x if ax is None else _Sum.apply(x, ax.group)
    return out if dtype is None else out.to(dtype)


class _RowPart(torch.autograd.Function):
    """``a @ w`` of 16-bit CUDA operands with a float32 output (cuBLAS
    accumulates in float32 either way); the gradients in the operands'
    dtype, as for ``a @ w``."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        out = torch.mm(a.reshape(-1, a.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.view(a.shape[:-1] + (w.shape[-1],))

    @staticmethod
    def backward(ctx, gr):
        a, w = ctx.saved_tensors
        gr = gr.to(a.dtype)
        a2, g2 = a.reshape(-1, a.shape[-1]), gr.reshape(-1, gr.shape[-1])
        return gr @ w.T, a2.T @ g2


def row(a, w, ax: Axis | None):
    """A row-parallel product: this rank's part of ``a @ w`` (its rows of
    ``w``, its columns of ``a``), for :func:`g` to sum.  On the card, with
    16-bit operands, the part is float32, so the sum over the ranks
    rounds once as the whole product does (a 16-bit part would round
    before the sum as well); elsewhere, and without an axis, ``a @ w``."""
    if ax is None or not a.is_cuda or a.dtype not in (torch.bfloat16,
                                                      torch.float16):
        return a @ w
    return _RowPart.apply(a, w)


def all_max(x, ax: Axis):
    """The elementwise max of the ranks' ``x`` over ``ax`` (no
    gradient)."""
    return fsdp._all_reduce(x, ax.group, op=dist.ReduceOp.MAX)


def stat_sum(x, ax: Axis | None):
    """A statistic that each rank computes on its shard, summed over
    ``ax`` both ways (``fsdp._AllReduceSum``): each rank uses the sum on
    its own shard, so the gradient of the sum is the ranks' together."""
    return x if ax is None else fsdp._AllReduceSum.apply(x, ax.group)


class _GatherLast(torch.autograd.Function):
    """The ranks' chunks concatenated along the last dim in rank order;
    the gradient is this rank's chunk of it."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax, ctx.n = ax, x.shape[-1]
        return fsdp._all_gather(x, x.dim() - 1, ax.group, ax.size)

    @staticmethod
    def backward(ctx, gr):
        return gr.narrow(-1, ctx.ax.rank * ctx.n, ctx.n).contiguous(), None


def gather_last(x, ax: Axis | None):
    """The whole of a tensor split over ``ax`` along its last dim (the
    vocabulary's logits, for a caller that wants them all)."""
    return x if ax is None else _GatherLast.apply(x, ax)


# ---------------------------------------------------------------------------
# The vocabulary
# ---------------------------------------------------------------------------


def vocab_lookup(table, tokens, ax: Axis | None):
    """Rows ``tokens`` of an embedding table whose rows are split over
    ``ax``: each rank looks up the tokens its rows hold (zero for the
    others), and :func:`g` sums them.  ``table`` is this rank's rows."""
    if ax is None:
        return table[tokens]
    n = table.shape[0]
    lo = ax.rank * n
    idx = tokens.long() - lo
    mine = (idx >= 0) & (idx < n)
    out = table[torch.where(mine, idx, 0)]
    out = torch.where(mine[..., None], out, torch.zeros((), dtype=out.dtype,
                                                        device=out.device))
    return g(out, ax)


def vocab_logsumexp(logits, ax: Axis | None):
    """logsumexp over the last dim of logits split over ``ax`` (this
    rank's columns): the max and the sum of exponentials over ``ax``.
    The max is held constant (logsumexp does not depend on it), the sum
    passes its gradient through (every rank uses the same logz)."""
    if ax is None:
        return torch.logsumexp(logits, dim=-1)
    with torch.no_grad():
        m = all_max(logits.amax(dim=-1), ax)
    s = torch.exp(logits - m[..., None]).sum(dim=-1)
    return m + torch.log(g(s, ax))


def vocab_pick(logits, targets, ax: Axis | None):
    """``logits[..., targets]`` of logits split over ``ax``: the rank
    that holds each target's column gives it, the others 0, summed."""
    if ax is None:
        return torch.gather(logits, -1, targets[..., None])[..., 0]
    n = logits.shape[-1]
    idx = targets.long() - ax.rank * n
    mine = (idx >= 0) & (idx < n)
    got = torch.gather(logits, -1, torch.where(mine, idx, 0)[..., None])
    return g(torch.where(mine, got[..., 0], 0.0), ax)
