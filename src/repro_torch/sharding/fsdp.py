"""Sharded training state on a ``DeviceMesh``: the parameters and AdamW
moments as DTensors placed by :class:`~repro_torch.sharding.rules.MeshRules`,
the port's counterpart of the reference's ``in_shardings`` under pjit.

A leaf whose placements shard some dimension is a DTensor holding only
this rank's shard; a leaf that every placement replicates stays a plain
tensor (the same on every rank).  No rank ever holds a whole sharded leaf
except inside :func:`gather`, which the models call where they use a
leaf (FSDP semantics): a layer's leaves inside the layer, the
embeddings, norms and heads where they are applied.

:func:`gather` returns the whole leaf as a plain tensor.  Its backward
takes the gradient as ``Partial`` over the mesh axes named by
:func:`grad_partial` -- the axes the batch is split over, where each rank
holds the gradient of its own rows -- and ``Replicate`` over the others,
where every rank saw the same rows (a ``Partial`` there would multiply
the gradient by the axis width).  So the gradient of a sharded leaf
comes back reduce-scattered to the leaf's placements, summed over the
batch axes; the step divides by their width.

A model passes its compute dtype: the shard is cast first and gathered
in it (bf16 moves half the bytes of f32), and the gradient is reduced in
the leaf's own dtype -- the values of casting the whole leaf, as the
replicated step does.  The collectives are ``torch.distributed``'s
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``),
one per sharded mesh dim, on the mesh dim's group -- not DTensor's own
redistribution: its functional collectives fault on CUDA tensors over
gloo (torch 2.11), the backend ``launch.mesh.choose_backend`` picks
where ranks share a card.

Importing this module initialises neither CUDA nor a process group.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

# (mesh, the axes the batch is split over) of the step running
# (``grad_partial``); None outside a step: a gathered leaf's gradient
# then stays Replicate
_PARTIAL: list = [None]
# whether unstack gives each layer of an accumulating leaf a gradient leaf
# of its own (``layer_leaves``)
_LAYER_LEAVES: list = [False]
# the gathers' and reduce-scatters' collectives since the last
# ``reset_collective_stats``: wall seconds, calls, output bytes by op
COLLECTIVE_STATS: dict = {}


def _dt():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor (a placed leaf)."""
    return isinstance(x, _dt())


def local(x):
    """This rank's shard of a DTensor (a view of its storage), or ``x``."""
    return x.to_local() if is_sharded(x) else x


def contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def replicated(placements) -> bool:
    from torch.distributed.tensor import Replicate
    return all(isinstance(p, Replicate) for p in placements)


def local_shape(shape, mesh, placements) -> tuple:
    """The shape of one rank's shard (the rules split evenly)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split over mesh dim {i} ({n})")
            out[p.dim] //= n
    return tuple(out)


def local_chunk(full, mesh, placements):
    """This rank's shard of the whole tensor ``full`` (a view): each
    ``Shard(d)`` narrows dim ``d`` to this rank's coordinate on that mesh
    dimension, in mesh order (a dim sharded over two mesh axes splits
    over the first, then the second, as ``P(("a", "b"))``)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            size = out.shape[p.dim] // mesh.size(i)
            out = out.narrow(p.dim, coord[i] * size, size)
    return out


def from_local(loc, mesh, placements, shape):
    """A DTensor of global ``shape`` from this rank's shard ``loc`` (no
    communication, no check)."""
    return _dt().from_local(loc, mesh, tuple(placements), run_check=False,
                            shape=torch.Size(shape),
                            stride=contiguous_stride(shape))


def place(full, mesh, placements):
    """``full`` placed on ``mesh``: a DTensor of this rank's shard, a copy
    that lets the whole tensor go, or ``full`` itself where every
    placement replicates.  Every rank must pass the same ``full``;
    nothing is communicated."""
    if replicated(placements):
        return full
    loc = local_chunk(full, mesh, placements)
    if loc.numel() != full.numel():
        loc = loc.clone(memory_format=torch.contiguous_format)
    return from_local(loc, mesh, placements, full.shape)


def placed_zeros(shape, dtype, mesh, placements, device):
    """Zeros placed like :func:`place` without the whole tensor ever
    existing (on ``meta``, nothing is allocated)."""
    if replicated(placements):
        return torch.zeros(shape, dtype=dtype, device=device)
    loc = torch.zeros(local_shape(shape, mesh, placements), dtype=dtype,
                      device=device)
    return from_local(loc, mesh, placements, shape)


def like(loc, ref):
    """``loc``, this rank's shard of a tensor placed as the DTensor
    ``ref``, as a DTensor; ``loc`` itself when ``ref`` is plain."""
    if not is_sharded(ref):
        return loc
    return from_local(loc, ref.device_mesh, ref.placements, ref.shape)


def replicas(x) -> int:
    """How many ranks hold each element of ``x``: the ranks of its mesh
    over the shards, or every rank of the world for a plain tensor."""
    from torch.distributed.tensor import Shard
    if not is_sharded(x):
        return dist.get_world_size() if dist.is_initialized() else 1
    mesh = x.device_mesh
    shards = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                       if isinstance(p, Shard))
    return mesh.size() // shards


def row_range(x) -> tuple[int, int]:
    """``[lo, hi)``: the dim-0 rows of the whole tensor that this rank's
    shard of ``x`` holds, for placements that shard dim 0 only (ZeRO-1)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    lo, size = 0, x.shape[0]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            if p.dim != 0:
                raise ValueError(f"placements {x.placements} shard a dim "
                                 "other than 0")
            size //= mesh.size(i)
            lo += coord[i] * size
    return lo, lo + size


# ---------------------------------------------------------------------------
# The gather and its gradient
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def grad_partial(mesh, axes):
    """Within the block, a gathered leaf's gradient is ``Partial`` over
    the axes ``axes`` (names of ``mesh``'s dims, those the batch is split
    over) and ``Replicate`` over the others, and :func:`batch_mean`
    averages over ``axes``.  The step wraps its forward and backward in
    it; ``mesh`` None is no step on a mesh."""
    prev = _PARTIAL[0]
    _PARTIAL[0] = None if mesh is None else (mesh, tuple(axes))
    try:
        yield
    finally:
        _PARTIAL[0] = prev


def _partial_dims(mesh) -> tuple:
    """The indices of ``mesh``'s dims the current gradient is Partial over
    (:func:`grad_partial`)."""
    if _PARTIAL[0] is None:
        return ()
    axes = _PARTIAL[0][1]
    return tuple(i for i, name in enumerate(mesh.mesh_dim_names)
                 if name in axes)


def reset_collective_stats() -> dict:
    """Zero :data:`COLLECTIVE_STATS` (and return it)."""
    COLLECTIVE_STATS.update(seconds=0.0, calls=0, bytes_by_op={})
    return COLLECTIVE_STATS


reset_collective_stats()


def _collective(fn, name: str, out, inp, group, **kw):
    t0 = time.perf_counter()
    fn(out, inp, group=group, **kw)
    st = COLLECTIVE_STATS
    st["seconds"] += time.perf_counter() - t0
    st["calls"] += 1
    st["bytes_by_op"][name] = st["bytes_by_op"].get(name, 0) + \
        out.numel() * out.element_size()
    return out


def _all_reduce_into(out, inp, group, op=dist.ReduceOp.SUM):
    dist.all_reduce(out, op=op, group=group)


def _all_gather(x, dim: int, group, n: int):
    """The concatenation along ``dim`` of ``x`` over the ``n`` ranks of
    ``group``, in rank order."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=xt.dtype, device=xt.device)
    _collective(dist.all_gather_into_tensor, "all-gather", out, xt, group)
    return out.movedim(0, dim)


def _reduce_scatter(g, dim: int, group, n: int):
    """The sum over the ``n`` ranks of ``group`` of ``g``, this rank's
    chunk along ``dim``."""
    gt = g.movedim(dim, 0).contiguous()
    out = torch.empty((gt.shape[0] // n,) + tuple(gt.shape[1:]),
                      dtype=gt.dtype, device=gt.device)
    _collective(dist.reduce_scatter_tensor, "reduce-scatter", out, gt,
                group)
    return out.movedim(0, dim)


def _all_reduce(g, group, op=dist.ReduceOp.SUM):
    """The reduction (a SUM by default) of ``g`` over ``group``, in a
    copy."""
    g = g.contiguous().clone()
    return _collective(_all_reduce_into, "all-reduce", g, g, group, op=op)


class _AllReduceSum(torch.autograd.Function):
    """SUM over ``group``; the gradient is summed over it too (each
    rank's loss saw the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def batch_mean(x):
    """The mean of ``x`` over the ranks the step's batch is split over
    (:func:`grad_partial`), differentiably: a statistic over the global
    batch, as the reference computes it on the whole batch (the MoE
    router's expert loads).  ``x`` itself outside a step or where one
    rank holds the batch."""
    if _PARTIAL[0] is None:
        return x
    mesh, axes = _PARTIAL[0]
    n = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)
    if n == 1:
        return x
    for a in axes:
        x = _AllReduceSum.apply(x, mesh.get_group(a))
    return x / n


def _gather_local(loc, mesh, placements, keep=()):
    """The whole tensor from this rank's shard ``loc``: an all-gather over
    each sharded mesh dim, the innermost first (a dim sharded over two
    mesh axes splits over the first, then the second); the mesh dims
    whose indices are in ``keep`` stay sharded."""
    from torch.distributed.tensor import Shard
    x = loc
    for i in reversed(range(mesh.ndim)):
        p, n = placements[i], mesh.size(i)
        if isinstance(p, Shard) and n > 1 and i not in keep:
            x = _all_gather(x, p.dim, mesh.get_group(i), n)
    return x


class _Gather(torch.autograd.Function):
    """A shard gathered whole in ``dtype`` (cast before the gather, so a
    bf16 step moves half the bytes), but over the mesh dims ``keep``,
    where it stays this rank's shard; the gradient, taken back in the
    shard's dtype, is reduced over the ``partial`` mesh dims (a
    reduce-scatter where the leaf is sharded, an all-reduce where it is
    replicated), cut to this rank's chunk over the others, and left as
    it is over ``keep`` (the rank's own shard's gradient)."""

    @staticmethod
    def forward(ctx, loc, mesh, placements, dtype, partial, keep=()):
        ctx.mesh, ctx.placements, ctx.partial = mesh, placements, partial
        ctx.dtype, ctx.keep = loc.dtype, keep
        x = _gather_local(loc.to(dtype), mesh, placements, keep)
        return x.clone() if x is loc else x

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Shard
        mesh = ctx.mesh
        coord = mesh.get_coordinate()
        g = g.to(ctx.dtype)
        for i, p in enumerate(ctx.placements):
            n = mesh.size(i)
            if n == 1 or i in ctx.keep:
                continue
            group = mesh.get_group(i)
            if i in ctx.partial:
                g = _reduce_scatter(g, p.dim, group, n) \
                    if isinstance(p, Shard) else _all_reduce(g, group)
            elif isinstance(p, Shard):
                size = g.shape[p.dim] // n
                g = g.narrow(p.dim, coord[i] * size, size)
        return g.contiguous(), None, None, None, None, None


def full(x):
    """The whole of ``x`` as a plain tensor on every rank (``x`` itself
    when plain); no gradient."""
    if not is_sharded(x):
        return x
    with torch.no_grad():
        return _gather_local(local(x), x.device_mesh, x.placements)


class LocalShard(NamedTuple):
    """This rank's shard of a sharded leaf as the models take it: the
    local tensor, which autograd records (the step's gradient leaf, or a
    layer's view of it: :func:`unstack`, :func:`layer_slice`), with the
    whole leaf's mesh, placements and shape.  The models only
    :func:`gather` it, so no DTensor enters the autograd graph."""

    local: torch.Tensor
    mesh: object
    placements: tuple
    shape: tuple

    @property
    def dtype(self):
        return self.local.dtype


def is_plain(x) -> bool:
    """Whether ``x`` is a plain tensor (a replicated leaf)."""
    return isinstance(x, torch.Tensor) and not is_sharded(x)


def as_input(loc, x):
    """``loc`` (this rank's local tensor of ``x``) as the models take
    ``x``: itself for a plain ``x``, else a :class:`LocalShard`."""
    if is_plain(x):
        return loc
    return LocalShard(loc, x.device_mesh, tuple(x.placements),
                      tuple(x.shape))


def _parts(x):
    """(local, mesh, placements, shape) of a DTensor or a LocalShard."""
    if isinstance(x, LocalShard):
        return x
    return local(x), x.device_mesh, tuple(x.placements), tuple(x.shape)


def gather(x, dtype=None, *, keep=(), partial=()):
    """The whole leaf where a model uses it, in ``dtype`` (default its
    own): a plain tensor cast; a DTensor's (or a LocalShard's)
    all-gather, whose gradient is reduced over the :func:`grad_partial`
    axes and scattered back to the shard's placements, in its dtype.

    ``keep`` names mesh dims over which the leaf stays this rank's shard
    (tensor parallelism gathers "all but ``model``"): its gradient there
    is the rank's own.  ``partial`` names more mesh dims over which the
    gradient is summed, where each rank's use of the whole leaf gives
    only its part of the gradient (``sharding/tp.py``).  A plain leaf
    takes neither (``tp.whole`` sums a plain leaf's gradient)."""
    if is_plain(x):
        return x if dtype is None else x.to(dtype)
    loc, mesh, placements, _ = _parts(x)
    names = mesh.mesh_dim_names
    keep = tuple(names.index(a) for a in keep if a in names)
    partial = tuple(sorted(set(_partial_dims(mesh)) | {
        names.index(a) for a in partial if a in names}))
    if set(keep) & set(partial):
        raise ValueError(f"mesh dims {keep} both kept and partial")
    return _Gather.apply(loc, mesh, placements, dtype or loc.dtype,
                         partial, keep)


def gather_tree(tree: dict, dtype=None) -> dict:
    """:func:`gather` over a (nested) dict of leaves."""
    return {k: gather_tree(v, dtype) if isinstance(v, dict)
            else gather(v, dtype) for k, v in tree.items()}


def _drop_lead(placements, shape, n: int = 1) -> tuple:
    """``placements`` with the ``n`` leading (unsharded) dims gone."""
    from torch.distributed.tensor import Shard
    if any(isinstance(p, Shard) and p.dim < n for p in placements):
        raise ValueError(f"a layer dim of {tuple(shape)} is sharded")
    return tuple(Shard(p.dim - n) if isinstance(p, Shard) else p
                 for p in placements)


@contextlib.contextmanager
def layer_leaves():
    """Within the block, :func:`unstack` gives each layer of a stacked
    gradient leaf whose ``.grad`` is set (an accumulator) a gradient leaf
    of its own, whose ``.grad`` is the accumulator's view of that layer:
    autograd adds a layer's gradient into the accumulator in place as
    soon as the layer's backward has run.  An ``unbind`` would hold every
    layer's gradient until the backward reaches layer 0, then stack them:
    a second gradient tree beside the accumulators.  The microbatched
    train step runs its forwards and backwards in it."""
    prev = _LAYER_LEAVES[0]
    _LAYER_LEAVES[0] = True
    try:
        yield
    finally:
        _LAYER_LEAVES[0] = prev


def _layers(t) -> tuple:
    """``t``'s slices along dim 0: its ``unbind``, or within
    :func:`layer_leaves` for a leaf with an accumulator, a leaf a slice
    (a view of ``t``) with ``.grad`` the accumulator's slice."""
    if not (_LAYER_LEAVES[0] and t.is_leaf and t.grad is not None):
        return t.unbind(0)
    base, acc = t.detach(), t.grad
    out = []
    for i in range(t.shape[0]):
        v = base[i].requires_grad_(True)
        v.grad = acc[i]
        out.append(v)
    return tuple(out)


def unstack(x) -> tuple:
    """The slices of a stacked leaf along its leading (layer) dim: one
    ``unbind`` of a plain tensor, or of a sharded leaf's local shard into
    LocalShards (the layer dim is never sharded).  Either way the
    backward stacks the layers' gradients once -- or, within
    :func:`layer_leaves`, adds each into its layer of the accumulator."""
    if is_plain(x):
        return _layers(x)
    loc, mesh, placements, shape = _parts(x)
    pl = _drop_lead(placements, shape)
    return tuple(LocalShard(v, mesh, pl, shape[1:]) for v in _layers(loc))


def layer_slice(x, *idx):
    """``x[idx]`` of a stacked leaf, for integer indices over its leading
    (unsharded) dims."""
    if is_plain(x):
        return x[idx]
    loc, mesh, placements, shape = _parts(x)
    return LocalShard(loc[idx], mesh,
                      _drop_lead(placements, shape, len(idx)),
                      shape[len(idx):])


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def shard_bytes(tree) -> int:
    """Bytes this rank holds of the leaves of ``tree`` (its shards)."""
    from repro_torch._tree import leaves
    return sum(local(x).numel() * local(x).element_size()
               for x in leaves(tree) if isinstance(x, torch.Tensor))


def full_leaves(tree, *, keep: bool = True):
    """Each leaf of ``tree`` whole on the host, in leaf order: every rank
    takes part in each gather, one leaf at a time, and only a rank with
    ``keep`` keeps the result (the others get None)."""
    from repro_torch._tree import leaves
    out = []
    for x in leaves(tree):
        whole = full(x).detach()
        out.append(whole.cpu() if keep else None)
        del whole
    return out
