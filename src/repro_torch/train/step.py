"""Train and serve steps: the port of ``repro.train.step``.

``make_train_step`` returns ``train_step(params, opt_state, batch, step)
-> (params, opt_state, metrics)``: the loss and its gradient by
``torch.autograd`` (on a card the attention gradient runs the
flash_attention backward kernels), gradient accumulation over
``microbatches`` as the reference's ``lax.scan`` does it (sum the
microbatches' losses, gradients and metrics, then scale by 1/m), the
warm-up-cosine learning rate, and AdamW, which updates the parameters and
moments in place.  The microbatches' gradients add up in one float32 tree
as they form (each leaf's ``.grad``; a stacked leaf's layer by layer,
``fsdp.layer_leaves``), so a step holds one gradient tree at most.
``make_prefill_step`` and ``make_decode_step`` are the serving steps.

The partition specs (``param_pspecs``, ``opt_pspecs``, ``batch_pspec``,
``cache_pspecs``, ...) are the reference's, from a
:class:`~repro_torch.sharding.rules.MeshRules`.  On a mesh the bundle
places the training state by them, as the reference's ``in_shardings``
do (``sharding/fsdp.py``): ``fsdp_tp`` parameters and moments sharded
(FSDP over the data axes, the ``model`` axis sharding the stored leaves
too), ``dp_only`` parameters replicated and their moments ZeRO-1 (dim 0
over the data axes).  A sharded leaf is a DTensor of this rank's shard;
a replicated one a plain tensor.  Each rank runs the step on its share
of the batch (``batch_rows``).  The models gather a sharded leaf where
they use it -- over every mesh dim but ``model`` where the rules split
it over ``model``, whose products then run on this rank's shards
(``sharding/tp.py``), as the reference's GSPMD computes them -- and its
gradient comes back reduce-scattered: ``Partial`` over the axes the
batch is split over (``StepBundle.batch_axes``), then divided by their
width.  A plain leaf's gradient, the loss and the metrics are averaged
over the world with ``all_reduce``.  The values are those of the
replicated step on the global batch.  A decode cell's cache is placed
by ``cache_pspecs`` (``StepBundle.init_cache``): each rank holds its
shard as plain tensors, and the decode step computes on its shards.

``make_compressed_train_step`` is the int8 error-feedback data-parallel
step: local gradients, ``ef_compress`` against this rank's residual, the
int32 all-reduce on a shared scale, division by the data-parallel width,
the mean of loss and metrics over the ranks, then AdamW.  The reference's
residual carries a leading device axis; here each rank holds its own
(1, ...) slice of it, updated in place.

A :class:`StepBundle` is one (arch x shape) cell on one device, or on a
mesh (``mesh``, ``rules``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch._tree import leaves, tree_map, unflatten_like
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.api import Model, build_model
from repro_torch.models.layers import TensorSpec
from repro_torch.models.transformer import cache_of
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               dequantize_int8, quantize_int8,
                               warmup_cosine)
from repro_torch.optim.compress import requantize_sum
from repro_torch.sharding import fsdp
from repro_torch.sharding import tp as tp_lib
from repro_torch.sharding.rules import MeshRules, P

DEFAULT_LR = dict(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)


# ---------------------------------------------------------------------------
# batch sharding: widest prefix of the data axes that divides the batch
# ---------------------------------------------------------------------------


def batch_axes_for(rules: MeshRules, batch_size: int):
    axes = rules.data_axes
    while axes:
        if batch_size % rules.axis_size(axes) == 0:
            return axes
        axes = axes[:-1]
    return ()


def batch_pspec(rules: MeshRules, batch_size: int, ndim: int) -> P:
    axes = batch_axes_for(rules, batch_size)
    spec = [None] * ndim
    if axes:
        spec[0] = axes if len(axes) > 1 else axes[0]
    return P(*spec)


def batch_share(rules: MeshRules, batch_size: int,
                coordinate) -> tuple[int, int]:
    """``[lo, hi)`` rows of a ``batch_size`` batch that the rank at
    ``coordinate`` (its index on each of the mesh's axes, in order) holds
    under :func:`batch_pspec`: the batch split over the widest prefix of
    the data axes that divides it, row-major over those axes."""
    axes = batch_axes_for(rules, batch_size)
    where = dict(zip(rules.axis_names, coordinate))
    idx = 0
    for a in axes:
        idx = idx * rules.axis_size(a) + where[a]
    rows = batch_size // rules.axis_size(axes)
    return idx * rows, (idx + 1) * rows


def batch_rows(rules: MeshRules, batch_size: int, coordinate,
               microbatches: int = 1):
    """The rows of a ``batch_size`` batch that the rank at ``coordinate``
    takes for a step of ``microbatches``: its :func:`batch_share` of each
    microbatch in turn (an index tensor), so that its i-th local
    microbatch is its share of the global i-th, the rows the reference's
    step accumulates together -- which matters where a microbatch's
    statistic is no mean over its rows (the MoE router's expert loads).
    With one microbatch, :func:`batch_share`'s ``(lo, hi)``."""
    if microbatches == 1:
        return batch_share(rules, batch_size, coordinate)
    axes = batch_axes_for(rules, batch_size)
    n, per = rules.axis_size(axes), batch_size // microbatches
    if batch_size % microbatches or per % n:
        raise ValueError(f"a batch of {batch_size} does not split into "
                         f"{microbatches} microbatches over {n} ranks")
    lo, _ = batch_share(rules, batch_size, coordinate)
    r = lo // (batch_size // n)           # this rank's index over the axes
    return torch.cat([torch.arange(i * per + r * (per // n),
                                   i * per + (r + 1) * (per // n))
                      for i in range(microbatches)])


# ---------------------------------------------------------------------------
# Cache sharding (decode shapes)
# ---------------------------------------------------------------------------


def cache_pspecs(cfg: ArchConfig, rules: MeshRules, cache_specs: dict,
                 batch: int) -> dict:
    """Partition specs of the decode cache."""
    baxes = batch_axes_for(rules, batch)
    b_entry = (baxes if len(baxes) > 1 else (baxes[0] if baxes else None))
    tp = rules.tp_axis
    tp_size = rules.axis_size(tp)

    def kv_spec(s) -> P:
        # (L, B, S, Hkv, hd) or (chunks, B, S, Hkv, hd)
        _, b, sc, hkv, _ = s.shape
        how = tp_lib.kv_split(cfg.plan.decode_kv_shard, tp_size, hkv, sc) \
            if tp else None
        if how == "heads":
            return P(None, b_entry, None, tp, None)
        if how == "seq":
            return P(None, b_entry, tp, None, None)
        return P(None, b_entry, None, None, None)

    out = {}
    for k, s in cache_specs.items():
        if k in ("k", "v", "xk", "xv"):
            out[k] = kv_spec(s)
        elif k == "ssm":      # (L, B, nh, hd, ds)
            nh = s.shape[2]
            out[k] = P(None, b_entry,
                       tp if (tp and nh % tp_size == 0) else None, None, None)
        elif k == "conv":     # (L, B, W-1, C)
            c = s.shape[3]
            out[k] = P(None, b_entry, None,
                       tp if (tp and c % tp_size == 0) else None)
        elif k == "pos_buf":
            out[k] = P(None)
        else:                 # cur and misc scalars
            out[k] = P()
    return out


def param_pspecs(model: Model, rules: MeshRules):
    return tree_map(lambda s: rules.param(s.axes, s.shape), model.specs())


def opt_pspecs(model: Model, rules: MeshRules) -> AdamWState:
    moment = tree_map(lambda s: rules.opt(s.axes, s.shape), model.specs())
    return AdamWState(step=P(), mu=moment, nu=tree_map(lambda x: x, moment))


def batch_pspecs_for_shape(model: Model, rules: MeshRules,
                           shape: ShapeConfig) -> dict:
    return {k: batch_pspec(rules, v.shape[0], len(v.shape))
            for k, v in model.input_specs(shape).items()}


def metrics_spec(model: Model) -> dict:
    if model.cfg.family == "encdec":
        return {"ce": P()}
    return {"ce": P(), "zloss": P(), "aux": P()}


def _world_mean(x, n: int, group=None):
    """Mean of ``x`` over the ranks of ``group``: an all-reduce SUM, then
    division by ``n``."""
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x / n


def _div_local(g, n: int):
    """A sharded gradient's shard divided by ``n`` in place."""
    if n != 1:
        fsdp.local(g).div_(n)
    return g


def loss_and_grads(model: Model, params, batch, partial=None):
    """(loss, metrics, grads) of one batch, all detached; the gradients
    have the parameters' structure and dtypes.  With ``partial``, (mesh,
    the axes of its dims the batch is split over), a sharded leaf's
    gradient is summed over those axes and placed as the leaf
    (``fsdp.grad_partial``)."""
    flat = leaves(params)
    with torch.enable_grad(), fsdp.grad_partial(*(partial or (None, ()))):
        # a sharded leaf enters as its local shard (fsdp.LocalShard): the
        # gradient is taken on plain tensors, then placed as the leaf
        ps = [fsdp.local(p).detach().requires_grad_(True) for p in flat]
        loss, metrics = model.loss(unflatten_like(params, [
            fsdp.as_input(q, p) for q, p in zip(ps, flat)]), batch)
        gs = torch.autograd.grad(loss, ps)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten_like(params, [fsdp.like(g, p)
                                    for g, p in zip(gs, flat)]))


def make_train_step(model: Model, *, lr_kw: Optional[dict] = None,
                    microbatches: int = 1, data_parallel: bool = False,
                    rules: Optional[MeshRules] = None, batch_axes=()):
    """The train step.  With ``data_parallel`` each rank runs it on its
    share of the batch: a sharded leaf's gradient is summed over the mesh
    axes ``batch_axes`` of ``rules`` (those the batch is split over) and
    divided by their width; a plain leaf's gradient, the loss and the
    metrics are averaged over the world."""
    lr_kw = lr_kw or DEFAULT_LR
    partial = (rules.mesh, tuple(batch_axes)) if data_parallel and rules \
        else None
    n_b = rules.axis_size(tuple(batch_axes)) if partial else 1

    def train_step(params, opt_state, batch, step):
        if microbatches > 1:
            def split(x):
                b = x.shape[0]
                return x.reshape((microbatches, b // microbatches)
                                 + tuple(x.shape[1:]))

            mb = {k: split(v) for k, v in batch.items()}
            flat = leaves(params)
            dev = fsdp.local(flat[0]).device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            # the enc-dec family's loss reports ce alone
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                       for k in metrics_spec(model)}
            # one float32 gradient tree for the step: each leaf's .grad,
            # into which autograd adds each microbatch's gradient in place
            # as it forms (a stacked leaf's layer by layer,
            # fsdp.layer_leaves), the sums 0 + g0 + g1 + ... in order
            ps = [fsdp.local(p).detach().to(torch.float32) for p in flat]
            for q in ps:
                q.requires_grad_(True)
                q.grad = torch.zeros_like(q)
            inputs = unflatten_like(params, [fsdp.as_input(q, p)
                                             for q, p in zip(ps, flat)])
            for i in range(microbatches):
                with torch.enable_grad(), fsdp.layer_leaves(), \
                        fsdp.grad_partial(*(partial or (None, ()))):
                    li, mi = model.loss(inputs,
                                        {k: v[i] for k, v in mb.items()})
                    torch.autograd.backward(li)
                loss = loss + li.detach()
                metrics = {k: v + mi[k].detach() for k, v in metrics.items()}
            inv = 1.0 / microbatches
            loss = loss * inv
            grads = unflatten_like(params, [fsdp.like(q.grad.mul_(inv), p)
                                            for q, p in zip(ps, flat)])
            del ps, inputs
            metrics = {k: v * inv for k, v in metrics.items()}
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch,
                                                  partial)
        if data_parallel:
            n = dist.get_world_size()
            grads = tree_map(lambda g: _div_local(g, n_b)
                             if fsdp.is_sharded(g) else _world_mean(g, n),
                             grads)
            loss = _world_mean(loss, n)
            metrics = {k: _world_mean(v, n) for k, v in metrics.items()}
        lr = warmup_cosine(step, **lr_kw)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, lr=lr)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


# ---------------------------------------------------------------------------
# Compressed-gradient train step (int8 error feedback on the DP axis)
# ---------------------------------------------------------------------------


def init_residual(model: Model, rules: MeshRules):
    """This rank's slice of the per-device error-feedback residual: zeros
    of shape (1, *param.shape), float32, on the model's device (the
    reference's (n_dev, ...) tree over ``rules``' data axes, one row a
    rank)."""
    return tree_map(lambda s: torch.zeros((1,) + tuple(s.shape),
                                          dtype=torch.float32,
                                          device=model.device),
                    model.specs())


def _compressed_grads(model: Model, params, batch, residual, n_dev: int,
                     group=None):
    """(loss, metrics, grads) of one data-parallel step with int8
    error-feedback compression: local gradients, each added to this
    rank's residual and quantised (``ef_compress``; the residual, updated
    in place, keeps the quantisation error), the int32 all-reduce on the
    shared scale (``requantize_sum``), divided by ``n_dev``; the loss and
    metrics averaged over the ranks.  Leaf by leaf, each local gradient
    dropped once folded in."""
    loss, metrics, grads = loss_and_grads(model, params, batch)
    flat = leaves(grads)
    del grads
    out = []
    for i, r in enumerate(leaves(residual)):
        comp = r[0].add_(flat[i])   # g + r, in the residual's storage
        flat[i] = None
        q, s = quantize_int8(comp)
        comp.sub_(dequantize_int8(q, s))
        out.append(requantize_sum(q, s, group).div_(n_dev))
    loss = _world_mean(loss, n_dev, group)
    metrics = {k: _world_mean(v, n_dev, group) for k, v in metrics.items()}
    return loss, metrics, unflatten_like(params, out)


def make_compressed_train_step(model: Model, rules: MeshRules, *,
                               lr_kw: Optional[dict] = None, group=None):
    """The dp_only step with an explicit int8 all-reduce over ``group``
    (default: the world), whose size must be the data-parallel width of
    ``rules``: ``train_step(params, opt_state, residual, batch, step) ->
    (params, opt_state, residual, metrics)`` on this rank's batch share.
    Per step: two collectives a parameter leaf (the scale's MAX, the
    counts' SUM) and one per averaged scalar (loss, ce, zloss, aux)."""
    if rules.plan.mode != "dp_only":
        raise ValueError("compression targets the DP plan (mode dp_only), "
                         f"got {rules.plan.mode!r}")
    lr_kw = lr_kw or DEFAULT_LR
    n_dev = rules.axis_size(rules.data_axes)
    if dist.get_world_size(group) != n_dev:
        raise ValueError(f"the data axes {rules.data_axes} span {n_dev} "
                         f"devices, the group has "
                         f"{dist.get_world_size(group)} ranks")

    def train_step(params, opt_state, residual, batch, step):
        loss, metrics, grads = _compressed_grads(model, params, batch,
                                                residual, n_dev, group)
        lr = warmup_cosine(step, **lr_kw)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, lr=lr)
        return params, opt_state, residual, {"loss": loss, **metrics,
                                             **opt_metrics}

    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        # serving wants only the next-token distribution: last_only
        # slices before the unembed, so (B, S, V) never materialises
        return model.forward(params, batch, last_only=True)[:, -1, :]

    return prefill_step


def make_decode_step(model: Model):
    @torch.no_grad()
    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step


@dataclass
class StepBundle:
    """One (arch x shape) cell: the model and its step, on one device or
    on a mesh (``rules`` its sharding rules), its fields in the
    reference's order.  On a mesh ``param_placements`` and
    ``opt_placements`` (an ``AdamWState`` of trees) hold each leaf's
    DTensor placements, from ``param_pspecs`` and ``opt_pspecs``: the
    counterparts of the reference's ``in_shardings[0:2]``; ``batch_axes``
    are the mesh axes the global batch is split over; a decode cell's
    ``cache_placements`` place each cache leaf by ``cache_pspecs``."""

    cfg: ArchConfig
    shape: ShapeConfig
    mesh: object
    rules: Optional[MeshRules]
    model: Model
    kind: str                 # "train" | "prefill" | "decode"
    step_fn: Callable
    device: torch.device
    param_placements: object = None
    opt_placements: object = None
    batch_axes: tuple = ()
    cache_placements: Optional[dict] = None

    def _zeros(self, spec, places, device, dtype=None):
        return tree_map(lambda s, pl: fsdp.placed_zeros(
            s.shape, dtype or s.dtype, self.mesh, pl, device),
            spec, places)

    def init_state(self, seed: int = 0):
        """Parameters drawn from ``seed`` as ``Model.init`` draws them and
        zero AdamW moments.  On a mesh each leaf is placed as soon as it
        is drawn, so a rank holds one whole leaf at most, and only while
        it is cut to this rank's shard; the values are the replicated
        init's."""
        if self.mesh is None:
            params = self.model.init(seed)
            return params, adamw_init(params)
        params = self.model.init(seed, mesh=self.mesh,
                                 placements=self.param_placements)
        return params, self._moments(self.device)

    def _moments(self, device) -> AdamWState:
        specs = self.model.specs()
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=self._zeros(specs, self.opt_placements.mu, device,
                           torch.float32),
            nu=self._zeros(specs, self.opt_placements.nu, device,
                           torch.float32))

    def state_bytes(self) -> int:
        """This rank's bytes of parameters and moments by the placements
        alone: each leaf's shard shape (``fsdp.local_shape``) times its
        itemsize."""
        sizes = []
        for places, itemsize in ((self.param_placements, None),
                                 (self.opt_placements.mu, 4),
                                 (self.opt_placements.nu, 4)):
            tree_map(lambda sp, pl, n=itemsize: sizes.append(
                (n or sp.dtype.itemsize) * math.prod(
                    fsdp.local_shape(sp.shape, self.mesh, pl))),
                self.model.specs(), places)
        return sum(sizes)

    def abstract_state(self):
        """The placed state on ``meta``: the shapes, dtypes and placements
        of :meth:`init_state`, nothing allocated."""
        params = self._zeros(self.model.specs(), self.param_placements,
                             "meta")
        return params, self._moments("meta")

    # -- the decode cache ---------------------------------------------------
    def _cache_leaves(self):
        """(name, TensorSpec, this rank's shape) of each cache leaf: its
        ``cache_pspecs`` shard on a mesh (``fsdp.local_shape``), else the
        whole leaf."""
        specs = self.model.cache_specs(self.shape.global_batch,
                                       self.shape.seq_len)
        return [(k, s, tuple(s.shape) if self.cache_placements is None
                 else fsdp.local_shape(s.shape, self.mesh,
                                       self.cache_placements[k]))
                for k, s in specs.items()]

    def init_cache(self, device=None) -> dict:
        """This rank's decode cache: each leaf its ``cache_pspecs`` shard
        as a plain tensor (rows over the batch axes; K/V heads or
        positions, SSM heads and conv channels over ``model``), zeros,
        ``pos_buf`` all -1 (whole on every rank) and the position ``cur``
        0, a host int.  Off a mesh, and where the plan has no tensor
        axis, the model's cache of the cell's rows."""
        return cache_of({k: TensorSpec(shape, s.dtype)
                         for k, s, shape in self._cache_leaves()},
                        self.device if device is None else device)

    def abstract_cache(self) -> dict:
        """:meth:`init_cache` on ``meta``: nothing allocated."""
        return self.init_cache("meta")

    def cache_bytes(self) -> int:
        """This rank's bytes of the decode cache by its placements."""
        return sum(s.dtype.itemsize * math.prod(shape)
                   for _, s, shape in self._cache_leaves())

    def state_shardings(self):
        """``(DeviceMesh, spec)`` of each sharded leaf of the state (None
        for a replicated leaf), for ``restore_checkpoint(shardings=)``;
        None off a mesh."""
        if self.mesh is None:
            return None

        def pair(spec, places):
            return None if fsdp.replicated(places) else (self.mesh, spec)
        p_spec = param_pspecs(self.model, self.rules)
        o_spec = opt_pspecs(self.model, self.rules)
        return (tree_map(pair, p_spec, self.param_placements),
                AdamWState(step=None,
                           mu=tree_map(pair, o_spec.mu,
                                       self.opt_placements.mu),
                           nu=tree_map(pair, o_spec.nu,
                                       self.opt_placements.nu)))


def build_step_bundle(cfg: ArchConfig, shape: ShapeConfig, mesh=None, *,
                      device="cuda", unroll: bool = False,
                      compressed: bool = False,
                      lr_kw: Optional[dict] = None,
                      model_kw: Optional[dict] = None) -> StepBundle:
    """The step of ``shape``'s kind.  On a ``mesh`` (a ``DeviceMesh``
    over the world) the bundle carries the placements of the state, and a
    train shape's step reduces its gradients over the ranks, or with
    ``compressed`` is :func:`make_compressed_train_step` (its step takes
    and returns the residual, :func:`init_residual`; its moments ZeRO-1,
    as the reference's compressed bundle places them).  ``unroll`` (the
    reference's layer-scan unroll) goes to the model, where it has no
    effect."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev, unroll=unroll, **(model_kw or {}))
    rules = None if mesh is None else MeshRules(cfg.plan, mesh)
    places = {}
    if rules is not None:
        o_spec = opt_pspecs(model, rules)
        places = dict(
            param_placements=tree_map(rules.placements,
                                      param_pspecs(model, rules)),
            opt_placements=AdamWState(
                step=(), mu=tree_map(rules.placements, o_spec.mu),
                nu=tree_map(rules.placements, o_spec.nu)),
            batch_axes=batch_axes_for(rules, shape.global_batch))
    if compressed and shape.kind == "train":
        if rules is None:
            raise ValueError("the compressed step needs a mesh")
        step_fn = make_compressed_train_step(model, rules, lr_kw=lr_kw)
    elif shape.kind == "train":
        step_fn = make_train_step(model, lr_kw=lr_kw,
                                  microbatches=cfg.plan.microbatches,
                                  data_parallel=mesh is not None,
                                  rules=rules,
                                  batch_axes=places.get("batch_axes", ()))
    elif shape.kind == "prefill":
        step_fn = make_prefill_step(model)
    else:
        step_fn = make_decode_step(model)
        if rules is not None:
            b = shape.global_batch
            places["cache_placements"] = tree_map(
                rules.placements, cache_pspecs(
                    cfg, rules, model.cache_specs(b, shape.seq_len), b))
    return StepBundle(cfg=cfg, shape=shape, mesh=mesh, rules=rules,
                      model=model, kind=shape.kind, step_fn=step_fn,
                      device=dev, **places)
