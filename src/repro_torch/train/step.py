"""Train and serve steps: the port of ``repro.train.step``.

``make_train_step`` returns ``train_step(params, opt_state, batch, step)
-> (params, opt_state, metrics)``: the loss and its gradient by
``torch.autograd`` (on a card the attention gradient runs the
flash_attention backward kernels), gradient accumulation over
``microbatches`` as the reference's ``lax.scan`` does it (sum the
microbatches' losses, gradients and metrics, then scale by 1/m), the
warm-up-cosine learning rate, and AdamW, which updates the parameters and
moments in place.  With ``data_parallel`` each rank runs it on its share
of the batch and the gradients, loss and metrics are averaged over the
world with ``all_reduce``: the value the reference's pjit computes on the
global batch.  ``make_prefill_step`` and ``make_decode_step`` are the
serving steps.

The partition specs (``param_pspecs``, ``opt_pspecs``, ``batch_pspec``,
``cache_pspecs``, ...) are the reference's, from a
:class:`~repro_torch.sharding.rules.MeshRules`.  The port's parameters
and moments stay replicated on every rank; the specs place a restored
checkpoint and a rank's batch share.

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

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch._tree import leaves, tree_map, unflatten_like
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.api import Model, build_model
from repro_torch.optim import (AdamWState, adamw_update, dequantize_int8,
                               quantize_int8, warmup_cosine)
from repro_torch.optim.compress import requantize_sum
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
        mode = cfg.plan.decode_kv_shard
        if tp and mode in ("heads", "auto") and hkv % tp_size == 0:
            return P(None, b_entry, None, tp, None)
        if tp and mode in ("seq", "auto") and sc % tp_size == 0:
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


def loss_and_grads(model: Model, params, batch):
    """(loss, metrics, grads) of one batch, all detached; the gradients
    have the parameters' structure and dtypes."""
    flat = leaves(params)
    with torch.enable_grad():
        ps = [p.detach().requires_grad_(True) for p in flat]
        loss, metrics = model.loss(unflatten_like(params, ps), batch)
        gs = torch.autograd.grad(loss, ps)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten_like(params, gs))


def make_train_step(model: Model, *, lr_kw: Optional[dict] = None,
                    microbatches: int = 1, data_parallel: bool = False):
    lr_kw = lr_kw or DEFAULT_LR

    def train_step(params, opt_state, batch, step):
        if microbatches > 1:
            def split(x):
                b = x.shape[0]
                return x.reshape((microbatches, b // microbatches)
                                 + tuple(x.shape[1:]))

            mb = {k: split(v) for k, v in batch.items()}
            dev = leaves(params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            # the enc-dec family's loss reports ce alone
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                       for k in metrics_spec(model)}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                li, mi, gi = loss_and_grads(
                    model, params, {k: v[i] for k, v in mb.items()})
                loss = loss + li
                metrics = {k: v + mi[k] for k, v in metrics.items()}
                tree_map(lambda g, x: g.add_(x), grads, gi)
                # the next microbatch's gradients form without this set
                del gi
            inv = 1.0 / microbatches
            loss = loss * inv
            grads = tree_map(lambda g: g.mul_(inv), grads)
            metrics = {k: v * inv for k, v in metrics.items()}
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        if data_parallel:
            n = dist.get_world_size()
            grads = tree_map(lambda g: _world_mean(g, n), grads)
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
    on a mesh (``rules`` its sharding rules)."""

    cfg: ArchConfig
    shape: ShapeConfig
    model: Model
    kind: str                 # "train" | "prefill" | "decode"
    step_fn: Callable
    device: torch.device
    mesh: object = None
    rules: Optional[MeshRules] = None


def build_step_bundle(cfg: ArchConfig, shape: ShapeConfig, *,
                      device="cuda", mesh=None, compressed: bool = False,
                      lr_kw: Optional[dict] = None,
                      model_kw: Optional[dict] = None) -> StepBundle:
    """The step of ``shape``'s kind.  On a ``mesh`` (a ``DeviceMesh``
    over the world) a train shape's step averages its gradients over the
    ranks, or with ``compressed`` is :func:`make_compressed_train_step`
    (its step takes and returns the residual, :func:`init_residual`)."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev, **(model_kw or {}))
    rules = None if mesh is None else MeshRules(cfg.plan, mesh)
    if compressed and shape.kind == "train":
        if rules is None:
            raise ValueError("the compressed step needs a mesh")
        step_fn = make_compressed_train_step(model, rules, lr_kw=lr_kw)
    elif shape.kind == "train":
        step_fn = make_train_step(model, lr_kw=lr_kw,
                                  microbatches=cfg.plan.microbatches,
                                  data_parallel=mesh is not None)
    elif shape.kind == "prefill":
        step_fn = make_prefill_step(model)
    else:
        step_fn = make_decode_step(model)
    return StepBundle(cfg=cfg, shape=shape, model=model, kind=shape.kind,
                      step_fn=step_fn, device=dev, mesh=mesh, rules=rules)
