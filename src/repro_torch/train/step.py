"""Train and serve steps: the port of ``repro.train.step`` on one device.

``make_train_step`` returns ``train_step(params, opt_state, batch, step)
-> (params, opt_state, metrics)``: the loss and its gradient by
``torch.autograd`` (on a card the attention gradient runs the
flash_attention backward kernels), gradient accumulation over
``microbatches`` as the reference's ``lax.scan`` does it (sum the
microbatches' losses, gradients and metrics, then scale by 1/m), the
warm-up-cosine learning rate, and AdamW, which updates the parameters and
moments in place.  ``make_prefill_step`` and ``make_decode_step`` are the
serving steps.

A :class:`StepBundle` is one (arch x shape) cell on one device.  The
sharding half of the reference's bundle -- ``MeshRules``, the batch,
cache, parameter and optimiser partition specs, and the int8-compressed
data-parallel step -- needs a mesh and waits for ROADMAP A11.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch._tree import leaves, tree_map, unflatten_like
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.api import Model, build_model
from repro_torch.optim import adamw_update, warmup_cosine

DEFAULT_LR = dict(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)
METRICS = ("ce", "zloss", "aux")


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
                    microbatches: int = 1):
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
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                       for k in METRICS}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                li, mi, gi = loss_and_grads(
                    model, params, {k: v[i] for k, v in mb.items()})
                loss = loss + li
                metrics = {k: metrics[k] + mi[k] for k in METRICS}
                tree_map(lambda g, x: g.add_(x), grads, gi)
                # the next microbatch's gradients form without this set
                del gi
            inv = 1.0 / microbatches
            loss = loss * inv
            grads = tree_map(lambda g: g.mul_(inv), grads)
            metrics = {k: v * inv for k, v in metrics.items()}
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        lr = warmup_cosine(step, **lr_kw)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, lr=lr)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

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
    """One (arch x shape) cell on one device: the model and its step."""

    cfg: ArchConfig
    shape: ShapeConfig
    model: Model
    kind: str                 # "train" | "prefill" | "decode"
    step_fn: Callable
    device: torch.device


def build_step_bundle(cfg: ArchConfig, shape: ShapeConfig, *,
                      device="cuda", lr_kw: Optional[dict] = None,
                      model_kw: Optional[dict] = None) -> StepBundle:
    dev = resolve_device(device)
    model = build_model(cfg, device=dev, **(model_kw or {}))
    if shape.kind == "train":
        step_fn = make_train_step(model, lr_kw=lr_kw,
                                  microbatches=cfg.plan.microbatches)
    elif shape.kind == "prefill":
        step_fn = make_prefill_step(model)
    else:
        step_fn = make_decode_step(model)
    return StepBundle(cfg=cfg, shape=shape, model=model, kind=shape.kind,
                      step_fn=step_fn, device=dev)
