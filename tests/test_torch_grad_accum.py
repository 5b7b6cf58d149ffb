"""The microbatched train step's gradient accumulation: one float32
gradient tree for the whole step.

``make_train_step`` adds each microbatch's gradients into one tree of
accumulators as autograd forms them (each leaf's ``.grad``; a stacked
leaf's layer by layer through ``fsdp.layer_leaves``).  These tests hold
it to the loop it replaced -- a whole gradient tree a microbatch from
``loss_and_grads``, added into a zero float32 tree and dropped, kept
below as ``_tree_per_microbatch_step`` -- bit for bit (``0 + g0 + g1 +
...`` are the same floats in the same order), and pin its memory: a
step's peak of allocated bytes, read from ``torch.profiler``'s memory
events, stays within one gradient tree plus the largest leaf (the
gradient norm squares one leaf at a time) and a little, where the old
loop holds two trees at once.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_common import CPU
import repro_torch.optim.adamw as adamw_lib
from repro_torch._tree import leaves, unflatten_like
from repro_torch.configs import get_arch
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import build_model
from repro_torch.optim import adamw_init, adamw_update, warmup_cosine
from repro_torch.train.step import (DEFAULT_LR, loss_and_grads,
                                    make_train_step, metrics_spec)

CASES = [("qwen2-1.5b", 2), ("mamba2-1.3b", 4)]
# wide and shallow, a few tokens a microbatch: the parameters, not the
# activations, set the step's memory
WIDE = {"qwen2-1.5b": dict(num_layers=4, d_model=256, n_heads=4,
                           n_kv_heads=2, d_ff=512),
        "mamba2-1.3b": dict(num_layers=4, d_model=256)}
# the peak's allowance over one tree and the largest leaf: the
# activations of a (2, 8) microbatch and AdamW's slices, in trees
SLACK = 0.1


def _tree_per_microbatch_step(model, microbatches):
    """The microbatched step as it was before one tree: each
    microbatch's whole gradient tree from ``loss_and_grads``, added into
    a zero float32 tree, then dropped (one device, no mesh)."""
    def train_step(params, opt_state, batch, step):
        mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                           + tuple(v.shape[1:])) for k, v in batch.items()}
        flat = leaves(params)
        dev = flat[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                   for k in metrics_spec(model)}
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for p in flat]
        for i in range(microbatches):
            li, mi, gi = loss_and_grads(model, params,
                                        {k: v[i] for k, v in mb.items()})
            loss = loss + li
            metrics = {k: v + mi[k] for k, v in metrics.items()}
            for a, g in zip(acc, leaves(gi)):
                a.add_(g)
            del gi
        inv = 1.0 / microbatches
        loss = loss * inv
        grads = unflatten_like(params, [a.mul_(inv) for a in acc])
        del acc
        metrics = {k: v * inv for k, v in metrics.items()}
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, lr=warmup_cosine(step, **DEFAULT_LR))
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def _model(arch, **over):
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    return build_model(cfg, compute_dtype=torch.float32, device=CPU)


def _batch(model, microbatches, seq):
    return TokenPipeline(2 * microbatches, seq, model.cfg.vocab_size,
                         seed=1, device=CPU).batch_at(0)


@pytest.mark.parametrize("arch,microbatches", CASES)
def test_one_tree_step_equals_the_tree_per_microbatch_step(arch,
                                                           microbatches):
    """Parameters, moments and every metric equal the old loop's bit for
    bit, from the same parameters and zero moments at step 150 (past
    warm-up)."""
    model = _model(arch)
    batch = _batch(model, microbatches, 16)
    out = []
    for make in (_tree_per_microbatch_step, lambda m, n: make_train_step(
            m, microbatches=n)):
        params = model.init(0)
        out.append(make(model, microbatches)(params, adamw_init(params),
                                            batch, 150))
    (p0, o0, m0), (p1, o1, m1) = out
    for name, a, b in (("params", p0, p1), ("mu", o0.mu, o1.mu),
                       ("nu", o0.nu, o1.nu)):
        for x, y in zip(leaves(a), leaves(b), strict=True):
            assert torch.equal(x, y), name
    assert int(o0.step) == int(o1.step) == 1
    assert set(m0) == set(m1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k


def _peak_bytes(fn) -> int:
    """The most bytes ``fn`` held allocated at once beyond what it found,
    at the profiler's op granularity: each op's own allocations less its
    frees, summed in time order."""
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    now = peak = 0
    for _, nbytes in sorted((e.time_range.start, e.self_cpu_memory_usage)
                            for e in prof.events()):
        now += nbytes
        peak = max(peak, now)
    return peak


@pytest.mark.parametrize("arch,microbatches", CASES)
def test_microbatched_step_holds_one_gradient_tree(arch, microbatches,
                                                   monkeypatch):
    """A step's peak stays below one float32 gradient tree plus the
    largest leaf plus SLACK trees: never two trees at once (the old loop
    peaks above two, its running sum beside the next microbatch's whole
    tree)."""
    monkeypatch.setattr(adamw_lib, "UPDATE_SLICE", 1 << 14)
    model = _model(arch, **WIDE[arch])
    batch = _batch(model, microbatches, 8)
    params = model.init(0)
    opt = adamw_init(params)
    sizes = [4 * p.numel() for p in leaves(params)]
    tree = sum(sizes)
    step = make_train_step(model, microbatches=microbatches)
    peak = _peak_bytes(lambda: step(params, opt, batch, 150))
    assert peak <= tree + max(sizes) + SLACK * tree, (
        f"peak {peak / tree:.3f} trees, largest leaf "
        f"{max(sizes) / tree:.3f}")
    # the measurement sees the old loop's two trees
    params = model.init(0)
    opt = adamw_init(params)
    old = _tree_per_microbatch_step(model, microbatches)
    assert _peak_bytes(lambda: old(params, opt, batch, 150)) > 2 * tree
