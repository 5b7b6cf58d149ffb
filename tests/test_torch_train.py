"""The port's training path against ``repro``: ``Model.loss`` and its
gradients, one ``make_train_step`` step (with and without microbatches)
from the same parameters, batch and a non-trivial AdamW state (and
whisper-medium's, whose metrics are {"ce"} alone), the remat policies,
the smoke loss-and-grad of every arch (for the MoE, VLM and enc-dec
families against ``jax.grad``), and the step's FLOP count against
``torch.utils.flop_counter`` on the plain path.

The parameters are the reference's tree filled from a numpy seed
(``test_torch_models._params_np``), carried over by
``convert.model_params``; the AdamW moments are numpy draws carried over
by ``convert.adamw_state``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from test_torch_common import CPU
from test_torch_models import _batch_np, _both, _params_np, _tokens
from repro.configs import get_arch as r_arch
from repro.models import build_model as r_build
from repro.optim import AdamWState as RAdamWState
from repro.train.step import make_train_step as r_make_train_step
import repro_torch.configs as p_configs
import repro_torch.core.plant as p_plant
from repro_torch import convert
from repro_torch._tree import leaves_with_paths
from repro_torch.models import build_model as p_build
from repro_torch.train.step import loss_and_grads, make_train_step

DENSE = ["smollm-135m", "qwen2-1.5b"]
# the SSM and hybrid families: every Mamba-2 layer's scan differentiated
# (on the CPU, autograd through the scan's plain version)
SSM = ["mamba2-1.3b", "zamba2-2.7b"]
LOSS_F32 = dict(rtol=1e-5, atol=0.0)
GRAD_F32 = dict(rtol=1e-4, atol=1e-6)
STEP_F32 = dict(rtol=1e-4, atol=1e-7)
BF16_LOSS = dict(rtol=2e-2, atol=2e-2)


def _flat(tree):
    """{path: numpy} of a reference pytree or a port tree (same paths)."""
    if isinstance(tree, dict) and tree and not isinstance(
            next(iter(tree.values())), (dict, torch.Tensor)):
        tree = jax.tree.map(np.asarray, tree)
    out = {}
    for path, leaf in leaves_with_paths(tree):
        out["/".join(path)] = (leaf.detach().float().numpy()
                               if isinstance(leaf, torch.Tensor)
                               else np.asarray(leaf, np.float32))
    return out


def _models(arch, dtype="float32", **over):
    rc, pc, rp, pp = _both(arch, **over)
    rm = r_build(rc, compute_dtype=getattr(jnp, dtype))
    pm = p_build(pc, compute_dtype=getattr(torch, dtype), device=CPU)
    return rc, pc, rp, pp, rm, pm


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}


@pytest.mark.parametrize("arch", DENSE + SSM)
def test_loss_matches_reference(arch):
    rc, pc, rp, pp, rm, pm = _models(arch)
    rb, pb = _batch(rc)
    want_loss, want = rm.loss(rp, rb)
    got_loss, got = pm.loss(pp, pb)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **LOSS_F32)
    for k in ("ce", "zloss", "aux"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   **LOSS_F32, err_msg=k)


@pytest.mark.parametrize("arch", DENSE + SSM)
def test_gradients_match_jax_grad(arch):
    rc, pc, rp, pp, rm, pm = _models(arch)
    rb, pb = _batch(rc, seed=1)
    (_, _), want = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(
        rp, rb)
    _, _, got = loss_and_grads(pm, pp, pb)
    want, got = _flat(want), _flat(got)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD_F32, err_msg=k)


@pytest.mark.parametrize("arch", DENSE + SSM)
def test_bf16_loss_matches_reference(arch):
    rc, pc, rp, pp, rm, pm = _models(arch, "bfloat16")
    rb, pb = _batch(rc, seed=2)
    np.testing.assert_allclose(float(pm.loss(pp, pb)[0]),
                               float(rm.loss(rp, rb)[0]), **BF16_LOSS)


def _adamw_np(ref_cfg, seed=3, step=150):
    """A non-trivial AdamW state past warm-up: numpy moments (nu > 0) of
    the parameters' shapes, step 150."""
    rng = np.random.default_rng(seed)
    specs = r_build(ref_cfg).specs()
    is_spec = dict(is_leaf=lambda x: hasattr(x, "init"))
    mu = jax.tree.map(lambda s: (1e-3 * rng.standard_normal(s.shape))
                      .astype(np.float32), specs, **is_spec)
    nu = jax.tree.map(lambda s: (1e-6 * (0.1 + rng.random(s.shape)))
                      .astype(np.float32), specs, **is_spec)
    return {"step": np.int32(step), "mu": mu, "nu": nu}


def _step_both(arch, microbatches, batch=2):
    rc, pc, rp, pp, rm, pm = _models(arch)
    rb, pb = _batch(rc, b=batch, seed=4)
    if rc.frontend != "none":      # the VLM's image embeddings
        e = _batch_np(rc, b=batch, seed=4)["embeds"]
        rb["embeds"], pb["embeds"] = jnp.asarray(e), torch.from_numpy(e)
    st = _adamw_np(rc)
    r_opt = RAdamWState(step=jnp.int32(st["step"]),
                        mu=jax.tree.map(jnp.asarray, st["mu"]),
                        nu=jax.tree.map(jnp.asarray, st["nu"]))
    p_opt = convert.adamw_state(st, device=CPU)
    step = int(st["step"])
    r_params, r_opt, r_m = jax.jit(r_make_train_step(
        rm, microbatches=microbatches))(rp, r_opt, rb, jnp.int32(step))
    p_params, p_opt, p_m = make_train_step(
        pm, microbatches=microbatches)(pp, p_opt, pb, step)
    return (r_params, r_opt, r_m), (p_params, p_opt, p_m)


@pytest.mark.parametrize("arch,microbatches", [("smollm-135m", 1),
                                               ("qwen2-1.5b", 1),
                                               ("qwen2-1.5b", 2),
                                               ("mamba2-1.3b", 2),
                                               ("olmoe-1b-7b", 4),
                                               ("phi-3-vision-4.2b", 2)])
def test_train_step_matches_reference(arch, microbatches):
    """One step from the same parameters, batch (the VLM's with its
    embeds) and AdamW state past warm-up; with microbatches the MoE's aux
    loss accumulates over them as the reference's does."""
    (rp, ro, rm), (pp, po, pm) = _step_both(arch, microbatches, batch=4)
    for name, want, got in (("params", rp, pp), ("mu", ro.mu, po.mu),
                            ("nu", ro.nu, po.nu)):
        want, got = _flat(want), _flat(got)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **STEP_F32,
                                       err_msg=f"{name}/{k}")
    assert int(po.step) == int(ro.step) == 151
    for k in ("loss", "ce", "zloss", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-5,
                                   err_msg=k)
    if arch == "olmoe-1b-7b":
        assert float(pm["aux"]) > 0


def _loss_grads(pc, pp, pb):
    pm = p_build(pc, compute_dtype=torch.float32, device=CPU)
    return loss_and_grads(pm, pp, pb)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-2.7b",
                                  "olmoe-1b-7b"])
def test_remat_policies_change_no_number(arch):
    rc, pc, rp, pp = _both(arch)
    _, pb = _batch(rc, seed=5)
    base = _loss_grads(pc, pp, pb)
    for policy in ("dots", "full"):
        cfg = dataclasses.replace(pc, plan=dataclasses.replace(
            pc.plan, remat=policy))
        loss, metrics, grads = _loss_grads(cfg, pp, pb)
        assert float(loss) == float(base[0]), policy
        want, got = _flat(base[2]), _flat(grads)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{policy}/{k}")


def _fwd_bwd_flops(pc, pp, pb):
    with FlopCounterMode(display=False) as fc:
        _loss_grads(pc, pp, pb)
    return fc.get_total_flops()


def test_dots_policy_recomputes_attention_not_products():
    """"dots" saves the weight products (aten.mm) and recomputes the rest:
    its backward redoes exactly the plain attention's two forward batched
    products per layer, "full" redoes every product."""
    rc, pc, rp, pp = _both("qwen2-1.5b")
    _, pb = _batch(rc, seed=6)
    flops = {}
    for policy in ("none", "dots", "full"):
        cfg = dataclasses.replace(pc, plan=dataclasses.replace(
            pc.plan, remat=policy))
        flops[policy] = _fwd_bwd_flops(cfg, pp, pb)
    b, s = pb["tokens"].shape
    attn_fwd = 4 * b * pc.n_heads * pc.resolved_head_dim * s * s \
        * pc.num_layers
    assert flops["dots"] - flops["none"] == attn_fwd
    assert flops["full"] > flops["dots"]


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-1.5b"])
def test_step_flops_match_flop_counter(arch):
    """train_step_cost's count equals what the FLOP counter sees of a
    forward and backward once the masked pairs the plain attention also
    computes (all 16^2, not the 16 x 17 / 2 causal ones) are added."""
    rc, pc, rp, pp = _both(arch)
    _, pb = _batch(rc, b=2, s=16, seed=7)
    flops, nbytes = p_plant.train_step_cost(pc, 2, 16)
    per_pair = 3 * 4 * 2 * pc.n_heads * pc.resolved_head_dim \
        * pc.num_layers
    masked = 16 * 16 - p_plant.attention_pairs(16)
    assert _fwd_bwd_flops(pc, pp, pb) == flops + per_pair * masked
    assert nbytes == 28 * pc.param_count()


def test_load_from_cost_analysis_uses_the_h100():
    assert not hasattr(p_plant, "TPU_PEAK_FLOPS")
    assert p_plant.load_from_cost_analysis(989e12 * 0.25, 0.0, 1.0) == \
        pytest.approx(0.25)
    assert p_plant.load_from_cost_analysis(0.0, 3.35e12 * 0.5, 1.0) == \
        pytest.approx(0.5)
    assert p_plant.load_from_cost_analysis(1e18, 0.0, 1.0) == 1.0
    assert p_plant.load_from_cost_analysis(1.0, 1.0, 0.0) == 1.0
    # rows 0-3 see 1-4 columns, rows 4-9 see 4
    assert p_plant.attention_pairs(10, window=4) == 1 + 2 + 3 + 4 + 6 * 4


# the MoE, VLM and enc-dec families: their smoke case also holds the
# loss and every gradient against the reference's jax.grad
NEW_FAMILIES = ("moe", "vlm", "encdec")


@pytest.mark.parametrize("arch", p_configs.list_archs())
def test_smoke_loss_and_grad(arch):
    """tests/test_models.py's smoke test on every arch: a finite loss and
    finite, nonzero gradients of a (2, 16) batch (with the VLM's embeds
    or the enc-dec family's frames); for the MoE, VLM and enc-dec
    families, the loss and gradients against ``jax.grad`` of the same
    parameters."""
    import repro_torch.configs.archs  # noqa: F401  (registry)
    cfg = p_configs.get_arch(arch).reduced()
    if cfg.family in NEW_FAMILIES:
        rc, cfg, rp, params, rm, model = _models(arch)
    else:
        model = p_build(cfg, compute_dtype=torch.float32, device=CPU)
        params = model.init(0)
    batch = _batch_np(cfg, seed=10)
    batch["tokens"] = (np.arange(2 * 16).reshape(2, 16)
                       % cfg.vocab_size).astype(np.int32)
    loss, metrics, grads = loss_and_grads(
        model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert torch.isfinite(loss) and float(loss) > 0
    g = [x for _, x in leaves_with_paths(grads)]
    assert all(torch.isfinite(x).all() for x in g)
    assert any(float(x.abs().max()) > 0 for x in g)
    assert set(metrics) == ({"ce"} if cfg.family == "encdec"
                            else {"ce", "zloss", "aux"})
    if cfg.family not in NEW_FAMILIES:
        return
    (want_loss, want_m), want = jax.jit(jax.value_and_grad(
        rm.loss, has_aux=True))(rp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), **LOSS_F32)
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]),
                                   **LOSS_F32, err_msg=k)
    if cfg.family == "moe":
        assert float(metrics["aux"]) > 0
    want, got = _flat(want), _flat(grads)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD_F32, err_msg=k)


def test_encdec_train_step_matches_reference():
    """One make_train_step step of whisper-medium (reduced) over two
    microbatches from the same parameters, batch and AdamW state: the
    step accumulates {"ce"} alone, as the reference's does."""
    rc, pc, rp, pp, rm, pm = _models("whisper-medium")
    batch = _batch_np(rc, b=4, seed=11)
    st = _adamw_np(rc)
    r_opt = RAdamWState(step=jnp.int32(st["step"]),
                        mu=jax.tree.map(jnp.asarray, st["mu"]),
                        nu=jax.tree.map(jnp.asarray, st["nu"]))
    step = int(st["step"])
    r_params, r_opt, r_m = jax.jit(r_make_train_step(rm, microbatches=2))(
        rp, r_opt, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.int32(step))
    p_params, p_opt, p_m = make_train_step(pm, microbatches=2)(
        pp, convert.adamw_state(st, device=CPU),
        {k: torch.from_numpy(v) for k, v in batch.items()}, step)
    assert set(p_m) == set(r_m)
    assert "zloss" not in p_m and "aux" not in p_m
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(p_m[k]), float(r_m[k]), rtol=1e-5,
                                   err_msg=k)
    for name, want, got in (("params", r_params, p_params),
                            ("mu", r_opt.mu, p_opt.mu)):
        want, got = _flat(want), _flat(got)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **STEP_F32,
                                       err_msg=f"{name}/{k}")


@pytest.mark.parametrize("policy,per_layer", [("none", 1), ("dots", 2),
                                              ("full", 2)])
def test_attention_runs_again_under_remat(policy, per_layer, monkeypatch):
    """The launch count the card's train phase expects: one attention
    forward per layer and step without remat, two with "dots" or "full"
    (the backward recomputes it), and one backward either way."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, *, causal, window):
        calls["fwd"] += 1
        return fa.flash_attention_lse_ref(q, k, v, causal=causal,
                                          window=window)

    def bwd(q, k, v, o, do, lse, *, causal, window):
        calls["bwd"] += 1
        return fa.flash_attention_bwd_ref(q, k, v, o, do.contiguous(), lse,
                                          causal=causal, window=window)

    monkeypatch.setattr(fa, "_fwd", fwd)
    monkeypatch.setattr(fa, "_bwd", bwd)
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, *, causal=True, window=0:
                        fa.FlashAttentionFn.apply(q, k, v, causal, window,
                                                  ops._needs_grad(q, k, v)))
    rc, pc, rp, pp = _both("qwen2-1.5b")
    cfg = dataclasses.replace(pc, plan=dataclasses.replace(pc.plan,
                                                           remat=policy))
    _, pb = _batch(rc, seed=8)
    loss, _, grads = _loss_grads(cfg, pp, pb)
    assert calls == {"fwd": per_layer * cfg.num_layers,
                     "bwd": cfg.num_layers}
    want = _flat(_loss_grads(pc, pp, pb)[2])    # autograd of the plain
    for k, g in _flat(grads).items():
        np.testing.assert_allclose(g, want[k], **GRAD_F32, err_msg=k)


def test_serve_steps_and_input_specs():
    """The bundle's prefill step is the forward's last logits, its decode
    step the argmax of decode_step's, and input_specs give the
    reference's shapes for train, prefill and decode."""
    from repro.models.api import build_model as r_model
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.step import build_step_bundle
    rc, pc, rp, pp = _both("qwen2-1.5b")
    _, pb = _batch(rc, seed=9)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("t", 16, 2, kind)
        want = r_model(rc).input_specs(shape)
        got = p_build(pc, device=CPU).input_specs(shape)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
    pre = build_step_bundle(pc, ShapeConfig("p", 16, 2, "prefill"),
                            device=CPU,
                            model_kw=dict(compute_dtype=torch.float32))
    assert pre.kind == "prefill" and pre.device.type == "cpu"
    logits = pre.step_fn(pp, pb)
    full = pre.model.forward(pp, pb)
    torch.testing.assert_close(logits, full[:, -1], rtol=1e-5, atol=1e-5)
    dec = build_step_bundle(pc, ShapeConfig("d", 16, 2, "decode"),
                            device=CPU,
                            model_kw=dict(compute_dtype=torch.float32))
    cache = dec.model.init_cache(2, 16)
    tok, cache = dec.step_fn(pp, cache, pb["tokens"][:, 0])
    want_logits, _ = dec.model.decode_step(pp, dec.model.init_cache(2, 16),
                                           pb["tokens"][:, 0])
    assert tok.dtype == torch.int32 and cache["cur"] == 1
    assert torch.equal(tok, torch.argmax(want_logits, -1).to(torch.int32))
