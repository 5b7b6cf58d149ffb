"""The port's LM against ``repro.models``: the same parameters (made with
numpy from a seed, carried into the port by ``convert.model_params``)
through both packages' forward and decode steps, at the reduced widths of
qwen2-1.5b (GQA + QKV bias + tied embeddings), smollm-135m, yi-9b,
mamba2-1.3b (SSM) and zamba2-2.7b (hybrid: Mamba-2 layers and a shared
attention block); and every full-size arch's parameter shapes and count,
without allocating them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU
import repro.models.transformer as r_tr
from repro.configs import get_arch as r_arch, list_archs
from repro.models import build_model as r_build
import repro_torch.configs as p_configs
import repro_torch.models.transformer as p_tr
from repro_torch import convert
from repro_torch.models import build_model as p_build

ARCHS = ["qwen2-1.5b", "smollm-135m", "yi-9b", "mamba2-1.3b", "zamba2-2.7b"]
SSM_ARCHS = ["mamba2-1.3b", "zamba2-2.7b"]
F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
# The SSM families' bf16 rounding noise exceeds BF16 element by element:
# on these inputs the reference's own bf16 logits miss its f32 logits by
# up to 0.045 (mamba2) and 0.054 (zamba2).  Their bf16 forwards are held
# to BF16's 2e-2 as a norm-relative error against the reference's bf16,
# and element by element to no more than 1.25x the reference's own
# distance from its f32 forward.
SSM_BF16_REL = 2e-2
SSM_BF16_VS_REF_NOISE = 1.25
DEC = dict(atol=2e-3, rtol=2e-3)   # decode vs forward (tests/test_models.py)


def _params_np(ref_cfg, seed=0):
    """The reference's parameter tree filled with numpy draws: weights at
    0.3/sqrt(fan-in), the (tied) embedding at 0.1, norm scales near 1,
    nonzero biases, so the logits are O(1) and every term of the layer
    shows in them."""
    rng = np.random.default_rng(seed)
    specs = r_tr.lm_specs(ref_cfg)

    def fill(s):
        if s.init == "ones":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        if s.init == "zeros":  # the QKV biases
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = s.shape[-2] if len(s.shape) > 1 else s.shape[-1]
        if "vocab" in s.axes:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.3 / np.sqrt(fan_in)
                * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree.map(fill, specs, is_leaf=lambda x: hasattr(x, "init"))


def _both(arch, **over):
    rc = dataclasses.replace(r_arch(arch).reduced(), **over)
    pc = dataclasses.replace(p_configs.get_arch(arch).reduced(), **over)
    params = _params_np(rc)
    return rc, pc, jax.tree.map(jnp.asarray, params), \
        convert.model_params(params, device=CPU)


def _tokens(cfg, b=2, s=16):
    return ((np.arange(b * s).reshape(b, s) * 7 + 3)
            % cfg.vocab_size).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(arch, dtype):
    rc, pc, rp, pp = _both(arch)
    rm = r_build(rc, compute_dtype=getattr(jnp, dtype))
    pm = p_build(pc, compute_dtype=getattr(torch, dtype), device=CPU)
    tok = _tokens(rc)
    tol = F32 if dtype == "float32" else BF16
    noise_floor = dtype == "bfloat16" and arch in SSM_ARCHS
    for last_only in (False, True):
        want = rm.forward(rp, {"tokens": jnp.asarray(tok)},
                          last_only=last_only)
        got = pm.forward(pp, {"tokens": torch.from_numpy(tok)},
                         last_only=last_only)
        assert tuple(got.shape) == tuple(want.shape)
        assert got.dtype == getattr(torch, dtype)
        v = rc.vocab_size  # the padded columns are -1e30 in both
        g = got.float().numpy()[..., :v]
        w = np.asarray(want, np.float32)[..., :v]
        if noise_floor:
            f32 = np.asarray(r_build(rc, compute_dtype=jnp.float32).forward(
                rp, {"tokens": jnp.asarray(tok)}, last_only=last_only))[
                ..., :v]
            assert np.linalg.norm(g - w) / np.linalg.norm(w) < SSM_BF16_REL
            assert np.abs(g - f32).max() <= \
                SSM_BF16_VS_REF_NOISE * np.abs(w - f32).max()
        else:
            np.testing.assert_allclose(g, w, **tol)
        assert (got.float().numpy()[..., v:] == -1e30).all()


def _decode_both(rc, pc, rp, pp, tok, total):
    rm = r_build(rc, compute_dtype=jnp.float32)
    pm = p_build(pc, compute_dtype=torch.float32, device=CPU)
    rcache, pcache = rm.init_cache(tok.shape[0], total), \
        pm.init_cache(tok.shape[0], total)
    for i in range(tok.shape[1]):
        rl, rcache = rm.decode_step(rp, rcache, jnp.asarray(tok[:, i]))
        pl, pcache = pm.decode_step(pp, pcache, torch.from_numpy(tok[:, i]))
        np.testing.assert_allclose(pl.numpy()[:, :rc.vocab_size],
                                   np.asarray(rl)[:, :rc.vocab_size], **F32,
                                   err_msg=f"step {i}")
    return rcache, pcache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_cache_match_reference(arch):
    rc, pc, rp, pp = _both(arch)
    tok = _tokens(rc, s=8)
    rcache, pcache = _decode_both(rc, pc, rp, pp, tok, total=12)
    assert pcache["cur"] == int(rcache["cur"]) == 8
    assert set(pcache) == set(rcache)
    for k in set(pcache) - {"cur", "pos_buf"}:  # k/v, or ssm/conv
        assert pcache[k].dtype == getattr(torch, str(rcache[k].dtype))
        np.testing.assert_allclose(pcache[k].numpy(), np.asarray(rcache[k]),
                                   **F32, err_msg=k)
    if "pos_buf" in rcache:
        np.testing.assert_array_equal(pcache["pos_buf"].numpy(),
                                      np.asarray(rcache["pos_buf"]))


def test_ring_buffer_matches_reference():
    """A sliding window of 8 on both packages: the cache is a ring of 8
    slots, and decoding 20 tokens wraps it twice."""
    rc, pc, rp, pp = _both("qwen2-1.5b", sliding_window=8)
    assert p_tr.cache_len_for(pc, 20) == r_tr.cache_len_for(rc, 20) == 8
    tok = _tokens(rc, s=20)
    rcache, pcache = _decode_both(rc, pc, rp, pp, tok, total=20)
    assert pcache["k"].shape[2] == 8
    np.testing.assert_array_equal(pcache["pos_buf"].numpy(),
                                  np.asarray(rcache["pos_buf"]))
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(rcache["k"]),
                               **F32)
    # the windowed forward (flash_attention with window=8) agrees too
    pm = p_build(pc, compute_dtype=torch.float32, device=CPU)
    rm = r_build(rc, compute_dtype=jnp.float32)
    np.testing.assert_allclose(
        pm.forward(pp, {"tokens": torch.from_numpy(tok)}).numpy()[
            ..., :rc.vocab_size],
        np.asarray(rm.forward(rp, {"tokens": jnp.asarray(tok)}))[
            ..., :rc.vocab_size], **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_port_forward(arch):
    """Teacher-forced decode logits equal the full forward's (causality
    and cache), the check of tests/test_models.py on the port alone."""
    _, pc, _, pp = _both(arch)
    pm = p_build(pc, compute_dtype=torch.float32, device=CPU)
    tok = torch.from_numpy(_tokens(pc, s=8))
    full = pm.forward(pp, {"tokens": tok})
    cache = pm.init_cache(2, 8)
    dec = []
    for i in range(8):
        logits, cache = pm.decode_step(pp, cache, tok[:, i])
        dec.append(logits)
    torch.testing.assert_close(torch.stack(dec, 1), full, **DEC)


def test_decode_continues_from_a_converted_reference_cache():
    rc, pc, rp, pp = _both("qwen2-1.5b")
    rm = r_build(rc, compute_dtype=jnp.float32)
    pm = p_build(pc, compute_dtype=torch.float32, device=CPU)
    tok = _tokens(rc, s=6)
    cache = rm.init_cache(2, 8)
    for i in range(5):
        _, cache = rm.decode_step(rp, cache, jnp.asarray(tok[:, i]))
    pcache = convert.decode_cache(jax.tree.map(np.asarray, cache), CPU)
    assert pcache["cur"] == 5 and isinstance(pcache["cur"], int)
    want, _ = rm.decode_step(rp, cache, jnp.asarray(tok[:, 5]))
    got, pcache = pm.decode_step(pp, pcache, torch.from_numpy(tok[:, 5]))
    np.testing.assert_allclose(got.numpy()[:, :rc.vocab_size],
                               np.asarray(want)[:, :rc.vocab_size], **F32)
    assert pcache["cur"] == 6


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_continues_from_a_converted_reference_ssm_cache(arch):
    """An SSM cache (``ssm`` f32, ``conv``) and a hybrid one (with per-chunk
    ``k``/``v`` and ``pos_buf``) carried across after five reference
    steps: the next step's logits and the whole cache agree."""
    rc, pc, rp, pp = _both(arch)
    rm = r_build(rc, compute_dtype=jnp.float32)
    pm = p_build(pc, compute_dtype=torch.float32, device=CPU)
    tok = _tokens(rc, s=6)
    cache = rm.init_cache(2, 8)
    for i in range(5):
        _, cache = rm.decode_step(rp, cache, jnp.asarray(tok[:, i]))
    pcache = convert.decode_cache(jax.tree.map(np.asarray, cache), CPU)
    assert pcache["cur"] == 5 and isinstance(pcache["cur"], int)
    assert pcache["ssm"].dtype == torch.float32
    want, cache = rm.decode_step(rp, cache, jnp.asarray(tok[:, 5]))
    got, pcache = pm.decode_step(pp, pcache, torch.from_numpy(tok[:, 5]))
    np.testing.assert_allclose(got.numpy()[:, :rc.vocab_size],
                               np.asarray(want)[:, :rc.vocab_size], **F32)
    assert pcache["cur"] == 6 and set(pcache) == set(cache)
    for k in set(pcache) - {"cur"}:
        np.testing.assert_allclose(pcache[k].numpy(), np.asarray(cache[k]),
                                   **F32, err_msg=k)


def test_hybrid_decode_updates_the_cache_in_place():
    """The hybrid family's (num_layers, ...) SSM state is read as
    (n_chunks, period, ...) views: a decode step writes the cache's own
    storage and makes no copy of it."""
    _, pc, _, pp = _both("zamba2-2.7b")
    pm = p_build(pc, compute_dtype=torch.float32, device=CPU)
    cache = pm.init_cache(2, 8)
    ptrs = {k: v.data_ptr() for k, v in cache.items() if k != "cur"}
    _, out = pm.decode_step(pp, cache, torch.tensor([1, 2]))
    assert out is cache
    assert {k: v.data_ptr() for k, v in cache.items() if k != "cur"} == ptrs
    for k in ("ssm", "conv", "k", "v"):
        assert cache[k].abs().sum() > 0, k


def _spec_shapes(tree, prefix=""):
    """path -> shape of a nested dict of ParamSpecs or tensors."""
    out = {}
    for k, s in tree.items():
        if isinstance(s, dict):
            out.update(_spec_shapes(s, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(s.shape)
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_full_size_specs_and_param_count_match_reference(arch):
    rc, pc = r_arch(arch), p_configs.get_arch(arch)
    assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    assert pc.param_count() == rc.param_count()
    assert pc.active_param_count() == rc.active_param_count()
    assert pc.padded_vocab == rc.padded_vocab
    if pc.family not in p_tr.PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP A13c"):
            p_tr.lm_specs(pc)
        with pytest.raises(NotImplementedError, match="ROADMAP A13c"):
            p_build(pc, device=CPU)
        return
    want = {"/".join(k.key for k in path): s.shape for path, s in
            jax.tree_util.tree_flatten_with_path(
                r_tr.lm_specs(rc), is_leaf=lambda x: hasattr(x, "init"))[0]}
    got = _spec_shapes(p_tr.lm_specs(pc))
    assert got == want
    total = sum(int(np.prod(s)) for s in got.values())
    if pc.family == "dense":
        assert total == pc.param_count()
    else:  # the analytic count leaves out dt_bias and gate_norm
        assert total == pc.param_count() + pc.num_layers * (
            pc.ssm_n_heads + pc.ssm_d_inner)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs there")
    cfg = p_configs.get_arch("qwen2-1.5b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        p_build(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.model_params({"w": np.zeros(2, np.float32)})


def test_init_draws_every_spec_from_the_seed():
    cfg = p_configs.get_arch("qwen2-1.5b").reduced()
    model = p_build(cfg, device=CPU)
    a, b, c = model.init(0), model.init(0), model.init(1)
    assert _spec_shapes(a) == _spec_shapes(model.specs())
    la = a["layers"]
    assert all(torch.equal(la[k], b["layers"][k]) for k in la)
    assert not torch.equal(la["wq"], c["layers"]["wq"])
    assert torch.equal(la["ln1"], torch.ones_like(la["ln1"]))
    assert torch.equal(la["bq"], torch.zeros_like(la["bq"]))
    assert a["embed"].dtype == torch.float32
    assert float(a["embed"].std()) == pytest.approx(0.02, rel=0.05)
