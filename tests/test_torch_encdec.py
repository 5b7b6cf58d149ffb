"""The port's enc-dec family (``repro_torch.models.encdec``, whisper-medium
at its reduced widths) against ``repro.models.encdec``: the layers it adds
(``layernorm``, ``gelu_mlp``, ``sinusoidal_positions``), ``encode``,
``decode_train`` and ``encdec_loss`` in f32 and bf16, the loss's gradient
against ``jax.grad``, ``precompute_cross_kv`` and the decode steps and
cache, teacher-forced decode against the forward, and the non-causal
plain attention at whisper's Sk = 1500 against the reference's
``blocked_attention``.

The parameters are the reference's tree filled from a numpy seed
(``test_torch_models._params_np``), the frames 0.02 x numpy normals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.encdec as r_ed
import repro.models.layers as r_layers
import repro_torch.models.encdec as p_ed
import repro_torch.models.layers as p_layers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from test_torch_common import CPU
from test_torch_models import _batch_np, _both
from test_torch_train import _flat

ARCH = "whisper-medium"
F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
GRAD = dict(rtol=1e-4, atol=1e-6)
DEC = dict(atol=2e-3, rtol=2e-3)
ATTN_F32 = dict(atol=2e-5, rtol=2e-5)


def _setup(b=2, s=16, seed=0):
    rc, pc, rp, pp = _both(ARCH)
    batch = _batch_np(rc, b, s, seed)
    return rc, pc, rp, pp, {k: jnp.asarray(v) for k, v in batch.items()}, \
        {k: torch.from_numpy(v) for k, v in batch.items()}


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    np.testing.assert_allclose(
        p_layers.layernorm(*map(torch.from_numpy, (x, scale, bias))).numpy(),
        np.asarray(r_layers.layernorm(*map(jnp.asarray, (x, scale, bias)))),
        atol=1e-6, rtol=1e-6)
    # bf16 in, bf16 out, computed in f32
    got = p_layers.layernorm(torch.from_numpy(x).bfloat16(),
                             *map(torch.from_numpy, (scale, bias)))
    want = r_layers.layernorm(jnp.asarray(x).astype(jnp.bfloat16),
                              *map(jnp.asarray, (scale, bias)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)
    w1 = (0.2 * rng.standard_normal((64, 96))).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(96)).astype(np.float32)
    w2 = (0.2 * rng.standard_normal((96, 64))).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(64)).astype(np.float32)
    args = (x, w1, b1, w2, b2)
    np.testing.assert_allclose(
        p_layers.gelu_mlp(*map(torch.from_numpy, args)).numpy(),
        np.asarray(r_layers.gelu_mlp(*map(jnp.asarray, args))),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seq,d", [(1500, 1024), (448, 1024), (16, 64),
                                   (7, 2), (3, 3)])
def test_sinusoidal_positions_are_the_references_bits(seq, d):
    got = p_layers.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq,
                                                               2 * (d // 2))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(r_layers.sinusoidal_positions(seq, d)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_decode_and_loss_match_reference(dtype):
    rc, pc, rp, pp, rb, pb = _setup()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = F32 if dtype == "float32" else BF16
    r_enc = r_ed.encode(rc, rp, rb["frames"], dtype=jd)
    p_enc = p_ed.encode(pc, pp, pb["frames"], dtype=td)
    assert p_enc.dtype == td
    np.testing.assert_allclose(p_enc.float().numpy(),
                               np.asarray(r_enc, np.float32), **tol)
    v = rc.vocab_size
    for last_only in (False, True):
        want = r_ed.decode_train(rc, rp, rb["tokens"], r_enc, dtype=jd,
                                 last_only=last_only)
        got = p_ed.decode_train(pc, pp, pb["tokens"], p_enc, dtype=td,
                                last_only=last_only)
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.float().numpy()[..., :v],
                                   np.asarray(want, np.float32)[..., :v],
                                   **tol)
        assert (got.float().numpy()[..., v:] == -1e30).all()
    want_loss, want_m = r_ed.encdec_loss(rc, rp, rb, dtype=jd)
    got_loss, got_m = p_ed.encdec_loss(pc, pp, pb, dtype=td)
    assert set(got_m) == set(want_m) == {"ce"}
    np.testing.assert_allclose(float(got_loss), float(want_loss), **tol)
    np.testing.assert_allclose(float(got_m["ce"]), float(want_m["ce"]),
                               **tol)


def test_loss_gradient_matches_jax_grad():
    rc, pc, rp, pp, rb, pb = _setup(seed=1)
    want = jax.grad(lambda p: r_ed.encdec_loss(rc, p, rb,
                                               dtype=jnp.float32)[0])(rp)

    def req(tree):
        return {k: req(v) if isinstance(v, dict)
                else v.detach().clone().requires_grad_(True)
                for k, v in tree.items()}
    leaves = req(pp)
    loss, _ = p_ed.encdec_loss(pc, leaves, pb, dtype=torch.float32)
    loss.backward()

    def grads(tree):
        return {k: grads(v) if isinstance(v, dict) else v.grad
                for k, v in tree.items()}
    got, want = _flat(grads(leaves)), _flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD, err_msg=k)


def _decode_both(rc, pc, rp, pp, rb, pb, steps, total):
    """Both packages' decode over ``steps`` tokens of the batch after the
    prefill's encode and cross K/V: each step's logits held at 1e-4;
    returns both caches."""
    from repro.models import build_model as r_build
    from repro_torch.models import build_model as p_build
    rm = r_build(rc, compute_dtype=jnp.float32)
    pm = p_build(pc, compute_dtype=torch.float32, device=CPU)
    b = rb["tokens"].shape[0]
    rcache, pcache = rm.init_cache(b, total), pm.init_cache(b, total)
    r_enc = r_ed.encode(rc, rp, rb["frames"], dtype=jnp.float32)
    p_enc = p_ed.encode(pc, pp, pb["frames"], dtype=torch.float32)
    rcache["xk"], rcache["xv"] = r_ed.precompute_cross_kv(rc, rp, r_enc)
    pcache["xk"], pcache["xv"] = p_ed.precompute_cross_kv(pc, pp, p_enc)
    for k in ("xk", "xv"):
        assert tuple(pcache[k].shape) == tuple(rcache[k].shape) == (
            rc.num_layers, b, rc.encoder_seq, rc.n_kv_heads,
            rc.resolved_head_dim)
        np.testing.assert_allclose(pcache[k].numpy(),
                                   np.asarray(rcache[k]), **F32)
    v = rc.vocab_size
    for i in range(steps):
        rl, rcache = rm.decode_step(rp, rcache, rb["tokens"][:, i])
        pl, pcache = pm.decode_step(pp, pcache, pb["tokens"][:, i])
        np.testing.assert_allclose(pl.numpy()[:, :v],
                                   np.asarray(rl)[:, :v], **F32,
                                   err_msg=f"step {i}")
        assert (pl.numpy()[:, v:] == -1e30).all()
    return rcache, pcache


def test_decode_steps_and_cache_match_reference():
    rc, pc, rp, pp, rb, pb = _setup(s=8, seed=2)
    rcache, pcache = _decode_both(rc, pc, rp, pp, rb, pb, steps=6,
                                  total=10)
    assert pcache["cur"] == int(rcache["cur"]) == 6
    assert set(pcache) == set(rcache)
    for k in ("k", "v"):
        np.testing.assert_allclose(pcache[k].numpy(), np.asarray(rcache[k]),
                                   **F32, err_msg=k)
    np.testing.assert_array_equal(pcache["pos_buf"].numpy(),
                                  np.asarray(rcache["pos_buf"]))
    specs = p_ed.encdec_cache_specs(pc, 2, 10, torch.float32)
    assert {k: tuple(s.shape) for k, s in specs.items()} == {
        k: tuple(s.shape) for k, s in r_ed.encdec_cache_specs(
            rc, 2, 10, jnp.float32).items() if k != "cur"}


def test_port_decode_matches_port_forward():
    """Teacher-forced decode logits against ``decode_train``'s on the same
    encoder output (causality, the self-attention cache and the cross
    K/V), on the port alone."""
    _, pc, _, pp, _, pb = _setup(s=12, seed=3)
    from repro_torch.models import build_model as p_build
    pm = p_build(pc, compute_dtype=torch.float32, device=CPU)
    full = pm.forward(pp, pb)
    enc = p_ed.encode(pc, pp, pb["frames"], dtype=torch.float32)
    cache = pm.init_cache(2, 12)
    cache["xk"], cache["xv"] = p_ed.precompute_cross_kv(pc, pp, enc)
    dec = []
    for i in range(12):
        logits, cache = pm.decode_step(pp, cache, pb["tokens"][:, i])
        dec.append(logits)
    torch.testing.assert_close(torch.stack(dec, 1), full, **DEC)


@pytest.mark.parametrize("sq,sk", [(1500, 1500), (40, 1500)])
def test_non_causal_plain_attention_matches_blocked_attention(sq, sk):
    """Whisper's encoder (Sq = Sk = 1500) and cross (Sq 40 against Sk
    1500) calls: no kv tile divides 1500, which the Pallas kernel refuses
    non-causal and the port takes."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, sq, 2, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, sk, 2, 64)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(r_layers.blocked_attention(
        *map(jnp.asarray, (q, k, v)), causal=False))
    for fn in (fa.flash_attention_ref, ops.flash_attention):
        got = fn(*map(torch.from_numpy, (q, k, v)), causal=False)
        np.testing.assert_allclose(got.numpy(), want, **ATTN_F32)
