"""The port's AdamW, schedule and int8 error-feedback compression:
``tests/test_optim.py``'s six cases on the port, and direct parity of
``adamw_update``, ``warmup_cosine``, ``quantize_int8`` and
``ef_compress`` with ``repro.optim`` on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.optim as r_optim
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               compress_init, dequantize_int8, ef_compress,
                               ef_decompress, quantize_int8, warmup_cosine)


def test_adamw_minimises_quadratic():
    params = {"x": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        grads = {"x": 2 * (params["x"] - target)}
        params, state, m = adamw_update(grads, state, params, lr=5e-2,
                                        weight_decay=0.0)
    np.testing.assert_allclose(params["x"].numpy(), target.numpy(),
                               atol=0.05)


def test_grad_clipping():
    params = {"x": torch.zeros(4)}
    state = adamw_init(params)
    grads = {"x": torch.full((4,), 1e6)}
    _, _, m = adamw_update(grads, state, params, lr=1e-3, clip_norm=1.0)
    assert float(m["grad_norm"]) > 1.0  # reported pre-clip


def test_warmup_cosine_shape():
    lrs = [float(warmup_cosine(s, peak_lr=1.0, warmup_steps=10,
                               total_steps=100)) for s in range(100)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0, abs=0.01)
    assert np.argmax(lrs) == pytest.approx(10, abs=1)
    assert lrs[-1] < 0.2


@given(st.floats(1e-6, 1e3), st.integers(0, 2**31 - 1))
@settings(max_examples=50, deadline=None)
def test_int8_quant_error_bounded(scale, seed):
    x = torch.from_numpy(scale * np.random.default_rng(seed)
                         .standard_normal(64).astype(np.float32))
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs().numpy()
    assert err.max() <= float(s) * 0.5 + 1e-9  # half-ULP rounding


def test_error_feedback_accumulates_exactly():
    """Sum over steps of (decompressed) == sum of true grads, up to the
    final residual -- the EF invariant."""
    rng = np.random.default_rng(0)
    state = compress_init({"w": torch.zeros(32)})
    total_true = torch.zeros(32)
    total_sent = torch.zeros(32)
    for i in range(20):
        g = {"w": torch.from_numpy(rng.standard_normal(32).astype(
            np.float32)) * (10.0 ** (i % 3 - 1))}
        q, s, state = ef_compress(g, state)
        total_true += g["w"]
        total_sent += ef_decompress(q, s)["w"]
    np.testing.assert_allclose((total_sent + state.residual["w"]).numpy(),
                               total_true.numpy(), rtol=1e-4, atol=1e-4)


def test_compression_ratio():
    """int8 payload = 4x fewer wire bytes than f32."""
    g = {"w": torch.ones(1024)}
    q, s, _ = ef_compress(g, compress_init(g))
    assert q["w"].dtype == torch.int8
    assert q["w"].numel() * q["w"].element_size() * 4 == \
        g["w"].numel() * g["w"].element_size()


# ---------------------------------------------------------------------------
# Direct parity with repro.optim
# ---------------------------------------------------------------------------


def _tree(rng, scale=1.0):
    return {"a": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal(7)).astype(np.float32)}}


@pytest.mark.parametrize("gscale", [1e-3, 10.0])   # unclipped, clipped
def test_adamw_update_matches_reference(gscale):
    rng = np.random.default_rng(1)
    params, grads = _tree(rng), _tree(rng, gscale)
    mu, nu = _tree(rng, 1e-2), {k: v for k, v in _tree(rng).items()}
    nu = {"a": np.abs(nu["a"]) * 1e-3, "b": {"c": np.abs(nu["b"]["c"])
                                             * 1e-3}}
    lr = 2.5e-3
    to_j = lambda t: {k: to_j(v) if isinstance(v, dict) else jnp.asarray(v)
                      for k, v in t.items()}
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict)
                      else torch.from_numpy(v.copy()) for k, v in t.items()}
    rp, rs, rm = r_optim.adamw_update(
        to_j(grads), r_optim.AdamWState(jnp.int32(150), to_j(mu), to_j(nu)),
        to_j(params), lr=lr)
    pp, ps, pm = adamw_update(
        to_t(grads), AdamWState(torch.tensor(150, dtype=torch.int32),
                                to_t(mu), to_t(nu)), to_t(params), lr=lr)
    for got, want in ((pp, rp), (ps.mu, rs.mu), (ps.nu, rs.nu)):
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(got["b"]["c"].numpy(),
                                   np.asarray(want["b"]["c"]), rtol=1e-6,
                                   atol=1e-9)
    assert int(ps.step) == int(rs.step) == 151
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-6)


def test_warmup_cosine_matches_reference():
    kw = dict(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)
    steps = [0, 1, 50, 99, 100, 101, 150, 5000, 9999, 10_000, 12_000]
    got = [float(warmup_cosine(s, **kw)) for s in steps]
    want = [float(r_optim.warmup_cosine(s, **kw)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_quantize_and_ef_compress_match_reference():
    rng = np.random.default_rng(2)
    g, r = _tree(rng, 3.0), _tree(rng, 0.01)
    x = g["a"]
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = r_optim.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    to_j = lambda t: {k: to_j(v) if isinstance(v, dict) else jnp.asarray(v)
                      for k, v in t.items()}
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict)
                      else torch.from_numpy(v.copy()) for k, v in t.items()}
    pq, ps, pst = ef_compress(to_t(g), compress_init(to_t(g))._replace(
        residual=to_t(r)))
    rq, rs, rst = r_optim.ef_compress(to_j(g),
                                      r_optim.CompressionState(to_j(r)))
    for path in (("a",), ("b", "c")):
        def get(t):
            for p in path:
                t = t[p]
            return np.asarray(t)
        np.testing.assert_array_equal(get(pq), get(rq))
        assert float(get(ps)) == float(get(rs))
        np.testing.assert_allclose(get(pst.residual), get(rst.residual),
                                   rtol=0, atol=1e-7)


def test_adamw_update_in_slices_is_bitwise_the_whole_update(monkeypatch):
    """A leaf larger than UPDATE_SLICE is updated slice by slice: the
    parameters and both moments equal the whole-leaf update bit for bit,
    a non-contiguous leaf included."""
    import repro_torch.optim.adamw as adamw_lib
    rng = np.random.default_rng(7)

    def tree():
        big = torch.from_numpy(rng.standard_normal((5, 333)).astype(
            np.float32))
        return {"big": big, "small": torch.from_numpy(
            rng.standard_normal(6).astype(np.float32)), "strided": big.T}
    params, grads = tree(), tree()

    def run(n_slice):
        monkeypatch.setattr(adamw_lib, "UPDATE_SLICE", n_slice)
        p = {k: v.clone() for k, v in params.items()}
        state = adamw_init(p)
        for _ in range(3):
            p, state, _ = adamw_update(grads, state, p, lr=1e-2)
        return p, state
    whole, s_whole = run(1 << 30)
    sliced, s_sliced = run(100)
    for k in params:
        assert torch.equal(whole[k], sliced[k]), k
        assert torch.equal(s_whole.mu[k], s_sliced.mu[k]), k
        assert torch.equal(s_whole.nu[k], s_sliced.nu[k]), k
