"""The gradient of the port's ssd_scan.

On the CPU: the explicit chunked backward (``ssd_scan_bwd_ref``, the
decomposition the CUDA kernels use) and autograd through the plain
forward (``ssd_scan_ref``) against ``jax.grad`` of the reference's
``repro.models.ssd.ssd_chunked`` (the Pallas kernel has no gradient; the
reference trains through that function), from zeros and from an initial
state, and both against float64 autograd through the sequential
recurrence ``ssd_ref``, also at chunk 256, where the reference's own
segment sums lose digits; masked entries whose decay underflows give
finite gradients.

The gradients are held relative to each gradient's scale: by norm,
||g - g_ref|| <= tol ||g_ref||, and by element, max |g - g_ref| <= tol
max |g_ref|.  Elementwise rtol 1e-4 / atol 1e-6 (the model gradients'
tolerance) does not hold between the reference's own float32 gradient and
the float64 recurrence at these shapes: the scan's gradients reach |g| ~
100-1000, sums of hundreds of terms, and the elements that cancel near 0
keep an absolute rounding of ~1e-5-1e-3 (up to 138 of 131,072 elements of
dx outside it).

On a card (marked ``cuda``, skipped without one): the four backward
kernels (``ssd_scan_bwd``) against the plain version over a grid
of shapes and both dtypes, bitwise equal repeats, strided inputs, and
what the wrapper refuses:

    python -m pytest -q -m cuda tests/test_torch_ssd_bwd.py

The card's machine has no JAX: it is imported inside the tests that use
it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as sk

# ||g - g_ref|| / ||g_ref|| and max |g - g_ref| / max |g_ref| per
# gradient: against jax.grad (whose own distance from the float64
# recurrence reaches 4.5e-6 by norm, its dA's) and against the float64
# recurrence (the port's reaches 3.3e-7 by norm at chunks <= 64 and stays
# under 1e-5 at chunk 256)
GRAD_REL = 1e-4
F64_REL = 1e-5
CARD_F32 = dict(atol=1e-4, rtol=1e-4)
# the kernels against the plain version in float32 at 1e-4 of each
# gradient's scale: ||k - p|| <= 1e-4 ||p|| and max |k - p| <= 1e-4 max
# |p| (elementwise 1e-4 does not hold between two float32 orders of
# summation where |g| reaches 1e4 and elements cancel)
CARD_SCALE_REL = 1e-4
# bf16 inputs: the kernels' gradient, norm-relative per gradient from the
# gradient of the f32 inputs, within 1.25x the plain version's own on the
# same bf16 inputs (as the bf16 forward is held)
BF16_VS_PLAIN = 1.25
NAMES = ("dx", "ddt", "dA", "dB", "dC")

# (b, s, nh, hd, ds, chunk): tests/test_torch_ssd.py's shapes
SHAPES = [
    (1, 64, 4, 16, 16, 16),
    (2, 128, 8, 16, 32, 32),
    (1, 256, 16, 32, 64, 64),
    (2, 96, 4, 16, 16, 32),
]


def _inputs(b, s, nh, hd, ds, seed=0):
    """x, dt = softplus(N), A = -exp(0.5 N), B, C as the reference's
    kernel tests draw them, and dy = N, with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(nh))).astype(np.float32)
    B = rng.standard_normal((b, s, ds)).astype(np.float32)
    C = rng.standard_normal((b, s, ds)).astype(np.float32)
    dy = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    return x, dt, A, B, C, dy


def _jax_grads(arrs, chunk, init=None):
    import jax
    import jax.numpy as jnp
    from repro.models.ssd import ssd_chunked
    x, dt, A, B, C, dy = (jnp.asarray(a) for a in arrs)
    leaves = (x, dt, A, B, C) + (() if init is None else (jnp.asarray(init),))

    def loss(*lv):
        y, _ = ssd_chunked(*lv[:5], chunk,
                           initial_state=None if init is None else lv[5])
        return jnp.sum(y * dy)
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(
        range(len(leaves))))(*leaves)]


def _autograd(fn, tensors, dy):
    leaves = [t.clone().requires_grad_(True) for t in tensors]
    return torch.autograd.grad(fn(*leaves), leaves, dy)


def _rel(a, b):
    a, b = (torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v).double() for v in (a, b))
    return float((a - b).norm() / b.norm())


def _max_rel(a, b):
    """max |a - b| / max |b|: the largest error against the gradient's
    largest element."""
    a, b = (torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v).double() for v in (a, b))
    return float((a - b).abs().max() / b.abs().max())


def _assert_close(mine, ref, tol, name):
    """Within ``tol`` of ``ref``'s scale, by norm and by element."""
    assert _rel(mine, ref) <= tol, (name, _rel(mine, ref))
    assert _max_rel(mine, ref) <= tol, (name, _max_rel(mine, ref))


def _f64_grads(t):
    """Gradients of sum(ssd_ref(x, dt, A, B, C) * dy) in float64."""
    return _autograd(sk.ssd_ref, [a.double() for a in t[:5]], t[5].double())


@pytest.mark.parametrize("b,s,nh,hd,ds,chunk", SHAPES)
def test_plain_backward_matches_jax_grad(b, s, nh, hd, ds, chunk):
    arrs = _inputs(b, s, nh, hd, ds, seed=20)
    want = _jax_grads(arrs, chunk)
    t = [torch.from_numpy(a) for a in arrs]
    explicit = sk.ssd_scan_bwd_ref(*t, chunk)
    assert explicit[5] is None
    auto = _autograd(lambda *lv: sk.ssd_scan_ref(*lv, chunk)[0], t[:5], t[5])
    exact = _f64_grads(t)
    for name, e, a, w, x in zip(NAMES, explicit, auto, want, exact):
        assert e.dtype == a.dtype == torch.float32
        for mine in (e, a):
            _assert_close(mine, w, GRAD_REL, name)
            _assert_close(mine, x, F64_REL, name)


@pytest.mark.parametrize("b,s,nh,hd,ds,chunk", SHAPES[1:3])
def test_plain_backward_with_initial_state_matches_jax_grad(b, s, nh, hd, ds,
                                                            chunk):
    arrs = _inputs(b, s, nh, hd, ds, seed=21)
    init = np.random.default_rng(22).standard_normal(
        (b, nh, hd, ds)).astype(np.float32)
    want = _jax_grads(arrs, chunk, init)
    t = [torch.from_numpy(a) for a in arrs]
    ti = torch.from_numpy(init)
    explicit = sk.ssd_scan_bwd_ref(*t, chunk, initial_state=ti)
    auto = _autograd(lambda *lv: sk.ssd_scan_ref(
        *lv[:5], chunk, initial_state=lv[5])[0], t[:5] + [ti], t[5])
    for name, e, a, w in zip(NAMES + ("d_initial_state",), explicit, auto,
                             want):
        for mine in (e, a):
            _assert_close(mine, w, GRAD_REL, name)


def test_plain_backward_chunk256_matches_float64_recurrence():
    """At chunk 256 the reference's segment sums (cs_i - cs_j) keep ~1e-4
    of a short segment's exponent; the port's are summed on their own, so
    its float32 gradient stays within 1e-5 of float64 autograd through the
    sequential recurrence, relative to each gradient's norm and largest
    element."""
    arrs = _inputs(1, 512, 4, 16, 32, seed=23)
    t = [torch.from_numpy(a) for a in arrs]
    want = _f64_grads(t)
    got = sk.ssd_scan_bwd_ref(*t, 256)[:5]
    auto = _autograd(lambda *lv: sk.ssd_scan_ref(*lv, 256)[0], t[:5], t[5])
    for name, g, a, w in zip(NAMES, got, auto, want):
        for mine in (g, a):
            _assert_close(mine, w, F64_REL, name)


def test_masked_entries_give_finite_gradients():
    """Decays that underflow to 0 (large dt |A|): every gradient finite,
    explicit and autograd agree."""
    x, dt, A, B, C, dy = (torch.from_numpy(a)
                          for a in _inputs(1, 64, 3, 16, 16, seed=24))
    dt = dt * 40.0
    A = A * torch.tensor([1.0, 30.0, 300.0])
    got = sk.ssd_scan_bwd_ref(x, dt, A, B, C, dy, 32)[:5]
    auto = _autograd(lambda *lv: sk.ssd_scan_ref(*lv, 32)[0],
                     [x, dt, A, B, C], dy)
    for name, g, a in zip(NAMES, got, auto):
        assert torch.isfinite(g).all() and torch.isfinite(a).all(), name
        torch.testing.assert_close(g, a, **CARD_F32, msg=name)


def test_plain_backward_dtypes_and_ops_cpu_gradient():
    """bf16 x, B, C and dy: dx, dB, dC come back in bf16, ddt and dA in
    float32; on the CPU ops.ssd_scan's gradient is the plain version's."""
    x, dt, A, B, C, dy = (torch.from_numpy(a)
                          for a in _inputs(2, 32, 2, 16, 16, seed=25))
    bf = [v.bfloat16() for v in (x, B, C, dy)]
    out = sk.ssd_scan_bwd_ref(bf[0], dt, A, bf[1], bf[2], bf[3], 8)
    assert [o.dtype for o in out[:5]] == [torch.bfloat16, torch.float32,
                                           torch.float32, torch.bfloat16,
                                           torch.bfloat16]
    got = _autograd(lambda *lv: ops.ssd_scan(*lv, chunk=8),
                    [x, dt, A, B, C], dy)
    want = sk.ssd_scan_bwd_ref(x, dt, A, B, C, dy, 8)[:5]
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, **CARD_F32, msg=name)


def test_backward_wrapper_refuses_cpu_tensors():
    t = [torch.from_numpy(a) for a in _inputs(1, 32, 2, 16, 16)]
    before = sk.ssd_scan_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd_scan_bwd(*t, chunk=16)
    assert sk.ssd_scan_bwd.launches == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _card(arrs, device, dtype=torch.float32, strided_bc=False):
    x, dt, A, B, C, dy = (torch.from_numpy(a).to(device) for a in arrs)
    if strided_bc:  # halves of one (b, s, 2 ds) projection, as the model
        B, C = torch.cat([B, C], -1).to(dtype).chunk(2, dim=-1)
    else:
        B, C = B.to(dtype), C.to(dtype)
    return x.to(dtype), dt, A, B, C, dy.to(dtype)


# the reference's test shapes, the reduced models' chunk of 8, chunks up
# to 256 with hd 16-64 and ds 16-128, and mamba2-1.3b's and zamba2-2.7b's
# training calls (one sequence of 2048)
CARD_SHAPES = SHAPES + [(2, 16, 8, 16, 16, 8), (1, 128, 4, 32, 128, 16),
                        (2, 512, 4, 64, 128, 128), (1, 512, 3, 64, 64, 256),
                        (1, 2048, 64, 64, 128, 256),
                        (1, 2048, 80, 64, 64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_plain_version(cuda, shape, dtype):
    *dims, chunk = shape
    arrs = _inputs(*dims, seed=26)
    args = _card(arrs, cuda, dtype, strided_bc=dtype == torch.bfloat16)
    before = sk.ssd_scan_bwd.launches
    got = sk.ssd_scan_bwd(*args, chunk=chunk)
    again = sk.ssd_scan_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.ssd_scan_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert [g.dtype for g in got] == [dtype, torch.float32, torch.float32,
                                      dtype, dtype]
    want = sk.ssd_scan_bwd_ref(*args, chunk)[:5]
    if dtype == torch.float32:
        for name, g, w in zip(NAMES, got, want):
            assert _rel(g, w) <= CARD_SCALE_REL, name
            assert float((g - w).abs().max()) <= \
                CARD_SCALE_REL * float(w.abs().max()), name
        return
    # bf16: the kernels' distance from the gradient of the f32 inputs
    # within 1.25x the plain version's own on the same bf16 inputs
    exact = sk.ssd_scan_bwd_ref(*_card(arrs, cuda), chunk)[:5]
    for name, g, w, e in zip(NAMES, got, want, exact):
        assert _rel(g, e) <= BF16_VS_PLAIN * _rel(w, e), name


@pytest.mark.cuda
def test_cuda_backward_of_large_decays_is_finite(cuda):
    x, dt, A, B, C, dy = _card(_inputs(1, 256, 3, 16, 16, seed=27), cuda)
    dt = dt * 40.0
    A = A * torch.tensor([1.0, 30.0, 300.0], device=cuda)
    got = sk.ssd_scan_bwd(x, dt, A, B, C, dy, chunk=128)
    want = sk.ssd_scan_bwd_ref(x, dt, A, B, C, dy, 128)[:5]
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, **CARD_F32, msg=name)


@pytest.mark.cuda
def test_cuda_backward_reads_strided_dy(cuda):
    """dy with a broadcast (stride-0) layout, as ``y.sum()`` gives it."""
    x, dt, A, B, C, _ = _card(_inputs(1, 64, 2, 16, 16, seed=28), cuda)
    dy = torch.ones(1, 1, 1, 1, device=cuda).expand(x.shape)
    got = sk.ssd_scan_bwd(x, dt, A, B, C, dy, chunk=16)
    want = sk.ssd_scan_bwd_ref(x, dt, A, B, C, dy, 16)[:5]
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, **CARD_F32, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["chunk_ragged", "head_dim", "dy_shape",
                                 "dy_float16"])
def test_cuda_backward_rejects_what_it_does_not_take(cuda, bad):
    hd = 48 if bad == "head_dim" else 16
    x, dt, A, B, C, dy = _card(_inputs(1, 96, 2, hd, 16, seed=29), cuda)
    chunk = 64 if bad == "chunk_ragged" else 32
    if bad == "dy_shape":
        dy = dy[:, :64]
    elif bad == "dy_float16":
        dy = dy.half()
    before = sk.ssd_scan_bwd.launches
    with pytest.raises(ValueError):
        sk.ssd_scan_bwd(x, dt, A, B, C, dy, chunk=chunk)
    assert sk.ssd_scan_bwd.launches == before
