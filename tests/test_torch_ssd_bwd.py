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

On the CPU also the tensor-core path's host side: its plan (head groups,
splits and grid) against worked-out values and over sizes and cards, and
the 16-byte layout rule.

On a card (marked ``cuda``, skipped without one): the backward kernels
(``ssd_scan_bwd``: the tensor-core path on bf16, the f32 path on f32)
against the plain version over a grid of shapes and both dtypes, ragged
head groups and splits, an f32 dy on bf16 inputs, bitwise equal repeats,
strided and copied inputs, what the wrapper refuses, and the kernels'
registers and spills:

    python -m pytest -q -m cuda tests/test_torch_ssd_bwd.py

The card's machine has no JAX: it is imported inside the tests that use
it.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
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


@pytest.mark.parametrize("call,want", [
    # mamba2-1.3b's training call: 16 groups of 4 heads, 8 splits
    ((1, 2048, 64, 64, 128, 256, 132),
     dict(tile=64, tiles=4, heads_per_group=4, groups=16, ksplits=8,
          chunk_blocks=512, bc_blocks=512, partial_bytes=37748736)),
    # zamba2-2.7b's: 80 heads, ds 64
    ((1, 2048, 80, 64, 64, 256, 132),
     dict(heads_per_group=4, groups=20, ksplits=8, chunk_blocks=640,
          bc_blocks=512)),
    # mamba2-1.3b's prefill call: enough blocks with 8 heads a group
    ((2, 4096, 64, 64, 128, 256, 132),
     dict(heads_per_group=8, groups=8, ksplits=2, chunk_blocks=1024,
          bc_blocks=512)),
    # a chunk of 8 (one 8-row tile padded to 16), 4 heads
    ((1, 64, 4, 16, 16, 8, 132),
     dict(tile=8, tiles=1, heads_per_group=1, groups=4, ksplits=4,
          chunk_blocks=32, bc_blocks=64)),
    # 5 heads: ragged groups of 2 on a 6-SM card, 4 ragged splits on 20
    ((1, 512, 5, 64, 128, 64, 6),
     dict(heads_per_group=2, groups=3, ksplits=1, chunk_blocks=24)),
    ((1, 512, 5, 16, 16, 64, 20),
     dict(heads_per_group=1, groups=5, ksplits=4, bc_blocks=64)),
])
def test_bwd_plan_worked_values(call, want):
    plan = sk.bwd_plan(*call)
    assert {k: plan[k] for k in want} == want
    b, s, nh, hd, ds, chunk, _ = call
    # every head in one group and one split; W's and dB/dC's f32 partials
    # below the per-head (nh, b, s, ds) pair of the f32 path
    assert (plan["groups"] - 1) * plan["heads_per_group"] < nh \
        <= plan["groups"] * plan["heads_per_group"]
    assert 1 <= plan["ksplits"] <= nh
    assert plan["partial_bytes"] < 2 * 4 * nh * b * s * ds or nh < 8


@pytest.mark.parametrize("b,s,nh,chunk,sms", [
    (b, s, nh, chunk, sms) for b, s, chunk in ((1, 64, 8), (2, 4096, 256))
    for nh in (3, 64) for sms in (6, 132)])
def test_bwd_plan_fills_the_card(b, s, nh, chunk, sms):
    """Over sizes, heads and cards: the head group and the splits are
    powers of two up to 8 (splits up to nh); a group smaller than 8 is the
    largest that still gives three chunk blocks an SM, a split count above
    1 the least that gives two dB/dC blocks an SM (or it stops at 8 or
    nh); the blocks are the tiles times the groups or the splits."""
    plan = sk.bwd_plan(b, s, nh, 64, 128, chunk, sms)
    g, ks, nc = plan["heads_per_group"], plan["ksplits"], s // chunk
    assert g in (1, 2, 4, 8) and ks in (1, 2, 4, 8) and ks <= nh
    assert plan["tiles"] * plan["tile"] == chunk
    assert plan["groups"] == -(-nh // g)
    assert plan["chunk_blocks"] == b * nc * plan["groups"] * plan["tiles"]
    assert plan["bc_blocks"] == b * nc * plan["tiles"] * 2 * ks
    if g < 8:
        assert b * nc * -(-nh // (2 * g)) * plan["tiles"] < 3 * sms
    assert g == 1 or plan["chunk_blocks"] >= 3 * sms
    if ks > 1:
        assert plan["bc_blocks"] // 2 < 2 * sms
    assert 2 * ks > min(8, nh) or plan["bc_blocks"] >= 2 * sms


@pytest.mark.cuda
@pytest.mark.parametrize("call,want", [
    # mamba2-1.3b's training call, zamba2-2.7b's, a chunk of 8
    ((1, 2048, 64, 64, 128, 256, 4, 8), (22692864, 16777216)),
    ((1, 2048, 80, 64, 64, 256, 4, 8), (19836160, 10485760)),
    ((1, 64, 4, 16, 16, 8, 1, 4), (28768, 32768)),
])
def test_cuda_bwd_scratch_worked_values(cuda, call, want):
    """The scratch the launcher carves, each piece rounded up to 8
    elements: f32 the states twice, the decays, the scores, W's group
    partials, the vectors, dE's and dA's partials, the splits' dB and dC;
    bf16 the states' four planes."""
    assert sk.bwd_scratch(*call) == want


@pytest.mark.cuda
def test_bwd_plan_scratch_with_f32_dy(cuda):
    """An f32 dy adds its hi and lo bf16 planes, (2, b, s, nh, hd)."""
    a = sk.bwd_scratch(2, 256, 3, 32, 64, 64, 1, 2)
    c = sk.bwd_scratch(2, 256, 3, 32, 64, 64, 1, 2, dy_f32=True)
    assert c[1] - a[1] == 2 * 2 * 256 * 3 * 32
    assert c[0] == a[0]
    with pytest.raises(ValueError):
        sk.bwd_scratch(2, 256, 3, 32, 64, 64, 1, 4)  # more splits than heads


def test_bf16_layout_rule():
    """16-byte start, strides over the leading dims multiples of 8, last
    dim contiguous: B and C as halves of one projection fit; a view one
    element in, a row of 129, or a broadcast last dim do not."""
    bc = torch.zeros(2, 32, 2 * 64, dtype=torch.bfloat16)
    B, C = bc.chunk(2, dim=-1)
    assert sk.fits_bf16_layout(B) and sk.fits_bf16_layout(C)
    flat = torch.zeros(2 * 32 * 64 + 8, dtype=torch.bfloat16)
    assert not sk.fits_bf16_layout(flat[1:1 + 2 * 32 * 64].view(2, 32, 64))
    assert not sk.fits_bf16_layout(
        torch.zeros(2, 32, 129, dtype=torch.bfloat16)[..., :64])
    assert not sk.fits_bf16_layout(
        torch.zeros(1, 1, 1, dtype=torch.bfloat16).expand(2, 32, 64))
    with pytest.raises(ValueError, match="16-byte"):
        sk.check_bf16_layout(B, B, flat[1:1 + 2 * 32 * 64].view(2, 32, 64))


def test_backward_kernel_names_by_path():
    """Each path's kernel names (those chip_smoke.py sums device time by)
    are __global__ functions of the source, and the two paths share
    none."""
    src = (_build.CSRC / "ssd_scan_bwd.cu").read_text()
    defined = set(re.findall(
        r"__global__\s+void\s+__launch_bounds__\([^)]*\)\s+(ssd_bwd_\w+)\(",
        src))
    assert len(sk.BWD_KERNELS[torch.bfloat16]) == 5
    assert len(sk.BWD_KERNELS[torch.float32]) == 4
    for names in sk.BWD_KERNELS.values():
        assert set(names) <= defined
    assert not set(sk.BWD_KERNELS[torch.bfloat16]) & set(
        sk.BWD_KERNELS[torch.float32])


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


def _bf16_check(got, again, want, exact, dtype=torch.bfloat16):
    """Bitwise equal twice, the types, and each gradient within 1.25x the
    plain version's distance from the f32 inputs' gradient."""
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert [g.dtype for g in got] == [dtype, torch.float32, torch.float32,
                                      dtype, dtype]
    for name, g, w, e in zip(NAMES, got, want, exact):
        assert _rel(g, e) <= BF16_VS_PLAIN * _rel(w, e), name


# (b, s, nh, hd, ds, chunk, SMs the plan is made for): ragged head groups
# (5 heads in groups of 2; 3 heads in one group of 8) and ragged splits (5
# heads in 4), ds 16 and 128, hd 16 and 64, chunks 16-256
TC_CASES = [(1, 512, 5, 64, 128, 64, 6), (1, 512, 5, 16, 16, 64, 20),
            (2, 96, 3, 16, 128, 32, 1), (1, 256, 3, 64, 16, 256, 1),
            (2, 64, 5, 32, 64, 16, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_CASES)
def test_cuda_tc_backward_ragged_groups_and_splits(cuda, case, monkeypatch):
    *dims, chunk, sms = case
    monkeypatch.setattr(sk, "sm_count", lambda _dev: sms)
    arrs = _inputs(*dims, seed=30)
    args = _card(arrs, cuda, torch.bfloat16, strided_bc=True)
    got = sk.ssd_scan_bwd(*args, chunk=chunk)
    again = sk.ssd_scan_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    want = sk.ssd_scan_bwd_ref(*args, chunk)[:5]
    exact = sk.ssd_scan_bwd_ref(*_card(arrs, cuda), chunk)[:5]
    _bf16_check(got, again, want, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 4, 16, 32, 16),
                                   (1, 512, 5, 64, 128, 256)])
def test_cuda_tc_backward_takes_f32_dy(cuda, shape):
    """bf16 x, B and C with an f32 dy: the kernels split dy as hi + lo."""
    *dims, chunk = shape
    arrs = _inputs(*dims, seed=31)
    x, dt, A, B, C, _ = _card(arrs, cuda, torch.bfloat16, strided_bc=True)
    dy = torch.from_numpy(arrs[5]).to(cuda)
    args = (x, dt, A, B, C, dy)
    got = sk.ssd_scan_bwd(*args, chunk=chunk)
    again = sk.ssd_scan_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    want = sk.ssd_scan_bwd_ref(*args, chunk)[:5]
    exact = sk.ssd_scan_bwd_ref(*_card(arrs, cuda), chunk)[:5]
    _bf16_check(got, again, want, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["misaligned", "broadcast", "strided"])
def test_cuda_tc_backward_copies_a_dy_off_the_layout(cuda, layout):
    """A bf16 dy off the 16-byte rule is copied: the same gradients as its
    contiguous copy, bitwise."""
    x, dt, A, B, C, dy = _card(_inputs(2, 128, 4, 16, 32, seed=32), cuda,
                               torch.bfloat16, strided_bc=True)
    if layout == "misaligned":
        flat = torch.empty(dy.numel() + 8, dtype=dy.dtype, device=cuda)
        bad = flat[1:1 + dy.numel()].view(dy.shape)
        bad.copy_(dy)
    elif layout == "broadcast":
        bad = dy[:1, :1, :1, :1].expand(dy.shape)
    else:  # every other step: strides (2 s nh hd, 2 nh hd, ...) fit; a
        # column of 17 does not
        wide = torch.zeros(*dy.shape[:3], 17, dtype=dy.dtype, device=cuda)
        wide[..., :16] = dy
        bad = wide[..., :16]
    assert not sk.fits_bf16_layout(bad)
    before = sk.ssd_scan_bwd.launches
    got = sk.ssd_scan_bwd(x, dt, A, B, C, bad, chunk=16)
    want = sk.ssd_scan_bwd(x, dt, A, B, C, bad.contiguous(), chunk=16)
    torch.cuda.synchronize()
    assert sk.ssd_scan_bwd.launches == before + 2
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["x", "B", "C"])
def test_cuda_tc_backward_refuses_x_b_c_off_the_layout(cuda, bad):
    x, dt, A, B, C, dy = _card(_inputs(1, 64, 2, 16, 16, seed=33), cuda,
                               torch.bfloat16)
    t = {"x": x, "B": B, "C": C}[bad]
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=cuda)
    off = flat[1:1 + t.numel()].view(t.shape)
    off.copy_(t)
    args = {"x": x, "B": B, "C": C, bad: off}
    before = sk.ssd_scan_bwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        sk.ssd_scan_bwd(args["x"], dt, A, args["B"], args["C"], dy,
                        chunk=16)
    assert sk.ssd_scan_bwd.launches == before


@pytest.mark.cuda
def test_cuda_tc_backward_kernels_do_not_spill(cuda):
    """The runtime's registers, local memory and occupancy at the training
    calls' widths: no local memory, and at ds 128 two blocks of the chunk
    and dB/dC kernels resident on an SM."""
    for ds in (128, 64):
        info = sk.bwd_kernel_info(64, ds)
        assert set(info) == set(sk.BWD_KERNELS[torch.bfloat16])
        for name, k in info.items():
            assert k["local_bytes"] == 0, (name, ds, k)
            assert k["blocks_per_sm"] >= 1, (name, ds, k)
            if ds == 128 and name in ("ssd_bwd_tc_chunk", "ssd_bwd_tc_bc"):
                assert k["blocks_per_sm"] >= 2, (name, k)
