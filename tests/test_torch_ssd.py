"""The port's ssd_scan kernel and Mamba-2 block: the plain version against
the Pallas kernel (interpret mode) and the sequential oracle, the model's
chunked scan, block and decode step against ``repro.models.ssd`` on the
CPU, and the CUDA kernel against its plain version on a card (marked
``cuda``, skipped without one).

The card's machine has no JAX, so this file imports JAX and the
reference only inside the tests that compare with them:

    python -m pytest -q -m cuda tests/test_torch_ssd.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as sk
from repro_torch.models import ssd as p_ssd

# the reference's tolerances (tests/test_kernels.py)
ORACLE = dict(atol=5e-4, rtol=5e-3)    # chunked scan vs the recurrence
CHUNKED = dict(atol=1e-4, rtol=1e-4)   # two chunked forms
BF16 = dict(atol=0.15, rtol=0.1)       # bf16 x vs the f32 recurrence
# the bf16 path (bf16 products) vs the f32 plain version on the same bf16
# inputs, as ||y - y_plain|| / ||y_plain||
BF16_REL = 1e-2
F32 = dict(atol=1e-4, rtol=1e-4)       # the model's block, f32

# (b, s, nh, hd, ds, chunk): tests/test_kernels.py's four shapes
SHAPES = [
    (1, 64, 4, 16, 16, 16),
    (2, 128, 8, 16, 32, 32),
    (1, 256, 16, 32, 64, 64),
    (2, 96, 4, 16, 16, 32),
]


def _inputs(b, s, nh, hd, ds, seed=0):
    """x, dt = softplus(N), A = -exp(0.5 N), B, C as the reference's
    kernel tests draw them, here with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(nh))).astype(np.float32)
    B = rng.standard_normal((b, s, ds)).astype(np.float32)
    C = rng.standard_normal((b, s, ds)).astype(np.float32)
    return x, dt, A, B, C


def _t(arrs, x_dtype=torch.float32, device="cpu"):
    x, *rest = (torch.from_numpy(a).to(device) for a in arrs)
    return (x.to(x_dtype), *rest)


@pytest.mark.parametrize("b,s,nh,hd,ds,chunk", SHAPES)
def test_plain_version_matches_pallas_and_oracle(b, s, nh, hd, ds, chunk):
    import jax.numpy as jnp
    from repro.kernels import ops as r_ops, ref as r_ref
    arrs = _inputs(b, s, nh, hd, ds)
    j = [jnp.asarray(a) for a in arrs]
    pallas = np.asarray(r_ops.ssd_scan(*j, chunk=chunk, interpret=True))
    oracle = np.asarray(r_ref.ssd_ref(*j))
    got, _ = sk.ssd_scan_ref(*_t(arrs), chunk)
    np.testing.assert_allclose(got.numpy(), oracle, **ORACLE)
    np.testing.assert_allclose(got.numpy(), pallas, **CHUNKED)


def test_plain_version_bf16_matches_pallas_and_oracle():
    import jax.numpy as jnp
    from repro.kernels import ops as r_ops, ref as r_ref
    arrs = _inputs(1, 128, 4, 16, 32, seed=1)
    xb = torch.from_numpy(arrs[0]).bfloat16()
    xf = xb.float().numpy()  # the bf16 values, exactly, in f32
    j = [jnp.asarray(a) for a in arrs[1:]]
    pallas = r_ops.ssd_scan(jnp.asarray(xf, jnp.bfloat16), *j, chunk=32,
                            interpret=True)
    oracle = np.asarray(r_ref.ssd_ref(jnp.asarray(xf), *j))
    got, _ = sk.ssd_scan_ref(xb, *(torch.from_numpy(a) for a in arrs[1:]),
                             32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), oracle, **BF16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), **BF16)


def test_chunked_scan_matches_reference_with_state():
    """The port's ssd_chunked (the plain version) against the reference's:
    y and the final state, from zeros and from a given initial state."""
    import jax.numpy as jnp
    from repro.models.ssd import ssd_chunked as r_chunked
    arrs = _inputs(2, 128, 8, 16, 32, seed=2)
    init = np.random.default_rng(3).standard_normal(
        (2, 8, 16, 32)).astype(np.float32)
    j = [jnp.asarray(a) for a in arrs]
    for state in (None, init):
        want_y, want_s = r_chunked(*j, 32, initial_state=None if state is None
                                   else jnp.asarray(state))
        got_y, got_s = p_ssd.ssd_chunked(
            *_t(arrs), 32,
            initial_state=None if state is None else torch.from_numpy(state))
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   **CHUNKED)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   **CHUNKED)
    assert p_ssd.ssd_chunked is sk.ssd_scan_ref  # one copy of the algorithm


def test_sequential_oracle_matches_reference():
    import jax.numpy as jnp
    from repro.kernels import ref as r_ref
    arrs = _inputs(2, 40, 4, 16, 16, seed=4)
    want = np.asarray(r_ref.ssd_ref(*(jnp.asarray(a) for a in arrs)))
    np.testing.assert_allclose(sk.ssd_ref(*_t(arrs)).numpy(), want, **F32)


def test_segsum_matches_reference():
    import jax.numpy as jnp
    from repro.models.ssd import _segsum as r_segsum
    dA = -np.abs(np.random.default_rng(5).standard_normal((3, 16))
                 ).astype(np.float32)
    want = np.asarray(r_segsum(jnp.asarray(dA)))
    got = p_ssd._segsum(torch.from_numpy(dA)).numpy()
    assert (np.isneginf(got) == np.isneginf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=1e-5)


def _block_case(seed=6):
    """Reduced mamba2 config and one layer's parameters, drawn with numpy
    (A_log and dt_bias nonzero, so every term of the block shows)."""
    from repro.configs import get_arch as r_arch
    from repro.models.ssd import ssd_specs as r_specs
    import repro_torch.configs as p_configs
    rc = r_arch("mamba2-1.3b").reduced()
    pc = p_configs.get_arch("mamba2-1.3b").reduced()
    rng = np.random.default_rng(seed)
    lp = {}
    for k, s in r_specs(rc, 1, np.float32).items():
        shape = s.shape[1:]
        if s.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif s.init == "zeros":
            a = 0.3 * rng.standard_normal(shape)
        else:
            a = 0.3 / np.sqrt(shape[0]) * rng.standard_normal(shape)
        lp[k] = a.astype(np.float32)
    return rc, pc, lp


def test_ssd_block_matches_reference():
    import jax.numpy as jnp
    from repro.models.ssd import ssd_block as r_block
    rc, pc, lp = _block_case()
    x = np.random.default_rng(7).standard_normal(
        (2, 24, rc.d_model)).astype(np.float32)
    want = r_block(rc, {k: jnp.asarray(v) for k, v in lp.items()},
                   jnp.asarray(x), rc.norm_eps)
    got = p_ssd.ssd_block(pc, {k: torch.from_numpy(v) for k, v in lp.items()},
                          torch.from_numpy(x), pc.norm_eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_ssd_block_decode_matches_reference_in_place():
    import jax.numpy as jnp
    from repro.models.ssd import ssd_block_decode as r_decode
    rc, pc, lp = _block_case(seed=8)
    rng = np.random.default_rng(9)
    specs = p_ssd.ssd_decode_state_specs(pc, 1, 3, torch.float32)
    assert specs["ssm"].dtype == torch.float32
    state = {k: rng.standard_normal(s.shape[1:]).astype(np.float32)
             for k, s in specs.items()}
    rstate = {k: jnp.asarray(v) for k, v in state.items()}
    pstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    ssm_ptr = pstate["ssm"].data_ptr()
    rlp = {k: jnp.asarray(v) for k, v in lp.items()}
    plp = {k: torch.from_numpy(v) for k, v in lp.items()}
    for step in range(4):
        x = rng.standard_normal((3, rc.d_model)).astype(np.float32)
        want, rstate = r_decode(rc, rlp, jnp.asarray(x), rstate, rc.norm_eps)
        got, out_state = p_ssd.ssd_block_decode(pc, plp, torch.from_numpy(x),
                                                pstate, pc.norm_eps)
        assert out_state is pstate  # written in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32,
                                   err_msg=f"step {step}")
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(pstate[k].numpy(),
                                       np.asarray(rstate[k]), **F32)
    assert pstate["ssm"].data_ptr() == ssm_ptr


def test_ops_ssd_scan_takes_the_plain_version_on_cpu_tensors():
    args = _t(_inputs(2, 64, 4, 16, 32, seed=10))
    before = sk.ssd_scan.launches
    got = ops.ssd_scan(*args, chunk=16)
    assert torch.equal(got, sk.ssd_scan_ref(*args, 16)[0])
    assert sk.ssd_scan.launches == before


def test_sequence_not_a_multiple_of_chunk_raises():
    import jax.numpy as jnp
    from repro.models.ssd import ssd_chunked as r_chunked
    arrs = _inputs(1, 40, 2, 16, 16, seed=11)
    with pytest.raises(ValueError, match="multiple of chunk"):
        sk.ssd_scan_ref(*_t(arrs), 16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd_scan(*_t(arrs), chunk=16)
    with pytest.raises(AssertionError):  # the reference asserts it
        r_chunked(*(jnp.asarray(a) for a in arrs), 16)


def test_cuda_wrapper_refuses_cpu_tensors():
    args = _t(_inputs(1, 32, 2, 16, 16))
    before = sk.ssd_scan.launches
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd_scan(*args, chunk=16)
    assert sk.ssd_scan.launches == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


# test shapes in f32, the bf16 case, the reduced models' chunk of 8, and
# both full-width prefill calls (mamba2-1.3b, zamba2-2.7b) in both dtypes,
# B and C in f32; then the bf16 kernels' edges (chunk 8, 16, 64, hd 16 and
# 32, ds 16 and 128) and both prefill calls with B and C in bf16, strided
# as the model passes them (halves of one (b, s, 2 ds) projection)
CARD_CASES = ([(shape, torch.float32, "f32") for shape in SHAPES]
              + [((1, 128, 4, 16, 32, 32), torch.bfloat16, "f32"),
                 ((2, 16, 8, 16, 16, 8), torch.float32, "f32"),
                 ((2, 512, 4, 64, 128, 128), torch.float32, "f32")]
              + [((2, 4096, nh, 64, ds, 256), dt, "f32")
                 for nh, ds in ((64, 128), (80, 64))
                 for dt in (torch.float32, torch.bfloat16)]
              + [(shape, torch.bfloat16, "bf16_strided")
                 for shape in ((2, 64, 4, 16, 16, 8),
                               (2, 128, 4, 32, 128, 16),
                               (1, 256, 8, 16, 128, 64),
                               (1, 256, 4, 32, 16, 64),
                               (2, 4096, 64, 64, 128, 256),
                               (2, 4096, 80, 64, 64, 256))])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,bc", CARD_CASES)
def test_cuda_kernel_matches_plain_version(cuda, shape, dtype, bc):
    *dims, chunk = shape
    args = _t(_inputs(*dims, seed=12), dtype, cuda)
    if bc == "bf16_strided":
        x, dt, A, B, C = args
        B, C = torch.cat([B, C], -1).bfloat16().chunk(2, dim=-1)
        assert not B.is_contiguous()
        args = (x, dt, A, B, C)
    before = sk.ssd_scan.launches
    got = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.ssd_scan.launches == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    if dtype == torch.float32:
        want = sk.ssd_scan_ref(*args, chunk)[0]
        torch.testing.assert_close(got, want, **CHUNKED)
        if dims[1] <= 512:  # the recurrence steps once per token
            torch.testing.assert_close(got, sk.ssd_ref(*args), **ORACLE)
    else:
        oracle = sk.ssd_ref(args[0].float(), *args[1:])
        torch.testing.assert_close(got.float(), oracle, **BF16)
        want = sk.ssd_scan_ref(args[0].float(), *args[1:], chunk)[0]
        rel = float((got.float() - want).norm() / want.norm())
        assert rel <= BF16_REL, rel


@pytest.mark.cuda
def test_cuda_kernel_reads_strided_bf16_b_and_c(cuda):
    """B and C as the model passes them: bf16 halves of one (b, s, 2 ds)
    projection, so their rows are strided."""
    x, dt, A, B, C = _t(_inputs(2, 256, 8, 32, 64, seed=13), device=cuda)
    bc = torch.cat([B, C], -1).bfloat16()
    Bv, Cv = bc.chunk(2, dim=-1)
    assert not Bv.is_contiguous()
    got = sk.ssd_scan(x, dt, A, Bv, Cv, chunk=64)
    want = sk.ssd_scan_ref(x, dt, A, Bv, Cv, 64)[0]
    torch.testing.assert_close(got, want, **CHUNKED)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["chunk_ragged", "chunk_size", "head_dim",
                                 "float16", "dt_bf16", "mixed_bc",
                                 "misaligned_bf16_b"])
def test_cuda_kernel_rejects_what_it_does_not_take(cuda, bad):
    hd = 48 if bad == "head_dim" else 16
    x, dt, A, B, C = _t(_inputs(1, 96, 2, hd, 16, seed=14), device=cuda)
    chunk = {"chunk_ragged": 64, "chunk_size": 48}.get(bad, 32)
    if bad == "float16":
        x = x.half()
    elif bad == "dt_bf16":
        dt = dt.bfloat16()
    elif bad == "mixed_bc":
        B = B.bfloat16()
    elif bad == "misaligned_bf16_b":  # a view one element (2 bytes) in
        x, C = x.bfloat16(), C.bfloat16()
        B = torch.cat([B, B[..., :1]], -1).bfloat16()[..., 1:]
        assert B.data_ptr() % 16 == 2
    before = sk.ssd_scan.launches
    with pytest.raises(ValueError):
        sk.ssd_scan(x, dt, A, B, C, chunk=chunk)
    assert sk.ssd_scan.launches == before
