"""The gradient of the port's flash_attention.

On the CPU: autograd through the plain version against ``jax.grad`` of the
reference's ``blocked_attention`` (which the reference trains through), the
backward kernels' formulas (``flash_attention_bwd_ref``) against autograd,
``FlashAttentionFn``'s plumbing with the plain versions in the kernels'
place, the bf16 dkdv kernel's GQA split (``dkdv_splits`` and its plain
version ``flash_bwd_dkdv_split_ref``), and that the kernels' build hash
covers the headers they include.  On a card (marked ``cuda``, skipped
without one): the two backward wrappers against autograd through the
plain version over a grid of shapes, the forward's LSE, a split call,
bitwise equal repeats, the kernels the profiler sees (``BWD_KERNELS``),
no spills, and the repaired fault -- a backward through
``ops.flash_attention`` reaches the kernels, and one through
``ops.ssd_scan`` reaches the scan's backward kernels:

    python -m pytest -q -m cuda tests/test_torch_flash_bwd.py

The card's machine has no JAX: it is imported inside the tests that use
it.
"""
import re
import shutil

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.obs.trace import kernel_base

# the reference's kernel tolerances (tests/test_kernels.py) on the CPU;
# 1e-4 for float32 gradients on the card, whose sums run over up to 4096
# rows in another order than the plain version's
F32_GRAD = dict(atol=2e-5, rtol=2e-5)
CARD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _arrays(b, s, h, hkv, d, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, h, d), (b, sk, hkv, d), (b, sk, hkv, d),
                       (b, s, h, d))]


def _plain_grads(q, k, v, do, **kw):
    """(out, dq, dk, dv) of autograd through the plain version."""
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = fa.flash_attention_ref(q, k, v, **kw)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    return out.detach(), dq, dk, dv


# ---------------------------------------------------------------------------
# CPU: the plain gradient against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,window", [
    ((1, 64, 4, 1, 64), 0),      # GQA 4:1
    ((2, 48, 6, 2, 64), 8),      # GQA 3:1, window 8
    ((1, 40, 4, 1, 128), 8),
    ((1, 32, 6, 2, 128), 0),
])
def test_plain_gradient_matches_jax_grad_of_blocked_attention(shape,
                                                              window):
    import jax
    import jax.numpy as jnp
    from repro.models.layers import blocked_attention
    q, k, v, do = _arrays(*shape, seed=1)

    def f(q, k, v):
        out = blocked_attention(q, k, v, causal=True, window=window)
        return jnp.sum(out * do)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _plain_grads(*map(torch.from_numpy, (q, k, v, do)),
                       causal=True, window=window)[1:]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_GRAD)


@pytest.mark.parametrize("shape,causal,window,sk", [
    ((1, 40, 4, 2, 96), True, 0, None),     # phi-3-vision's head dim
    ((2, 48, 4, 4, 96), True, 8, None),
    ((1, 150, 2, 2, 64), False, 0, None),   # whisper's encoder, ragged Sk
    ((1, 24, 2, 2, 64), False, 0, 150),     # its cross-attention
    ((1, 40, 4, 2, 96), False, 0, 70),
])
def test_plain_gradient_matches_jax_grad_head_dim_96_and_non_causal(
        shape, causal, window, sk):
    """The calls of the VLM and enc-dec families: head dim 96 and
    non-causal attention whose Sk is not a multiple of a kv block,
    against jax.grad of the reference's blocked_attention."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import blocked_attention
    q, k, v, do = _arrays(*shape, seed=9, sk=sk)

    def f(q, k, v):
        out = blocked_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(out * do)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _plain_grads(*map(torch.from_numpy, (q, k, v, do)),
                       causal=causal, window=window)[1:]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_GRAD)
    # and the kernels' formulas give the same gradient
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    out, lse = fa.flash_attention_lse_ref(qt, kt, vt, causal=causal,
                                          window=window)
    for g, w in zip(fa.flash_attention_bwd_ref(qt, kt, vt, out, dot, lse,
                                               causal=causal, window=window),
                    got):
        torch.testing.assert_close(g, w, **F32_GRAD)


@pytest.mark.parametrize("shape,window,sk", [
    ((1, 64, 4, 4, 32), 0, None),
    ((2, 48, 6, 2, 16), 8, None),
    ((1, 40, 6, 1, 80), 0, 24),     # Sq > Sk: every row still sees a key
    ((1, 24, 4, 2, 64), 5, 40),     # Sk > Sq
])
def test_kernel_formulas_match_autograd(shape, window, sk):
    q, k, v, do = map(torch.from_numpy, _arrays(*shape, seed=2, sk=sk))
    out, lse = fa.flash_attention_lse_ref(q, k, v, causal=True,
                                          window=window)
    torch.testing.assert_close(
        out, fa.flash_attention_ref(q, k, v, causal=True, window=window),
        rtol=0, atol=0)
    got = fa.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=True,
                                     window=window)
    want = _plain_grads(q, k, v, do, causal=True, window=window)[1:]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32_GRAD)


def test_kernel_formulas_give_rows_without_keys_no_gradient():
    """Sq > Sk + window leaves rows that see no key: the kernels' formulas
    give them (and what they would add to dk, dv) zero, never NaN."""
    q, k, v, do = map(torch.from_numpy, _arrays(1, 40, 2, 1, 16, seed=3,
                                                sk=8))
    out, lse = fa.flash_attention_lse_ref(q, k, v, causal=True, window=4)
    dq, dk, dv = fa.flash_attention_bwd_ref(q, k, v, out, do, lse,
                                            causal=True, window=4)
    assert all(torch.isfinite(x).all() for x in (dq, dk, dv))
    assert (dq[:, 11:] == 0).all()      # row 11 on sees no column < 8


def test_function_plumbing_with_plain_versions(monkeypatch):
    """FlashAttentionFn with the plain versions in the kernels' place: one
    forward with its LSE, one backward handed autograd's non-contiguous
    dO as it comes, and the gradients equal autograd's."""
    calls = []

    def fwd(q, k, v, *, causal, window):
        calls.append("fwd")
        return fa.flash_attention_lse_ref(q, k, v, causal=causal,
                                          window=window)

    def bwd(q, k, v, o, do, lse, *, causal, window):
        calls.append(("bwd", do.is_contiguous()))
        return fa.flash_attention_bwd_ref(q, k, v, o, do.contiguous(), lse,
                                          causal=causal, window=window)

    monkeypatch.setattr(fa, "_fwd", fwd)
    monkeypatch.setattr(fa, "_bwd", bwd)
    q, k, v, do = map(torch.from_numpy, _arrays(2, 32, 4, 2, 16, seed=4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.FlashAttentionFn.apply(*leaves, True, 6, True)
    assert out.grad_fn is not None
    # a transposed view as the incoming gradient
    do_t = do.transpose(1, 2).contiguous().transpose(1, 2)
    got = torch.autograd.grad(out, leaves, do_t)
    want = _plain_grads(q, k, v, do, causal=True, window=6)[1:]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32_GRAD)
    assert calls == ["fwd", ("bwd", False)]


def test_cpu_dispatch_is_differentiated_as_it_is():
    q, k, v, do = map(torch.from_numpy, _arrays(1, 16, 2, 1, 16, seed=5))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True, window=0)
    assert out.grad_fn is not None
    assert "FlashAttentionFn" not in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, do)
    want = _plain_grads(q, k, v, do, causal=True)[1:]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("fn", [fa.flash_bwd_dq, fa.flash_bwd_dkdv,
                                fa.flash_attention_with_lse])
def test_backward_wrappers_refuse_cpu_tensors(fn):
    q, k, v, do = map(torch.from_numpy, _arrays(1, 16, 2, 1, 16))
    lse = torch.zeros(1, 2, 16)
    args = {fa.flash_bwd_dq: (q, k, v, q, do, lse),
            fa.flash_bwd_dkdv: (q, k, v, do, lse, lse),
            fa.flash_attention_with_lse: (q, k, v)}[fn]
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)


@pytest.mark.parametrize("b,hkv,group,sk,want", [
    (2, 2, 6, 2048, 3),     # qwen2-1.5b's training call: 384 blocks
    (2, 2, 6, 4096, 2),     # its prefill call: 512 blocks
])
def test_dkdv_splits_at_qwen2_calls(b, hkv, group, sk, want):
    assert fa.dkdv_splits(b, hkv, group, sk) == want


@pytest.mark.parametrize("b,hkv,group,sk", [
    (1, 1, 6, 128), (1, 4, 8, 300), (4, 8, 4, 4096), (1, 32, 1, 4096),
    (2, 1, 12, 64), (1, 2, 16, 1000)])
def test_dkdv_splits_is_the_least_divisor_that_fills_the_card(b, hkv, group,
                                                              sk):
    s = fa.dkdv_splits(b, hkv, group, sk)
    blocks = b * hkv * -(-sk // fa.BWD_ROWS)
    least = fa.DKDV_BLOCKS_PER_SM * fa.H100_SMS
    assert group % s == 0
    assert s == group or blocks * s >= least
    assert all(blocks * r < least for r in range(1, s) if group % r == 0)


@pytest.mark.parametrize("splits", [1, 2, 3, 6])
def test_dkdv_split_ref_matches_the_kernel_formulas(splits):
    """Split float32 partials added in split order give the backward's dk
    and dv (GQA group 6, a window, Sq > Sk)."""
    q, k, v, do = map(torch.from_numpy, _arrays(2, 40, 12, 2, 16, seed=10,
                                                sk=32))
    out, lse = fa.flash_attention_lse_ref(q, k, v, causal=True, window=12)
    delta = torch.einsum("bqhd,bqhd->bhq", do, out)
    got = fa.flash_bwd_dkdv_split_ref(q, k, v, do, lse, delta,
                                      splits=splits, causal=True, window=12)
    want = fa.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=True,
                                      window=12)[1:]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32_GRAD)


def test_library_path_hashes_the_headers_a_source_includes(monkeypatch,
                                                          tmp_path):
    """An edited csrc/hopper.cuh names a new library for both attention
    sources (no stale build loads) and leaves a source that does not
    include it alone.  Reads files only: no nvcc."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("flash_attention", "flash_attention_bwd", "pid_update")
    before = {n: _build.library_path(n) for n in names}
    assert csrc / "hopper.cuh" in _build.sources("flash_attention_bwd")
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["flash_attention_bwd"] != before["flash_attention_bwd"]
    assert after["pid_update"] == before["pid_update"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernels_are_defined_in_the_source(dtype):
    """Every kernel name a backward wrapper launches (the names
    chip_smoke.py sums device time by) is a __global__ function of the
    source, and the bf16 names are not the scalar kernels'."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    defined = set(re.findall(
        r"__global__\s+void\s+__launch_bounds__\([^)]*\)\s+(flash_bwd_\w+)\(",
        src))
    names = [n for group in fa.BWD_KERNELS[dtype].values() for n in group]
    assert set(names) <= defined
    assert set(fa.BWD_KERNELS[dtype]) == {"flash_bwd_dq", "flash_bwd_dkdv"}
    if dtype == torch.bfloat16:
        assert not set(names) & {n for group in
                                 fa.BWD_KERNELS[torch.float32].values()
                                 for n in group}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


F32, BF16 = torch.float32, torch.bfloat16
# (B, S, H, Hkv, D), dtype, window, Sk (None: Sk = S)
CARD_CASES = ([((1, 128, 4, 4, 32), dt, 0, None) for dt in (F32, BF16)]
              + [((2, 256, 4, 2, 64), dt, 0, None) for dt in (F32, BF16)]
              + [((2, 192, 6, 3, 16), dt, 0, None) for dt in (F32, BF16)]
              + [((1, 200, 6, 2, 80), dt, w, None) for dt in (F32, BF16)
                 for w in (0, 24)]
              + [((1, 300, 12, 2, 128), dt, w, None) for dt in (F32, BF16)
                 for w in (0, 100)]
              + [((1, 256, 4, 2, 64), BF16, 0, 100),    # Sq > Sk
                 ((1, 100, 4, 2, 64), F32, 0, 60),
                 ((1, 100, 4, 2, 64), BF16, 16, 160),   # Sk > Sq
                 ((1, 300, 2, 2, 32), BF16, 16, None),
                 ((1, 256, 6, 1, 128), BF16, 0, None),  # GQA group 6
                 ((2, 1024, 12, 2, 128), BF16, 0, None),
                 ((2, 2048, 12, 2, 128), BF16, 0, None)]  # the training call
              # head dim 96 (phi-3-vision-4.2b), S not a multiple of 64
              + [((1, 200, 4, 2, 96), dt, w, None) for dt in (F32, BF16)
                 for w in (0, 24)]
              + [((1, 2048, 32, 32, 96), BF16, 0, None)])
# non-causal, Sk not a multiple of the 64-row tiles: whisper-medium's
# encoder (Sq = Sk = 1500) and cross-attention (Sq 448 against 1500)
NON_CAUSAL_CASES = [((1, 1500, 4, 4, 64), dt, None) for dt in (F32, BF16)] \
    + [((1, 448, 4, 4, 64), dt, 1500) for dt in (F32, BF16)] \
    + [((1, 300, 4, 2, 96), BF16, 1000), ((1, 100, 4, 4, 96), F32, 60)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,window,sk", CARD_CASES)
def test_cuda_backward_matches_plain_autograd(cuda, shape, dtype, window,
                                              sk):
    q, k, v, do = (torch.from_numpy(a).to(cuda, dtype)
                   for a in _arrays(*shape, seed=6, sk=sk))
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True,
                                           window=window)
    before = fa.flash_bwd_dq.launches, fa.flash_bwd_dkdv.launches
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True,
                                 window=window)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkdv.launches) == (
        before[0] + 1, before[1] + 1)
    _, want_lse = fa.flash_attention_lse_ref(q, k, v, causal=True,
                                             window=window)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)
    want = _plain_grads(q, k, v, do, causal=True, window=window)[1:]
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,sk", NON_CAUSAL_CASES)
def test_cuda_backward_matches_plain_autograd_non_causal(cuda, shape, dtype,
                                                         sk):
    """No dk or dv row >= Sk is written, and the rows TMA zero-fills past
    Sk read as masked, not as scores of 0."""
    q, k, v, do = (torch.from_numpy(a).to(cuda, dtype)
                   for a in _arrays(*shape, seed=8, sk=sk))
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=False)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=False)
    want = _plain_grads(q, k, v, do, causal=False)[1:]
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **CARD_TOL[dtype])


@pytest.mark.cuda
def test_cuda_rows_without_keys_get_no_gradient(cuda):
    q, k, v, do = (torch.from_numpy(a).to(cuda, BF16)
                   for a in _arrays(1, 128, 2, 2, 32, seed=7, sk=32))
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True, window=16)
    assert torch.isinf(lse[:, :, 47:]).all() and \
        torch.isfinite(lse[:, :, :47]).all()
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True,
                                        window=16)
    assert all(torch.isfinite(x).all() for x in (dq, dk, dv))
    assert (dq[:, 47:] == 0).all()


@pytest.mark.cuda
def test_cuda_ops_flash_attention_carries_autograd(cuda):
    """The repaired fault: a backward through ops.flash_attention on the
    card reaches the two backward kernels and gives the plain version's
    gradients; under no_grad the forward is one launch and equal to the
    kernel's output bit for bit."""
    q, k, v, do = (torch.from_numpy(a).to(cuda, BF16)
                   for a in _arrays(2, 256, 12, 2, 128, seed=8))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkdv.launches)
    out = ops.flash_attention(*leaves, causal=True, window=0)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkdv.launches) == tuple(n + 1 for n in before)
    want = _plain_grads(q, k, v, do, causal=True)[1:]
    for g, w in zip(got, want):
        assert float(g.float().abs().max()) > 0
        torch.testing.assert_close(g.float(), w.float(), **CARD_TOL[BF16])
    with torch.no_grad():
        served = ops.flash_attention(q, k, v, causal=True)
    assert served.grad_fn is None
    assert torch.equal(served, fa.flash_attention(q, k, v, causal=True))


@pytest.mark.cuda
def test_cuda_ops_ssd_scan_carries_autograd(cuda):
    """A backward through ops.ssd_scan on the card reaches the scan's
    backward kernels and gives the plain version's gradients; under
    no_grad the forward is one launch with no autograd node."""
    from repro_torch.kernels import ssd_scan as sk
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(1, 64, 2, 16, device=cuda, generator=g)
    dt = torch.nn.functional.softplus(
        torch.randn(1, 64, 2, device=cuda, generator=g))
    A = -torch.exp(torch.randn(2, device=cuda, generator=g))
    B, C = torch.randn(2, 1, 64, 16, device=cuda, generator=g)
    dy = torch.randn(x.shape, device=cuda, generator=g)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    before = (sk.ssd_scan.launches, sk.ssd_scan_bwd.launches)
    y = ops.ssd_scan(*leaves, chunk=16)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (sk.ssd_scan.launches, sk.ssd_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want = sk.ssd_scan_bwd_ref(x, dt, A, B, C, dy, 16)[:5]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        served = ops.ssd_scan(*leaves, chunk=16)
    assert served.grad_fn is None
    assert sk.ssd_scan_bwd.launches == before[1] + 1


def _card_inputs(cuda, shape, dtype, seed, sk=None):
    q, k, v, do = (torch.from_numpy(a).to(cuda, dtype)
                   for a in _arrays(*shape, seed=seed, sk=sk))
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
    return q, k, v, out, do, lse


@pytest.mark.cuda
def test_cuda_split_dkdv_matches_plain_autograd(cuda):
    """A bf16 call that splits each GQA group over six blocks (and sums
    their f32 partials) gives the plain version's gradients."""
    shape = (1, 192, 6, 1, 64)
    assert fa.dkdv_splits(1, 1, 6, 192) == 6
    q, k, v, out, do, lse = _card_inputs(cuda, shape, BF16, seed=12)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    want = _plain_grads(q, k, v, do, causal=True)[1:]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **CARD_TOL[BF16])


@pytest.mark.cuda
def test_cuda_backward_is_bitwise_deterministic(cuda):
    """No atomics: two runs at the training call (dkdv split 3) give the
    same bits."""
    q, k, v, out, do, lse = _card_inputs(cuda, (2, 2048, 12, 2, 128), BF16,
                                         seed=13)
    first = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    second = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("key,want", [
    ("void (anonymous namespace)::flash_bwd_dq_wgmma<128>(CUtensorMap_st, "
     "CUtensorMap_st, (anonymous namespace)::BwdArgs, int)",
     "flash_bwd_dq_wgmma"),
    ("void (anonymous namespace)::flash_bwd_dkdv_sum(float const*, "
     "__nv_bfloat16*, __nv_bfloat16*, long long, int)",
     "flash_bwd_dkdv_sum"),
    ("void (anonymous namespace)::flash_bwd_dkdv<64, float>(float const*, "
     "float const*)", "flash_bwd_dkdv"),
])
def test_kernel_base_reads_the_name_the_profiler_gives(key, want):
    """The name a wrapper's device time is summed by: never a substring,
    so flash_bwd_dkdv_sum is not counted as flash_bwd_dkdv."""
    assert kernel_base(key) == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_backward_launches_the_named_kernels(cuda, dtype):
    """The profiler's kernels of one backward are exactly the dtype's
    BWD_KERNELS: in bf16 the wgmma kernels and, at a split call, the sum;
    the scalar kernels only for float32."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, out, do, lse = _card_inputs(cuda, (2, 256, 4, 2, 64), dtype,
                                         seed=14)
    assert fa.dkdv_splits(2, 2, 2, 256) == 2
    torch.cuda.synchronize()
    for _ in range(3):  # CUPTI now and then delivers no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
            torch.cuda.synchronize()
        seen = {kernel_base(e.key) for e in prof.key_averages()
                if "flash_bwd" in e.key}
        if seen:
            break
    want = {n for group in fa.BWD_KERNELS[dtype].values() for n in group}
    assert seen == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_bwd_kernel_info_has_no_spills(cuda, dtype):
    for d in fa.HEAD_DIMS:
        info = fa.bwd_kernel_info(dtype, d)
        assert set(info) == {n for group in fa.BWD_KERNELS[dtype].values()
                             for n in group}
        for name, x in info.items():
            assert 0 < x["registers"] <= 255 and x["local_bytes"] == 0, \
                (d, name, x)
