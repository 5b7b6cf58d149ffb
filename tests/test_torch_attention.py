"""The port's flash_attention: its plain version against the Pallas kernel
(interpret mode) on the CPU, the port's blocked attention against the
reference's, the CPU dispatch of ``ops.flash_attention``, and the CUDA
kernel against its plain version on a card (marked ``cuda``, skipped
without one).

The card's machine has no JAX, so this file imports JAX and the
reference only inside the tests that compare with them:

    python -m pytest -q -m cuda tests/test_torch_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.layers import blocked_attention

# the reference's kernel tolerances (tests/test_kernels.py)
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}

CAUSAL_SHAPES = [
    (1, 128, 4, 4, 32),    # MHA
    (2, 256, 4, 2, 64),    # GQA 2:1
    (1, 256, 8, 1, 64),    # MQA
    (2, 192, 6, 3, 16),    # padding path (192 % 128 != 0)
]


def _qkv(b, s, h, hkv, d, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (rng.standard_normal((b, s, h, d), np.float32),
            rng.standard_normal((b, sk, hkv, d), np.float32),
            rng.standard_normal((b, sk, hkv, d), np.float32))


def _pallas(arrs, dtype, **kw):
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    out = ref_ops.flash_attention(
        *(jnp.asarray(a).astype(jd) for a in arrs), interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port_ref(arrs, dtype, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in arrs]
    return fa.flash_attention_ref(*t, **kw).float().numpy()


@pytest.mark.parametrize("shape", CAUSAL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_matches_pallas_causal(shape, dtype):
    arrs = _qkv(*shape)
    np.testing.assert_allclose(_port_ref(arrs, dtype, causal=True),
                               _pallas(arrs, dtype, causal=True),
                               **TOL[dtype])


@pytest.mark.parametrize("window", [32, 64, 100])
def test_plain_version_matches_pallas_sliding_window(window):
    arrs = _qkv(1, 256, 2, 2, 32, seed=1)
    np.testing.assert_allclose(
        _port_ref(arrs, torch.float32, causal=True, window=window),
        _pallas(arrs, torch.float32, causal=True, window=window,
                block_q=64, block_k=64),
        **TOL[torch.float32])


def test_plain_version_matches_pallas_head_dim_128_gqa_padded():
    """qwen2-1.5b's heads (12 query, 2 kv, head_dim 128) at a length the
    kernel pads (130 % 128 != 0)."""
    arrs = _qkv(1, 130, 12, 2, 128, seed=2)
    np.testing.assert_allclose(_port_ref(arrs, torch.float32),
                               _pallas(arrs, torch.float32),
                               **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_matches_pallas_head_dim_80(dtype):
    """zamba2-2.7b's shared block: 32 heads of 2560 / 32 = 80, at a length
    the kernel pads (200 % 128 != 0) and with a window."""
    arrs = _qkv(1, 200, 4, 4, 80, seed=7)
    for window in (0, 64):
        np.testing.assert_allclose(
            _port_ref(arrs, dtype, causal=True, window=window),
            _pallas(arrs, dtype, causal=True, window=window), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_matches_blocked_attention_head_dim_96(dtype):
    """phi-3-vision-4.2b's heads: 3072 / 32 = 96, causal with and without
    a window, at a length the kernel pads, against the reference's
    blocked_attention (its model path) and the Pallas kernel."""
    import jax.numpy as jnp
    from repro.models.layers import blocked_attention as ref_blocked
    arrs = _qkv(1, 200, 4, 2, 96, seed=9)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for window in (0, 64):
        got = _port_ref(arrs, dtype, causal=True, window=window)
        want = ref_blocked(*(jnp.asarray(a).astype(jd) for a in arrs),
                           causal=True, window=window)
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                                   **TOL[dtype])
        np.testing.assert_allclose(
            got, _pallas(arrs, dtype, causal=True, window=window),
            **TOL[dtype])


@pytest.mark.parametrize("s,window", [(512, 0), (512, 64), (192, 0)])
def test_blocked_attention_matches_reference(s, window):
    """block_q 128: S 512 runs the blocked loop (with the window's KV
    slice at window 64), S 192 the single-block fallback."""
    import jax.numpy as jnp
    from repro.models.layers import blocked_attention as ref_blocked
    arrs = _qkv(2, s, 4, 2, 32, seed=3)
    want = ref_blocked(*map(jnp.asarray, arrs), causal=True, window=window,
                       block_q=128)
    got = blocked_attention(*map(torch.from_numpy, arrs), causal=True,
                            window=window, block_q=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # the kernel's plain version computes the same function
    np.testing.assert_allclose(
        _port_ref(arrs, torch.float32, causal=True, window=window),
        got.numpy(), atol=1e-4, rtol=1e-4)


def test_decode_attention_matches_reference():
    """One query against a cache whose valid length differs per row."""
    import jax.numpy as jnp
    from repro.models.layers import decode_attention as ref_decode
    from repro_torch.models.layers import decode_attention
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 8, 32), np.float32)
    kc = rng.standard_normal((3, 20, 2, 32), np.float32)
    vc = rng.standard_normal((3, 20, 2, 32), np.float32)
    lens = np.array([1, 12, 20], np.int32)
    want = ref_decode(*map(jnp.asarray, (q, kc, vc, lens)))
    got = decode_attention(*map(torch.from_numpy, (q, kc, vc, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[
        torch.float32])


def test_ops_flash_attention_takes_the_plain_version_on_cpu_tensors():
    q, k, v = map(torch.from_numpy, _qkv(1, 100, 4, 2, 16, seed=4))
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True, window=24)
    assert torch.equal(got, fa.flash_attention_ref(q, k, v, causal=True,
                                                   window=24))
    assert fa.flash_attention.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = map(torch.from_numpy, _qkv(1, 64, 2, 2, 32))
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_dtype_names_a_kernel_of_the_source(dtype):
    """The kernel a dtype launches at every head dim is defined in the CUDA
    source, and its name starts with flash_fwd, the name chip_smoke.py
    sums the prefill's attention time by."""
    src = (fa._build.CSRC / "flash_attention.cu").read_text()
    name = fa.KERNELS[dtype]
    assert dtype in fa.DTYPES and name.startswith("flash_fwd")
    assert f"{name}(" in src and f"{name}<D>" in src


def test_non_causal_padded_kv_raises():
    """The Pallas kernel still refuses a non-causal call whose Sk its kv
    block would pad; the port takes it (whisper's Sk = 1500) and gives the
    reference's blocked_attention, in both dtypes."""
    import jax.numpy as jnp
    from repro.models.layers import blocked_attention as ref_blocked
    arrs = _qkv(1, 192, 2, 2, 32)
    with pytest.raises(NotImplementedError):
        _pallas(arrs, torch.float32, causal=False)
    for dtype in (torch.float32, torch.bfloat16):
        jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        want = np.asarray(ref_blocked(
            *(jnp.asarray(a).astype(jd) for a in arrs),
            causal=False).astype(jnp.float32))
        got = ops.flash_attention(*(torch.from_numpy(a).to(dtype)
                                    for a in arrs), causal=False)
        np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
        np.testing.assert_allclose(_port_ref(arrs, dtype, causal=False),
                                   want, **TOL[dtype])
    # a whole number of kv blocks: the Pallas kernel's own case
    arrs = _qkv(1, 256, 2, 2, 32)
    np.testing.assert_allclose(_port_ref(arrs, torch.float32, causal=False),
                               _pallas(arrs, torch.float32, causal=False),
                               **TOL[torch.float32])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


CARD_CASES = ([(s, dt, 0, None) for s in CAUSAL_SHAPES
               for dt in (torch.float32, torch.bfloat16)]
              + [((1, 256, 2, 2, 32), torch.float32, w, None)
                 for w in (32, 64, 100)]
              + [((1, 130, 12, 2, 128), torch.bfloat16, 0, None),
                 ((1, 200, 4, 4, 80), torch.float32, 64, None),
                 ((2, 320, 4, 4, 80), torch.bfloat16, 0, None),
                 ((1, 100, 4, 2, 64), torch.float32, 0, 60),    # Sq > Sk
                 ((1, 100, 4, 2, 64), torch.bfloat16, 16, 160)]
              # the bf16 TMA kernel's edges: Sq not a multiple of its
              # 128-row q-tile (small and at prefill length)
              + [((1, 200, 4, 2, 128), torch.bfloat16, 0, None),
                 ((1, 200, 4, 4, 80), torch.bfloat16, 0, None),
                 ((1, 4160, 2, 1, 128), torch.bfloat16, 0, None),
                 ((1, 4160, 2, 2, 80), torch.bfloat16, 0, None)]
              # Sq > Sk, and Sk shorter than one 128-row kv tile: TMA's
              # zero fill stands in for the rows >= Sk
              + [((1, 200, 4, 2, 128), torch.bfloat16, 0, 100),
                 ((1, 200, 4, 4, 80), torch.bfloat16, 0, 100),
                 ((1, 200, 4, 2, 128), torch.bfloat16, 0, 60),
                 ((1, 50, 4, 4, 80), torch.bfloat16, 0, 60)]
              # windows narrower than a kv tile
              + [((1, 300, 4, 2, d), torch.bfloat16, w, None)
                 for d in (80, 128) for w in (16, 100)]
              # GQA groups 1, 6 and 16
              + [((1, 256, 4, 4, 128), torch.bfloat16, 0, None),
                 ((1, 256, 6, 1, 128), torch.bfloat16, 0, None),
                 ((1, 256, 16, 1, 64), torch.bfloat16, 0, None),
                 ((1, 256, 16, 1, 64), torch.float32, 0, None)]
              # the small head dims, with windows and Sk > Sq
              + [((1, 300, 2, 1, 16), torch.bfloat16, 100, None),
                 ((1, 300, 2, 2, 32), torch.bfloat16, 16, None),
                 ((1, 300, 4, 2, 64), torch.bfloat16, 100, 340)]
              # head dim 96 (phi-3-vision-4.2b): ragged Sq, a window,
              # Sq > Sk, and at prefill length
              + [((1, 200, 4, 2, 96), dt, w, None)
                 for dt in (torch.float32, torch.bfloat16) for w in (0, 64)]
              + [((1, 200, 4, 4, 96), torch.bfloat16, 0, 100),
                 ((1, 4160, 2, 2, 96), torch.bfloat16, 0, None)])

# non-causal calls whose Sk no kv tile divides: whisper-medium's encoder
# (Sq = Sk = 1500) and cross-attention (Sq 448 against Sk 1500), head
# dim 96, Sk under one tile
NON_CAUSAL_CASES = [((1, 1500, 4, 4, 64), dt, None)
                    for dt in (torch.float32, torch.bfloat16)] + \
    [((1, 448, 4, 4, 64), torch.bfloat16, 1500),
     ((1, 448, 4, 4, 64), torch.float32, 1500),
     ((1, 300, 4, 2, 96), torch.bfloat16, 1000),
     ((1, 100, 4, 4, 96), torch.float32, 60),
     ((1, 40, 2, 1, 128), torch.bfloat16, 70)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,window,sk", CARD_CASES)
def test_cuda_kernel_matches_plain_version(cuda, shape, dtype, window, sk):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(*shape, seed=5, sk=sk))
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,sk", NON_CAUSAL_CASES)
def test_cuda_kernel_matches_plain_version_non_causal(cuda, shape, dtype,
                                                      sk):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(*shape, seed=6, sk=sk))
    got = ops.flash_attention(q, k, v, causal=False)
    want = fa.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 96, 128])
@pytest.mark.parametrize("layout", ["fused_qkv", "bhsd"])
def test_cuda_kernel_reads_strided_views(cuda, layout, d):
    """q, k, v as views the kernel's tensor maps read through their
    strides: the three slices of one fused (B, S, 3, H, D) projection, and
    (B, H, S, D) tensors transposed to (B, S, H, D)."""
    b, s, h = 2, 300, 4
    g = torch.Generator(device="cuda").manual_seed(8)
    if layout == "fused_qkv":
        qkv = torch.randn(b, s, 3, h, d, device=cuda, generator=g)
        q, k, v = qkv.to(torch.bfloat16).unbind(2)
    else:
        q, k, v = (torch.randn(b, h, s, d, device=cuda, generator=g)
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=True, window=100)
    want = fa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True, window=100)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_info_has_no_spills(cuda, dtype):
    for d in fa.HEAD_DIMS:
        info = fa.kernel_info(dtype, d)
        assert info["kernel"] == fa.KERNELS[dtype]
        assert 0 < info["registers"] <= 255 and info["local_bytes"] == 0, \
            (d, info)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["head_dim", "float16", "stride",
                                 "no_keys"])
def test_cuda_kernel_rejects_what_it_does_not_take(cuda, bad):
    d = 48 if bad == "head_dim" else 32
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _qkv(
        1, 64, 2, 2, d, sk=0 if bad == "no_keys" else None))
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "stride":
        q = q.transpose(1, 3).contiguous().transpose(1, 3)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, causal=bad != "no_keys")
    assert fa.flash_attention.launches == before
