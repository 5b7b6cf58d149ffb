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
    q, k, v = map(torch.from_numpy, _qkv(1, 192, 2, 2, 32))
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, v, causal=False)
    with pytest.raises(NotImplementedError):
        fa.flash_attention_ref(q, k, v, causal=False)
    # a whole number of kv blocks is fine without the causal mask
    q, k, v = map(torch.from_numpy, _qkv(1, 256, 2, 2, 32))
    out = ops.flash_attention(q, k, v, causal=False)
    assert out.shape == q.shape and torch.isfinite(out).all()


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
                 ((1, 300, 4, 2, 64), torch.bfloat16, 100, 340)])


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
@pytest.mark.parametrize("d", [80, 128])
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
                                 "non_causal_padded"])
def test_cuda_kernel_rejects_what_it_does_not_take(cuda, bad):
    d = 48 if bad == "head_dim" else 32
    s = 192 if bad == "non_causal_padded" else 64
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _qkv(1, s, 2, 2, d))
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "stride":
        q = q.transpose(1, 3).contiguous().transpose(1, 3)
    before = fa.flash_attention.launches
    err = NotImplementedError if bad == "non_causal_padded" else ValueError
    with pytest.raises(err):
        fa.flash_attention(q, k, v, causal=bad != "non_causal_padded")
    assert fa.flash_attention.launches == before
