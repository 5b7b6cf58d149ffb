"""The registered long shapes on the CPU, against ``repro``: RoPE at
positions up to 524,287 (``long_500k``'s last), decode steps from a deep
cache -- ``cur`` 32,760 on a 32,768-position cache (``decode_32k``) and
524,280 (``long_500k``) on the SSM state and the 4,096-slot rings of the
sliding-window archs -- and the kernels' plain versions called in pieces,
as the card checks the kernels at calls too long for them whole: the
attention on bands of query rows, the scan on segments chained through
``initial_state`` and on subsets of its heads.

The models are the reduced configs (2 layers, width 64); the deep caches
are filled with seeded values in the state a long prompt leaves, made in
the reference's layout and carried across by ``convert.decode_cache``.
Tolerances are the reference's own: float32 logits 1e-4, ``cur`` and
``pos_buf`` exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU
from test_torch_models import F32, _both
from repro.configs import get_arch as r_arch, list_archs
from repro.kernels.ref import attention_ref as r_attention_ref
from repro.models import build_model as r_build
from repro.models.layers import apply_rope as r_apply_rope
from repro.models.layers import rope_freqs as r_rope_freqs
from repro.models.ssd import ssd_chunked as r_ssd_chunked
from repro_torch import convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as sk
from repro_torch.models import build_model as p_build
from repro_torch.models.layers import apply_rope as p_apply_rope
from repro_torch.models.layers import rope_freqs as p_rope_freqs

LONG = 524_288       # long_500k's sequence
DEEP = 32_768        # decode_32k's
ROPE_POSITIONS = (0, 1, 4_095, 4_096, 32_760, 32_767, 131_071,
                  524_280, 524_286, 524_287)
# float32 sin and cos of the same angle in two libraries: an ulp or two
ROPE_TOL = dict(atol=2e-6, rtol=1e-6)
STEPS = 12           # decode steps: past the ring's wrap at 524,280


def _rotary():
    """(head_dim, theta) of every arch with rotary attention, at full
    width and reduced."""
    pairs = set()
    for name in list_archs():
        for cfg in (r_arch(name), r_arch(name).reduced()):
            if cfg.family in ("dense", "moe", "hybrid", "vlm"):
                pairs.add((cfg.resolved_head_dim, float(cfg.rope_theta)))
    return sorted(pairs)


ROTARY = _rotary()


@pytest.mark.parametrize("head_dim,theta", ROTARY)
def test_rope_freqs_equal_the_references_bit_for_bit(head_dim, theta):
    """The frequencies the reference's compiled models use (XLA folds
    them in float64 and rounds once): the port's float32 pow and
    reciprocal missed them by an ulp in up to 25 of 64 entries (head dim
    128, theta 1e6), an angle error that grows with the position."""
    want = np.asarray(jax.jit(lambda: r_rope_freqs(head_dim, theta))())
    got = p_rope_freqs(head_dim, theta).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("head_dim,theta", ROTARY)
def test_apply_rope_matches_reference_at_deep_positions(head_dim, theta):
    """RoPE at positions up to 524,287 against the reference's compiled
    apply_rope (as its forward and decode step run it)."""
    rng = np.random.default_rng(head_dim)
    pos = np.array(ROPE_POSITIONS, np.int32)[None]                # (1, S)
    x = rng.standard_normal((1, pos.shape[1], 3, head_dim)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda x, p: r_apply_rope(x, p, theta))(
        jnp.asarray(x), jnp.asarray(pos)))
    got = p_apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                       theta).numpy()
    np.testing.assert_allclose(got, want, **ROPE_TOL)


# ---------------------------------------------------------------------------
# decode from a deep cache
# ---------------------------------------------------------------------------


def _deep_cache(rm, cfg, cur: int, total: int, seed: int) -> dict:
    """The reference's ``init_cache(1, total)`` in the state a prompt of
    ``cur`` tokens leaves, with seeded values: every K/V slot of a
    position before ``cur`` (the ring's last ``window`` positions, each
    at its slot ``p % slots``) and its ``pos_buf`` entry, the SSM state
    and the conv window; numpy, with ``cur`` an int32."""
    rng = np.random.default_rng(seed)
    cache = jax.tree.map(np.array, rm.init_cache(1, total))
    if "pos_buf" in cache:
        slots = cache["pos_buf"].shape[0]
        pos = np.arange(max(0, cur - slots), cur)
        cache["pos_buf"][pos % slots] = pos
        filled = np.zeros(slots, bool)
        filled[pos % slots] = True
        for name in ("k", "v"):
            kv = cache[name]
            kv[:, :, filled] = 0.5 * rng.standard_normal(
                kv[:, :, filled].shape)
    if "ssm" in cache:
        cache["ssm"][...] = 0.1 * rng.standard_normal(cache["ssm"].shape)
        cache["conv"][...] = 0.5 * rng.standard_normal(cache["conv"].shape)
    cache["cur"] = np.int32(cur)
    return cache


def _decode_from(arch, cur, total, **over):
    """STEPS decode steps of both packages from the same deep cache: each
    step's logits at F32, then the whole cache (``cur`` and ``pos_buf``
    exact)."""
    rc, pc, rp, pp = _both(arch, **over)
    rm = r_build(rc, compute_dtype=jnp.float32)
    pm = p_build(pc, compute_dtype=torch.float32, device=CPU)
    rcache = _deep_cache(rm, rc, cur, total, seed=cur % 1000)
    pcache = convert.decode_cache(rcache, CPU)
    assert pcache["cur"] == cur
    rcache = jax.tree.map(jnp.asarray, rcache)
    rstep = jax.jit(rm.decode_step)      # as the reference's serve runs it
    tok = (np.arange(STEPS) * 37 + 5) % rc.vocab_size
    for i in range(STEPS):
        rl, rcache = rstep(rp, rcache, jnp.asarray(tok[i:i + 1]))
        pl, pcache = pm.decode_step(pp, pcache,
                                    torch.from_numpy(tok[i:i + 1]))
        np.testing.assert_allclose(
            pl.numpy()[:, :rc.vocab_size],
            np.asarray(rl)[:, :rc.vocab_size], **F32,
            err_msg=f"{arch} step {i} at cur {cur + i}")
    assert pcache["cur"] == int(rcache["cur"]) == cur + STEPS
    assert set(pcache) == set(rcache)
    for k in set(pcache) - {"cur", "pos_buf"}:
        np.testing.assert_allclose(pcache[k].numpy(), np.asarray(rcache[k]),
                                   **F32, err_msg=k)
    if "pos_buf" in rcache:
        np.testing.assert_array_equal(pcache["pos_buf"].numpy(),
                                      np.asarray(rcache["pos_buf"]))
    return rc, pcache


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "yi-9b"])
def test_decode_from_cur_32760_on_a_32k_cache(arch):
    """decode_32k's cache, 8 positions short of full: the steps fill it,
    then wrap onto position 0's slot as the reference's ring does."""
    rc, cache = _decode_from(arch, DEEP - 8, DEEP)
    assert cache["k"].shape[2] == DEEP
    assert cache["pos_buf"][DEEP - 1] == DEEP - 1


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b",
                                  "mixtral-8x22b"])
def test_decode_from_cur_524280(arch):
    """long_500k's decode: the SSM state (no positions), and the
    4,096-slot rings of zamba2-2.7b's shared attention and mixtral's
    layers (the published window on the reduced width), whose slot 4,088
    at 524,280 wraps to 0 within the steps."""
    over = {} if arch == "mamba2-1.3b" else {
        "sliding_window": r_arch(arch).sliding_window}
    rc, cache = _decode_from(arch, LONG - 8, LONG, **over)
    if arch != "mamba2-1.3b":
        slots = rc.sliding_window
        assert cache["k"].shape[2] == slots == 4096
        pos = cache["pos_buf"].numpy()
        last = LONG - 8 + STEPS - 1
        assert pos.max() == last and pos.min() == last - slots + 1
        assert pos[last % slots] == last


# ---------------------------------------------------------------------------
# the plain versions in pieces
# ---------------------------------------------------------------------------


def _attn_inputs(b, s, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, n, d)).astype(np.float32)
                 for n in (h, hkv, hkv))


@pytest.mark.parametrize("window", [0, 48])
def test_flash_plain_version_on_row_bands_equals_the_whole_call(window):
    """Bands of query rows (the first, a middle one, the last) against
    the keys before each band's end -- from the window's first visible
    column where there is one -- give the whole call's rows, in the
    port's plain version and the reference's attention_ref."""
    q, k, v = _attn_inputs(2, 300, 6, 2, 32)
    whole = fa.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, window=window).numpy()
    want = np.asarray(r_attention_ref(*map(jnp.asarray, (q, k, v)),
                                      causal=True, window=window))
    np.testing.assert_allclose(whole, want, **F32)
    for r0, r1 in ((0, 64), (100, 228), (236, 300)):
        c0 = max(0, r0 - window + 1) if window else 0
        band = fa.flash_attention_ref(
            torch.from_numpy(q[:, r0:r1]), torch.from_numpy(k[:, c0:r1]),
            torch.from_numpy(v[:, c0:r1]), causal=True, window=window,
            q_start=r0, k_start=c0).numpy()
        np.testing.assert_allclose(band, whole[:, r0:r1], rtol=1e-6,
                                   atol=1e-6, err_msg=f"rows {r0}:{r1}")


def test_flash_plain_version_aligns_short_queries_at_the_top_left():
    """With Sq < Sk and no offsets, query row i sees keys 0..i (the
    kernel's and the reference's numbering): the first Sq rows of the
    square call, not its last."""
    q, k, v = _attn_inputs(1, 96, 4, 4, 16, seed=1)
    short = fa.flash_attention_ref(torch.from_numpy(q[:, :40]),
                                   torch.from_numpy(k), torch.from_numpy(v))
    whole = fa.flash_attention_ref(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(short.numpy(), whole[:, :40].numpy(),
                               rtol=1e-6, atol=1e-6)
    want = np.asarray(r_attention_ref(jnp.asarray(q[:, :40]),
                                      jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(short.numpy(), want, **F32)


def _ssd_inputs(b, s, nh, hd, ds, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(
        np.float32)
    A = -np.exp(0.5 * rng.standard_normal(nh)).astype(np.float32)
    B = rng.standard_normal((b, s, ds)).astype(np.float32)
    C = rng.standard_normal((b, s, ds)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("segments", [2, 4])
def test_ssd_plain_version_in_chained_segments_equals_one_call(segments):
    """Segments of whole chunks, each entering with the state the last
    one left (``initial_state``): the same outputs and final state as one
    call, in the port's plain version and the reference's
    ssd_chunked."""
    x, dt, A, B, C = _ssd_inputs(2, 64, 4, 16, 16)
    chunk = 8
    args = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    y, state = sk.ssd_scan_ref(*args, chunk)
    ry, rstate = r_ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **F32)
    np.testing.assert_allclose(state.numpy(), np.asarray(rstate), **F32)
    n = x.shape[1] // segments
    carry, parts = None, []
    for i in range(segments):
        sl = slice(i * n, (i + 1) * n)
        part, carry = sk.ssd_scan_ref(args[0][:, sl], args[1][:, sl],
                                      args[2], args[3][:, sl],
                                      args[4][:, sl], chunk,
                                      initial_state=carry)
        parts.append(part)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), y.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(carry.numpy(), state.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_ssd_plain_version_on_a_subset_of_heads():
    """The heads are independent (B and C shared by all): a subset's
    outputs are the whole call's at those heads."""
    x, dt, A, B, C = _ssd_inputs(1, 48, 6, 16, 16, seed=2)
    args = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    y, state = sk.ssd_scan_ref(*args, 8)
    lo, hi = 2, 5
    ys, ss = sk.ssd_scan_ref(args[0][:, :, lo:hi], args[1][..., lo:hi],
                             args[2][lo:hi], args[3], args[4], 8)
    np.testing.assert_allclose(ys.numpy(), y[:, :, lo:hi].numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ss.numpy(), state[:, lo:hi].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_run_serve_takes_the_callers_weights():
    """``run_serve(params=)`` serves the weights it is given (the card's
    yi-9b phase holds 35 GB of them) and draws none."""
    import argparse
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import Model
    cfg = get_arch("smollm-135m").reduced()
    params = p_build(cfg, device=CPU).init(0)
    drawn = []
    orig = Model.init
    Model.init = lambda self, *a, **k: drawn.append(1) or orig(self, *a,
                                                               **k)
    try:
        args = argparse.Namespace(arch="smollm-135m", requests=2,
                                  prompt_len=3, decode_tokens=4,
                                  gridpilot=False, island_port=0)
        out = run_serve(args, cfg=cfg, params=params, device=CPU)
    finally:
        Model.init = orig
    assert not drawn
    assert out["batch"] == 2 and out["shed_at"] is None
