"""Leaf physics of the port against the reference: plant, PUE, the
workload model, AR(4)/RLS with the host rebalance, and the twin's
demand-row synthesis."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU, assert_close, n, np_tree
import repro.core.ar4 as r_ar4
import repro.core.plant as r_plant
import repro.core.pue as r_pue
import repro.core.twin as r_twin
import repro.workload.model as r_wl
from repro_torch import convert
import repro_torch.core.ar4 as ar4
import repro_torch.core.plant as plant
import repro_torch.core.pue as pue
import repro_torch.core.twin as twin
import repro_torch.workload.model as wl

F32 = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(0)


def _u(lo, hi, shape):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def test_power_model_and_inverse_match_reference():
    f = _u(300, 1600, 500)
    load = _u(0.0, 1.0, 500)
    assert_close(n(plant.power_model(torch.from_numpy(f),
                                     torch.from_numpy(load))),
                 r_plant.power_model(f, load), **F32)
    assert_close(n(plant.power_model(plant.F_NOMINAL,
                                     torch.from_numpy(load))),
                 r_plant.power_model(r_plant.F_NOMINAL, load), **F32)
    cap = _u(60, 320, 500)
    assert_close(n(plant.freq_at_cap(torch.from_numpy(cap),
                                     torch.from_numpy(load))),
                 r_plant.freq_at_cap(cap, load), rtol=1e-5, atol=1e-3)
    # the voltage-floor branch is taken on both sides of F_VMIN
    fq = n(plant.freq_at_cap(torch.from_numpy(cap), torch.from_numpy(load)))
    assert (fq < plant.F_VMIN).any() and (fq > plant.F_VMIN).any()


@pytest.mark.parametrize("slew", [None, r_plant.GOV_SLEW])
def test_plant_step_matches_reference(slew):
    n_chips = 64
    load = _u(0.05, 1.0, n_chips)
    caps = _u(100, 300, n_chips)
    noise = RNG.standard_normal(n_chips).astype(np.float32)
    ref = dataclasses.replace(r_plant.init_plant(n_chips),
                              power=jnp.asarray(_u(60, 300, n_chips)),
                              temp=jnp.asarray(_u(30, 90, n_chips)))
    st = convert.plant_state(np_tree(ref), CPU)
    ref = r_plant.write_cap(ref, jnp.asarray(caps))
    st = plant.write_cap(st, torch.from_numpy(caps))
    for k in range(4):
        ref = r_plant.plant_step(ref, load, 5.0, tau_ms=6.0, slew_w_ms=slew)
        st = plant.plant_step(st, torch.from_numpy(load), 5.0, tau_ms=6.0,
                              slew_w_ms=slew)
    for f in ("power", "cap", "pending_cap", "pending_ms", "temp", "freq"):
        assert_close(n(getattr(st, f)), getattr(ref, f), rtol=1e-5,
                     atol=1e-3, msg=f)
    # the noise override adds 0.35 W per unit normal before the clip
    quiet = plant.plant_step(st, torch.from_numpy(load), 5.0)
    loud = plant.plant_step(st, torch.from_numpy(load), 5.0,
                            noise=torch.from_numpy(noise))
    inside = (n(quiet.power) > 36.0) & (n(quiet.power) < 305.0)
    assert_close(n(loud.power)[inside] - n(quiet.power)[inside],
                 0.35 * noise[inside], rtol=1e-4, atol=1e-4)


def test_pue_facility_and_meter_gain_match_reference():
    L = _u(0.0, 1.2, 400)
    ta = _u(-10, 35, 400)
    pd = _u(1.05, 1.6, 400)
    tL, tta, tpd = map(torch.from_numpy, (L, ta, pd))
    assert_close(n(pue.pue(tL, tta, pue_design=tpd)),
                 r_pue.pue(L, ta, pue_design=pd), **F32)
    assert_close(n(pue.facility_power(tL * 7.0, 7.0, tta, pue_design=tpd)),
                 r_pue.facility_power(L * 7.0, 7.0, ta, pue_design=pd),
                 **F32)
    mu = _u(0.3, 1.0, 400)
    rho = _u(0.0, 0.3, 400)
    assert_close(n(pue.ffr_meter_gain(torch.from_numpy(mu),
                                      torch.from_numpy(rho), tta,
                                      pue_design=tpd)),
                 r_pue.ffr_meter_gain(mu, rho, ta, pue_design=pd),
                 rtol=1e-4, atol=1e-4)
    assert pue.pue(1.0, pue.T_REF) == pytest.approx(
        float(r_pue.pue(1.0, r_pue.T_REF)), rel=1e-6)


def test_workload_model_matches_reference():
    p = _u(0.0, 1.1, 500)
    cw = RNG.choice(wl.CLOCK_W, 500).astype(np.float32)
    assert_close(n(wl.throughput_frac(torch.from_numpy(cw),
                                      torch.from_numpy(p))),
                 r_wl.throughput_frac(cw, p), **F32)
    assert wl.throughput_frac(0.88, 0.9) == pytest.approx(
        float(r_wl.throughput_frac(0.88, 0.9)), rel=1e-6)
    t = np.arange(0, 40, dtype=np.int32)
    for amp in (0.0, 0.3):
        got = [wl.step_transient(int(s), 10.0, amp) for s in t]
        assert_close(got, r_wl.step_transient(t, 10.0, amp), **F32)
    assert wl.mix_index("balanced") == r_wl.mix_index("balanced")
    with pytest.raises(ValueError):
        wl.mix_index("nope")


def test_rls_and_rebalance_track_reference_over_300_steps():
    """AR(4)/RLS over a few hundred normalised host-power samples,
    including symmetrisation, the trace ceiling and the warm-up gate."""
    H, C, steps = 5, 3, 300
    t = np.arange(steps)[:, None]
    u = (0.7 + 0.1 * np.sin(t / 7.0 + np.arange(H))
         + 0.02 * RNG.standard_normal((steps, H))).astype(np.float32)
    ref, st = r_ar4.init_rls(H), convert.rls_state(
        np_tree(r_ar4.init_rls(H)), CPU)
    ref_err, errs = [], []
    for k in range(steps):
        ref, e_r = r_ar4.rls_update(ref, jnp.asarray(u[k]))
        st, e = ar4.rls_update(st, torch.from_numpy(u[k]))
        ref_err.append(np.asarray(e_r))
        errs.append(n(e))
    # a-priori errors agree step by step early, and on average throughout
    assert_close(np.array(errs[:50]), np.array(ref_err[:50]), rtol=1e-3,
                 atol=1e-5)
    assert_close(np.mean(errs), np.mean(ref_err), rtol=2e-2)
    assert_close(n(ar4.predict(st)), r_ar4.predict(ref), rtol=2e-2,
                 atol=1e-3)
    assert (n(st.steps) == steps).all()
    # the rebalance: proportional shedding and headroom split
    pred = _u(300, 900, H)
    env = _u(300, 900, H)
    chip = _u(40, 300, (H, C))
    assert_close(n(ar4.host_rebalance(torch.from_numpy(pred),
                                      torch.from_numpy(env),
                                      torch.from_numpy(chip), 100.0,
                                      300.0)),
                 r_ar4.host_rebalance(pred, env, chip, 100.0, 300.0), **F32)


def test_rls_covariance_ceiling_and_warmup_gate():
    ref = r_ar4.init_rls(2, p0=1e5)
    st = convert.rls_state(np_tree(ref), CPU)
    for k in range(8):
        x = np.full(2, 1e-3 * (k % 2), np.float32)
        ref, _ = r_ar4.rls_update(ref, jnp.asarray(x))
        st, _ = ar4.rls_update(st, torch.from_numpy(x))
        if k < r_ar4.ORDER:
            # warm-up: theta and P stay at their initial values
            assert_close(n(st.theta), np.asarray(ref.theta), **F32)
    tr = np.trace(n(st.P), axis1=-2, axis2=-1)
    assert (tr <= 1e4 * ar4.ORDER * (1 + 1e-5)).all()
    assert_close(n(st.P), np.asarray(ref.P), rtol=1e-4, atol=1e-2)


def test_host_load_rows_match_reference_on_its_draws():
    """The demand model, fed the reference's per-scenario constants and
    white noise, gives the reference's rows (slow waves, bursty duty)."""
    n_hosts, key = 10, jax.random.PRNGKey(3)
    p = r_twin.host_load_params(n_hosts, key)
    b = 2
    want = np.asarray(r_twin.host_loads_block(p, b))          # (K, H)
    fast = np.asarray(jax.random.normal(jax.random.fold_in(p.fast_key, b),
                                        (r_twin.LOAD_BLOCK_S, n_hosts)))
    pp = convert.host_load_params(
        jax.tree.map(lambda x: np.asarray(x)[None], np_tree(p)), [0], CPU)
    tf = float(b * 3600) + torch.arange(3600, dtype=torch.float32)
    got = n(twin.host_loads_rows(pp, tf, torch.from_numpy(fast)[None]))[0]
    assert_close(got, want, rtol=1e-4, atol=2e-5)
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_schedule_helpers_and_replay_match_reference():
    """The hourly accounting: signal-ranked schedules and the power/carbon
    replay, per scenario row."""
    import repro.core.dispatch as r_disp
    import repro_torch.core.dispatch as disp
    N, H = 4, 30
    sig = _u(50, 500, (N, H))
    mask = (np.arange(H)[None, :] < np.array([30, 24, 12, 5])[:, None])
    mask = mask.astype(np.float32)
    n_his = np.array([[3, 10], [0, 5], [12, 40], [1, 2]], np.int32)
    thr = n(disp.signal_thresholds(torch.from_numpy(sig),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(n_his)))
    want = jax.vmap(r_disp.signal_thresholds)(sig, mask, n_his)
    np.testing.assert_array_equal(thr, np.asarray(want))
    mu = n(disp.schedule_from_threshold(
        torch.from_numpy(sig), torch.from_numpy(thr[:, :1]), 0.4,
        torch.from_numpy(mask), 0.9))
    np.testing.assert_array_equal(mu, np.asarray(jax.vmap(
        lambda s, t, m: r_disp.schedule_from_threshold(s, t, 0.4, m, 0.9))(
            sig, thr[:, :1], mask)))
    ta = _u(-5, 30, (N, H))
    pd = _u(1.1, 1.4, N)
    mw = _u(5, 20, N)
    green = _u(100, 300, N)
    cw = np.float32([0.88, 0.15, 0.5, 0.88])
    got = disp.replay_schedule(
        torch.from_numpy(mu), torch.from_numpy(sig), torch.from_numpy(ta),
        torch.from_numpy(mask), pue_design=torch.from_numpy(pd),
        green_ci=torch.from_numpy(green), design_w=torch.from_numpy(mw),
        clock_w=torch.from_numpy(cw))
    want = jax.vmap(lambda m, c, t, k, p, g, w, cl: r_disp.replay_schedule(
        m, c, t, k, pue_design=p, green_ci=g, design_w=w, clock_w=cl))(
            mu, sig, ta, mask, pd, green, mw, cw)
    assert set(got) == set(want)
    for k in want:
        assert_close(n(got[k]), want[k], rtol=1e-5, atol=1e-5, msg=k)
