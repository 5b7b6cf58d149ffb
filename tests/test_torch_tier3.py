"""Tier-3 selection of the port against ``repro.core.tier3``: the terms
of J(mu, rho) pointwise, and ``select_operating_points`` on the E9-fast
batch with every weight setting the engine uses."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU, assert_close, n, port_specs
import repro.core.tier3 as r_tier3
import repro.workload.model as r_wl
from repro.grid.scenarios import build_scenario_batch as r_build
from repro.grid.scenarios import product_specs as r_specs
import repro_torch.core.tier3 as tier3
from repro_torch.grid.scenarios import build_scenario_batch

RNG = np.random.default_rng(1)
F32 = dict(rtol=1e-4, atol=1e-5)


def _pts(m=600):
    mu = RNG.uniform(0.3, 1.0, m).astype(np.float32)
    rho = RNG.uniform(0.0, 0.3, m).astype(np.float32)
    ta = RNG.uniform(-5, 32, m).astype(np.float32)
    pd = RNG.uniform(1.1, 1.5, m).astype(np.float32)
    return mu, rho, ta, pd


@pytest.mark.parametrize("pue_aware", [True, False])
def test_objective_terms_match_reference(pue_aware):
    mu, rho, ta, pd = _pts()
    t = [torch.from_numpy(x) for x in (mu, rho, ta, pd)]
    assert_close(n(tier3.q_ffr(t[0], t[1], t[2], pue_aware=pue_aware,
                               pue_design=t[3])),
                 r_tier3.q_ffr(mu, rho, ta, pue_aware=pue_aware,
                               pue_design=pd), **F32)
    g = RNG.uniform(0, 1, mu.shape).astype(np.float32)
    assert_close(n(tier3.cfe_score(t[0], torch.from_numpy(g))),
                 r_tier3.cfe_score(mu, g), **F32)
    for pidx in (0, 1):
        v_r = r_tier3.event_verdict(mu, ta, rho, pidx, pd,
                                    pue_aware=pue_aware)
        v_p = tier3.event_verdict(t[0], t[2], t[1], pidx, t[3],
                                  pue_aware=pue_aware)
        for k in ("rho_it", "t_full_ms", "delivered_unit",
                  "delivered_frac"):
            assert_close(n(v_p[k]), v_r[k], rtol=1e-4, atol=1e-4, msg=k)
        for k in ("budget_ok", "delivered_ok"):
            assert (n(v_p[k]) == np.asarray(v_r[k])).mean() > 0.995, k
        assert_close(n(tier3.revenue_score(t[0], t[1], t[2], pidx,
                                           pue_aware=pue_aware,
                                           pue_design=t[3],
                                           events_per_day=6.0)),
                     r_tier3.revenue_score(mu, rho, ta, pidx,
                                           pue_aware=pue_aware,
                                           pue_design=pd,
                                           events_per_day=6.0),
                     rtol=1e-4, atol=1e-4)
        assert_close(n(tier3.throughput_score(t[0], t[1], 0.5, pidx,
                                              events_per_day=6.0,
                                              ckpt_cost_s=45.0)),
                     r_tier3.throughput_score(mu, rho, 0.5, pidx,
                                              events_per_day=6.0,
                                              ckpt_cost_s=45.0), **F32)


def _fast_batches():
    specs = r_specs(countries=("SE", "DE", "PL"), seeds=(0,), horizon_h=6,
                    products=("FFR",), reserve_rhos=(0.0, 0.2),
                    event_seeds=(0,))
    return r_build(specs), build_scenario_batch(port_specs(specs),
                                                device=CPU)


# (price_aware, workload_weight, rho_mode): the engine's weight settings
_SETTINGS = [(False, 0.0, "batch"), (False, 0.0, "tier3"),
             (True, 0.0, "batch"), (True, 0.0, "tier3"),
             (False, 0.3, "tier3"), (True, 0.3, "tier3")]


@pytest.mark.parametrize("price_aware,w_tok,rho_mode", _SETTINGS)
def test_select_operating_points_on_e9_fast(price_aware, w_tok, rho_mode):
    rb, pb = _fast_batches()
    kw = dict(pue_aware=True, events_per_day=24.0, ckpt_cost_s=30.0,
              use_revenue=price_aware, fix_rho=(rho_mode == "batch"),
              use_workload=(w_tok != 0.0))
    w = (tier3.W_FFR, tier3.W_CFE, tier3.W_REV_DEFAULT if price_aware
         else 0.0, w_tok)
    clock = np.asarray(r_wl.CLOCK_W)[np.asarray(rb.mix_idx)]

    def ref_one(ci, ta, mask, pd, pidx, rho, cw):
        g = r_tier3.greenness_from_ci(ci, mask)
        op = r_tier3.select_operating_points(
            g, ta, pue_design=pd, weights=w, product_idx=pidx,
            rho_fixed=rho, clock_w=cw, **kw)
        return op.mu, op.rho

    mu_r, rho_r = jax.vmap(ref_one)(rb.ci, rb.t_amb, rb.mask, rb.pue_design,
                                    rb.product_idx, rb.reserve_rho,
                                    jnp.asarray(clock))
    g = tier3.greenness_from_ci(pb.ci, pb.mask)
    assert_close(n(g), jax.vmap(r_tier3.greenness_from_ci)(rb.ci, rb.mask),
                 **F32)
    op = tier3.select_operating_points(
        g, pb.t_amb, pue_design=pb.pue_design, weights=w,
        product_idx=pb.product_idx, rho_fixed=pb.reserve_rho,
        clock_w=torch.from_numpy(clock), **kw)
    assert tuple(op.mu.shape) == tuple(mu_r.shape) == (6, 6)
    # float32 near-ties may flip a cell between the frameworks; the
    # E9-fast batch has none
    np.testing.assert_array_equal(n(op.mu), np.asarray(mu_r))
    np.testing.assert_array_equal(n(op.rho), np.asarray(rho_r))
    if rho_mode == "batch":
        np.testing.assert_array_equal(
            n(op.rho), np.broadcast_to(n(pb.reserve_rho)[:, None], (6, 6)))


def test_argmax_takes_the_first_of_tied_maxima():
    """An all-zero objective (every cell infeasible or equal) picks the
    first candidate in both frameworks."""
    g = torch.full((1, 3), 0.5)
    op = tier3.select_operating_points(g, torch.full((1, 3), 10.0),
                                       pue_aware=True, weights=(0.0, 0.0))
    ref = r_tier3.select_operating_points(jnp.full((3,), 0.5),
                                          jnp.full((3,), 10.0),
                                          pue_aware=True, weights=(0.0, 0.0))
    np.testing.assert_array_equal(n(op.mu)[0], np.asarray(ref.mu))
    np.testing.assert_array_equal(n(op.rho)[0], np.asarray(ref.rho))
    assert float(op.mu[0, 0]) == pytest.approx(float(tier3.MU_GRID[0]))


def test_pad_weights_and_selector_and_cap_table():
    assert tier3._pad_weights((0.5, 0.5)) == [0.5, 0.5, 0.0, 0.0]
    with pytest.raises(ValueError):
        tier3._pad_weights((1, 2, 3, 4, 5))
    ci = RNG.uniform(50, 400, 24).astype(np.float32)
    ta = RNG.uniform(0, 25, 24).astype(np.float32)
    ref = r_tier3.Tier3Selector(w_rev=0.25).select_day(ci, ta)
    got = tier3.Tier3Selector(w_rev=0.25).select_day(torch.from_numpy(ci),
                                                     torch.from_numpy(ta))
    np.testing.assert_array_equal(n(got.mu), np.asarray(ref.mu))
    np.testing.assert_array_equal(n(got.rho), np.asarray(ref.rho))
    np.testing.assert_array_equal(tier3.cap_table(3, 900.0, 100.0, 300.0),
                                  r_tier3.cap_table(3, 900.0, 100.0, 300.0))


def _forecast_24h(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(50, 400, 24).astype(np.float32),
            rng.uniform(-5, 30, 24).astype(np.float32))


@pytest.mark.parametrize("price_aware", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_selector_and_hourly_plan_match_reference(price_aware, seed):
    """Numpy forecasts of 24 h through the selector and through
    ``GridPilot.hourly_plan``: the same (mu, rho) per hour, the same
    objective, the same armed island row and plan."""
    import repro.core.controller as r_ctl
    import repro_torch.core.controller as p_ctl
    ci, ta = _forecast_24h(seed)
    w_rev = tier3.W_REV_DEFAULT if price_aware else 0.0
    ref = r_tier3.Tier3Selector(w_rev=w_rev).select_day(ci, ta)
    sel = tier3.Tier3Selector(w_rev=w_rev, device=CPU)
    got = sel.select_day(ci, ta)
    assert tuple(got.mu.shape) == tuple(np.shape(ref.mu)) == (24,)
    np.testing.assert_array_equal(n(got.mu), np.asarray(ref.mu))
    np.testing.assert_array_equal(n(got.rho), np.asarray(ref.rho))
    g = r_tier3.greenness_from_ci(ci)
    assert_close(n(sel.objective(got.mu, got.rho, torch.from_numpy(
        np.array(g)), torch.from_numpy(ta))),
        r_tier3.Tier3Selector(w_rev=w_rev).objective(ref.mu, ref.rho, g, ta),
        **F32)
    kw = dict(n_hosts=2, chips_per_host=2, start_island=False,
              price_aware=price_aware)
    gp_r, gp_p = r_ctl.GridPilot(**kw), p_ctl.GridPilot(**kw, device=CPU)
    plan_r, plan_p = gp_r.hourly_plan(ci, ta), gp_p.hourly_plan(ci, ta)
    assert gp_p.current_row == gp_r.current_row
    assert gp_p.island.armed_row == gp_r.island.armed_row
    assert plan_p == p_ctl.PowerPlan(**vars(plan_r))


def test_select_hour_squeezes_like_the_reference():
    sel, ref = tier3.Tier3Selector(device=CPU), r_tier3.Tier3Selector()
    for g, ta in ((0.7, 12.0), (np.array([0.2]), np.array([25.0]))):
        got, want = sel.select_hour(g, ta), ref.select_hour(g, ta)
        assert tuple(got.mu.shape) == tuple(np.shape(want.mu)) == ()
        assert float(got.mu) == pytest.approx(float(want.mu))
        assert float(got.rho) == pytest.approx(float(want.rho))


def test_selector_result_stays_on_the_device_it_was_given():
    ci, ta = _forecast_24h(3)
    op = tier3.Tier3Selector(device=CPU).select_day(ci, ta)
    assert op.mu.device.type == op.rho.device.type == "cpu"
    # tensors keep their own device, whatever the selector's default
    op = tier3.Tier3Selector().select_day(torch.from_numpy(ci),
                                          torch.from_numpy(ta))
    assert op.mu.device.type == op.rho.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tier3.Tier3Selector().select_day(ci, ta)


@pytest.mark.parametrize("fn", ["q_ffr", "revenue_score", "throughput_frac",
                                "pue"])
def test_float64_inputs_give_float64_results(fn):
    """Float64 tensors in give float64 out, as the reference does under
    ``jax.enable_x64``, to the rounding of float64 (1e-12)."""
    import repro.core.pue as r_pue
    import repro_torch.core.pue as pue
    import repro_torch.workload.model as wl
    rng = np.random.default_rng(12)
    m = 400
    mu, rho = rng.uniform(0.3, 1.0, m), rng.uniform(0.0, 0.3, m)
    ta, pd = rng.uniform(-5, 32, m), rng.uniform(1.1, 1.5, m)
    cw = rng.uniform(0.0, 1.0, m)
    p = rng.uniform(0.05, 1.1, m)  # both sides of the DVFS floor
    t = {k: torch.from_numpy(v) for k, v in
         dict(mu=mu, rho=rho, ta=ta, pd=pd, cw=cw, p=p).items()}
    calls = {
        "q_ffr": (lambda m_, a: m_.q_ffr(a["mu"], a["rho"], a["ta"],
                                          pue_aware=True,
                                          pue_design=a["pd"]), tier3,
                  r_tier3),
        "revenue_score": (lambda m_, a: m_.revenue_score(
            a["mu"], a["rho"], a["ta"], 1, pue_aware=True,
            pue_design=a["pd"], events_per_day=6.0), tier3, r_tier3),
        "throughput_frac": (lambda m_, a: m_.throughput_frac(a["cw"],
                                                              a["p"]),
                            wl, r_wl),
        "pue": (lambda m_, a: m_.pue(a["mu"], a["ta"], pue_design=a["pd"]),
                pue, r_pue),
    }
    call, port_mod, ref_mod = calls[fn]
    got = call(port_mod, t)
    with jax.enable_x64(True):
        want = np.asarray(call(ref_mod, {k: jnp.asarray(v.numpy())
                                         for k, v in t.items()}))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0.0)
