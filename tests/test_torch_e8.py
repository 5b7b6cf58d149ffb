"""E8, the PUE-aware multi-country sweep (paper Fig. 5, with E9's PUE
design axis), on the port against the reference bench
``benchmarks/e8_multicountry.py``.

The batch's specs, groups and noise equal the bench's exactly.  The
metrics are held on the 12-scenario 7-day batch and the ragged batch of
``tests/test_scenarios.py`` and on the fast batch: the candidates'
replay totals and the CFE shares at rtol 1e-3, the pp metrics at 1e-3
pp.  A shed-depth pick may differ only where the reference's two
candidates lie within 1e-5 of each other; the metrics are then compared
with the reference's picks passed in (``picks=``), as Tier-3 is pinned
through ``ops=``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU, assert_close, n
import benchmarks.e8_multicountry as r_e8
import repro.core.dispatch as r_dispatch
import repro.core.pue as r_pue
import repro.grid.scenarios as r_scen
import repro_torch.experiments as ex
import repro_torch.grid.scenarios as scen

TOTALS_RTOL = 1e-3
PP_ATOL = 1e-3
TIE_REL = 1e-5
PP_KEYS = ("delta_facility_pp", "facility_reduction_blind_pp",
           "facility_reduction_aware_pp", "it_reduction_blind_pp",
           "cooling_drag_pp")


def _ref_totals(ci, t_amb, mask, noise, pue_design):
    """The candidates' (metered, board) CO2 integrals of one scenario,
    built as ``r_e8._scenario_metrics`` builds them."""
    hv = jnp.sum(mask)
    los = jnp.asarray(r_e8.LO_LEVELS, jnp.float32)
    n_hi = jnp.clip(jnp.round((r_e8.DEMAND * hv - los * hv)
                              / (r_e8.MU_HI - los)), 0.0, hv)
    sigs = jnp.stack([ci, ci * r_pue.pue(r_e8.MU_HI, t_amb,
                                         pue_design=pue_design)])
    srt = jnp.sort(jnp.where(mask[None] > 0, sigs, jnp.inf), axis=-1)
    thr = jax.vmap(lambda s: r_dispatch.thresholds_from_sorted(s, n_hi))(srt)
    sched = jax.vmap(lambda sig, t: jax.vmap(
        lambda t_l, lo: r_dispatch.schedule_from_threshold(
            sig, t_l, lo, mask, r_e8.MU_HI))(t, los))(sigs, thr)
    flat = jnp.where(mask > 0, r_e8.DEMAND, 0.0)
    cand = jnp.concatenate([sched.reshape(-1, mask.shape[0]), flat[None]])
    tot = r_dispatch.replay_schedule(cand + noise[None], ci, t_amb, mask,
                                     pue_design=pue_design)
    return tot["co2"], tot["co2_it"]


def _port_specs(specs):
    return [scen.ScenarioSpec(**dataclasses.asdict(s)) for s in specs]


def _check_sweep(rbatch, pbatch):
    rnoise = r_e8.noise_for(rbatch)
    pnoise = ex.e8_noise(pbatch)
    np.testing.assert_array_equal(n(pnoise), np.asarray(rnoise))
    want = {k: np.asarray(v)
            for k, v in r_e8.sweep_batched(rbatch, rnoise).items()}
    fac_r, it_r = (np.asarray(a) for a in jax.vmap(_ref_totals)(
        rbatch.ci, rbatch.t_amb, rbatch.mask, rnoise, rbatch.pue_design))
    got = ex.e8_metrics(pbatch, pnoise)
    assert_close(n(got["co2_candidates"]), fac_r, rtol=TOTALS_RTOL, atol=0)
    assert_close(n(got["co2_it_candidates"]), it_r, rtol=TOTALS_RTOL, atol=0)

    los = np.asarray(ex.LO_LEVELS, np.float32)
    n_lo = len(los)
    pick_r = [np.searchsorted(los, want[k]) for k in
              ("shed_depth_blind", "shed_depth_aware")]
    # the helper builds the bench's candidates: its argmins are the bench's
    np.testing.assert_array_equal(pick_r[0], np.argmin(it_r[:, :n_lo], -1))
    np.testing.assert_array_equal(
        pick_r[1], np.argmin(fac_r[:, n_lo:2 * n_lo], -1))
    pick_p = [np.searchsorted(los, n(got[k])) for k in
              ("shed_depth_blind", "shed_depth_aware")]
    rows = np.arange(len(pick_r[0]))
    for mine, theirs, tot in ((pick_p[0], pick_r[0], it_r[:, :n_lo]),
                              (pick_p[1], pick_r[1], fac_r[:, n_lo:-1])):
        off = mine != theirs
        a, b = tot[rows, mine][off], tot[rows, theirs][off]
        assert (np.abs(a - b) <= TIE_REL * np.abs(b)).all(), \
            "a shed-depth pick differs beyond a near-tie"
    pinned = ex.e8_metrics(pbatch, pnoise,
                           picks=tuple(torch.from_numpy(p) for p in pick_r))
    for k in ex.METRIC_KEYS:
        if k in PP_KEYS:
            assert_close(n(pinned[k]), want[k], rtol=0, atol=PP_ATOL,
                         msg=k)
        elif k.startswith("cfe"):
            assert_close(n(pinned[k]), want[k], rtol=TOTALS_RTOL, atol=0,
                         msg=k)
        else:
            np.testing.assert_array_equal(n(pinned[k]), want[k], err_msg=k)
    return pinned


def test_masked_quantile_sorted_matches_reference():
    x = np.random.default_rng(2).uniform(0, 100, (5, 30)).astype(np.float32)
    n_valid = np.array([30, 20, 7, 2, 1], np.float32)
    mask = np.arange(30)[None, :] < n_valid[:, None]
    xs = np.sort(np.where(mask, x, np.inf), -1).astype(np.float32)
    for q in (0.0, 33.0, 50.0, 95.0, 100.0):
        want = jax.vmap(lambda a, m: r_scen.masked_quantile_sorted(a, m, q))(
            xs, n_valid)
        got = scen.masked_quantile_sorted(torch.from_numpy(xs),
                                          torch.from_numpy(n_valid), q)
        assert_close(n(got), want, rtol=1e-6, atol=1e-5)
        one = scen.masked_quantile_sorted(torch.from_numpy(xs[1]), 20, q)
        assert one.shape == () and float(one) == pytest.approx(
            float(want[1]), rel=1e-6)


@pytest.mark.parametrize("fast", [True, False])
def test_batch_specs_and_groups_equal_the_bench(fast):
    specs, groups = ex.e8_specs(fast)
    if fast:
        rbatch, rgroups = r_e8.build_e8_batch(fast=True)
        pbatch, pgroups = ex.build_e8_batch(True, device=CPU)
        assert pgroups == rgroups
        assert pbatch.n == rbatch.n == 26 and pbatch.h_max == 672
        for f in ("seed", "start_day", "mw", "pue_design", "hours"):
            np.testing.assert_array_equal(n(getattr(pbatch, f)),
                                          np.asarray(getattr(rbatch, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(n(ex.e8_noise(pbatch)),
                                      np.asarray(r_e8.noise_for(rbatch)))
    assert len(specs) == (26 if fast else 144)
    assert len(set(specs)) == len(specs)
    for _, _, _, idx in groups:
        assert all(0 <= i < len(specs) for i in idx)
    assert ex.METRIC_KEYS == r_e8.METRIC_KEYS
    assert (ex.HORIZON_H, ex.MW_LEVELS, ex.MU_HI, ex.LO_LEVELS,
            ex.DEMAND) == (r_e8.HORIZON_H, r_e8.MW_LEVELS, r_e8.MU_HI,
                           r_e8.LO_LEVELS, r_e8.DEMAND)


def test_full_batch_specs_equal_the_bench():
    """The full sweep's 144 specs and 20 groups, from the bench's own
    ``build_e8_batch`` with the batch synthesis stubbed out."""
    seen = {}

    def capture(specs):
        seen["specs"] = list(specs)
        return None
    orig = r_e8.build_scenario_batch
    r_e8.build_scenario_batch = capture
    try:
        _, rgroups = r_e8.build_e8_batch(fast=False)
    finally:
        r_e8.build_scenario_batch = orig
    specs, groups = ex.e8_specs(False)
    assert [dataclasses.astuple(s) for s in specs] == \
        [dataclasses.astuple(s) for s in seen["specs"]]
    assert groups == rgroups and len(groups) == 20


def test_sweep_matches_bench_week_batch():
    specs = r_scen.product_specs(countries=("SE", "DE", "PL"), seeds=(0, 1),
                                 start_days=(105,), mw_levels=(1.0, 50.0),
                                 horizon_h=7 * 24)
    _check_sweep(r_scen.build_scenario_batch(specs),
                 scen.build_scenario_batch(_port_specs(specs), device=CPU))


def test_sweep_matches_bench_ragged_batch():
    specs = [r_scen.ScenarioSpec("SE", horizon_h=5 * 24),
             r_scen.ScenarioSpec("DE", horizon_h=7 * 24)]
    _check_sweep(r_scen.build_scenario_batch(specs),
                 scen.build_scenario_batch(_port_specs(specs), device=CPU))


def test_sweep_matches_bench_fast_batch_and_headline():
    rbatch, groups = r_e8.build_e8_batch(fast=True)
    pbatch, _ = ex.build_e8_batch(True, device=CPU)
    got = _check_sweep(rbatch, pbatch)
    rows = ex.e8_group_rows(got, groups)
    want = r_e8._group_rows(
        {k: np.asarray(v) for k, v in r_e8.sweep_batched(
            rbatch, r_e8.noise_for(rbatch)).items()}, groups)
    for a, b in zip(rows, want):
        assert (a["kind"], a["country"], a["mw"]) == \
            (b["kind"], b["country"], b["mw"])
        for k in PP_KEYS:
            assert a[k] == pytest.approx(b[k], abs=PP_ATOL), k
    head = ex.e8_summary(rows)
    fig5 = [r for r in want if r["kind"] in ("fig5a", "fig5b")]
    drag = [r["cooling_drag_pp"] for r in fig5]
    assert head["drag_closed_pp"] == pytest.approx((min(drag), max(drag)),
                                                   abs=PP_ATOL)
    assert set(head["delta_pp_10mw"]) == {"SE", "DE", "PL"}
    assert set(head["delta_pp_by_mw"]) == {
        f"{m}mw.{c}" for c in ("SE", "PL") for m in (1, 10, 50)}
    assert list(head["e9_drag_pp"]) == ["1.10", "1.20", "1.30", "1.40"]
    assert head["low_ci_widest"] in (0, 1)
