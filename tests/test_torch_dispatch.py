"""The port's job-level dispatcher (paper Algorithm 1) against
``repro.core.dispatch``.

The cases of ``tests/test_dispatch.py`` run on the port's
``GridPilotDispatcher``, with the reference's synthetic M100 job traces
(``repro.data.m100``) converted into the port's ``Job``.  The parity
case runs one trace through both dispatchers: dispatch, deferral and
backfill counts exact, energies and CO2 at rtol 1e-3.
"""
import dataclasses

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import repro_torch.core.pue as pue_lib
from repro_torch.core import dispatch
from repro_torch.core.dispatch import GridPilotDispatcher, Job
from repro_torch.grid.signals import make_grid

ENERGY = 1e-3


def _trace(n_jobs, horizon_h, nodes, seed):
    """The reference's synthetic M100 trace as the port's Jobs."""
    from repro.data.m100 import synthesize_m100_trace
    return [Job(**dataclasses.asdict(j))
            for j in synthesize_m100_trace(n_jobs, horizon_h, nodes,
                                           seed=seed)]


def _dispatcher(pue_aware=True, nodes=32, hours=120, seed=0):
    g = make_grid("DE", hours, seed=seed)
    return GridPilotDispatcher(nodes, 2000.0, g.ci, g.t_amb,
                               pue_aware=pue_aware)


def test_all_jobs_eventually_run():
    jobs = _trace(60, 48.0, 32, seed=1)
    _dispatcher().run(jobs, horizon_h=72)
    assert sum(1 for j in jobs if j.start_h >= 0) == len(jobs)


def test_no_node_oversubscription():
    stats = _dispatcher().run(_trace(80, 48.0, 32, seed=2), horizon_h=72)
    assert max(stats.util_trace) <= 1.05


def test_aging_budget_forces_dispatch():
    old = Job(jid=0, submit_h=0.0, duration_h=5.0, nodes=1,
              power_node_w=2000.0, d_max_h=1.0)
    _dispatcher().run([old], horizon_h=24)
    assert old.start_h >= 0 and old.start_h <= 2.0


def test_short_jobs_skip_deferral():
    short = Job(jid=0, submit_h=0.0, duration_h=1.0, nodes=1,
                power_node_w=2000.0)
    _dispatcher().run([short], horizon_h=24)
    assert short.start_h == 0.0


def test_sigma_composite_defers_more_in_dirty_hours():
    stats = _dispatcher(pue_aware=True, seed=3).run(
        _trace(100, 60.0, 32, seed=3), horizon_h=72)
    assert stats.deferred > 0
    assert stats.capped_job_hours > 0


def test_pue_aware_reduces_facility_co2():
    a = _dispatcher(pue_aware=True, seed=4).run(_trace(80, 60.0, 32, seed=4),
                                                horizon_h=96)
    b = _dispatcher(pue_aware=False, seed=4).run(
        _trace(80, 60.0, 32, seed=4), horizon_h=96)
    assert a.co2_t <= b.co2_t * 1.02


def test_reserve_rho_withholds_capacity():
    jobs_r = _trace(40, 48.0, 32, seed=5)
    s0 = _dispatcher(seed=5).run(_trace(40, 48.0, 32, seed=5), horizon_h=96)
    sr = _dispatcher(seed=5).run(jobs_r, horizon_h=96, reserve_rho=0.75)
    assert max(sr.util_trace) <= 0.25 + 0.08 + 1e-6
    assert max(sr.util_trace) < max(s0.util_trace)
    assert sum(1 for j in jobs_r if j.start_h >= 0) == len(jobs_r)
    assert np.mean(sr.wait_hours) >= np.mean(s0.wait_hours) - 1e-9


def test_run_accounting_matches_replay_schedule():
    import torch
    d = _dispatcher(seed=6)
    stats = d.run(_trace(40, 48.0, 32, seed=6), horizon_h=48)
    mu = np.asarray(stats.util_trace, np.float32)
    tot = dispatch.replay_schedule(
        torch.from_numpy(mu), torch.from_numpy(d.ci[:48].astype(np.float32)),
        torch.from_numpy(d.t_amb[:48].astype(np.float32)),
        torch.ones(mu.shape), pue_design=d.pue_design,
        green_ci=float(d.green_ci), design_w=d.design_it_w)
    assert stats.it_energy_mwh == pytest.approx(float(tot["it"]) / 1e6,
                                                rel=1e-6)
    assert stats.co2_t == pytest.approx(float(tot["co2"]) / 1e9, rel=1e-6)
    assert stats.cfe_num == pytest.approx(float(tot["cfe_fac"]) / 1e6,
                                          rel=1e-6)
    assert len(stats.pue_trace) == 48 and min(stats.pue_trace) >= 1.0


def test_run_warns_on_removed_inline_accounting_kwargs():
    d = _dispatcher(seed=7)
    with pytest.warns(DeprecationWarning, match="replay_schedule"):
        d.run([], horizon_h=2, integrate_energy=True)
    with pytest.raises(TypeError):
        d.run([], horizon_h=2, not_a_kwarg=1)


def test_deprecated_kwargs_delegate_matches_inline_path():
    """Each deprecated kwarg warns, and the delegated accounting equals a
    per-hour float64 integration of the realised utilisation trace."""
    horizon = 24
    d = _dispatcher(seed=9)
    stats = {}
    for kw in ("integrate_energy", "integrate_carbon", "inline_accounting"):
        with pytest.warns(DeprecationWarning, match=kw):
            stats[kw] = _dispatcher(seed=9).run(
                _trace(20, float(horizon), 32, seed=9), horizon_h=horizon,
                **{kw: True})
    ref = _dispatcher(seed=9).run(_trace(20, float(horizon), 32, seed=9),
                                  horizon_h=horizon)
    it = fac = co2 = co2_it = cfe = 0.0
    for h, mu in enumerate(ref.util_trace):
        load = min(max(mu, 0.05), 1.0)
        p = float(pue_lib.pue(load, d.t_amb[h], pue_design=d.pue_design))
        it_w = load * d.design_it_w
        fac_w = it_w * p
        it += it_w
        fac += fac_w
        co2 += fac_w * d.ci[h]
        co2_it += it_w * d.ci[h]
        if d.ci[h] <= d.green_ci:
            cfe += fac_w
    for s in list(stats.values()) + [ref]:
        assert s.util_trace == ref.util_trace
        assert s.it_energy_mwh == pytest.approx(it / 1e6, rel=1e-4)
        assert s.facility_energy_mwh == pytest.approx(fac / 1e6, rel=1e-4)
        assert s.co2_t == pytest.approx(co2 / 1e9, rel=1e-4)
        assert s.co2_it_t == pytest.approx(co2_it / 1e9, rel=1e-4)
        assert s.cfe_num == pytest.approx(cfe / 1e6, rel=1e-4)


@given(st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_beta_monotone_in_wait(seed):
    rng = np.random.default_rng(seed)
    j = Job(jid=0, submit_h=float(rng.uniform(0, 10)),
            duration_h=5.0, nodes=1, power_node_w=2000.0,
            d_max_h=float(rng.uniform(1, 48)))
    t1 = j.submit_h + rng.uniform(0, 24)
    t2 = t1 + rng.uniform(0, 24)
    assert j.beta(t2) >= j.beta(t1) >= 0.0


# ---------------------------------------------------------------------------
# one trace through both dispatchers
# ---------------------------------------------------------------------------

_COUNTS = ("dispatched", "deferred", "backfilled", "capped_job_hours")
_ENERGIES = ("it_energy_mwh", "facility_energy_mwh", "co2_t", "co2_it_t",
             "cfe_num")


@pytest.mark.parametrize("pue_aware,seed,rho", [
    (True, 3, 0.0), (False, 3, 0.0), (True, 8, 0.2)])
def test_dispatcher_matches_reference(pue_aware, seed, rho):
    from repro.core.dispatch import GridPilotDispatcher as RefDispatcher
    from repro.data.m100 import synthesize_m100_trace
    from repro.grid.signals import make_grid as ref_grid
    g = ref_grid("DE", 120, seed=seed)
    ref_jobs = synthesize_m100_trace(100, 60.0, 32, seed=seed)
    jobs = [Job(**dataclasses.asdict(j)) for j in ref_jobs]
    want = RefDispatcher(32, 2000.0, g.ci, g.t_amb,
                         pue_aware=pue_aware).run(ref_jobs, horizon_h=72,
                                                  reserve_rho=rho)
    got = GridPilotDispatcher(32, 2000.0, g.ci, g.t_amb,
                              pue_aware=pue_aware).run(jobs, horizon_h=72,
                                                       reserve_rho=rho)
    for k in _COUNTS:
        assert getattr(got, k) == getattr(want, k), k
    assert got.wait_hours == want.wait_hours
    assert [(j.start_h, j.done_h, j.nodes) for j in jobs] == \
        [(j.start_h, j.done_h, j.nodes) for j in ref_jobs]
    np.testing.assert_allclose(got.util_trace, want.util_trace, rtol=1e-12)
    for k in _ENERGIES:
        assert getattr(got, k) == pytest.approx(getattr(want, k),
                                                rel=ENERGY), k
    np.testing.assert_allclose(got.sigma_trace, want.sigma_trace,
                               rtol=ENERGY)
    np.testing.assert_allclose(got.pue_trace, want.pue_trace, rtol=ENERGY)
    assert got.cfe_num / got.facility_energy_mwh == pytest.approx(
        want.cfe_num / want.facility_energy_mwh, rel=ENERGY)


def test_dispatcher_runs_on_the_host():
    """The scheduler is the reference's host bookkeeping: no device
    argument, float64 signals, float32 PUE scalars."""
    import inspect
    assert "device" not in inspect.signature(GridPilotDispatcher).parameters
    d = _dispatcher(seed=2)
    s = d.sigma(5, 0.7)
    assert isinstance(s, float) and s > d.ci[5]
    assert d.sigma_threshold(5, 0.7) == pytest.approx(np.percentile(
        [d.sigma(h, 0.7) for h in range(5, 29)], 66.0))
