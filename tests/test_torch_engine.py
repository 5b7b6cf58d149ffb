"""The port's rollout engine against ``repro.core.engine``.

Both packages get the same inputs: the reference's frequency traces,
demand rows and plant noise (its per-tick split chain replayed), and its
own hourly (mu, rho) through ``ops=`` -- float32 near-ties can flip a
Tier-3 cell between the frameworks, so the seconds tier is held against
the reference with the operating points pinned, and the selection is
checked on its own (test_torch_tier3.py and the default-path test here).
Tolerances are the reference's own: rtol 1e-3 on energy, money and mu/rho,
2e-2 on the RLS-derived metrics, exact on event counts and seconds.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_common import (CPU, assert_close, n, np_tree, port_config,
                               port_specs, ref_inputs)
import repro.core.engine as r_eng
from repro.grid.scenarios import build_scenario_batch as r_build
from repro.grid.scenarios import product_specs as r_specs
import repro_torch.core.engine as eng
from repro_torch import convert
from repro_torch.grid.scenarios import build_scenario_batch
from repro_torch.launch.mesh import ScenarioMesh

REF_CFG = r_eng.EngineConfig(n_hosts=3, chips_per_host=2, e_max=8,
                             events_per_day=48.0)
CFG = port_config(REF_CFG)
ENERGY = 1e-3
RLS = 2e-2
_ENERGY_KEYS = ("mean_mu", "mean_rho", "sched_it_mwh", "sched_fac_mwh",
                "sched_co2_t", "sched_co2_it_t", "sched_cfe_fac_mwh",
                "cfe_mu", "sched_tokens_mtok", "chip_power_mean",
                "chip_power_p95", "it_mwh", "fac_mwh", "shed_it_mwh",
                "committed_mw", "capacity_eur", "penalty_eur", "net_eur",
                "thr_mean", "tokens_mtok", "tokens_ckpt_mtok",
                "tokens_lost_mtok")
_RLS_KEYS = ("ar4_mae_norm", "tracking_err_mean")
_EXACT_KEYS = ("n_events", "active_s", "n_compliant")


def _specs():
    # event draw 3 at 48 events/day triggers inside the first hour
    return r_specs(countries=("SE", "DE", "PL"), seeds=(2,), horizon_h=1,
                   products=("FFR",), reserve_rhos=(0.0, 0.2),
                   event_seeds=(3,))


@pytest.fixture(scope="module")
def world():
    """The reference rolled out on its own draws (summary + full, and a
    telemetry summary), and the port on the same inputs (full, and a
    telemetry summary)."""
    specs = _specs()
    rb = r_build(specs)
    pb = build_scenario_batch(port_specs(specs), device=CPU)
    freq, loads, noise = ref_inputs(REF_CFG, rb)
    ref_full = r_eng.engine_rollout(REF_CFG, rb, reduce="full", freq=freq,
                                    loads=loads)
    ops = (np.asarray(ref_full["mu_h"]), np.asarray(ref_full["rho_h"]))
    kw = dict(freq=freq, loads=loads, noise=noise, ops=ops, device=CPU)
    full = eng.engine_rollout(CFG, pb, reduce="full", **kw)
    tel_cfg = dataclasses.replace(REF_CFG, telemetry=True)
    ref_tel = r_eng.engine_rollout(tel_cfg, rb, freq=freq, loads=loads)
    tel = eng.engine_rollout(port_config(tel_cfg), pb, **kw)
    return dict(rb=rb, pb=pb, inputs=(freq, loads, noise), ops=ops,
                ref_full=ref_full, full=full, ref_tel=ref_tel, tel=tel)


def test_events_detected(world):
    assert (n(world["full"]["n_events"]) > 0).all()


def _check_summary(out, ref):
    for k in _ENERGY_KEYS:
        assert_close(n(out[k]), ref[k], rtol=ENERGY, atol=1e-6, msg=k)
    for k in _RLS_KEYS:
        assert_close(n(out[k]), ref[k], rtol=RLS, msg=k)
    for k in _EXACT_KEYS:
        np.testing.assert_array_equal(n(out[k]), np.asarray(ref[k]), k)
    for f in ("t_event_s", "valid", "budget_ok", "sustain_ok"):
        for ev in ("events", "events_sched"):
            np.testing.assert_array_equal(
                n(getattr(out[ev], f)), np.asarray(getattr(ref[ev], f)),
                err_msg=f"{ev}.{f}")
    for f in ("t_full_ms", "sustain_s", "delivered_mw", "delivered_frac"):
        for ev in ("events", "events_sched"):
            assert_close(n(getattr(out[ev], f)),
                         np.asarray(getattr(ref[ev], f)), rtol=ENERGY,
                         atol=1e-4, msg=f"{ev}.{f}")


def test_full_rollout_summary_matches_reference(world):
    _check_summary(world["full"], world["ref_full"])


def test_full_rollout_per_second_traces_match_reference(world):
    out, ref = world["full"], world["ref_full"]
    np.testing.assert_array_equal(n(out["trig"]), np.asarray(ref["trig"]))
    np.testing.assert_array_equal(n(out["shed"]), np.asarray(ref["shed"]))
    m, rm = out["metrics"], ref["metrics"]
    for f in ("host_power", "it_power", "facility_power", "envelope",
              "chip_power_mean", "chip_power_p95"):
        a, b = n(getattr(m, f)), np.asarray(getattr(rm, f))
        assert a.shape == b.shape, f
        # per-tick physics: the RLS prediction amplifies ulp differences
        # at isolated ticks, so hold the bulk and the mean
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
        assert np.quantile(rel, 0.99) < ENERGY, f
        assert rel.mean() < ENERGY / 10, f
    np.testing.assert_array_equal(n(m.ffr_active), np.asarray(rm.ffr_active))
    err = np.abs(n(m.ar4_abs_err) - np.asarray(rm.ar4_abs_err))
    assert err.mean() < 0.5          # W, design_host = 600 W
    assert_close(n(out["load_sec"]).mean(-1),
                 np.asarray(ref["load_sec"]).mean(-1), rtol=ENERGY)


def test_summary_matches_reduced_full(world):
    """The in-loop hourly reducer == reducing the full stacks."""
    out = world["full"]
    red = eng.summarize_rollout(CFG, world["pb"], out)
    for k, v in red.items():
        assert_close(n(out[k]), n(v), rtol=1e-4, atol=1e-4, msg=k)
    # and the reference's reducer agrees on its own stacks
    rred = r_eng.summarize_rollout(REF_CFG, world["rb"], world["ref_full"])
    for k, v in rred.items():
        tol = RLS if k in _RLS_KEYS else ENERGY
        assert_close(n(red[k]), v, rtol=tol, atol=1e-6, msg=k)


def test_summary_mode_with_telemetry_matches_reference(world):
    out, ref = world["tel"], world["ref_tel"]
    _check_summary(out, ref)
    t, rt = out["telemetry"], ref["telemetry"]
    assert set(t) == set(rt)
    for k in ("hour_n", "resp_hist", "resp_valid", "n_budget_ok",
              "resp_budget_ms"):
        np.testing.assert_array_equal(n(t[k]), np.asarray(rt[k]), k)
    for k in ("rls_rms_h", "track_rms_h"):
        assert_close(n(t[k]), rt[k], rtol=RLS, msg=k)
    for k in ("sat_frac_h", "resp_ms", "resp_ms_mean", "resp_ms_max",
              "load_final"):
        assert_close(n(t[k]), rt[k], rtol=ENERGY, atol=1e-5, msg=k)
    for k in ("slew_max_h", "slew_min_h"):
        assert_close(n(t[k]), rt[k], rtol=0.05, atol=2e-3, msg=k)
    # histogram counts: all buckets, to within a few ticks at the edges
    assert np.abs(n(t["track_hist"]) - np.asarray(rt["track_hist"])
                  ).max() <= 0.01 * 3600
    assert n(t["track_hist"]).sum(-1).tolist() == np.asarray(
        rt["track_hist"]).sum(-1).tolist()
    for leaf in torch.utils._pytree.tree_leaves(out):
        assert all(d != 3600 for d in leaf.shape), leaf.shape


def test_telemetry_off_leaves_default_outputs_unchanged(world):
    full, tel = world["full"], world["tel"]
    assert "telemetry" not in full
    for k, v in full.items():
        if k in ("metrics", "trig", "shed", "load_sec"):
            continue
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, tel[k]), k
        else:
            for a, b in zip(v, tel[k]):
                assert torch.equal(a, b), k


def test_chunk_summary_and_finalize_match_reference(world):
    """The port's monoid layer applied to the reference's own output
    equals the reference's."""
    rb, ref = world["rb"], world["ref_tel"]
    tel_cfg = dataclasses.replace(REF_CFG, telemetry=True)
    want = r_eng.sweep_finalize(r_eng.chunk_summary(tel_cfg, ref, rb))
    out = world["tel"]
    got = eng.sweep_finalize(eng.chunk_summary(port_config(tel_cfg), out,
                                               world["pb"]))
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "telemetry":
            continue
        tol = RLS if k in _RLS_KEYS else ENERGY
        assert got[k] == pytest.approx(v, rel=tol, abs=1e-6), k
    for k in ("rls_rms", "track_rms"):
        assert got["telemetry"][k] == pytest.approx(
            want["telemetry"][k], rel=RLS)
    np.testing.assert_array_equal(got["telemetry"]["resp_hist"],
                                  want["telemetry"]["resp_hist"])


def test_summary_merge_is_invariant_to_chunking_and_order(world):
    cfg = port_config(dataclasses.replace(REF_CFG, telemetry=True))
    out, pb = world["tel"], world["pb"]
    whole = eng.chunk_summary(cfg, out, pb)
    lanes = [torch.tensor([1., 1, 0, 0, 0, 0]),
             torch.tensor([0., 0, 1, 0, 1, 0]),
             torch.tensor([0., 0, 0, 1, 0, 1])]
    parts = [eng.chunk_summary(cfg, out, pb, lane=m) for m in lanes]
    for order in ((0, 1, 2), (2, 0, 1), (1, 2, 0)):
        agg = eng.summary_init(cfg, device=CPU)
        for i in order:
            agg = eng.summary_merge(agg, parts[i])
        for k in whole:
            assert_close(n(agg[k]), n(whole[k]), rtol=1e-5, atol=1e-5,
                         msg=k)
    ident = eng.summary_merge(eng.summary_init(cfg, device=CPU), whole)
    for k in whole:
        assert torch.equal(ident[k], whole[k]), k
    with pytest.raises(ValueError, match="key mismatch"):
        eng.summary_merge(eng.summary_init(CFG, device=CPU), whole)


def test_default_path_and_sweep(world):
    """With no overrides the port draws its own inputs and runs its own
    Tier-3 search; its operating points equal the reference's, and the
    streamed sweep (chunks of 4 and 2) equals the monolithic rollout."""
    specs = port_specs(_specs())
    pb = world["pb"]
    mono = eng.engine_rollout(CFG, pb, device=CPU)
    np.testing.assert_array_equal(n(mono["mu_h"]), world["ops"][0])
    np.testing.assert_array_equal(n(mono["rho_h"]), world["ops"][1])
    want = eng.sweep_finalize(eng.chunk_summary(CFG, mono, pb))
    done = []
    got = eng.engine_sweep(CFG, specs, chunk_size=4, device=CPU,
                           progress=lambda i, k: done.append((i, k)))
    assert done == [(1, 2), (2, 2)]
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    assert want["n_scenarios"] == 6.0 and want["seconds"] == 6 * 3600.0


def test_engine_step_reproduces_the_rollout_ticks(world):
    freq, loads, noise = world["inputs"]
    pb = world["pb"]
    params, _, _ = eng.engine_params(CFG, pb, ops=tuple(
        torch.from_numpy(x) for x in world["ops"]))
    state = eng.engine_init(CFG, pb.seed, device=CPU)
    trig_hz = torch.tensor([49.7] * pb.n)
    ticks = 30
    for t in range(ticks):
        state, (sec, m) = eng.engine_step(
            CFG, params, state,
            (torch.from_numpy(loads[:, t]),
             torch.from_numpy(freq[:, t]) < trig_hz,
             torch.ones(pb.n, dtype=torch.bool), t),
            noise=torch.from_numpy(noise[:, t]))
        assert torch.equal(m.it_power, world["full"]["metrics"].it_power[:, t])
    assert n(state.acc.n_s).tolist() == [float(ticks)] * pb.n
    want = n(world["full"]["metrics"].chip_power_mean[:, :ticks]).sum(-1)
    assert_close(n(state.acc.chip_mean), want, rtol=1e-6)


def test_convert_engine_state_continues_the_reference_carry(world):
    rs = r_eng.engine_init(REF_CFG, r_eng.scenario_keys(world["rb"])[1][0])
    st = convert.engine_state(
        {k: (np.asarray(v)[None] if not isinstance(v, dict) else
             {kk: np.asarray(vv)[None] for kk, vv in v.items()})
         for k, v in np_tree(rs).items()}, seed=[2], device=CPU)
    ref0 = eng.engine_init(CFG, torch.tensor([2]), device=CPU)
    for a, b in zip(torch.utils._pytree.tree_leaves(st),
                    torch.utils._pytree.tree_leaves(ref0)):
        assert torch.equal(a, b)


def test_hourly_only_rollout_matches_reference():
    specs = r_specs(countries=("SE", "PL"), horizon_h=48,
                    reserve_rhos=(0.1,))
    for rho_mode in ("batch", "tier3"):
        rcfg = r_eng.EngineConfig(with_seconds=False, rho_mode=rho_mode,
                                  price_aware=True)
        ref = r_eng.engine_rollout(rcfg, r_build(specs))
        out = eng.engine_rollout(port_config(rcfg),
                                 build_scenario_batch(port_specs(specs),
                                                      device=CPU),
                                 device=CPU)
        assert "events" not in out
        np.testing.assert_array_equal(n(out["mu_h"]), np.asarray(ref["mu_h"]))
        for k in ("sched_it_mwh", "sched_fac_mwh", "sched_co2_t",
                  "cfe_mu", "sched_tokens_mtok", "mean_mu", "mean_rho"):
            assert_close(n(out[k]), ref[k], rtol=ENERGY, msg=k)


def test_engine_rollout_validates_its_inputs():
    pb = build_scenario_batch(port_specs(r_specs(countries=("SE",),
                                                 horizon_h=1)), device=CPU)
    T = 3600
    with pytest.raises(ValueError, match="reduce"):
        eng.engine_rollout(CFG, pb, reduce="everything", device=CPU)
    with pytest.raises(ValueError, match="scenario"):
        eng.engine_rollout(CFG, pb, mesh=ScenarioMesh((CPU,), ("data",)),
                           device=CPU)
    with pytest.raises(ValueError, match="kind"):
        eng.engine_rollout(CFG, pb, mesh="cluster", device=CPU)
    with pytest.raises(ValueError, match=r"freq.*h_max \* 3600"):
        eng.engine_rollout(CFG, pb, freq=torch.zeros(1, T - 1), device=CPU)
    good = torch.full((1, T), 50.0)
    with pytest.raises(ValueError, match=r"loads.*n_hosts"):
        eng.engine_rollout(CFG, pb, freq=good, device=CPU,
                           loads=torch.zeros(1, T, CFG.n_hosts + 1))
    with pytest.raises(ValueError, match="noise"):
        eng.engine_rollout(CFG, pb, freq=good, device=CPU,
                           noise=torch.zeros(1, T, CFG.n_hosts, 1))
    with pytest.raises(ValueError, match="ops"):
        eng.engine_rollout(CFG, pb, freq=good, device=CPU,
                           ops=(torch.zeros(1, 2), torch.zeros(1, 2)))
    with pytest.raises(ValueError, match="chunk_size"):
        eng.engine_sweep(CFG, [], chunk_size=0, device=CPU)
    with pytest.raises(ValueError, match="empty"):
        eng.engine_sweep(CFG, [], chunk_size=4, device=CPU)
    with pytest.raises(ValueError, match="scenario"):
        eng.engine_sweep(CFG, port_specs(_specs()), chunk_size=4,
                         mesh=ScenarioMesh((CPU,), ("data",)), device=CPU)
    with pytest.raises(ValueError, match="rho_mode"):
        eng.EngineConfig(rho_mode="free")


def test_settle_reserve_matches_reference(world):
    """The constant-band settlement rule on the twin-coupled events."""
    import jax
    import repro.core.reserve as r_res
    import repro_torch.core.reserve as res
    rb, pb = world["rb"], world["pb"]
    ref_ev = world["ref_full"]["events"]
    want = jax.vmap(r_res.settle_reserve)(ref_ev, rb.product_idx,
                                          rb.reserve_rho, rb.mw,
                                          rb.pue_design, rb.hours)
    got = res.settle_reserve(world["full"]["events"], pb.product_idx,
                             pb.reserve_rho, pb.mw, pb.pue_design, pb.hours)
    assert set(got) == set(want)
    for k in ("committed_mw", "capacity_eur", "penalty_eur", "net_eur"):
        assert_close(n(got[k]), want[k], rtol=ENERGY, atol=1e-4, msg=k)
    for k in ("n_events", "n_compliant"):
        np.testing.assert_array_equal(n(got[k]), np.asarray(want[k]), k)
    # a constant band settles as the engine's hourly-band rule does
    assert_close(n(got["net_eur"]), n(world["full"]["net_eur"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# engine_step with one second per lane (the online service's tick)
# ---------------------------------------------------------------------------


def _lane(tree, i):
    return torch.utils._pytree.tree_map(lambda x: x[i:i + 1], tree)


def _leaves_equal(a, b):
    leaves = torch.utils._pytree.tree_leaves
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def test_engine_step_per_lane_seconds(world):
    """An (N,) tensor of equal seconds is the int path bit for bit; lanes
    at different seconds (across the warm-up gate and past the last hour)
    equal one-lane calls at their own int second."""
    freq, loads, noise = world["inputs"]
    pb = world["pb"]
    params, _, _ = eng.engine_params(CFG, pb, ops=tuple(
        torch.from_numpy(x) for x in world["ops"]))
    trig_hz = torch.tensor([49.7] * pb.n)
    on = torch.ones(pb.n, dtype=torch.bool)
    a = b = eng.engine_init(CFG, pb.seed, device=CPU)
    for t in range(0, 80, 4):
        xs = (torch.from_numpy(loads[:, t]),
              torch.from_numpy(freq[:, t]) < trig_hz, on)
        a, out_a = eng.engine_step(CFG, params, a, xs + (t,))
        b, out_b = eng.engine_step(CFG, params, b,
                                   xs + (torch.full((pb.n,), t),))
        assert _leaves_equal(a, b) and _leaves_equal(out_a, out_b), t
    ts = torch.tensor([10, 59, 60, 1234, 3599, 5000])
    rows = torch.from_numpy(loads[:, 30])
    below = torch.tensor([True, False, True, False, True, False])
    new, (sec, m) = eng.engine_step(CFG, params, a, (rows, below, on, ts))
    for i, t in enumerate(ts.tolist()):
        one, (sec1, m1) = eng.engine_step(
            CFG, _lane(params, i), _lane(a, i),
            (rows[i:i + 1], below[i:i + 1], on[i:i + 1], t))
        assert _leaves_equal(_lane(new, i), one), t
        assert _leaves_equal(_lane((sec, m), i), (sec1, m1)), t


# ---------------------------------------------------------------------------
# The seconds tier under the configurations the world above does not use
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["step_transient", "pue_blind", "fcr_d",
                                     "workload_weight"])
def test_seconds_tier_variant_matches_reference(variant):
    """Step transients, a PUE-blind plant, the FCR-D product and the
    workload-weighted objective, each against the reference on its own
    draws and operating points (2 countries x bands 0 / 0.2, 1 h)."""
    over = {"step_transient": dict(step_transient_amp=0.05),
            "pue_blind": dict(pue_aware=False),
            "workload_weight": dict(workload_weight=1.0)}.get(variant, {})
    rcfg = dataclasses.replace(REF_CFG, **over)
    specs = r_specs(countries=("SE", "PL"), seeds=(2,), horizon_h=1,
                    products=("FCR-D" if variant == "fcr_d" else "FFR",),
                    reserve_rhos=(0.0, 0.2), event_seeds=(3,))
    rb = r_build(specs)
    freq, loads, noise = ref_inputs(rcfg, rb)
    ref = r_eng.engine_rollout(rcfg, rb, freq=freq, loads=loads)
    ops = (np.asarray(ref["mu_h"]), np.asarray(ref["rho_h"]))
    out = eng.engine_rollout(
        port_config(rcfg), build_scenario_batch(port_specs(specs),
                                                device=CPU),
        freq=freq, loads=loads, noise=noise, ops=ops, device=CPU)
    assert n(out["n_events"]).sum() > 0
    _check_summary(out, ref)
