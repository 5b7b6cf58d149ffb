"""The paper's experiments on the port: E2 (inner-loop step response),
E4 (closed-loop demand following), E7 (FFR trigger-to-target latency
through the safety island, and its contrast arm through a Python
supervisor under allocation churn) and E8 (the PUE-aware controller
against the CI-only one over six grids, paper Fig. 5, with E9's PUE
design axis in the same batch).

The counterparts of ``benchmarks/e2_step_response.py``,
``e4_closed_loop.py``, ``e7_fr_latency.py`` and ``e8_multicountry.py``
of the JAX reference, with the same constants.  The plant and the PID
run on ``device``: E4's closed loop calls ``pid.pid_step`` once per 5 ms
tick for all seeds and chips together, one ``pid_update`` launch per
tick on a card.  E8's sweep is one batched pass over every scenario on
the batch's device (:func:`e8_metrics`), no loop over scenarios.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

import repro_torch.core.ar4 as ar4
import repro_torch.core.dispatch as dispatch
import repro_torch.core.island as island_lib
import repro_torch.core.pid as pid
import repro_torch.core.plant as plant
import repro_torch.core.pue as pue_lib
import repro_torch.core.tier3 as tier3
from repro_torch import resolve_device
from repro_torch.grid.markets import FR_PRODUCTS
from repro_torch.grid.scenarios import (ScenarioSpec, build_scenario_batch,
                                        masked_quantile_sorted)
from repro_torch.grid.signals import COUNTRY_ORDER

# E2: the paper's 280 -> 200 W step, settle to the +/-2 % band
E2_STEP_FROM, E2_STEP_TO = 280.0, 200.0
E2_PAPER_MS = {"matmul": 18, "inference": 21, "bursty": 29}

# E4: 30 s at 200 Hz, one host of 3 chips, Tier-2 at 1 Hz
E4_PAPER_PCT = {"inference": 1.68, "matmul": 2.12, "bursty": 11.08}
E4_HORIZON_S = 30
E4_CHIPS = 3
E4_SEEDS = (0, 1, 2)
E4_BAND_PCT = 5.0

# E7: 30 trials per workload through the island, 90 triggers through the
# supervisor; the paper's median / max / margin
E7_TRIALS_PER_WORKLOAD = 30
E7_OP_INDEX = 23
E7_FREQ_HZ = 49.45
E7_PAPER = {"median_ms": 97.2, "max_ms": 101.1, "margin_x": 6.9,
            "supervisor_p99_ms": 250.0}
E7_BUDGET_MS = FR_PRODUCTS["FFR"].activation_budget_ms

# E8: 28 days per scenario; the high-utilisation level, the shed depths
# each controller picks among, and the mean utilisation the work requires
HORIZON_H = 28 * 24
MW_LEVELS = (1.0, 10.0, 50.0)
MU_HI = 0.9
LO_LEVELS = (0.15, 0.25, 0.4)
DEMAND = 0.6
METRIC_KEYS = (
    "delta_facility_pp", "facility_reduction_blind_pp",
    "facility_reduction_aware_pp", "it_reduction_blind_pp",
    "cooling_drag_pp", "shed_depth_blind", "shed_depth_aware",
    "cfe_blind", "cfe_aware",
)
E8_PAPER_PP = (2.5, 5.8)   # the drag the aware controller closes, 50 MW
E9_DESIGNS = (1.10, 1.20, 1.30, 1.40)


def e2_settle_ms(workload: str, n_trials: int = 20, seed: int = 0, *,
                 device="cuda") -> list:
    """Settle time (ms) of each trial of the 280 -> 200 W cap step to the
    +/-2 % band, at 1 kHz telemetry resolution over 120 ms.

    The trials run as one plant of ``n_trials`` chips; the initial power
    jitter and the telemetry noise are the reference's numpy draws in its
    order, so the same seed gives the same trials.
    """
    dev = resolve_device(device)
    tau = plant.workload_tau_ms(workload)
    rng = np.random.default_rng(seed)
    p0 = np.empty(n_trials)
    noise = np.empty((n_trials, 120))
    for i in range(n_trials):
        p0[i] = rng.normal(0, 0.8)
        noise[i] = rng.normal(0, 0.4, 120)
    st = dataclasses.replace(
        plant.init_plant(n_trials, cap=300.0, device=dev),
        power=torch.from_numpy(E2_STEP_FROM + p0).to(dev, torch.float32))
    st = plant.write_cap(st, E2_STEP_TO)
    load = torch.full((n_trials,), 0.97, device=dev)
    trace = []
    for _ in range(120):
        st = plant.plant_step(st, load, 1.0, tau_ms=tau)
        trace.append(st.power)
    tr = torch.stack(trace, 1).cpu().numpy().astype(np.float64) + noise
    inband = np.abs(tr - E2_STEP_TO) <= 0.02 * E2_STEP_TO
    out = []
    for row in inband:
        settle = next((k for k in range(len(row)) if row[k:].all()), None)
        out.append(settle if settle is not None else len(row))
    return out


def e4_envelope(n_ticks: int) -> np.ndarray:
    """Demand-following trajectory: the host envelope steps between
    levels."""
    env_levels = np.array([720.0, 560.0, 640.0, 480.0, 680.0, 600.0])
    return np.repeat(env_levels, n_ticks // len(env_levels) + 1)[:n_ticks]


def e4_loads(workload: str, seeds=E4_SEEDS,
             n_ticks: int = int(E4_HORIZON_S * plant.CONTROL_HZ), *,
             device="cuda") -> torch.Tensor:
    """(S, T, CHIPS) per-chip utilisation at the 200 Hz ticks: chip c of
    seed s draws from a generator seeded ``s * CHIPS + c`` on ``device``,
    at the bursty phase offsets (0, 0.33, 0.67)."""
    dev = resolve_device(device)
    t = torch.arange(n_ticks, dtype=torch.float32, device=dev) / \
        plant.CONTROL_HZ
    out = []
    for s in seeds:
        chips = []
        for c, ph in enumerate((0.0, 0.33, 0.67)):
            g = torch.Generator(device=dev).manual_seed(s * E4_CHIPS + c)
            chips.append(plant.workload_load(workload, t, phase=ph,
                                             generator=g, device=dev))
        out.append(torch.stack(chips, dim=-1))
    return torch.stack(out)


def e4_trace_batch(loads, env, tau_ms: float, *,
                   device="cuda") -> torch.Tensor:
    """The closed loop over a leading seed axis: ``loads`` (S, T, CHIPS),
    ``env`` (T,) host envelope in W.  Returns the (S, T) host power in W
    at every tick.

    Tier-2 (AR(4)/RLS on the normalised host power, then the cap
    rebalance) runs on each second's first tick, Tier-1 (``pid_step``,
    one ``pid_update`` launch for every seed and chip) and the plant on
    every 5 ms tick.
    """
    dev = resolve_device(device)
    loads = _loads_on(loads, dev)
    env = np.array(env, np.float32)
    S, T, C = loads.shape
    scale = C * plant.TDP
    sec_ticks = int(plant.CONTROL_HZ)

    def per_seed(x):
        return x.expand(S, C).contiguous()

    pid_st = pid.PIDState(*(per_seed(x) for x in
                            pid.init_pid(C, 250.0, device=dev)))
    p0 = plant.init_plant(C, cap=300.0, device=dev)
    pl = plant.PlantState(**{k: per_seed(v) for k, v in vars(p0).items()})
    rls = ar4.init_rls((S, 1), device=dev)
    caps = torch.full((S, C), 280.0, device=dev)
    host_power = pl.power.sum(-1)
    powers = []
    for k in range(T):
        if k % sec_ticks == 0:
            rls, _ = ar4.rls_update(rls, (host_power / scale)[:, None])
            pred = ar4.predict(rls) * scale
            caps = ar4.host_rebalance(
                pred, torch.full_like(pred, float(env[k])),
                torch.clamp(pl.power, min=plant.P_IDLE)[:, None, :],
                plant.CAP_MIN, plant.CAP_MAX)[:, 0]
        pid_st, u = pid.pid_step(pid_st, caps, pl.power, pl.temp)
        pl = plant.write_cap(pl, u)
        pl = plant.plant_step(pl, loads[:, k], 1000.0 / plant.CONTROL_HZ,
                              tau_ms=tau_ms)
        host_power = pl.power.sum(-1)
        powers.append(host_power)
    return torch.stack(powers, dim=1)


def e4_tracking_err(host_power, loads, env) -> torch.Tensor:
    """The (S,) mean tracking error in % of an (S, T) host-power trace
    over the ticks where demand meets the envelope, after a 2 s
    transient."""
    dev = host_power.device
    loads = _loads_on(loads, dev)
    env_t = torch.from_numpy(np.array(env, np.float32)).to(dev)
    T = host_power.shape[1]
    demand = plant.power_model(plant.F_NOMINAL, loads).sum(-1)
    k = torch.arange(T, device=dev)
    valid = (k > 2 * int(plant.CONTROL_HZ)) & (demand >= env_t * 0.98)
    err = torch.abs(host_power - env_t) / env_t
    err_sum = torch.where(valid, err, 0.0).sum(-1)
    return 100.0 * err_sum / torch.clamp(valid.sum(-1).float(), min=1.0)


def e4_replay_batch(loads, env, tau_ms: float, *,
                    device="cuda") -> torch.Tensor:
    """E4's (S,) tracking error in %: :func:`e4_tracking_err` of
    :func:`e4_trace_batch`."""
    hp = e4_trace_batch(loads, env, tau_ms, device=device)
    return e4_tracking_err(hp, loads, env)


def _loads_on(loads, dev) -> torch.Tensor:
    if isinstance(loads, torch.Tensor):
        return loads.to(dev, torch.float32)
    return torch.from_numpy(np.array(loads, np.float32)).to(dev)


def e4_in_band(errs: dict) -> dict:
    """The reference bench's flags on seed 0: inference and matmul inside
    the 5 % band, bursty above it (the paper's cascade diagnostic)."""
    return {"inference_in_band": bool(errs["inference"][0] < E4_BAND_PCT),
            "matmul_in_band": bool(errs["matmul"][0] < E4_BAND_PCT),
            "bursty_above_band": bool(errs["bursty"][0] > E4_BAND_PCT)}


def settle_ms_sim(workload: str, rng, *, device="cuda") -> float:
    """Plant settle (ms) from the armed operating point to 95 % of the
    FFR step, through the slew-governed firmware path (5 ms NVML window
    included)."""
    dev = resolve_device(device)
    tau = plant.workload_tau_ms(workload)
    p0 = {"matmul": 280.0, "inference": 197.0, "bursty": 280.0}[workload]
    target = 200.0 if p0 > 210.0 else 140.0
    st = dataclasses.replace(
        plant.init_plant(1, cap=300.0, device=dev),
        power=torch.tensor([p0 + rng.normal(0, 1.0)], dtype=torch.float32,
                           device=dev))
    st = plant.write_cap(st, target)
    load = torch.tensor(
        [{"matmul": 0.97, "inference": 0.58, "bursty": 0.95}[workload]],
        device=dev)
    cross = p0 - 0.95 * (p0 - target)
    for k in range(1, 400):
        st = plant.plant_step(st, load, 1.0, tau_ms=tau,
                              slew_w_ms=plant.GOV_SLEW)
        if float(st.power[0]) <= cross:
            return float(k)
    return 400.0


def e7_cap_table() -> np.ndarray:
    """The island's register-file rows: Tier-3's (mu x rho) cap table for
    one 3-chip, 900 W host, one column per chip."""
    rows = tier3.cap_table(3, 900.0, 100.0, 300.0).reshape(-1)
    return np.repeat(rows[:, None], 3, axis=1)


def e7_island_trials(port: int, trials_per_workload: int =
                     E7_TRIALS_PER_WORKLOAD, seed: int = 7, *,
                     device="cuda") -> dict:
    """E7's main arm: each trial sends one UDP trigger to a
    :class:`SafetyIsland`, takes the wall time until the island has
    written the caps, and adds the plant's settle (:func:`settle_ms_sim`
    on ``device``).  Returns per-workload end-to-end ms, the island's
    dispatch times (us) and the rng for the contrast arm."""
    rng = np.random.default_rng(seed)
    isl = island_lib.SafetyIsland(3, e7_cap_table(), port=port)
    isl.arm(E7_OP_INDEX)
    isl.start()
    time.sleep(0.1)
    per_workload = {w: [] for w in plant.WORKLOADS}
    dispatch_us = []
    try:
        for w in plant.WORKLOADS:
            for _ in range(trials_per_workload):
                n0 = isl.trigger_count
                t_send = isl.send_trigger(op_index=E7_OP_INDEX,
                                          freq_hz=E7_FREQ_HZ)
                if not isl.wait_for_trigger(n0, timeout_s=2.0):
                    raise RuntimeError("the island lost a trigger")
                wall_ms = (isl.last_trigger_ns - t_send) / 1e6
                dispatch_us.append(wall_ms * 1e3)
                per_workload[w].append(
                    wall_ms + settle_ms_sim(w, rng, device=device))
                # randomised inter-trial delay (defeats caching)
                time.sleep(float(rng.uniform(0.002, 0.01)))
    finally:
        isl.stop()
    return dict(per_workload=per_workload, dispatch_us=dispatch_us, rng=rng)


def e7_supervisor_trials(rng, n: int = 90, *,
                         retained_objects: int = 1_500_000) -> np.ndarray:
    """E7's contrast arm: the same trigger through
    :class:`PythonSupervisor` while :class:`AllocationChurn` runs; the
    (n,) dispatch times in ms."""
    sup = island_lib.PythonSupervisor(3, e7_cap_table())
    churn = island_lib.AllocationChurn(retained_objects=retained_objects)
    sup.start()
    churn.start()
    lat = []
    try:
        for _ in range(n):
            t0 = sup.send_trigger(op_index=E7_OP_INDEX, freq_hz=E7_FREQ_HZ)
            # a collection pause of seconds on a loaded host is what this
            # arm measures: wait it out rather than stop at 2 s
            lat.append((sup.wait_done(timeout_s=60.0) - t0) / 1e6)
            time.sleep(float(rng.uniform(0.002, 0.01)))
    finally:
        churn.stop()
        sup.stop()
    return np.asarray(lat)


def e8_metrics(batch, noise, *, picks=None) -> dict:
    """Every E8 metric of every scenario of ``batch``: (N,) tensors on the
    batch's device, one batched pass.

    Both controllers schedule the same work: ``MU_HI`` in the hours their
    signal ranks best, a shed depth from ``LO_LEVELS`` elsewhere.  The
    blind one ranks by CI and picks its depth by board CO2, the aware one
    ranks by CI x PUE(MU_HI, T_amb) and picks by metered CO2.  One sort of
    the (N, 2, H) signal stack gives the thresholds and the green-hour
    median; the (N, 2L+1, H) candidates (the flat baseline last) carry the
    site-size ``noise`` (N, H) and replay in one ``replay_schedule``.

    Besides ``METRIC_KEYS`` the dict holds the candidates' metered and
    board CO2 integrals (``co2_candidates``, ``co2_it_candidates``, (N,
    2L+1)).  ``picks`` = (blind, aware) (N,) indices into ``LO_LEVELS``
    replaces the two argmin picks: near-ties between candidates can flip
    a pick between two frameworks, so the tests pin them through it, as
    Tier-3 is pinned through ``ops=``."""
    ci, t_amb, mask = batch.ci, batch.t_amb, batch.mask
    n, h = mask.shape
    valid = mask > 0
    hv = mask.sum(-1)                                          # (N,)
    work = DEMAND * hv
    los = torch.tensor(LO_LEVELS, dtype=torch.float32, device=mask.device)
    n_lo = los.shape[0]
    n_hi = torch.clamp(torch.round(
        (work[:, None] - los * hv[:, None]) / (MU_HI - los)),
        min=torch.zeros_like(hv[:, None]), max=hv[:, None])   # (N, L)

    pue_hi = pue_lib.pue(MU_HI, t_amb, pue_design=batch.pue_design[:, None])
    sigs = torch.stack([ci, ci * pue_hi], 1)                   # (N, 2, H)
    sigs_sorted = torch.sort(torch.where(valid[:, None], sigs, torch.inf),
                             dim=-1).values
    thr = dispatch.thresholds_from_sorted(
        sigs_sorted, n_hi[:, None, :].expand(n, 2, n_lo))      # (N, 2, L)
    sched = dispatch.schedule_from_threshold(
        sigs[:, :, None, :], thr[..., None], los[:, None],
        mask[:, None, None, :], MU_HI)                         # (N, 2, L, H)

    flat = torch.where(valid, DEMAND, 0.0)
    candidates = torch.cat([sched.reshape(n, 2 * n_lo, h), flat[:, None]], 1)
    tot = dispatch.replay_schedule(
        candidates + noise[:, None], ci[:, None], t_amb[:, None],
        mask[:, None], pue_design=batch.pue_design[:, None])
    fac, it = tot["co2"], tot["co2_it"]                        # (N, 2L+1)

    if picks is None:
        i_b = torch.argmin(it[:, :n_lo], -1)
        i_a = torch.argmin(fac[:, n_lo:2 * n_lo], -1)
    else:
        i_b, i_a = (torch.as_tensor(p, device=mask.device).long()
                    for p in picks)
    rows = torch.arange(n, device=mask.device)
    fac_0, it_0 = fac[:, -1], it[:, -1]
    red_b = 100.0 * (fac_0 - fac[rows, i_b]) / fac_0
    red_a = 100.0 * (fac_0 - fac[rows, n_lo + i_a]) / fac_0
    red_it_b = 100.0 * (it_0 - it[rows, i_b]) / it_0

    green = masked_quantile_sorted(sigs_sorted[:, 0], hv, 50.0)

    def cfe(mu):
        hit = torch.where((ci <= green[:, None]) & valid, mu, 0.0)
        return hit.sum(-1) / torch.clamp((mu * mask).sum(-1), min=1e-9)

    return {
        "delta_facility_pp": red_a - red_b,
        "facility_reduction_blind_pp": red_b,
        "facility_reduction_aware_pp": red_a,
        "it_reduction_blind_pp": red_it_b,
        "cooling_drag_pp": red_it_b - red_b,
        "shed_depth_blind": los[i_b],
        "shed_depth_aware": los[i_a],
        "cfe_blind": cfe(sched[rows, 0, i_b]),
        "cfe_aware": cfe(sched[rows, 1, i_a]),
        "co2_candidates": fac,
        "co2_it_candidates": it,
    }


def e8_noise(batch) -> torch.Tensor:
    """Site-size load noise (N, H): N(0, 0.10 / sqrt(MW)) per hour from
    numpy's ``default_rng(seed + 23)`` per scenario, the reference
    bench's own stream; on the batch's device."""
    seeds = batch.seed.cpu().numpy()
    mws = batch.mw.cpu().numpy().astype(np.float64)
    out = np.zeros((batch.n, batch.h_max), np.float32)
    for i in range(batch.n):
        rng = np.random.default_rng(int(seeds[i]) + 23)
        out[i] = rng.normal(0.0, 0.10 / np.sqrt(mws[i]), batch.h_max)
    return torch.from_numpy(out).to(batch.mask.device)


def e8_specs(fast: bool = False):
    """(specs, groups) of one sweep covering Fig. 5a (six grids at 10 MW),
    Fig. 5b (SE and PL at 1/10/50 MW) and E9's PUE design axis.  A group
    is (kind, country, level, scenario indices), ``level`` the MW size
    (fig5) or the PUE design (e9); identical specs replay once."""
    countries = COUNTRY_ORDER if not fast else ["SE", "DE", "PL"]
    seeds = (0,) if fast else (0, 1, 2)
    seasons = (15, 105, 196, 288) if not fast else (105, 196)
    specs: list[ScenarioSpec] = []
    groups: list[tuple] = []
    seen: dict[ScenarioSpec, int] = {}

    def add_group(kind, country, level, mw, pue_design, g_seeds):
        idx = []
        for s in g_seeds:
            for d in seasons:
                spec = ScenarioSpec(country=country, seed=s, start_day=d,
                                    mw=mw, pue_design=pue_design,
                                    horizon_h=HORIZON_H)
                if spec not in seen:
                    seen[spec] = len(specs)
                    specs.append(spec)
                idx.append(seen[spec])
        groups.append((kind, country, level, idx))

    for c in countries:
        add_group("fig5a", c, 10.0, 10.0, pue_lib.PUE_DESIGN, seeds)
    for c in ("SE", "PL"):
        for mw in MW_LEVELS:
            add_group("fig5b", c, mw, mw, pue_lib.PUE_DESIGN, seeds)
    for pd in E9_DESIGNS:
        for c in ("SE", "PL"):
            add_group("e9", c, pd, 10.0, pd, (0,))
    return specs, groups


def build_e8_batch(fast: bool = False, *, device="cuda"):
    """(batch, groups) of :func:`e8_specs` on ``device``: 144 scenarios x
    672 h, or 26 with ``fast``."""
    specs, groups = e8_specs(fast)
    return build_scenario_batch(specs, device=resolve_device(device)), \
        groups


def e8_group_rows(metrics: dict, groups) -> list[dict]:
    """One row per group: each metric averaged over the group's season x
    seed replicas, as host floats."""
    host = {k: np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor)
                          else v) for k, v in metrics.items()}
    rows = []
    for kind, country, level, idx in groups:
        row = {"kind": kind, "country": country, "mw": float(level)}
        for k in METRIC_KEYS:
            row[k] = float(np.mean(host[k][idx]))
        rows.append(row)
    return rows


def e8_summary(rows: list[dict]) -> dict:
    """The reference bench's headline from :func:`e8_group_rows`: the
    cooling drag the aware controller closes (min, max over Fig. 5's
    rows), ``delta_pp`` per grid at 10 MW and per MW for SE and PL, the
    schedule difference at the meter (min, max), whether the drag is
    widest on the low-CI grid (SE against PL at 10 MW, 0.3 pp slack) and
    E9's drag per PUE design.  Printed beside the paper's 2.5-5.8 pp; the
    reference enforces none of it."""
    fig5 = [r for r in rows if r["kind"] in ("fig5a", "fig5b")]
    drag = [r["cooling_drag_pp"] for r in fig5]
    sched = [r["delta_facility_pp"] for r in fig5]
    d10 = {r["country"]: r["cooling_drag_pp"] for r in fig5
           if r["mw"] == 10.0}
    e9: dict = {}
    for r in rows:
        if r["kind"] == "e9":
            e9.setdefault(r["mw"], []).append(r["cooling_drag_pp"])
    return {
        "drag_closed_pp": (min(drag), max(drag)),
        "delta_pp_10mw": {r["country"]: r["delta_facility_pp"]
                          for r in rows if r["kind"] == "fig5a"},
        "delta_pp_by_mw": {f"{int(r['mw'])}mw.{r['country']}":
                           r["delta_facility_pp"]
                           for r in rows if r["kind"] == "fig5b"},
        "scheduling_delta_pp": (min(sched), max(sched)),
        "low_ci_widest": (int(d10["SE"] >= d10["PL"] - 0.3)
                          if "SE" in d10 and "PL" in d10 else None),
        "e9_drag_pp": {f"{pd:.2f}": float(np.mean(v))
                       for pd, v in sorted(e9.items())},
        "paper_pp": E8_PAPER_PP,
    }
