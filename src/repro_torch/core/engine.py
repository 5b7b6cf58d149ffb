"""Unified three-tier rollout engine: the port of ``repro.core.engine``.

One rollout replays a :class:`~repro_torch.grid.scenarios.ScenarioBatch`
through every tier: Tier-3 (mu, rho) selection, the hourly schedule's
energy and carbon, frequency synthesis, the fused 1 Hz tick (reserve
detection + the twin's Tier-2/plant/meter physics), per-event verdicts
and settlement.  Where the reference runs ``jit(vmap(lax.scan))``, the
port runs Python loops over hours and seconds on tensors whose leading
axis is the scenario batch N: one tick is one pass of small tensor ops
over all N scenarios.

The tick loop never waits for the device: it reads no tensor value on
the host and branches only on static ``EngineConfig`` fields and the
Python second counter.  Per-second quantities the summary needs are
stacked once per hour and reduced there, so a tick stays a short chain
of elementwise ops.

``reduce="summary"`` returns (N,), (N, H_max) and (N, e_max) leaves;
``reduce="full"`` adds the per-second :class:`TwinMetrics` stacks and the
(N, T) trigger/shed/load traces.  ``engine_sweep`` streams chunked
rollouts through the :func:`summary_merge` monoid into preallocated
aggregates, so any chunking gives the monolithic numbers.

``mesh=`` splits the scenario axis over the lanes of a
:class:`~repro_torch.launch.mesh.ScenarioMesh` (padded to a multiple of
the lane count by repeating the last scenario) and, in a multi-process
launch, the sweep's specs over the processes (``process_slice``).  A
``"local"`` mesh over several cards in one process steps their slices
from one host loop, one lane after another; one process per card
(``"distributed"``, the ``REPRO_*`` environment) is how the port scales.
The reference caches one compiled sharded program per mesh topology; an
eager port has no program to cache.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple

import numpy as np
import torch

import repro_torch.core.dispatch as dispatch
import repro_torch.core.plant as plant_lib
import repro_torch.core.reserve as reserve
import repro_torch.core.tier3 as tier3_lib
import repro_torch.core.twin as twin_lib
import repro_torch.grid.frequency as frequency
import repro_torch.grid.markets as markets
import repro_torch.obs.telemetry as obs_tel
import repro_torch.workload.model as workload_lib
from repro_torch import resolve_device
from repro_torch._num import override, take, tensor
from repro_torch._tree import leaves, unflatten_like
from repro_torch.grid.scenarios import (ScenarioBatch, frequency_seeds,
                                        masked_quantile, scenario_chunk)
from repro_torch.launch import mesh as mesh_lib

K = twin_lib.LOAD_BLOCK_S    # seconds per hour block


@dataclass(frozen=True)
class EngineConfig:
    """Static knobs of the unified rollout: the reference's fields.
    ``unroll`` (the reference's scan unroll) is accepted and has no
    effect: the port's tick loop runs eagerly, one step at a time."""

    n_hosts: int = 4
    chips_per_host: int = 2
    chip_tdp: float = plant_lib.TDP
    pue_aware: bool = True
    rho_mode: str = "batch"
    price_aware: bool = False
    w_rev: float = tier3_lib.W_REV_DEFAULT
    events_per_day: float = tier3_lib.EVENTS_PER_DAY_DEFAULT
    e_max: int = 24
    max_freq_events: int = 64
    workload_weight: float = 0.0
    ckpt_cost_s: float = workload_lib.DEFAULT_GRID_CKPT_S
    step_transient_amp: float = 0.0
    step_period_s: float = workload_lib.STEP_PERIOD_S_DEFAULT
    telemetry: bool = False
    with_seconds: bool = True
    warmup_s: int = 60
    unroll: int = 1

    def __post_init__(self):
        if self.rho_mode not in ("batch", "tier3"):
            raise ValueError(
                f"rho_mode must be 'batch' or 'tier3', got {self.rho_mode!r}")

    @property
    def n_chips(self) -> int:
        return self.n_hosts * self.chips_per_host

    @property
    def design_it_w(self) -> float:
        return self.n_chips * self.chip_tdp

    @property
    def design_host(self) -> float:
        return self.chips_per_host * self.chip_tdp


class EngineAccum(NamedTuple):
    """Streaming aggregates of N scenarios, all (N,)."""

    n_s: torch.Tensor        # valid (in-horizon) seconds
    n_warm: torch.Tensor     # valid seconds past the RLS warm-up
    err: torch.Tensor        # sum of per-tick mean |AR4 err| / design_host
    track: torch.Tensor      # sum of tracking_err past warm-up
    load: torch.Tensor       # sum of cluster L = it / design
    fac: torch.Tensor        # sum of L * PUE(L) (per-unit meter draw)
    chip_mean: torch.Tensor  # sum of per-tick chip power mean (W)
    chip_p95: torch.Tensor   # sum of per-tick chip power p95 (W)
    shed_s: torch.Tensor     # seconds spent shedding for the reserve
    shed_it: torch.Tensor    # sum of armed rho_it over shed seconds
    thr: torch.Tensor        # sum of workload throughput fraction g(L)


class EngineState(NamedTuple):
    """The loop carry of N scenarios: twin + reserve detection + sums.
    ``seed`` keys the counter-based plant noise (the reference carries a
    PRNG key instead)."""

    rls: object                # ar4.RLSState over (N, H)
    chip_power: torch.Tensor   # (N, H, C) W
    caps: torch.Tensor         # (N, H, C) W
    seed: torch.Tensor         # (N,) int64
    last_load: torch.Tensor    # (N,) previous second's cluster L
    in_event: torch.Tensor     # (N,) bool: inside a held activation
    hold: torch.Tensor         # (N,) int32 sustain countdown (s)
    acc: EngineAccum


class EngineParams(NamedTuple):
    """Per-scenario tables the tick reads by hour."""

    mu_h: torch.Tensor       # (N, Hm) operating fraction
    rho_h: torch.Tensor      # (N, Hm) committed band
    t_amb_h: torch.Tensor    # (N, Hm) ambient degC
    rho_it_h: torch.Tensor   # (N, Hm) armed IT-side band
    min_dur_i: torch.Tensor  # (N,) int32 product sustain window
    pue_design: torch.Tensor  # (N,)
    clock_w: torch.Tensor    # (N,) workload-mix clock weight


class HourParams(NamedTuple):
    """One hour's (N,) values, gathered once per hour."""

    mu: torch.Tensor
    rho: torch.Tensor
    t_amb: torch.Tensor
    rho_it: torch.Tensor
    min_dur_i: torch.Tensor
    pue_design: torch.Tensor
    clock_w: torch.Tensor


class EngineSecond(NamedTuple):
    """Per-second outputs needed beyond the carry, (N,) each."""

    trig: torch.Tensor   # bool: a reserve event triggered this second
    shed: torch.Tensor   # bool: the reserve shed is being served
    load: torch.Tensor   # cluster L at the START of the second (pre-shed)


# per-tick quantities each tick emits for the hourly reduction
_ROW = ("err", "track", "L", "fac", "chip_mean", "chip_p95", "shed")


def engine_init(cfg: EngineConfig, seeds, *, device="cuda") -> EngineState:
    """Initial carry of N scenarios keyed by their (N,) seeds."""
    dev = resolve_device(device)
    seeds = torch.as_tensor(seeds, dtype=torch.int64).to(dev)
    n = seeds.shape[0]
    rls, chip_power, caps = twin_lib.twin_carry_init(
        cfg.n_hosts, cfg.chips_per_host, n, dev)
    in_ev, hold = reserve.detection_init(n, dev)
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    return EngineState(
        rls=rls, chip_power=chip_power, caps=caps, seed=seeds,
        last_load=z + plant_lib.P_IDLE / cfg.chip_tdp,
        in_event=in_ev, hold=hold,
        acc=EngineAccum(*([z] * len(EngineAccum._fields))))


def _hour_params(params: EngineParams, hour) -> HourParams:
    """One hour's (N,) values: ``hour`` is an int for every lane or an
    (N,) int64 tensor, one hour per lane."""
    last = params.mu_h.shape[-1] - 1
    if isinstance(hour, torch.Tensor):
        h = torch.clamp(hour, max=last)[:, None]

        def at(x):
            return torch.gather(x, -1, h)[:, 0]
    else:
        h = min(hour, last)

        def at(x):
            return x[:, h]
    return HourParams(
        mu=at(params.mu_h), rho=at(params.rho_h), t_amb=at(params.t_amb_h),
        rho_it=at(params.rho_it_h), min_dur_i=params.min_dur_i,
        pue_design=params.pue_design, clock_w=params.clock_w)


def _engine_tick(cfg: EngineConfig, hp: HourParams, state: EngineState,
                 base_load, below, in_hor, t, noise):
    """The fused 1 Hz tick of N scenarios.  Returns the new state (its
    ``acc`` untouched), the :class:`EngineSecond`, the TwinMetrics row and
    the (N, len(_ROW)) row of per-tick quantities for the aggregates."""
    (in_ev, hold), trig, shed = reserve.detection_step(
        (state.in_event, state.hold), below, in_hor, hp.min_dur_i)
    load_h = base_load * hp.mu[:, None] / 0.9
    if cfg.step_transient_amp:
        wave = workload_lib.step_transient(t, cfg.step_period_s,
                                           cfg.step_transient_amp)
        if isinstance(wave, torch.Tensor):
            wave = wave[:, None]
        load_h = torch.clamp(load_h * wave, 0.0, 1.0)
    (rls, chip_power, caps), m = twin_lib.twin_tick(
        cfg.n_hosts, cfg.chips_per_host, cfg.chip_tdp, hp.pue_design,
        (state.rls, state.chip_power, state.caps), load_h, hp.mu, hp.rho,
        shed, hp.t_amb, noise)
    L = m.it_power / cfg.design_it_w
    row = torch.stack([m.ar4_abs_err.mean(-1), m.tracking_err, L,
                       m.facility_power / cfg.design_it_w,
                       m.chip_power_mean, m.chip_power_p95,
                       shed.to(torch.float32)], dim=-1)
    sec = EngineSecond(trig=trig, shed=shed, load=state.last_load)
    new = state._replace(rls=rls, chip_power=chip_power, caps=caps,
                         last_load=L, in_event=in_ev, hold=hold)
    return new, sec, m, row


def _accumulate(cfg: EngineConfig, acc: EngineAccum, rows, g, w, rho_it,
                clock_w) -> EngineAccum:
    """Fold ticks into the aggregates: ``rows`` (N, k, len(_ROW)), gates
    ``g``/``w`` (N, k), the hour's armed band and clock weight (N,)."""
    r = dict(zip(_ROW, rows.unbind(-1)))
    thr = workload_lib.throughput_frac(clock_w[:, None], r["L"])
    return EngineAccum(
        n_s=acc.n_s + g.sum(-1),
        n_warm=acc.n_warm + w.sum(-1),
        err=acc.err + (w * r["err"]).sum(-1) / cfg.design_host,
        track=acc.track + (w * r["track"]).sum(-1),
        load=acc.load + (g * r["L"]).sum(-1),
        fac=acc.fac + (g * r["fac"]).sum(-1),
        chip_mean=acc.chip_mean + (g * r["chip_mean"]).sum(-1),
        chip_p95=acc.chip_p95 + (g * r["chip_p95"]).sum(-1),
        shed_s=acc.shed_s + r["shed"].sum(-1),
        shed_it=acc.shed_it + rho_it * r["shed"].sum(-1),
        thr=acc.thr + (g * thr).sum(-1))


def engine_step(cfg: EngineConfig, params: EngineParams,
                state: EngineState, xs, noise=None):
    """One fused 1 Hz tick of N scenarios.

    xs = (base_load (N, H), below (N,) bool, in_hor (N,) bool, t): the
    unscaled demand rows, the frequency-below-trigger flags, the horizon
    gates and the second, an int for every lane or an (N,) int64 tensor
    of each lane's own second (the online service's lanes are each at
    their own second since admission).  ``noise`` (N, H, C) overrides the
    counter-based plant noise of second ``t``.  Returns
    (state, (EngineSecond, TwinMetrics)).  A tensor ``t`` is read only
    on the device, so the tick can be captured as a CUDA graph.
    """
    base_load, below, in_hor, t = xs
    t = t.to(torch.int64) if isinstance(t, torch.Tensor) else int(t)
    hp = _hour_params(params, t // K)
    if noise is None:
        noise = twin_lib.plant_noise(state.seed, t, 1, cfg.n_hosts,
                                     cfg.chips_per_host)[:, 0]
    state, sec, m, row = _engine_tick(cfg, hp, state, base_load, below,
                                      in_hor, t, noise)
    g = in_hor.to(torch.float32)[:, None]
    if isinstance(t, torch.Tensor):
        w = g * (t >= cfg.warmup_s)[:, None]
    else:
        w = g * float(t >= cfg.warmup_s)
    acc = _accumulate(cfg, state.acc, row[:, None], g, w, hp.rho_it,
                      hp.clock_w)
    return state._replace(acc=acc), (sec, m)


# ---------------------------------------------------------------------------
# The hourly tiers and the rollout
# ---------------------------------------------------------------------------


def _hourly(cfg: EngineConfig, batch: ScenarioBatch, ops=None) -> dict:
    """Tier-3 grid search (or the ``ops`` override) + hourly schedule
    energy/carbon accounting, for every scenario of the batch."""
    clock_w = take(workload_lib.CLOCK_W, batch.mix_idx)
    if ops is None:
        green = tier3_lib.greenness_from_ci(batch.ci, batch.mask)
        w_rev = cfg.w_rev if cfg.price_aware else 0.0
        mu_sel, rho_sel = tier3_lib.select_operating_points(
            green, batch.t_amb, pue_aware=cfg.pue_aware,
            pue_design=batch.pue_design,
            weights=(tier3_lib.W_FFR, tier3_lib.W_CFE, w_rev,
                     cfg.workload_weight),
            product_idx=batch.product_idx,
            events_per_day=cfg.events_per_day,
            rho_fixed=batch.reserve_rho, clock_w=clock_w,
            ckpt_cost_s=cfg.ckpt_cost_s, use_revenue=cfg.price_aware,
            fix_rho=(cfg.rho_mode == "batch"),
            use_workload=(cfg.workload_weight != 0.0))
    else:
        mu_sel, rho_sel = ops
    mask = batch.mask
    mu_h = torch.where(mask > 0, mu_sel, 0.0)
    rho_h = torch.where(mask > 0, rho_sel, 0.0)
    green_ci = masked_quantile(batch.ci, mask, 50.0)
    energy = dispatch.replay_schedule(
        mu_h, batch.ci, batch.t_amb, mask, pue_design=batch.pue_design,
        green_ci=green_ci, design_w=batch.mw, clock_w=clock_w)
    hv = torch.clamp(mask.sum(-1), min=1.0)
    tok_rate = take(workload_lib.TOKENS_PER_MW_S, batch.mix_idx)
    return dict(
        mu_h=mu_h, rho_h=rho_h,
        mean_mu=(mu_h * mask).sum(-1) / hv,
        mean_rho=(rho_h * mask).sum(-1) / hv,
        sched_it_mwh=energy["it"],
        sched_fac_mwh=energy["fac"],
        sched_co2_t=energy["co2"] / 1000.0,
        sched_co2_it_t=energy["co2_it"] / 1000.0,
        sched_cfe_fac_mwh=energy["cfe_fac"],
        cfe_mu=energy["cfe_mu"],
        sched_tokens_mtok=energy["thr"] * 3600.0 * batch.mw * tok_rate / 1e6,
    )


def _gather(x, idx):
    return torch.gather(x, -1, idx.long())


def engine_params(cfg: EngineConfig, batch: ScenarioBatch, ops=None):
    """The hourly tiers of a batch and the tables its ticks read.

    Returns ``(params, hourly, vh)``: the :class:`EngineParams` that
    :func:`engine_step` takes, the hourly-tier output dict (Tier-3
    selection or the ``ops`` override, schedule energy and carbon), and
    the per-hour activation physics ``vh`` of ``tier3.event_verdict``.
    """
    hourly = _hourly(cfg, batch, ops)
    pidx = batch.product_idx
    vh = tier3_lib.event_verdict(hourly["mu_h"], batch.t_amb,
                                 hourly["rho_h"], pidx[:, None],
                                 batch.pue_design[:, None],
                                 pue_aware=cfg.pue_aware)
    min_dur = take(markets.MIN_DURATION_S, pidx)
    params = EngineParams(mu_h=hourly["mu_h"], rho_h=hourly["rho_h"],
                          t_amb_h=batch.t_amb, rho_it_h=vh["rho_it"],
                          min_dur_i=min_dur.to(torch.int32),
                          pue_design=batch.pue_design,
                          clock_w=take(workload_lib.CLOCK_W, batch.mix_idx))
    return params, hourly, vh


def _rollout(cfg: EngineConfig, reduce: str, batch: ScenarioBatch, freq,
             loads, noise, ops) -> dict:
    params, out, vh = engine_params(cfg, batch, ops)
    rho_h = params.rho_h
    dev = batch.device
    h_max = batch.h_max
    T = h_max * K
    pidx = batch.product_idx
    clock_w = params.clock_w
    valid_s = batch.hours.long() * 3600
    min_dur_f = take(markets.MIN_DURATION_S, pidx)
    trig_hz = take(markets.TRIGGER_HZ, pidx)

    below_all = freq < trig_hz[:, None]
    in_hor_all = torch.arange(T, device=dev)[None, :] < valid_s[:, None]
    lp = (twin_lib.host_load_params(cfg.n_hosts, batch.seed)
          if loads is None else None)
    state = engine_init(cfg, batch.seed, device=dev)
    secs, metrics, tel_h = [], [], []
    for b in range(T // K):
        hp = _hour_params(params, b)
        s = slice(b * K, (b + 1) * K)
        loads_r = twin_lib.host_loads_block(lp, b) if loads is None \
            else loads[:, s]
        noise_r = twin_lib.plant_noise(batch.seed, b * K, K, cfg.n_hosts,
                                       cfg.chips_per_host) \
            if noise is None else noise[:, s]
        below_r, in_r = below_all[:, s], in_hor_all[:, s]
        rows, hour_sec, hour_m, sat = [], [], [], []
        for k in range(K):
            t = b * K + k
            state, sec, m, row = _engine_tick(
                cfg, hp, state, loads_r[:, k], below_r[:, k], in_r[:, k], t,
                noise_r[:, k])
            rows.append(row)
            hour_sec.append(sec)
            if reduce == "full":
                hour_m.append(m)
            if cfg.telemetry:
                sat.append(obs_tel.cap_saturation(state.chip_power,
                                                  state.caps))
        # the hour's per-second quantities, reduced in one pass
        g = in_r.to(torch.float32)
        w = g * (torch.arange(b * K, (b + 1) * K, device=dev)
                 >= cfg.warmup_s)[None, :]
        rows = torch.stack(rows, dim=1)
        state = state._replace(acc=_accumulate(
            cfg, state.acc, rows, g, w, hp.rho_it, clock_w))
        secs.append(EngineSecond(*(torch.stack(x, dim=1)
                                   for x in zip(*hour_sec))))
        if reduce == "full":
            metrics.append(twin_lib.TwinMetrics(
                *(torch.stack(x, dim=1) for x in zip(*hour_m))))
        if cfg.telemetry:
            r = dict(zip(_ROW, rows.unbind(-1)))
            tel_h.append(obs_tel.accum_update(
                sat=torch.stack(sat, dim=1), err=r["err"],
                track=r["track"], g=g, w=w))
    sec = EngineSecond(*(torch.cat(x, dim=1) for x in zip(*secs)))

    # --- per-event verdicts ------------------------------------------------
    t_ev, valid = reserve.event_times(sec.trig, cfg.e_max)
    hour_ev = torch.clamp(t_ev // 3600, max=h_max - 1).long()
    vq = {k: _gather(x, hour_ev) for k, x in vh.items()}
    min_dur_c, valid_c, mw_c = (min_dur_f[:, None], valid_s[:, None],
                                batch.mw[:, None])
    events_sched = reserve.assemble_events(vq, t_ev, valid, min_dur_c,
                                           valid_c, mw_c)
    l_ev = _gather(sec.load, torch.clamp(t_ev, 0, T - 1))
    vt = tier3_lib.event_verdict(l_ev, _gather(batch.t_amb, hour_ev),
                                 _gather(rho_h, hour_ev), pidx[:, None],
                                 batch.pue_design[:, None],
                                 pue_aware=cfg.pue_aware)
    events = reserve.assemble_events(vt, t_ev, valid, min_dur_c, valid_c,
                                     mw_c)

    # --- settlement --------------------------------------------------------
    mask = batch.mask
    price = take(markets.CAPACITY_PRICE_EUR_MW_H, pidx)
    committed_h = rho_h * batch.mw[:, None] * batch.pue_design[:, None]
    capacity_eur = price * (committed_h * mask).sum(-1)
    penalty_eur = reserve.event_clawback(
        events, price[:, None] * _gather(committed_h, hour_ev)
        * tier3_lib.PENALTY_WINDOW_H)

    acc = state.acc
    n_div = torch.clamp(acc.n_s, min=1.0)
    nw = torch.clamp(acc.n_warm, min=1.0)
    tok_rate = take(workload_lib.TOKENS_PER_MW_S, batch.mix_idx)
    n_events_f = valid.sum(-1).to(torch.float32)
    thr_ref = workload_lib.throughput_frac(clock_w,
                                           float(tier3_lib.MU_GRID[-1]))
    tok_unit = batch.mw * tok_rate / 1e6
    tokens_mtok = acc.thr * tok_unit
    tokens_ckpt_mtok = n_events_f * cfg.ckpt_cost_s * thr_ref * tok_unit
    tokens_ref_mtok = acc.n_s * thr_ref * tok_unit
    mw = batch.mw
    out.update(
        ar4_mae_norm=acc.err / nw,
        tracking_err_mean=acc.track / nw,
        chip_power_mean=acc.chip_mean / n_div,
        chip_power_p95=acc.chip_p95 / n_div,
        it_mwh=acc.load * mw / 3600.0,
        fac_mwh=acc.fac * mw / 3600.0,
        events=events,
        events_sched=events_sched,
        n_events=valid.sum(-1).to(torch.int32),
        active_s=acc.shed_s.to(torch.int32),
        shed_it_mwh=acc.shed_it * mw / 3600.0,
        committed_mw=(committed_h * mask).sum(-1)
        / torch.clamp(mask.sum(-1), min=1.0),
        capacity_eur=capacity_eur,
        penalty_eur=penalty_eur,
        net_eur=capacity_eur - penalty_eur,
        n_compliant=(valid & events.compliant).sum(-1).to(torch.int32),
        thr_mean=acc.thr / n_div,
        tokens_mtok=tokens_mtok,
        tokens_ckpt_mtok=tokens_ckpt_mtok,
        tokens_lost_mtok=tokens_ref_mtok - tokens_mtok + tokens_ckpt_mtok,
    )
    if cfg.telemetry:
        hour = obs_tel.TickAccum(*(torch.stack(x, dim=1)
                                   for x in zip(*tel_h)))
        out["telemetry"] = obs_tel.finalize(
            hour, design_host=cfg.design_host, events=events,
            budget_ms=take(markets.BUDGET_MS, pidx), load_sec=sec.load,
            valid_s=valid_s, warmup_s=cfg.warmup_s,
            last_load=state.last_load)
    if reduce == "full":
        out["metrics"] = twin_lib.TwinMetrics(
            *(torch.cat(x, dim=1) for x in zip(*metrics)))
        out["trig"] = sec.trig
        out["shed"] = sec.shed
        out["load_sec"] = sec.load
    return out


# ---------------------------------------------------------------------------
# The scenario axis over mesh lanes
# ---------------------------------------------------------------------------

_SCENARIO_AXIS = mesh_lib.SCENARIO_AXIS


def _resolve_mesh(mesh, device="cuda"):
    """mesh= argument -> a validated mesh with a "scenario" axis.

    Strings ("auto" | "local" | "distributed") resolve through
    ``repro_torch.launch.mesh.resolve_mesh`` on ``device``'s kind.
    """
    if isinstance(mesh, str):
        mesh = mesh_lib.resolve_mesh(mesh, device=device)
    if _SCENARIO_AXIS not in mesh.axis_names:
        raise ValueError(
            f"engine mesh needs a {_SCENARIO_AXIS!r} axis, got mesh axes "
            f"{mesh.axis_names}")
    return mesh


def _map_tensors(fn, tree):
    """``fn`` over every tensor of a ScenarioBatch, tuple, NamedTuple or
    dict, keeping the structure; None and other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, ScenarioBatch):
        return ScenarioBatch(**{f.name: _map_tensors(fn, getattr(tree,
                                                                 f.name))
                                for f in fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, x) for x in tree)
    return tree


def _scenario_count(tree) -> int:
    sizes = []
    _map_tensors(lambda x: sizes.append(int(x.shape[0])), tree)
    return sizes[0]


def pad_scenario_axis(tree, multiple: int):
    """Right-pad the leading (scenario) axis of every tensor to a multiple
    of ``multiple`` by repeating the last scenario (every padded lane stays
    numerically well-defined); :func:`unpad_scenario_axis` slices it back.
    Returns ``(padded_tree, original_n)``."""
    n = _scenario_count(tree)
    pad = (-n) % multiple
    if pad == 0:
        return tree, n
    return _map_tensors(lambda x: torch.cat(
        [x, x[-1:].expand((pad,) + tuple(x.shape[1:]))]), tree), n


def unpad_scenario_axis(tree, n: int):
    """Slice the leading (scenario) axis of every tensor back to ``n``."""
    return _map_tensors(lambda x: x[:n], tree)


def _on_lanes(mesh, dev, fn, *args):
    """``fn(*args)`` split over the mesh's lanes: pad the scenario axis to
    a multiple of the lane count, run each lane's contiguous slice on its
    device, concatenate the outputs on ``dev`` and unpad."""
    lanes = mesh.devices
    args, n = pad_scenario_axis(args, len(lanes))
    m = _scenario_count(args) // len(lanes)
    outs = [fn(*_map_tensors(lambda x, i=i, d=d: x[i * m:(i + 1) * m].to(d),
                             args))
            for i, d in enumerate(lanes)]
    parts = [leaves(o) for o in outs]
    out = unflatten_like(outs[0], [torch.cat([p[j].to(dev) for p in parts])
                                   for j in range(len(parts[0]))])
    return unpad_scenario_axis(out, n)


def base_loads(cfg: EngineConfig, batch: ScenarioBatch) -> torch.Tensor:
    """(N, T, H) unscaled per-host demand rows, materialised: the same
    counter-based draws the rollout makes block by block."""
    return twin_lib.host_loads_trace(cfg.n_hosts, batch.h_max * K,
                                     batch.seed)


def engine_rollout(cfg: EngineConfig, batch: ScenarioBatch, *,
                   reduce: str = "summary", freq=None, loads=None,
                   noise=None, ops=None, mesh=None, device="cuda") -> dict:
    """Replay a ScenarioBatch through all composed tiers on ``device``.

    ``freq`` (N, T) and ``loads`` (N, T, H) override the synthesised
    frequency traces and demand rows, ``noise`` (N, T, H, C) the plant's
    per-tick standard normals, ``ops`` a ``(mu_h, rho_h)`` pair of
    (N, H_max) hourly trajectories in place of the Tier-3 search; all
    are validated against the batch up front.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.ScenarioMesh` or "auto" /
    "local" / "distributed") splits the batch over the mesh's lanes: N
    padded to a multiple of the lane count by repeating the last
    scenario, each lane's slice (and its slice of every override) rolled
    out on the lane's device, the outputs concatenated on ``device`` and
    sliced back to N -- the single-device numbers to float32
    reassociation.
    """
    if reduce not in ("summary", "full"):
        raise ValueError(f"reduce must be 'summary' or 'full', got {reduce!r}")
    dev = resolve_device(device)
    if mesh is not None:
        mesh = _resolve_mesh(mesh, dev)
    batch = batch.to(dev)
    n, T = batch.n, batch.h_max * K
    if ops is not None:
        want = (n, batch.h_max)
        mu_ops, rho_ops = (tensor(x, dev) for x in ops)
        if tuple(mu_ops.shape) != want or tuple(rho_ops.shape) != want:
            raise ValueError(
                f"ops override must be a (mu_h, rho_h) pair of shape "
                f"(N, H_max) = {want}, got {tuple(mu_ops.shape)} / "
                f"{tuple(rho_ops.shape)}")
        ops = (mu_ops, rho_ops)
    if not cfg.with_seconds:
        if mesh is None:
            return _hourly(cfg, batch, ops)
        return _on_lanes(mesh, dev, lambda b, o: _hourly(cfg, b, o),
                         batch, ops)
    if freq is None:
        freq, _ = frequency.synthesize_frequency_batch(
            frequency_seeds(batch), batch.product_idx, n_seconds=T,
            events_per_day=cfg.events_per_day,
            max_events=cfg.max_freq_events, device=dev)
    else:
        freq = override(freq, (n, T), "freq",
                        "(N, T) = (batch.n, batch.h_max * 3600)", dev)
    if loads is not None:
        loads = override(loads, (n, T, cfg.n_hosts), "loads",
                         "(N, T, H) = (batch.n, batch.h_max * 3600, "
                         "cfg.n_hosts)", dev)
    if noise is not None:
        noise = override(noise, (n, T, cfg.n_hosts, cfg.chips_per_host),
                         "noise", "(N, T, H, C)", dev)
    if mesh is None:
        return _rollout(cfg, reduce, batch, freq, loads, noise, ops)
    return _on_lanes(mesh, dev, lambda *a: _rollout(cfg, reduce, *a),
                     batch, freq, loads, noise, ops)


# ---------------------------------------------------------------------------
# Streaming sweep: chunked rollouts + online monoid aggregation
# ---------------------------------------------------------------------------

_SWEEP_SCHED_SUMS = ("sched_it_mwh", "sched_fac_mwh", "sched_co2_t",
                     "sched_co2_it_t", "sched_cfe_fac_mwh",
                     "sched_tokens_mtok")
_SWEEP_SECONDS_SUMS = ("it_mwh", "fac_mwh", "shed_it_mwh", "active_s",
                       "capacity_eur", "penalty_eur", "net_eur",
                       "n_events", "n_compliant", "tokens_mtok",
                       "tokens_ckpt_mtok", "tokens_lost_mtok")


def summary_init(cfg: EngineConfig, *, device="cuda") -> dict:
    """The monoid identity: the aggregate of zero scenarios (float32
    leaves; extremes start at -/+inf)."""
    dev = resolve_device(device)

    def z(v=0.0, size=()):
        return torch.full(size, v, dtype=torch.float32, device=dev)

    s = {k: z() for k in ("n_scenarios", "hours", "mu_hours", "rho_hours",
                          "cfe_mu_hours") + _SWEEP_SCHED_SUMS}
    if not cfg.with_seconds:
        return s
    s.update({k: z() for k in ("seconds", "warm_s", "ar4_err_s",
                               "track_err_s", "chip_mean_s", "chip_p95_s",
                               "thr_s", "committed_mw_hours",
                               "n_compliant_sched", "ev_delivered_frac_sum",
                               "ev_t_full_ms_sum", "ev_budget_ok",
                               "ev_sustain_ok", "ev_delivered_ok")
              + _SWEEP_SECONDS_SUMS})
    s["ev_t_full_ms_max"] = z(-np.inf)
    if cfg.telemetry:
        s.update(
            tel_track_hist=z(size=(obs_tel.N_TRACK_BUCKETS,)),
            tel_resp_hist=z(size=(obs_tel.N_RESP_BUCKETS,)),
            tel_rls2=z(), tel_track2=z(), tel_sat_s=z(),
            tel_n_budget_ok=z(), tel_resp_ms_sum=z(), tel_resp_n=z(),
            tel_resp_ms_max=z(-np.inf), tel_slew_max=z(-np.inf),
            tel_slew_min=z(np.inf))
    return s


def chunk_summary(cfg: EngineConfig, out: dict, batch: ScenarioBatch,
                  lane=None) -> dict:
    """Reduce one chunk's ``reduce="summary"`` output into the streaming
    aggregate (same keys as :func:`summary_init`).  ``lane`` (N,) masks
    lanes out of the sums (default: all valid).  Intensive metrics are
    re-extensified with the weights the rollout normalised by."""
    dev = batch.device
    lane = (torch.ones(batch.n, dtype=torch.float32, device=dev)
            if lane is None else torch.as_tensor(lane, dtype=torch.float32)
            .to(dev))
    hours = batch.hours.to(torch.float32)
    hv = torch.clamp(hours, min=1.0)
    s = dict(
        n_scenarios=lane.sum(),
        hours=(lane * hours).sum(),
        mu_hours=(lane * out["mean_mu"] * hv).sum(),
        rho_hours=(lane * out["mean_rho"] * hv).sum(),
        cfe_mu_hours=(lane * out["cfe_mu"]).sum(),
    )
    for k in _SWEEP_SCHED_SUMS:
        s[k] = (lane * out[k]).sum()
    if "it_mwh" not in out:
        return s
    n_s = hours * 3600.0
    nc = torch.clamp(n_s, min=1.0)
    nw = torch.clamp(n_s - cfg.warmup_s, min=1.0)
    s.update(
        seconds=(lane * n_s).sum(),
        warm_s=(lane * torch.clamp(n_s - cfg.warmup_s, min=0.0)).sum(),
        ar4_err_s=(lane * out["ar4_mae_norm"] * nw).sum(),
        track_err_s=(lane * out["tracking_err_mean"] * nw).sum(),
        chip_mean_s=(lane * out["chip_power_mean"] * nc).sum(),
        chip_p95_s=(lane * out["chip_power_p95"] * nc).sum(),
        thr_s=(lane * out["thr_mean"] * nc).sum(),
        committed_mw_hours=(lane * out["committed_mw"] * hv).sum(),
    )
    for k in _SWEEP_SECONDS_SUMS:
        s[k] = (lane * out[k].to(torch.float32)).sum()
    ev, evs = out["events"], out["events_sched"]
    lc = lane[:, None]
    vm = lc * ev.valid.to(torch.float32)
    s.update(
        n_compliant_sched=(lc * (evs.valid & evs.compliant)).sum(),
        ev_delivered_frac_sum=(vm * ev.delivered_frac).sum(),
        ev_t_full_ms_sum=(vm * ev.t_full_ms).sum(),
        ev_t_full_ms_max=torch.where(vm > 0, ev.t_full_ms,
                                     -torch.inf).amax(),
        ev_budget_ok=(vm * ev.budget_ok).sum(),
        ev_sustain_ok=(vm * ev.sustain_ok).sum(),
        ev_delivered_ok=(vm * ev.delivered_ok).sum(),
    )
    if cfg.telemetry and "telemetry" in out:
        s.update(obs_tel.sweep_summary(out["telemetry"], lane,
                                       warmup_s=cfg.warmup_s))
    return s


def summary_merge(agg: dict, chunk: dict, *, out: dict | None = None):
    """Fold one chunk aggregate into the running aggregate: keys ending
    ``_max`` merge by maximum, ``_min`` by minimum, the rest by sum.
    Commutative and associative.  With ``out`` the result is written into
    ``out``'s tensors in place (the sweep's preallocated aggregate)."""
    if agg.keys() != chunk.keys():
        raise ValueError(
            f"aggregate key mismatch: {sorted(agg)} vs {sorted(chunk)} "
            "(merging summaries from different EngineConfig modes?)")
    res = {}
    for k, a in agg.items():
        op = (torch.maximum if k.endswith("_max") else torch.minimum
              if k.endswith("_min") else torch.add)
        res[k] = (op(a, chunk[k]) if out is None
                  else op(a, chunk[k], out=out[k]))
    return res


def _finite(x) -> float:
    x = float(x)
    return x if np.isfinite(x) else 0.0


def sweep_finalize(agg: dict) -> dict:
    """Terminal aggregate -> fleet-level metrics (host-side floats)."""
    a = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v)) for k, v in agg.items()}
    hours = float(a["hours"])
    hv = max(hours, 1.0)
    out = dict(
        n_scenarios=float(a["n_scenarios"]),
        hours=hours,
        scenario_days=hours / 24.0,
        mean_mu=float(a["mu_hours"]) / hv,
        mean_rho=float(a["rho_hours"]) / hv,
        cfe_mu=float(a["cfe_mu_hours"]) / hv,
    )
    for k in _SWEEP_SCHED_SUMS:
        out[k] = float(a[k])
    if "seconds" not in a:
        return out
    sec = max(float(a["seconds"]), 1.0)
    warm = max(float(a["warm_s"]), 1.0)
    n_ev = max(float(a["n_events"]), 1.0)
    out.update(
        seconds=float(a["seconds"]),
        ar4_mae_norm=float(a["ar4_err_s"]) / warm,
        tracking_err_mean=float(a["track_err_s"]) / warm,
        chip_power_mean=float(a["chip_mean_s"]) / sec,
        chip_power_p95=float(a["chip_p95_s"]) / sec,
        thr_mean=float(a["thr_s"]) / sec,
        committed_mw=float(a["committed_mw_hours"]) / hv,
        compliance=float(a["n_compliant"]) / n_ev,
        compliance_sched=float(a["n_compliant_sched"]) / n_ev,
        delivered_frac_mean=float(a["ev_delivered_frac_sum"]) / n_ev,
        resp_ms_mean=float(a["ev_t_full_ms_sum"]) / n_ev,
        resp_ms_max=_finite(a["ev_t_full_ms_max"]),
        budget_ok_frac=float(a["ev_budget_ok"]) / n_ev,
        sustain_ok_frac=float(a["ev_sustain_ok"]) / n_ev,
        delivered_ok_frac=float(a["ev_delivered_ok"]) / n_ev,
    )
    for k in _SWEEP_SECONDS_SUMS:
        out[k] = float(a[k])
    if "tel_rls2" in a:
        out["telemetry"] = dict(
            track_hist=np.asarray(a["tel_track_hist"], np.float64),
            resp_hist=np.asarray(a["tel_resp_hist"], np.float64),
            rls_rms=float(np.sqrt(float(a["tel_rls2"]) / warm)),
            track_rms=float(np.sqrt(float(a["tel_track2"]) / warm)),
            sat_frac=float(a["tel_sat_s"]) / sec,
            n_budget_ok=float(a["tel_n_budget_ok"]),
            resp_ms_mean=(float(a["tel_resp_ms_sum"])
                          / max(float(a["tel_resp_n"]), 1.0)),
            resp_ms_max=_finite(a["tel_resp_ms_max"]),
            slew_max=_finite(a["tel_slew_max"]),
            slew_min=_finite(a["tel_slew_min"]),
        )
    return out


def _pad_chunk(batch: ScenarioBatch, pad_to: int):
    """Pad a chunk to ``pad_to`` lanes and return the lane validity mask
    that keeps the replicated padding out of the sums."""
    n = batch.n
    if n > pad_to:
        raise ValueError(f"chunk of {n} scenarios exceeds lane count "
                         f"{pad_to}")
    lane = (torch.arange(pad_to, device=batch.device) < n).to(torch.float32)
    return pad_scenario_axis(batch, pad_to)[0], lane


def engine_sweep(cfg: EngineConfig, specs, *, chunk_size: int, mesh=None,
                 h_max: int | None = None, finalize: bool = True,
                 progress=None, device="cuda") -> dict:
    """Stream a scenario sweep through chunk-sized rollouts with online
    aggregation: memory is O(chunk_size), not O(len(specs)).

    Each chunk's batch is built only when its turn comes, rolled out with
    ``reduce="summary"`` and folded into aggregate tensors allocated once
    (:func:`summary_init`) and updated in place.  ``h_max`` pins the
    padded hour axis for every chunk (default: the longest horizon in
    ``specs``), which fixes each scenario's frequency trace length, so
    any chunking reproduces the monolithic rollout.  Without a mesh the
    last chunk is not padded (an eager loop needs no fixed lane count).

    ``mesh`` splits each chunk over the mesh's lanes: the chunk padded to
    ``chunk_size`` rounded up to the lane count, with a lane mask that
    keeps the padding out of the sums, one aggregate per lane on its
    device, merged in lane order at the end.  In a multi-process launch
    (the ``REPRO_COORD_ADDR`` environment) every process calls this with
    the same ``specs`` and sweeps only its ``process_slice``; with
    ``finalize=False`` the process's raw aggregate comes back (CPU
    tensors) for out-of-band merging through :func:`summary_merge` and
    :func:`sweep_finalize`.  ``progress(chunks_done, n_chunks)`` is
    called after each folded chunk.
    """
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if len(specs) == 0:
        raise ValueError("empty scenario list")
    dev = resolve_device(device)
    mesh_lib.ensure_distributed(dev)
    lanes = (dev,) if mesh is None else _resolve_mesh(mesh, dev).devices
    if h_max is None:
        h_max = max(s.horizon_h for s in specs)
    lo0, hi0 = mesh_lib.process_slice(len(specs))
    m = -(-chunk_size // len(lanes))           # scenarios a lane a chunk
    aggs = [summary_init(cfg, device=d) for d in lanes]
    starts = range(lo0, hi0, chunk_size)
    for i, lo in enumerate(starts):
        batch = scenario_chunk(specs, lo, min(lo + chunk_size, hi0),
                               h_max=h_max, device=dev)
        if mesh is None:
            parts = [(batch, None)]
        else:
            batch, lane = _pad_chunk(batch, m * len(lanes))
            parts = [_map_tensors(lambda x, j=j: x[j * m:(j + 1) * m],
                                  (batch, lane))
                     for j in range(len(lanes))]
        for agg, d, (b, lane) in zip(aggs, lanes, parts):
            b = b.to(d)
            out = engine_rollout(cfg, b, reduce="summary", device=d)
            summary_merge(agg, chunk_summary(cfg, out, b, lane), out=agg)
        if progress is not None:
            progress(i + 1, len(starts))
    agg = {k: v.cpu() for k, v in aggs[0].items()}
    for other in aggs[1:]:
        agg = summary_merge(agg, {k: v.cpu() for k, v in other.items()})
    return sweep_finalize(agg) if finalize else agg


def summarize_rollout(cfg: EngineConfig, batch: ScenarioBatch,
                      full: dict) -> dict:
    """Recompute the streaming summary from a ``reduce="full"`` rollout
    (the oracle of the in-loop reducer)."""
    m = full["metrics"]
    T = m.it_power.shape[-1]
    t = torch.arange(T, device=m.it_power.device)
    g = (t[None, :] < batch.hours[:, None].long() * 3600).to(torch.float32)
    w = g * (t >= cfg.warmup_s)[None, :]
    nw = torch.clamp(w.sum(-1), min=1.0)
    n = torch.clamp(g.sum(-1), min=1.0)
    err = m.ar4_abs_err.mean(-1) / cfg.design_host
    L = m.it_power / cfg.design_it_w
    F = m.facility_power / cfg.design_it_w
    clock_w = take(workload_lib.CLOCK_W, batch.mix_idx)
    thr_sum = (workload_lib.throughput_frac(clock_w[:, None], L) * g).sum(-1)
    tok_rate = take(workload_lib.TOKENS_PER_MW_S, batch.mix_idx)
    return dict(
        ar4_mae_norm=(err * w).sum(-1) / nw,
        tracking_err_mean=(m.tracking_err * w).sum(-1) / nw,
        chip_power_mean=(m.chip_power_mean * g).sum(-1) / n,
        chip_power_p95=(m.chip_power_p95 * g).sum(-1) / n,
        it_mwh=(L * g).sum(-1) * batch.mw / 3600.0,
        fac_mwh=(F * g).sum(-1) * batch.mw / 3600.0,
        active_s=(full["shed"] & (g > 0)).sum(-1),
        thr_mean=thr_sum / n,
        tokens_mtok=thr_sum * batch.mw * tok_rate / 1e6,
    )


__all__ = ["EngineConfig", "EngineState", "EngineParams", "EngineAccum",
           "engine_init", "engine_params", "engine_step", "engine_rollout",
           "base_loads", "pad_scenario_axis", "unpad_scenario_axis",
           "summary_init", "chunk_summary", "summary_merge",
           "sweep_finalize", "engine_sweep", "summarize_rollout"]
