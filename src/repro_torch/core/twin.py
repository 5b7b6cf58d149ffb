"""Cluster digital twin: the port of ``repro.core.twin``, the multiscale
24 h simulation behind paper Fig. 4.

At the 1 Hz tick, Tier-2 predicts each host's next-second power with
AR(4)/RLS and rebalances the per-chip caps inside the host envelope;
Tier-1 and the plant are quasi-static over the second (the PID settles
in < 30 ms, which ``pid_rollout_grid`` checks); an FFR activation sheds
the envelope to (mu - rho).  Every function carries a leading scenario
axis N: hosts are (N, H), chips (N, H, C).

The engine runs :func:`twin_tick` fused with the reserve detection.  The
standalone twin (:func:`run_twin`, :func:`run_twin_batch`) replays
scenarios prepared on the host (:func:`prepare_scenario`: the Tier-3
schedule, FFR events from ``FFRTriggerGen``, per-second demand) as one
loop over seconds on the stacked (N, ...) tensors, writing preallocated
(N, T, ...) metric buffers.

Randomness is counter-based (``repro_torch.random``), keyed by the
scenario seed: the demand noise of hour ``b`` and the plant noise of
second ``t`` are the same numbers in any batch.  The standalone twin
takes the reference's draws through ``loads=`` and ``noise=``, and its
Tier-3 schedule through ``ops=``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

import repro_torch.core.ar4 as ar4_lib
import repro_torch.core.plant as plant_lib
import repro_torch.core.pue as pue_lib
import repro_torch.core.tier3 as tier3_lib
import repro_torch.grid.markets as markets
import repro_torch.grid.signals as signals
import repro_torch.random as rnd
import repro_torch.workload.model as workload_lib
from repro_torch import resolve_device
from repro_torch._num import const, override, tensor

LOAD_BLOCK_S = 3600
IDLE_FLOOR_W = 53.0   # FFR deep shed: P_idle + min clocks


class TwinMetrics(NamedTuple):
    host_power: torch.Tensor       # (N, H) W
    host_pred: torch.Tensor        # (N, H) W  Tier-2 one-step-ahead
    ar4_abs_err: torch.Tensor      # (N, H) W  a-priori |err|
    chip_power_mean: torch.Tensor  # (N,)
    chip_power_p95: torch.Tensor   # (N,)
    envelope: torch.Tensor         # (N,) W cluster envelope setpoint
    it_power: torch.Tensor         # (N,) W cluster IT power
    facility_power: torch.Tensor   # (N,) W at the meter
    ffr_active: torch.Tensor       # (N,) bool
    tracking_err: torch.Tensor     # (N,) |it - envelope| / envelope


@dataclass(frozen=True)
class TwinConfig:
    n_hosts: int = 100
    chips_per_host: int = 3
    chip_tdp: float = plant_lib.TDP
    pue_design: float = pue_lib.PUE_DESIGN
    pue_aware: bool = True
    seconds: int = 86_400
    seed: int = 0
    # step-synchronous training transient (workload.step_transient):
    # amplitude 0 (the default) leaves the demand traces unchanged
    step_transient_amp: float = 0.0
    step_period_s: float = workload_lib.STEP_PERIOD_S_DEFAULT

    @property
    def n_chips(self) -> int:
        return self.n_hosts * self.chips_per_host

    @property
    def design_it_w(self) -> float:
        return self.n_chips * self.chip_tdp


class HostLoadParams(NamedTuple):
    """Per-scenario constants of the counter-based 1 Hz load synthesis."""

    mean: torch.Tensor        # (H,) archetype mean utilisation
    fast_sigma: torch.Tensor  # (H,) white-noise sigma
    slow_sigma: torch.Tensor  # (H,) band-limited wander sigma
    phases: torch.Tensor      # (N, H, 4) slow-wave phase offsets
    is_bursty: torch.Tensor   # (H,) bool: duty-cycled archetype
    duty_phase: torch.Tensor  # (H,) bursty duty-cycle phase offset
    jitter_ph: torch.Tensor   # (N, H) bursty edge-jitter phase
    seed: torch.Tensor        # (N,) int64: keys each block's white noise


def _host_kinds(n_hosts: int) -> np.ndarray:
    """Archetype mix: 50 % matmul-like, 30 % inference, 20 % bursty."""
    return np.array([0] * (n_hosts // 2)
                    + [1] * (3 * n_hosts // 10)
                    + [2] * (n_hosts - n_hosts // 2 - 3 * n_hosts // 10))


def host_load_params(n_hosts: int, seeds: torch.Tensor) -> HostLoadParams:
    """(N,) scenario seeds -> the constants of the per-second synthesis."""
    dev = seeds.device
    kinds = _host_kinds(n_hosts)
    stats = np.array([[plant_lib._ARCHETYPES[w][f] for w in
                       ("matmul", "inference", "bursty")]
                      for f in ("mean", "fast_sigma", "slow_sigma")],
                     np.float32)[:, kinds]
    sd = seeds[:, None]
    phases = rnd.uniform(sd[:, :, None], rnd.LOAD_PHASE, 0,
                         rnd.lanes((n_hosts, 4), dev)) * (2 * math.pi)
    jitter = rnd.uniform(sd, rnd.LOAD_JITTER, 0,
                         rnd.lanes((n_hosts,), dev)) * 6.28

    def t(x, dtype=torch.float32):
        return const(x, dev, dtype)

    return HostLoadParams(
        mean=t(stats[0]), fast_sigma=t(stats[1]), slow_sigma=t(stats[2]),
        phases=phases, is_bursty=t(kinds == 2, torch.bool),
        duty_phase=t(np.asarray(kinds * 0.37, np.float32)),
        jitter_ph=jitter, seed=seeds)


def host_loads_rows(p: HostLoadParams, tf: torch.Tensor,
                    fast: torch.Tensor) -> torch.Tensor:
    """Absolute seconds, (K,) shared by the N scenarios or (N, K) per
    scenario, + (N, K, H) white noise -> (N, K, H) demand rows:
    slow-wave wander, white noise and the bursty duty cycle."""
    tf = tf if tf.dim() == 2 else tf[None]                      # (1|N, K)
    freqs = const(np.float32(plant_lib.SLOW_FREQS_HZ), tf.device)
    ang = 2 * math.pi * freqs * tf[..., None]                   # (., K, 4)
    s_t, c_t = torch.sin(ang), torch.cos(ang)
    ph = p.phases[:, None]                                      # (N,1,H,4)
    slow = ((s_t[:, :, None] * torch.cos(ph)).sum(-1)
            + (c_t[:, :, None] * torch.sin(ph)).sum(-1)) / 2.0
    base = p.mean + p.slow_sigma * slow + p.fast_sigma * fast   # (N, K, H)
    ang_j = 2 * math.pi * plant_lib.BURSTY_JITTER_FREQ_HZ * tf  # (., K)
    jph = p.jitter_ph[:, None, :]
    jit_t = plant_lib.BURSTY_EDGE_JITTER_S * (
        torch.sin(ang_j)[..., None] * torch.cos(jph)
        + torch.cos(ang_j)[..., None] * torch.sin(jph))
    frac = torch.remainder((tf[..., None] + jit_t)
                           / plant_lib.BURSTY_PERIOD_S + p.duty_phase, 1.0)
    on = frac < plant_lib.BURSTY_DUTY
    bursty = torch.where(on, base, plant_lib.BURSTY_LOW + 0.01 * fast)
    return torch.clamp(torch.where(p.is_bursty, bursty, base), 0.0, 1.0)


def host_loads_block(p: HostLoadParams, b: int) -> torch.Tensor:
    """The (N, LOAD_BLOCK_S, H) demand rows of hour block ``b``."""
    dev = p.seed.device
    H = p.mean.shape[-1]
    tf = float(b * LOAD_BLOCK_S) + torch.arange(
        LOAD_BLOCK_S, dtype=torch.float32, device=dev)
    fast = rnd.normal(p.seed[:, None, None], rnd.LOAD_NOISE, b,
                      rnd.lanes((LOAD_BLOCK_S, H), dev))
    return host_loads_rows(p, tf, fast)


def host_loads_at(p: HostLoadParams, t) -> torch.Tensor:
    """The (N, H) demand rows of second ``t`` (an int for every scenario
    or an (N,) tensor): random access into the counter-based synthesis,
    the same numbers as that row of :func:`host_loads_block`."""
    dev = p.seed.device
    H = p.mean.shape[-1]
    n = p.seed.shape[0]
    t = torch.as_tensor(t, dtype=torch.int64, device=dev).expand(n)
    b, k = t // LOAD_BLOCK_S, t % LOAD_BLOCK_S
    lane = k[:, None] * H + torch.arange(H, dtype=torch.int64, device=dev)
    fast = rnd.normal(p.seed[:, None], rnd.LOAD_NOISE, b[:, None], lane)
    return host_loads_rows(p, t.to(torch.float32)[:, None],
                           fast[:, None])[:, 0]


def host_loads_trace(n_hosts: int, n_seconds: int,
                     seeds: torch.Tensor) -> torch.Tensor:
    """Materialised (N, T, H) trace: the blocks of :func:`host_loads_block`
    concatenated."""
    p = host_load_params(n_hosts, seeds)
    nb = -(-n_seconds // LOAD_BLOCK_S)
    blocks = [host_loads_block(p, b) for b in range(nb)]
    return torch.cat(blocks, dim=1)[:, :n_seconds]


def plant_noise(seeds: torch.Tensor, t0, k: int, n_hosts: int,
                chips_per_host: int) -> torch.Tensor:
    """(N, k, H, C) standard normals of seconds t0..t0+k-1: the plant
    noise the twin tick adds at 2 W, keyed by (seed, second, chip).
    ``t0`` is an int for every scenario or an (N,) tensor, one start
    second per scenario."""
    dev = seeds.device
    if isinstance(t0, torch.Tensor):
        t = t0.to(dev, torch.int64)[:, None] + torch.arange(
            k, dtype=torch.int64, device=dev)
    else:
        t = torch.arange(t0, t0 + k, dtype=torch.int64, device=dev)[None]
    return rnd.normal(seeds[:, None, None, None], rnd.PLANT_NOISE,
                      t[:, :, None, None],
                      rnd.lanes((n_hosts, chips_per_host), dev))


def live_load_noise(seeds: torch.Tensor, t: torch.Tensor,
                    n_hosts: int) -> torch.Tensor:
    """(N, H) white noise of each scenario's own second ``t`` (N,): the
    online service's per-second demand draw, keyed by (seed, second,
    host).  The rollout draws a whole hour block at once instead
    (:func:`host_loads_block`)."""
    return rnd.normal(seeds[:, None], rnd.SERVICE_LOAD, t[:, None],
                      rnd.lanes((n_hosts,), seeds.device))


def twin_carry_init(n_hosts: int, chips_per_host: int, n: int, device):
    """Initial Tier-2 + plant carry of ``n`` scenarios: (rls, chip_power,
    caps)."""
    rls0 = ar4_lib.init_rls((n, n_hosts), device=device)
    shape = (n, n_hosts, chips_per_host)
    chip_power0 = torch.full(shape, plant_lib.P_IDLE, dtype=torch.float32,
                             device=device)
    caps0 = torch.full(shape, plant_lib.CAP_MAX, dtype=torch.float32,
                       device=device)
    return rls0, chip_power0, caps0


def twin_tick(n_hosts: int, chips_per_host: int, chip_tdp: float,
              pue_design, carry, load_h, mu, rho, ffr, t_amb, noise):
    """The 1 Hz fused Tier-2/Tier-1/plant update for one second of N
    scenarios.  ``load_h`` (N, H); ``mu``, ``rho``, ``ffr``, ``t_amb``,
    ``pue_design`` (N,); ``noise`` (N, H, C) standard normals.
    Returns (carry, TwinMetrics row)."""
    H, C = n_hosts, chips_per_host
    design_host = C * chip_tdp
    design_it_w = H * design_host
    rls, chip_power, caps = carry

    frac = torch.where(ffr, mu - rho, mu)
    envelope = frac * design_it_w
    host_env = (frac * design_host)[:, None].expand(-1, H)
    load_h = load_h * torch.where(
        ffr, frac / torch.clamp(mu, min=1e-3), 1.0)[:, None]

    pred = ar4_lib.predict(rls) * design_host
    caps = ar4_lib.host_rebalance(
        pred, host_env, torch.clamp(chip_power, min=plant_lib.P_IDLE),
        plant_lib.CAP_MIN, plant_lib.CAP_MAX)

    demand = plant_lib.power_model(plant_lib.F_NOMINAL,
                                   load_h[..., None]) + 2.0 * noise
    target = torch.minimum(demand, caps)
    shed_target = torch.minimum(
        torch.clamp(frac * chip_tdp, min=IDLE_FLOOR_W)[:, None, None], caps)
    target = torch.where(ffr[:, None, None],
                         torch.minimum(target, shed_target), target)
    chip_power = target

    host_power = chip_power.sum(-1)
    rls, abs_err_norm = ar4_lib.rls_update(rls, host_power / design_host)
    abs_err = abs_err_norm * design_host

    it = host_power.sum(-1)
    L = it / design_it_w
    fac = it * pue_lib.pue(L, t_amb, pue_design=pue_design)
    track = torch.abs(it - envelope) / torch.clamp(envelope, min=1.0)
    flat = chip_power.reshape(chip_power.shape[0], -1)
    out = TwinMetrics(
        host_power=host_power, host_pred=pred, ar4_abs_err=abs_err,
        chip_power_mean=flat.mean(-1),
        chip_power_p95=torch.quantile(flat, 0.95, dim=-1),
        envelope=envelope, it_power=it, facility_power=fac,
        ffr_active=ffr, tracking_err=track)
    return (rls, chip_power, caps), out


# ---------------------------------------------------------------------------
# The standalone twin: host-prepared scenarios, one loop over seconds
# ---------------------------------------------------------------------------


class TwinInputs(NamedTuple):
    """Per-second inputs of one scenario, all tensors on one device; a
    list of these stacks into a leading scenario axis
    (:func:`stack_scenarios`)."""

    loads: torch.Tensor      # (T, H) per-host demand, scaled by the hour's mu
    mu_sec: torch.Tensor     # (T,) Tier-3 operating fraction
    rho_sec: torch.Tensor    # (T,) committed FFR band
    ffr_sec: torch.Tensor    # (T,) bool FFR activation flag
    t_amb_sec: torch.Tensor  # (T,) ambient degC
    seed: torch.Tensor       # () int64: keys the counter-based plant noise


@dataclass(frozen=True)
class TwinScenario:
    """One prepared scenario: the loop's inputs and the host-side context
    the summary needs (FFR event list, hourly operating points, grid)."""

    inputs: TwinInputs
    grid: signals.GridSignals
    events: list
    mu_h: np.ndarray
    rho_h: np.ndarray
    seed: int


def prepare_scenario(cfg: TwinConfig, grid: signals.GridSignals,
                     events=None, seed: int | None = None, *, loads=None,
                     ops=None, device="cuda") -> TwinScenario:
    """Host-side scenario preparation: the Tier-3 schedule, the FFR
    events, the per-second demand, on ``device``.

    ``seed`` overrides ``cfg.seed``.  ``events`` is a list of
    (t_event_s, nadir_hz, recovery_s) (default: one day of
    ``FFRTriggerGen(4 events/day, seed)``).  ``ops`` = (mu_h, rho_h), each
    (hours,), replaces the Tier-3 selection; ``loads`` (T, H) replaces the
    per-second demand as :class:`TwinInputs` holds it (already scaled by
    the hourly mu and the step transient).
    """
    dev = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    hours = cfg.seconds // 3600
    T, H = cfg.seconds, cfg.n_hosts
    if ops is None:
        sel = tier3_lib.Tier3Selector(pue_aware=cfg.pue_aware,
                                      pue_design=cfg.pue_design, device=dev)
        op = sel.select_day(grid.ci[:hours], grid.t_amb[:hours])
        mu_h = np.atleast_1d(op.mu.cpu().numpy())
        rho_h = np.atleast_1d(op.rho.cpu().numpy())
    else:
        mu_h, rho_h = (np.atleast_1d(np.asarray(x, np.float32)) for x in ops)
        if mu_h.shape != (hours,) or rho_h.shape != (hours,):
            raise ValueError(f"ops override must be a (mu_h, rho_h) pair of "
                             f"shape ({hours},), got {mu_h.shape} / "
                             f"{rho_h.shape}")

    if events is None:
        events = markets.FFRTriggerGen(events_per_day=4.0,
                                       seed=seed).sample_day()
    ffr = np.zeros(T, bool)
    for (t0, _nadir, rec) in events:
        i0 = int(t0)
        ffr[i0: min(i0 + int(rec), T)] = True

    hour_idx = np.minimum(np.arange(T) // 3600, hours - 1)

    def on_dev(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    mu_sec = on_dev(mu_h[hour_idx])
    rho_sec = on_dev(rho_h[hour_idx])
    t_amb_sec = on_dev(np.asarray(grid.t_amb[hour_idx], np.float32))
    if loads is None:
        seeds = torch.tensor([seed], dtype=torch.int64, device=dev)
        loads = host_loads_trace(H, T, seeds)[0] * mu_sec[:, None] / 0.9
        if cfg.step_transient_amp:
            # synchronised-training power wave, zero-mean over a period
            wave = workload_lib.step_transient(
                torch.arange(T, device=dev), cfg.step_period_s,
                cfg.step_transient_amp)
            loads = torch.clamp(loads * wave[:, None], 0.0, 1.0)
    else:
        loads = override(loads, (T, H), "loads", "(T, H)", dev)
    inputs = TwinInputs(loads=loads, mu_sec=mu_sec, rho_sec=rho_sec,
                        ffr_sec=on_dev(ffr, torch.bool), t_amb_sec=t_amb_sec,
                        seed=torch.tensor(seed, dtype=torch.int64,
                                          device=dev))
    return TwinScenario(inputs=inputs, grid=grid, events=events,
                        mu_h=mu_h, rho_h=rho_h, seed=seed)


def stack_scenarios(scenarios: list[TwinScenario]) -> TwinInputs:
    """Stack per-scenario inputs along a new leading scenario axis."""
    return TwinInputs(*(torch.stack(xs)
                        for xs in zip(*(s.inputs for s in scenarios))))


def _twin_loop(cfg: TwinConfig, inp: TwinInputs, noise) -> TwinMetrics:
    """The 1 Hz loop over N stacked scenarios: one :func:`twin_tick` per
    second, each hour's rows written into preallocated (N, T, ...)
    buffers.  ``noise`` (N, T, H, C) or None (counter-based draws, one
    hour block at a time)."""
    N, T, H = inp.loads.shape
    C = cfg.chips_per_host
    dev = inp.loads.device

    def buf(*shape, dtype=torch.float32):
        return torch.empty((N, T) + shape, dtype=dtype, device=dev)

    out = TwinMetrics(
        host_power=buf(H), host_pred=buf(H), ar4_abs_err=buf(H),
        chip_power_mean=buf(), chip_power_p95=buf(), envelope=buf(),
        it_power=buf(), facility_power=buf(),
        ffr_active=buf(dtype=torch.bool), tracking_err=buf())
    carry = twin_carry_init(H, C, N, dev)
    for s0 in range(0, T, LOAD_BLOCK_S):
        k = min(LOAD_BLOCK_S, T - s0)
        nz = (plant_noise(inp.seed, s0, k, H, C) if noise is None
              else noise[:, s0:s0 + k])
        rows = []
        for j in range(k):
            t = s0 + j
            carry, m = twin_tick(
                H, C, cfg.chip_tdp, cfg.pue_design, carry, inp.loads[:, t],
                inp.mu_sec[:, t], inp.rho_sec[:, t], inp.ffr_sec[:, t],
                inp.t_amb_sec[:, t], nz[:, j])
            rows.append(m)
        for dst, xs in zip(out, zip(*rows)):
            dst[:, s0:s0 + k] = torch.stack(xs, dim=1)
    return out


def _metrics_at(out: TwinMetrics, i: int) -> TwinMetrics:
    return TwinMetrics(*(x[i] for x in out))


def summarize_twin(cfg: TwinConfig, scen: TwinScenario,
                   out: TwinMetrics) -> dict:
    """Paper Fig. 4 summary numbers for one scenario's metrics (leaves
    (T, ...)), computed on the host from one copy of the metrics, as the
    reference does."""
    hours = cfg.seconds // 3600
    mu_h, rho_h, events, grid = scen.mu_h, scen.rho_h, scen.events, scen.grid
    o = {k: v.detach().cpu().numpy() for k, v in out._asdict().items()}
    warm = 60  # let RLS warm up before scoring
    err = o["ar4_abs_err"][warm:]
    design_host = cfg.chips_per_host * cfg.chip_tdp
    mae_norm = float(np.mean(err) / design_host)
    p95_norm = float(np.percentile(err, 95) / design_host)

    # FFR provision quality at the meter: delivered/committed per event
    fac = o["facility_power"]
    it = o["it_power"]
    qs = []
    for (t0, _n, rec) in events:
        i0 = int(t0)
        if i0 < 30 or i0 + 30 > cfg.seconds:
            continue
        pre = fac[i0 - 20: i0 - 2].mean()
        post = fac[i0 + 10: i0 + min(int(rec), 60)].mean()
        h = int(min(i0 // 3600, hours - 1))
        committed = rho_h[h] * cfg.design_it_w * cfg.pue_design
        if committed <= 0:
            continue
        qs.append(min((pre - post) / committed, 1.0))
    q_ffr = float(np.mean(qs)) if qs else float("nan")

    greenness = grid.greenness()[:hours]
    return dict(
        ar4_mae_norm=mae_norm,
        ar4_p95_norm=p95_norm,
        chip_power_mean=float(np.mean(o["chip_power_mean"])),
        chip_power_p95=float(np.mean(o["chip_power_p95"])),
        q_ffr=q_ffr,
        mean_mu_green=float(mu_h[greenness > 0.6].mean())
        if (greenness > 0.6).any() else float("nan"),
        mean_mu_dirty=float(mu_h[greenness < 0.4].mean())
        if (greenness < 0.4).any() else float("nan"),
        mean_rho=float(rho_h.mean()),
        tracking_err_mean=float(np.mean(o["tracking_err"][warm:])),
        it_energy_mwh=float(it.sum() / 3600.0 / 1e6),
        facility_energy_mwh=float(fac.sum() / 3600.0 / 1e6),
    )


def run_twin(cfg: TwinConfig, grid: signals.GridSignals, events=None, *,
             loads=None, noise=None, ops=None,
             device="cuda") -> tuple[TwinMetrics, dict]:
    """The multiscale twin on one grid.  Returns (per-second metrics with
    (T, ...) leaves, summary).  ``loads`` (T, H), ``noise`` (T, H, C) and
    ``ops`` override the scenario's draws and Tier-3 schedule."""
    scen = prepare_scenario(cfg, grid, events, loads=loads, ops=ops,
                            device=device)
    out, summaries = run_twin_batch(
        cfg, [scen], noise=None if noise is None else noise[None])
    return _metrics_at(out, 0), summaries[0]


def run_twin_batch(cfg: TwinConfig, scenarios: list[TwinScenario], *,
                   noise=None) -> tuple[TwinMetrics, list[dict]]:
    """Replay N prepared scenarios (on their device) as one loop over
    seconds on (N, ...) tensors.

    Returns (metrics with a leading (N,) scenario axis, one summary per
    scenario).  All scenarios share ``cfg``; they may differ in grid,
    season, seed and FFR event draw.  A scenario's demand is overridden
    where it is prepared (:func:`prepare_scenario`'s ``loads``);
    ``noise`` (N, T, H, C) replaces the plant's standard normals.
    """
    inp = stack_scenarios(scenarios)
    N, T, H = inp.loads.shape
    if noise is not None:
        noise = override(noise, (N, T, H, cfg.chips_per_host), "noise",
                         "(N, T, H, C)", inp.loads.device)
    out = _twin_loop(cfg, inp, noise)
    summaries = [summarize_twin(cfg, scen, _metrics_at(out, i))
                 for i, scen in enumerate(scenarios)]
    return out, summaries


def net_co2_decomposition(cfg: TwinConfig, grid: signals.GridSignals,
                          summary: dict, mu_h: np.ndarray | None = None,
                          rho_h: np.ndarray | None = None, *,
                          device="cuda") -> dict:
    """Net CO2 = Operational - Exogenous (paper Sect. 4 Metrics).

    Baseline: flat operation at the same total compute (mean mu), static
    PUE accounting, no FFR provision.  GridPilot: CI-aligned schedule +
    instantaneous PUE + avoided reserve-side emissions for the armed FFR
    band (displacing a fossil peaker at the reserve margin).  The Tier-3
    selection (when ``mu_h``/``rho_h`` are not given) and the PUE run on
    ``device``; the sums are numpy, as in the reference.
    """
    dev = resolve_device(device)
    hours = cfg.seconds // 3600
    ci = grid.ci[:hours]
    t_amb = grid.t_amb[:hours]
    if mu_h is None or rho_h is None:
        sel = tier3_lib.Tier3Selector(pue_aware=cfg.pue_aware,
                                      pue_design=cfg.pue_design, device=dev)
        op = sel.select_day(ci, t_amb)
        mu_h = op.mu.cpu().numpy()
        rho_h = op.rho.cpu().numpy()
    mu_h = np.asarray(mu_h, np.float32)
    rho_h = np.asarray(rho_h, np.float32)

    design_mw = cfg.design_it_w / 1e6
    # GridPilot operational: hourly IT = mu * design, instantaneous PUE
    it_gp = mu_h * design_mw
    pue_gp = pue_lib.pue(tensor(mu_h, dev), tensor(t_amb, dev),
                         pue_design=cfg.pue_design).cpu().numpy()
    co2_gp = float(np.sum(it_gp * pue_gp * ci) / 1000.0)  # tCO2
    # exogenous: the armed FFR band displaces spinning reserve on the local
    # grid -- a fossil peaker where fossil sets the margin (DE/IT/PL),
    # hydro/gas on clean grids (CH/SE); 9 % equivalent utilisation of the
    # armed band (Nordic activation statistics order)
    reserve_ci = min(650.0, 2.5 * float(np.mean(ci)) + 50.0)
    UTIL = 0.09
    exo = float(np.sum(rho_h * design_mw * cfg.pue_design * reserve_ci * UTIL)
                / 1000.0)
    # baseline: flat mu, static PUE, no reserve
    mu_flat = float(mu_h.mean())
    co2_base = float(np.sum(mu_flat * design_mw * cfg.pue_design * ci)
                     / 1000.0)

    net_gp = co2_gp - exo
    return dict(
        co2_baseline_t=co2_base,
        co2_operational_t=co2_gp,
        co2_exogenous_t=exo,
        co2_net_t=net_gp,
        operational_savings_pct=100.0 * (co2_base - co2_gp) / co2_base,
        exogenous_savings_pct=100.0 * exo / co2_base,
        net_savings_pct=100.0 * (co2_base - net_gp) / co2_base,
    )
