"""GridPilot-PUE dispatch (paper Algorithm 1): the port of
``repro.core.dispatch``.

The composite deferral signal is

    sigma(t) = CI(t) * PUE(t, L, T_amb)

compared with its 66th percentile over a 24 h look-ahead window: defer
when sigma exceeds it, dispatch otherwise.  Around it: an aging budget
beta_j = wait_j / d_max_j with a 0.7 cutoff, an 80 % power cap on running
jobs in high-sigma hours (EcoFreq), elastic replica scaling inversely to
sigma for the first 30 % of elastic jobs, and EASY backfill of short jobs.

:func:`replay_schedule` integrates power and carbon of utilisation
schedules over the hour axis; :func:`signal_thresholds` and
:func:`schedule_from_threshold` build signal-ranked schedules.  All work
on the last (hour) axis with any leading axes; the engine runs them on
its device.  :class:`GridPilotDispatcher` is the job-level scheduler:
host bookkeeping over hours, as in the reference.
"""
from __future__ import annotations

import heapq
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

import repro_torch.core.pue as pue_lib
import repro_torch.workload.model as workload_lib
from repro_torch._num import tensor
from repro_torch.obs import trace

SIGMA_PCT = 66.0
BETA_CUTOFF = 0.7
HIGH_SIGMA_CAP = 0.8        # EcoFreq default 80 % power-cap factor
ELASTIC_FRACTION = 0.3      # first 30 % of elastic jobs scale replicas
SHORT_JOB_H = 2.0           # EASY backfill / "not short" threshold
LOOKAHEAD_H = 24


def thresholds_from_sorted(signal_sorted, n_his) -> torch.Tensor:
    """Thresholds from an already-sorted signal (invalid entries at +inf);
    ``n_his`` (..., K) counts."""
    idx = torch.clamp(n_his.long() - 1, 0, signal_sorted.shape[-1] - 1)
    return torch.where(n_his > 0, torch.gather(signal_sorted, -1, idx),
                       -torch.inf)


def signal_thresholds(signal, mask, n_his) -> torch.Tensor:
    """Signal value below which a valid hour is among the n_his[k] best."""
    s = torch.sort(torch.where(mask > 0, signal, torch.inf), dim=-1).values
    return thresholds_from_sorted(s, n_his)


def schedule_from_threshold(signal, thr, lo, mask, mu_hi: float):
    """Schedule ``mu_hi`` where ``signal <= thr``, ``lo`` elsewhere."""
    mu = torch.where(signal <= thr, mu_hi, lo)
    return torch.where(mask > 0, mu, 0.0)


def _per_row(x):
    """A per-schedule knob against the hour axis: (...,) -> (..., 1)."""
    if isinstance(x, torch.Tensor) and x.dim() > 0:
        return x.unsqueeze(-1)
    return x


def replay_schedule(mu, ci, t_amb, mask, *, pue_design,
                    green_ci=None, design_w=1.0, clock_w=None) -> dict:
    """Integrate power/carbon of schedule(s) ``mu`` (..., H) over hours.

    ``pue_design``, ``green_ci``, ``design_w`` and ``clock_w`` are numbers
    or tensors of the leading shape.  Returns (...)-shaped totals: it,
    fac, co2_it, co2, cfe_mu, cfe_fac and, with ``clock_w``, thr (full-
    rate-equivalent workload hours).  Padded hours contribute nothing.
    """
    mu = tensor(mu)
    load = torch.clamp(mu, 0.05, 1.0)
    p = pue_lib.pue(load, t_amb, pue_design=_per_row(pue_design))
    dw = _per_row(design_w)
    it_w = load * dw * mask
    fac_w = load * p * dw * mask
    green = -torch.inf if green_ci is None else _per_row(green_ci)
    is_green = ci <= green
    out = dict(
        it=it_w.sum(-1), fac=fac_w.sum(-1),
        co2_it=(it_w * ci).sum(-1), co2=(fac_w * ci).sum(-1),
        cfe_mu=(torch.where(is_green, mu, 0.0) * mask).sum(-1),
        cfe_fac=torch.where(is_green, fac_w, 0.0).sum(-1))
    if clock_w is not None:
        out["thr"] = (workload_lib.throughput_frac(_per_row(clock_w), load)
                      * mask).sum(-1)
    return out


@dataclass
class Job:
    jid: int
    submit_h: float
    duration_h: float
    nodes: int
    power_node_w: float       # mean IT power per node at full rate
    elastic: bool = False
    d_max_h: float = 24.0     # aging budget denominator
    # runtime state
    start_h: float = -1.0
    done_h: float = -1.0
    replicas: float = 1.0     # elastic scale factor (1.0 = as submitted)
    remaining_h: float = field(default=-1.0)

    def __post_init__(self):
        if self.remaining_h < 0:
            self.remaining_h = self.duration_h

    @property
    def short(self) -> bool:
        return self.duration_h <= SHORT_JOB_H

    def beta(self, now_h: float) -> float:
        return max(now_h - self.submit_h, 0.0) / max(self.d_max_h, 1e-6)


@dataclass
class DispatchStats:
    dispatched: int = 0
    deferred: int = 0
    backfilled: int = 0
    capped_job_hours: float = 0.0
    wait_hours: list = field(default_factory=list)
    it_energy_mwh: float = 0.0
    facility_energy_mwh: float = 0.0
    co2_t: float = 0.0          # operational tCO2 (facility energy x CI)
    co2_it_t: float = 0.0       # IT-side tCO2 (board energy x CI)
    cfe_num: float = 0.0        # energy in green windows
    util_trace: list = field(default_factory=list)
    sigma_trace: list = field(default_factory=list)
    pue_trace: list = field(default_factory=list)


def _host_pue(load, t_amb, pue_design) -> np.ndarray:
    """``pue`` on float32 host tensors: the scheduler's per-hour scalars,
    rounded as the reference's float32 ``jnp`` rounds them."""
    return pue_lib.pue(torch.as_tensor(load, dtype=torch.float32),
                       torch.as_tensor(t_amb, dtype=torch.float32),
                       pue_design=pue_design).numpy()


class GridPilotDispatcher:
    """Hourly dispatch over a job trace against CI/T_amb series.

    ``pue_aware=False`` gives the CI-only Tier-3 baseline of E8 (sigma =
    CI alone); ``pue_aware=True`` uses the composite CI x PUE signal.

    Placement: the whole class runs on the host, as the reference's does.
    The scheduler is Python bookkeeping over jobs and hours in float64;
    the PUE of an hour and the energy/carbon integral of the realised
    utilisation trace (:func:`replay_schedule`) are float32 tensors on
    the CPU, so they round as the reference's float32 ``jnp`` does.
    Nothing of it is device work, so the class takes no ``device``.
    """

    def __init__(self, total_nodes: int, node_power_w: float,
                 ci_series: np.ndarray, t_amb_series: np.ndarray,
                 *, pue_aware: bool = True,
                 pue_design: float = pue_lib.PUE_DESIGN,
                 green_threshold_pct: float = 50.0):
        self.total_nodes = total_nodes
        self.node_power_w = node_power_w
        self.design_it_w = total_nodes * node_power_w
        self.ci = np.asarray(ci_series, np.float64)
        self.t_amb = np.asarray(t_amb_series, np.float64)
        self.pue_aware = pue_aware
        self.pue_design = pue_design
        self.green_ci = np.percentile(self.ci, green_threshold_pct)

    # -- signal -------------------------------------------------------------
    def _sigmas(self, hs: np.ndarray, load: float) -> np.ndarray:
        ci = self.ci[hs]
        if not self.pue_aware:
            return ci
        p = _host_pue(np.full(hs.shape, max(load, 0.05)), self.t_amb[hs],
                      self.pue_design)
        return ci * p.astype(np.float64)

    def sigma(self, h: int, load: float) -> float:
        return float(self._sigmas(np.asarray([h]), load)[0])

    def sigma_threshold(self, h: int, load: float) -> float:
        """66th percentile of sigma over the 24 h look-ahead window."""
        hs = np.arange(h, min(h + LOOKAHEAD_H, len(self.ci)))
        return float(np.percentile(self._sigmas(hs, load), SIGMA_PCT))

    # -- one scheduling tick (1 h) -------------------------------------------
    def _try_start(self, job: Job, free_nodes: int, now_h: float,
                   running: list, stats: DispatchStats,
                   sigma_hi: bool, sigma_ratio: float,
                   elastic_rank: int, n_elastic: int) -> int:
        need = job.nodes
        if job.elastic and n_elastic > 0 and elastic_rank < max(
                1, int(np.ceil(ELASTIC_FRACTION * n_elastic))):
            # scale replicas inversely to sigma: shrink in dirty windows
            scale = float(np.clip(1.0 / max(sigma_ratio, 0.25), 0.5, 2.0))
            job.replicas = scale
            need = max(1, int(round(job.nodes * scale)))
            # work-conserving: total node-hours preserved
            job.remaining_h = job.remaining_h * job.nodes / need
        if need <= free_nodes:
            job.start_h = now_h
            job.nodes = need
            running.append(job)
            stats.dispatched += 1
            stats.wait_hours.append(now_h - job.submit_h)
            return need
        return 0

    # kwargs that used to toggle an inline per-hour power/carbon
    # integration; accepted with a DeprecationWarning and ignored: the
    # accounting is always delegated to `replay_schedule`.
    _DEPRECATED_RUN_KWARGS = ("integrate_energy", "integrate_carbon",
                              "inline_accounting")

    def run(self, jobs: list[Job], horizon_h: Optional[int] = None,
            reserve_rho: float = 0.0, **deprecated) -> DispatchStats:
        """Replay the trace.  Returns aggregate stats.

        reserve_rho caps usable nodes at (1 - rho) of the fleet -- the FFR
        band withheld by Tier-3 (instantly sheddable duty-cycled capacity).
        The energy/carbon accounting is :func:`replay_schedule` over the
        realised utilisation trace.
        """
        for k in deprecated:
            if k not in self._DEPRECATED_RUN_KWARGS:
                raise TypeError(f"run() got an unexpected keyword {k!r}")
            warnings.warn(
                f"GridPilotDispatcher.run({k}=...) is deprecated and "
                "ignored: the inline power/carbon integration was removed; "
                "accounting is always delegated to replay_schedule.",
                DeprecationWarning, stacklevel=2)
        horizon = int(horizon_h if horizon_h is not None else len(self.ci))
        horizon = min(horizon, len(self.ci))
        with trace.span("dispatch.run", horizon_h=horizon,
                        n_jobs=len(jobs), reserve_rho=reserve_rho,
                        pue_aware=self.pue_aware) as run_attrs:
            stats = self._run_loop(jobs, horizon, reserve_rho)
            run_attrs["dispatched"] = stats.dispatched
            run_attrs["deferred"] = stats.deferred
            run_attrs["backfilled"] = stats.backfilled
        return stats

    def _run_loop(self, jobs: list[Job], horizon: int,
                  reserve_rho: float) -> DispatchStats:
        pending: list[tuple] = []   # heap by (submit, jid)
        arrivals = sorted(jobs, key=lambda j: j.submit_h)
        ai = 0
        running: list[Job] = []
        stats = DispatchStats()
        usable = int(round(self.total_nodes * (1.0 - reserve_rho)))
        load_est = 0.7

        for h in range(horizon):
            now = float(h)
            # job arrivals
            while ai < len(arrivals) and arrivals[ai].submit_h <= now:
                j = arrivals[ai]
                heapq.heappush(pending, (j.submit_h, j.jid, j))
                ai += 1
            # completions
            still = []
            for j in running:
                if j.remaining_h <= 1e-9:
                    j.done_h = now
                else:
                    still.append(j)
            running = still

            busy = sum(j.nodes for j in running)
            free = usable - busy
            sig = self.sigma(h, load_est)
            thr = self.sigma_threshold(h, load_est)
            sigma_hi = sig > thr
            sigma_ratio = sig / max(thr, 1e-9)
            stats.sigma_trace.append(sig)

            # Algorithm 1 main loop (priority = submit order)
            defer_back: list[tuple] = []
            n_elastic = sum(1 for _, _, j in pending if j.elastic)
            elastic_rank = 0
            while pending:
                _, _, job = heapq.heappop(pending)
                if sigma_hi and job.beta(now) < BETA_CUTOFF and not job.short:
                    stats.deferred += 1
                    defer_back.append((job.submit_h, job.jid, job))
                    continue
                got = self._try_start(job, free, now, running, stats,
                                      sigma_hi, sigma_ratio,
                                      elastic_rank, n_elastic)
                if job.elastic:
                    elastic_rank += 1
                if got == 0:
                    defer_back.append((job.submit_h, job.jid, job))
                else:
                    free -= got
            # EASY backfill: short jobs squeeze into remaining nodes
            rest = []
            for item in sorted(defer_back, key=lambda it: it[2].duration_h):
                job = item[2]
                if job.short and 0 < job.nodes <= free:
                    job.start_h = now
                    running.append(job)
                    free -= job.nodes
                    stats.backfilled += 1
                    stats.wait_hours.append(now - job.submit_h)
                else:
                    rest.append(item)
            pending = rest
            heapq.heapify(pending)

            # realised utilisation for this hour
            cap_factor = HIGH_SIGMA_CAP if sigma_hi else 1.0
            it_w = 0.0
            for j in running:
                it_w += j.nodes * self.node_power_w * cap_factor
                # capped jobs progress at ~96 % rate (paper: capping running
                # jobs delivers savings "without adding wait time")
                rate = 0.96 if sigma_hi else 1.0
                j.remaining_h -= rate
                if sigma_hi:
                    stats.capped_job_hours += j.nodes
            # idle nodes draw 8 % of their power
            it_w += (self.total_nodes - busy) * self.node_power_w * 0.08
            load = it_w / self.design_it_w
            load_est = 0.5 * load_est + 0.5 * load
            stats.util_trace.append(load)

        self._account(stats, horizon)
        return stats

    def _account(self, stats: DispatchStats, horizon: int) -> None:
        """Power/carbon accounting over the realised utilisation trace:
        one :func:`replay_schedule` call on host float32 tensors."""
        mu = np.asarray(stats.util_trace, np.float32)
        if mu.size == 0:
            return
        ci = self.ci[:horizon].astype(np.float32)
        t_amb = self.t_amb[:horizon].astype(np.float32)
        with trace.span("dispatch.account", horizon_h=horizon):
            tot = {k: float(v) for k, v in replay_schedule(
                torch.from_numpy(mu), torch.from_numpy(ci),
                torch.from_numpy(t_amb), torch.ones(mu.shape),
                pue_design=self.pue_design, green_ci=float(self.green_ci),
                design_w=self.design_it_w).items()}
        stats.it_energy_mwh = tot["it"] / 1e6        # W*h -> MWh
        stats.facility_energy_mwh = tot["fac"] / 1e6
        stats.co2_t = tot["co2"] / 1e9               # W*h * g/kWh -> t
        stats.co2_it_t = tot["co2_it"] / 1e9
        stats.cfe_num = tot["cfe_fac"] / 1e6
        stats.pue_trace = [float(v) for v in _host_pue(
            np.clip(mu, 0.05, 1.0), t_amb, self.pue_design)]

    def cfe(self, stats: DispatchStats) -> float:
        return stats.cfe_num / max(stats.facility_energy_mwh, 1e-9)
