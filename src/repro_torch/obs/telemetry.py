"""In-graph telemetry taps of the rollout engine: the port of
``repro.obs.telemetry``.

With ``EngineConfig.telemetry=True`` the engine reduces each hour's
ticks into a :class:`TickAccum` (RLS-residual and tracking-error square
sums, the cap-saturated chip fraction, cumulative tracking-error bucket
counts), and :func:`finalize` turns the stacked per-hour sums into the
reported moments, histograms and per-event response times.  Every
returned leaf is (N,), (N, H), (N, buckets) or (N, e_max): nothing
scales with the horizon in seconds.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._num import const

TRACK_ERR_EDGES = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1)
N_TRACK_BUCKETS = len(TRACK_ERR_EDGES) + 1
RESP_FRAC_EDGES = (0.05, 0.1, 0.15, 0.25, 0.5, 0.75, 1.0, 1.5)
N_RESP_BUCKETS = len(RESP_FRAC_EDGES) + 1
CAP_SAT_TOL_W = 1e-3
HOUR_S = 3600


class TickAccum(NamedTuple):
    """One hour's telemetry sums per scenario."""
    rls2: torch.Tensor      # (N,) sum of w * (fleet-mean |AR4 err|)^2 (W^2)
    track2: torch.Tensor    # (N,) sum of w * tracking_err^2
    sat: torch.Tensor       # (N,) sum of g * cap-saturated chip fraction
    track_le: torch.Tensor  # (N, E) cumulative counts sum w * (track <= e)


def cap_saturation(chip_power, caps) -> torch.Tensor:
    """(N, H, C) -> (N,) share of chips sitting at their Tier-2 cap."""
    sat = (chip_power >= caps - CAP_SAT_TOL_W).to(torch.float32)
    return sat.mean((-2, -1))


def accum_update(*, sat, err, track, g, w) -> TickAccum:
    """Reduce one hour of ticks, each input (N, K), into its sums:
    ``sat`` from :func:`cap_saturation`, ``err`` the fleet-mean |AR4
    err| (W), ``track`` the tracking error, ``g``/``w`` the in-horizon
    and past-warm-up gates the engine's own aggregates use."""
    edges = const(TRACK_ERR_EDGES, track.device)
    le = (track[..., None] <= edges).to(torch.float32)
    return TickAccum(
        rls2=(w * err * err).sum(-1),
        track2=(w * track * track).sum(-1),
        sat=(g * sat).sum(-1),
        track_le=(w[..., None] * le).sum(-2))


def histogram(edges, x, weights) -> torch.Tensor:
    """Weighted fixed-bucket histogram of ``x`` (..., M) against static
    ``edges``: buckets (-inf, e0], (e0, e1], ..., (eK, inf)."""
    c = torch.stack([(weights * (x <= ek)).sum(-1) for ek in edges], dim=-1)
    total = weights.sum(-1, keepdim=True)
    return torch.diff(c, dim=-1, prepend=torch.zeros_like(total),
                      append=total)


def response_histogram(t_full_ms, valid, budget_ms) -> torch.Tensor:
    """Per-event trigger-to-target times -> (..., N_RESP_BUCKETS)
    histogram of ``t_full / budget`` over valid events."""
    frac = t_full_ms / torch.clamp(budget_ms, min=1e-6)[..., None]
    return histogram(RESP_FRAC_EDGES, frac, valid.to(torch.float32))


def finalize(hour: TickAccum, *, design_host: float, events, budget_ms,
             load_sec, valid_s, warmup_s, last_load) -> dict:
    """Per-hour sums (leaves (N, B) / (N, B, E)) -> reported moments.

    ``load_sec`` is the (N, T) pre-tick cluster load and ``last_load``
    the final realised L, from which the per-second slew dL/dt is exact.
    """
    slew = torch.cat([load_sec[:, 1:], last_load[:, None]], -1) - load_sec
    n, T = load_sec.shape
    B = T // HOUR_S
    t = torch.arange(T, device=load_sec.device)
    g = (t[None, :] < valid_s[:, None]).to(torch.float32)
    w = g * (t >= warmup_s)[None, :]

    def hsum(x):
        return x.reshape(n, B, HOUR_S).sum(-1)

    n_h = hsum(g)
    w_h = hsum(w)
    nw_h = torch.clamp(w_h, min=1.0)
    has = n_h > 0
    slew_max_h = torch.where(g > 0, slew, -torch.inf).reshape(
        n, B, HOUR_S).amax(-1)
    slew_min_h = torch.where(g > 0, slew, torch.inf).reshape(
        n, B, HOUR_S).amin(-1)
    c = hour.track_le.sum(1)
    valid = events.valid
    vf = valid.to(torch.float32)
    n_ev = torch.clamp(vf.sum(-1), min=1.0)
    return dict(
        hour_n=n_h,
        rls_rms_h=torch.sqrt(hour.rls2 / nw_h) / design_host,
        track_rms_h=torch.sqrt(hour.track2 / nw_h),
        sat_frac_h=hour.sat / torch.clamp(n_h, min=1.0),
        slew_max_h=torch.where(has, slew_max_h, 0.0),
        slew_min_h=torch.where(has, slew_min_h, 0.0),
        track_hist=torch.diff(c, dim=-1, prepend=torch.zeros_like(c[:, :1]),
                              append=w_h.sum(-1, keepdim=True)),
        resp_hist=response_histogram(events.t_full_ms, valid, budget_ms),
        resp_ms=torch.where(valid, events.t_full_ms, 0.0),
        resp_valid=valid,
        resp_budget_ms=budget_ms,
        resp_ms_mean=(events.t_full_ms * vf).sum(-1) / n_ev,
        resp_ms_max=torch.where(valid, events.t_full_ms, 0.0).amax(-1),
        n_budget_ok=(valid & events.budget_ok).to(torch.int32).sum(-1),
        load_final=last_load,
    )


def sweep_summary(tel: dict, lane, *, warmup_s: int) -> dict:
    """Reduce a batched :func:`finalize` output into the streaming
    sweep's commutative-monoid telemetry accumulators (keys ending
    ``_max``/``_min`` merge by max/min, the rest by sum).  ``lane`` is
    the (N,) lane-validity mask."""
    lane = lane.to(torch.float32)
    lane_c = lane[:, None]
    hour_n = tel["hour_n"]
    B = hour_n.shape[-1]
    first = (torch.arange(B, device=hour_n.device) == 0).to(torch.float32)
    w_h = torch.clamp(hour_n - float(warmup_s) * first, min=0.0)
    nw_h = torch.clamp(w_h, min=1.0)
    rls2_h = torch.square(tel["rls_rms_h"]) * nw_h
    track2_h = torch.square(tel["track_rms_h"]) * nw_h
    sat_h = tel["sat_frac_h"] * torch.clamp(hour_n, min=1.0)
    has_hour = (lane_c * hour_n) > 0
    vf = tel["resp_valid"].to(torch.float32) * lane_c
    return dict(
        tel_track_hist=(lane_c * tel["track_hist"]).sum(0),
        tel_resp_hist=(lane_c * tel["resp_hist"]).sum(0),
        tel_rls2=(lane_c * rls2_h).sum(),
        tel_track2=(lane_c * track2_h).sum(),
        tel_sat_s=(lane_c * sat_h).sum(),
        tel_n_budget_ok=(lane * tel["n_budget_ok"]).sum(),
        tel_resp_ms_sum=(vf * tel["resp_ms"]).sum(),
        tel_resp_n=vf.sum(),
        tel_resp_ms_max=torch.where(vf > 0, tel["resp_ms"],
                                    -torch.inf).amax(),
        tel_slew_max=torch.where(has_hour, tel["slew_max_h"],
                                 -torch.inf).amax(),
        tel_slew_min=torch.where(has_hour, tel["slew_min_h"],
                                 torch.inf).amin(),
    )
