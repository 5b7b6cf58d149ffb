"""Tier-3: hourly cluster operating-point selector (paper Sect. 3.1,
Eq. 3): the port of ``repro.core.tier3``.

Grid search over mean operating fraction mu in {0.4..0.9} and FR band
rho in {0.0..0.3} maximising

    J(mu, rho) = 0.55 * Q_FFR + 0.45 * CFE  [+ w_rev * R]  [+ w_tok * G]

with Q_FFR evaluated at the facility meter.  Where the reference vmaps
the search over scenarios, :func:`select_operating_points` takes a
leading batch shape: greenness and ambient are (..., B) and each
per-scenario knob is a number or a tensor of the batch shape.
``torch.argmax`` takes the first of tied maxima, as ``jnp.argmax`` does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

import repro_torch.core.plant as plant_lib
import repro_torch.core.pue as pue_lib
import repro_torch.grid.markets as markets
import repro_torch.workload.model as workload_lib
from repro_torch import resolve_device
from repro_torch._num import const, device_of, take, tensor

MU_GRID = np.round(np.arange(0.4, 0.91, 0.1), 2)
RHO_GRID = np.round(np.arange(0.0, 0.31, 0.1), 2)
W_FFR, W_CFE = 0.55, 0.45
W_REV_DEFAULT = 0.25
MIN_RESIDUAL_LOAD = 0.17
RHO_MAX = float(RHO_GRID[-1])

DELIVERY_TOL = 0.02
PENALTY_WINDOW_H = 24.0
EVENTS_PER_DAY_DEFAULT = 4.0


class OperatingPoint(NamedTuple):
    mu: torch.Tensor   # mean operating fraction of design IT power
    rho: torch.Tensor  # committed FR reserve band (fraction of design IT)


def q_ffr(mu, rho, t_amb, *, pue_aware: bool,
          pue_design=pue_lib.PUE_DESIGN):
    """Relative FR-provision quality in [0, 1], evaluated at the meter."""
    dev = device_of(mu, rho, t_amb, pue_design)
    mu, rho = tensor(mu, dev), tensor(rho, dev)
    feasible = (mu - rho) >= MIN_RESIDUAL_LOAD
    committed_meter = rho * pue_design
    if pue_aware:
        gain = pue_lib.ffr_meter_gain(mu, rho, t_amb, pue_design=pue_design)
        rho_it = rho * pue_design / torch.clamp(gain, min=1e-3)
        rho_it = torch.minimum(rho_it, mu - MIN_RESIDUAL_LOAD)
        delivered = pue_lib.ffr_meter_gain(
            mu, rho_it, t_amb, pue_design=pue_design) * rho_it
    else:
        delivered = pue_lib.ffr_meter_gain(
            mu, rho, t_amb, pue_design=pue_design) * rho
    accuracy = torch.clamp(
        delivered / torch.clamp(committed_meter, min=1e-6), 0.0, 1.0)
    q = torch.pow(rho / RHO_MAX, 0.25) * accuracy
    return torch.where(feasible, q, 0.0)


def cfe_score(mu, greenness):
    """Per-hour CFE proxy: running high in green hours scores."""
    mu_n = tensor(mu) / float(MU_GRID[-1])
    return greenness * mu_n + (1.0 - greenness) * (1.0 - mu_n)


def event_verdict(mu, t_amb, rho, product_idx, pue_design,
                  pue_aware: bool = True) -> dict:
    """Physics of one activation at operating point ``mu``: the armed
    IT-side band, the governor-limited delivery time, and the meter-level
    delivered band per unit of design IT power."""
    dev = device_of(mu, rho, t_amb, pue_design, product_idx)
    mu = torch.clamp(tensor(mu, dev), min=1e-3)
    rho = tensor(rho, dev)
    if pue_aware:
        gain = pue_lib.ffr_meter_gain(mu, rho, t_amb, pue_design=pue_design)
        rho_it = rho * pue_design / torch.clamp(gain, min=1e-3)
    else:
        rho_it = rho
    rho_it = torch.minimum(torch.clamp(rho_it, min=0.0),
                           torch.clamp(mu - MIN_RESIDUAL_LOAD, min=0.0))
    residual = torch.clamp(mu - rho_it, min=1e-3)
    t_full_ms = plant_lib.ACTUATE_DELAY_MS + (
        torch.log(mu / residual) / plant_lib.GOV_SLEW)
    budget_ok = t_full_ms <= take(markets.BUDGET_MS, product_idx)
    delivered_unit = pue_lib.ffr_meter_gain(
        mu, rho_it, t_amb, pue_design=pue_design) * rho_it
    committed_unit = rho * pue_design
    delivered_frac = torch.where(
        committed_unit > 0.0, delivered_unit / committed_unit, 1.0)
    delivered_ok = delivered_frac >= 1.0 - DELIVERY_TOL
    return dict(rho_it=rho_it, t_full_ms=t_full_ms, budget_ok=budget_ok,
                delivered_unit=delivered_unit, delivered_frac=delivered_frac,
                delivered_ok=delivered_ok)


def revenue_score(mu, rho, t_amb, product_idx, *, pue_aware: bool,
                  pue_design=pue_lib.PUE_DESIGN,
                  events_per_day=EVENTS_PER_DAY_DEFAULT):
    """Expected settlement net revenue of a committed band, in units of
    the product's full-band capacity rate, clipped to [-1, 1]."""
    rho = tensor(rho, device_of(mu, rho, t_amb))
    v = event_verdict(mu, t_amb, rho, product_idx, pue_design,
                      pue_aware=pue_aware)
    shortfall = torch.clamp(1.0 - v["delivered_frac"], 0.0, 1.0)
    hard_miss = 1.0 - v["budget_ok"].to(rho.dtype)
    ev_per_h = tensor(events_per_day, rho.device,
                      v["rho_it"].dtype) / 24.0
    at_risk = ev_per_h * PENALTY_WINDOW_H * (shortfall + hard_miss)
    net = (rho / RHO_MAX) * (1.0 - at_risk)
    return torch.clamp(net, -1.0, 1.0)


def throughput_score(mu, rho, clock_w, product_idx, *,
                     events_per_day=EVENTS_PER_DAY_DEFAULT,
                     ckpt_cost_s=0.0):
    """Expected training-throughput retention of (mu, rho) in [0, 1]."""
    dev = device_of(mu, rho, clock_w, product_idx)
    mu, rho = tensor(mu, dev), tensor(rho, dev)
    g_run = workload_lib.throughput_frac(clock_w, mu)
    resid = torch.clamp(mu - rho, min=MIN_RESIDUAL_LOAD)
    g_shed = workload_lib.throughput_frac(clock_w, resid)
    dt = torch.promote_types(mu.dtype, rho.dtype)
    ev_per_h = tensor(events_per_day, dev, dt) / 24.0
    dur_s = take(markets.MIN_DURATION_S, product_idx)
    has_band = (rho > 0.0).to(rho.dtype)
    shed_frac = torch.clamp(ev_per_h * dur_s / 3600.0, 0.0, 1.0) * has_band
    dead_frac = torch.clamp(
        ev_per_h * tensor(ckpt_cost_s, dev, dt) / 3600.0, 0.0,
        1.0) * has_band
    dead_frac = torch.minimum(dead_frac, 1.0 - shed_frac)
    tokens = (1.0 - shed_frac - dead_frac) * g_run + shed_frac * g_shed
    g_max = workload_lib.throughput_frac(clock_w, float(MU_GRID[-1]))
    return tokens / torch.clamp(tensor(g_max, dev), min=1e-6)


def grid_candidates(rho_fixed=0.0, *, fix_rho: bool = False, device=None):
    """The candidate mesh (MU, RHO), each (6, R).  With ``fix_rho`` the
    band is ``rho_fixed``: a tensor of shape S gives RHO of shape
    S + (6, 1), one fixed band per scenario."""
    mus = const(MU_GRID, device)
    if fix_rho:
        rho = tensor(rho_fixed, device)
        MU = mus[:, None]
        return MU, rho[..., None, None].expand(rho.shape + (len(mus), 1))
    rhos = const(RHO_GRID, device)
    return torch.meshgrid(mus, rhos, indexing="ij")


def point_objective(mu, rho, greenness, t_amb, weights, product_idx,
                    events_per_day, clock_w, ckpt_cost_s, *,
                    pue_aware: bool, use_revenue: bool, use_workload: bool,
                    pue_design=pue_lib.PUE_DESIGN, price_rel=None):
    """J(mu, rho) at arbitrary (broadcastable) points, in the term order
    the grid search uses.  ``price_rel`` (the bidder's capacity-price
    realisation relative to nominal) scales the revenue term; None omits
    the multiply, as in the grid search."""
    q = q_ffr(mu, rho, t_amb, pue_aware=pue_aware, pue_design=pue_design)
    J = weights[0] * q + weights[1] * cfe_score(mu, greenness)
    if use_revenue:
        rev = revenue_score(
            mu, rho, t_amb, product_idx, pue_aware=pue_aware,
            pue_design=pue_design, events_per_day=events_per_day)
        if price_rel is not None:
            rev = price_rel * rev
        J = J + weights[2] * rev
    if use_workload:
        J = J + weights[3] * throughput_score(
            mu, rho, clock_w, product_idx,
            events_per_day=events_per_day, ckpt_cost_s=ckpt_cost_s)
    return J


def _pad_weights(weights) -> list:
    """(w_ffr, w_cfe[, w_rev[, w_tok]]) -> four float32 weights."""
    w = [float(np.float32(x)) for x in np.asarray(weights).reshape(-1)]
    if len(w) > 4:
        raise ValueError(f"expected at most 4 selection weights, "
                         f"got {len(w)}")
    return w + [0.0] * (4 - len(w))


def select_operating_points(greenness, t_amb, *, pue_aware: bool,
                            pue_design=pue_lib.PUE_DESIGN,
                            weights=(W_FFR, W_CFE, 0.0),
                            product_idx=0,
                            events_per_day=EVENTS_PER_DAY_DEFAULT,
                            rho_fixed=0.0,
                            clock_w=None,
                            ckpt_cost_s=workload_lib.DEFAULT_GRID_CKPT_S,
                            use_revenue: bool = False,
                            fix_rho: bool = False,
                            use_workload: bool = False) -> OperatingPoint:
    """Hourly grid search: greenness/t_amb (..., B) -> (..., B) (mu, rho).

    The leading shape S = greenness.shape[:-1] is the scenario batch; every
    knob (pue_design, product_idx, rho_fixed, clock_w, events_per_day,
    ckpt_cost_s) is a number or a tensor of shape S.
    """
    g = tensor(greenness)
    dev = g.device
    ta = tensor(t_amb, dev).expand(g.shape)
    lead = g.shape[:-1]
    if clock_w is None:
        clock_w = workload_lib.clock_weight("train")

    def knob(x, dtype=torch.float32):
        x = (x.to(dev, dtype) if isinstance(x, torch.Tensor)
             else torch.full((), x, dtype=dtype, device=dev)).expand(lead)
        return x[..., None, None, None]             # against (B, 6, R)

    MU, RHO = grid_candidates(knob(rho_fixed)[..., 0, 0], fix_rho=fix_rho,
                              device=dev)
    J = point_objective(
        MU, RHO, g[..., None, None], ta[..., None, None],
        _pad_weights(weights), knob(product_idx, torch.int64),
        knob(events_per_day), knob(clock_w), knob(ckpt_cost_s),
        pue_aware=pue_aware, use_revenue=use_revenue,
        use_workload=use_workload, pue_design=knob(pue_design))
    J = J.expand(g.shape + MU.shape[-2:])
    idx = torch.argmax(J.reshape(g.shape + (-1,)), dim=-1)
    mu = MU.expand(RHO.shape[-2:]).reshape(-1)[idx]
    if fix_rho:
        rho = knob(rho_fixed)[..., 0, 0].expand(g.shape)
    else:
        rho = RHO.reshape(-1)[idx]
    return OperatingPoint(mu=mu, rho=rho.contiguous())


def greenness_from_ci(ci, mask=None):
    """Normalised inverse CI over the (masked) forecast window, along the
    last axis."""
    ci = tensor(ci)
    if mask is None:
        lo = ci.amin(-1, keepdim=True)
        hi = ci.amax(-1, keepdim=True)
    else:
        m = tensor(mask, ci.device) > 0
        lo = torch.where(m, ci, torch.inf).amin(-1, keepdim=True)
        hi = torch.where(m, ci, -torch.inf).amax(-1, keepdim=True)
    return torch.clamp(1.0 - (ci - lo) / torch.clamp(hi - lo, min=1e-6),
                       0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Tier3Selector:
    """Hourly operating-point selection over a 24 h look-ahead window.

    ``w_rev > 0`` turns on the settlement-revenue feedback for the FR
    product named by ``product``.  Forecasts given as numbers or arrays
    go to ``device`` (default CUDA, which raises without a card); a
    tensor keeps the device it lies on.
    """

    pue_aware: bool = True
    pue_design: float = pue_lib.PUE_DESIGN
    w_ffr: float = W_FFR
    w_cfe: float = W_CFE
    w_rev: float = 0.0
    product: str = "FFR"
    events_per_day: float = EVENTS_PER_DAY_DEFAULT
    w_tok: float = 0.0
    workload_mix: str = "train"
    ckpt_cost_s: float = workload_lib.DEFAULT_GRID_CKPT_S
    device: str | torch.device | None = "cuda"

    def _on_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return tensor(x)
        return tensor(x, resolve_device(self.device))

    def objective(self, mu, rho, greenness, t_amb) -> torch.Tensor:
        """J(mu, rho) at broadcastable points, the terms the weights
        switch on."""
        return point_objective(
            mu, rho, greenness, t_amb,
            _pad_weights((self.w_ffr, self.w_cfe, self.w_rev, self.w_tok)),
            markets.PRODUCT_ORDER.index(self.product), self.events_per_day,
            workload_lib.clock_weight(self.workload_mix), self.ckpt_cost_s,
            pue_aware=self.pue_aware, use_revenue=bool(self.w_rev),
            use_workload=bool(self.w_tok), pue_design=self.pue_design)

    def select_hour(self, greenness, t_amb) -> OperatingPoint:
        """Grid search; greenness/t_amb are scalars or batched.  Size-1
        axes are squeezed, as the reference does."""
        op = select_operating_points(
            torch.atleast_1d(self._on_device(greenness)),
            torch.atleast_1d(self._on_device(t_amb)),
            pue_aware=self.pue_aware, pue_design=self.pue_design,
            weights=(self.w_ffr, self.w_cfe, self.w_rev, self.w_tok),
            product_idx=markets.PRODUCT_ORDER.index(self.product),
            events_per_day=self.events_per_day,
            clock_w=workload_lib.clock_weight(self.workload_mix),
            ckpt_cost_s=self.ckpt_cost_s,
            use_revenue=bool(self.w_rev), use_workload=bool(self.w_tok))
        return OperatingPoint(mu=op.mu.squeeze(), rho=op.rho.squeeze())

    def select_day(self, ci_24h, t_amb_24h) -> OperatingPoint:
        """Vectorised selection for a 24-entry forecast window."""
        return self.select_hour(greenness_from_ci(self._on_device(ci_24h)),
                                self._on_device(t_amb_24h))


def cap_table(n_chips_per_host: int, host_design_w: float,
              cap_min: float, cap_max: float) -> np.ndarray:
    """(mu x rho) -> per-chip cap after a full FFR activation (numpy)."""
    mu = MU_GRID[:, None]
    rho = RHO_GRID[None, :]
    residual = np.maximum(mu - rho, MIN_RESIDUAL_LOAD)
    per_chip = residual * host_design_w / n_chips_per_host
    return np.clip(per_chip, cap_min, cap_max).astype(np.float32)
