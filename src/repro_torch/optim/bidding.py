"""Differentiable Tier-3 bidding on ``torch.autograd``: the port of
``repro.optim.bidding``.

The grid search in ``tier3`` scans 24 candidate cells per hour against
the NOMINAL forecast.  This module optimises the same settlement
objective continuously, in expectation over an ensemble of price / CI /
temperature / activation-rate realisations per hour:

    max_{mu, rho, bid}  E_ens[ w0*Q_FFR(mu, rho) + w1*CFE(mu)
                               + w2 * price_rel * R(mu, bid)
                               [+ w3 * G(mu, rho)] ]

``rho`` is the armed Tier-1 band (what the plant sheds, what Q_FFR and
the throughput term price) and ``bid`` <= rho is the capacity sold and
settled: shading the bid below the armed band hedges delivery risk.

* **Feasibility by construction.**  The decision variables live in an
  unconstrained z-space; the decode (a sigmoid box for mu, a softmin cap
  for rho, a sigmoid share for bid) only expresses strictly feasible
  points.
* **Gradient + CEM hybrid.**  One ``torch.autograd.grad`` of the sum over
  hours of each hour's smooth surrogate gives every hour's gradient in
  one backward pass (hours are independent), which drives an Adam ascent
  step; a CEM proposal cloud evaluated under the HARD objective (the
  exact ``tier3`` terms, cliffs included) pulls the iterate across the
  verdict cliffs gradients cannot see.  The running best under the hard
  objective is seeded with the grid search's own argmax, so the result
  is never worse than the grid search on the same ensemble.
* **Batched over hours, no host sync in the loop.**  Every hour is a
  row of (B, ...) tensors; the per-iteration incumbents are stacked on
  the device and copied to the host once, after the last step.
* **Bit-parity escape hatch.**  With ``n_ens=1`` (the nominal member
  only) and ``n_iter=0`` the optimiser is the hard-objective argmax over
  ``tier3.grid_candidates()`` and returns ``select_operating_points``'s
  cell bit for bit.

Randomness is counter-based (``repro_torch.random``): the ensemble is
keyed by (seed, hour, member), the CEM proposals by (seed, hour,
iteration).  ``optimize_bids`` takes both as overrides (``ensemble=``,
``proposals=``), which is how parity tests replay the reference's draws.

The clips of the z-space use ``torch.maximum``/``torch.minimum``, whose
gradient splits evenly at a tie as ``jnp.clip``'s does: a grid cell
encodes onto the box edge ``+-Z_CLIP``, so the first step's gradient
sits exactly on such a tie.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

import repro_torch.core.pue as pue_lib
import repro_torch.core.tier3 as tier3
import repro_torch.grid.markets as markets
import repro_torch.random as rnd
import repro_torch.workload.model as workload_lib
from repro_torch import resolve_device
from repro_torch._num import take, tensor
from repro_torch.obs import trace

MU_LO = float(tier3.MU_GRID[0])
MU_HI = float(tier3.MU_GRID[-1])
RHO_MAX = tier3.RHO_MAX
Z_CLIP = 6.0          # logit-space box: keeps encode/decode invertible
_TAU_CAP = 0.01       # softmin temperature of the rho feasibility cap


@dataclasses.dataclass(frozen=True)
class BidConfig:
    """Static knobs of the bidding optimiser."""

    n_ens: int = 8            # ensemble members (member 0 is the nominal)
    n_iter: int = 48          # optimisation steps
    # Adam ascent on the smooth surrogate
    lr: float = 0.08
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    # CEM proposal cloud evaluated under the hard objective
    cem_pop: int = 16
    cem_elite: int = 4
    cem_weight: float = 0.5   # blend of elite mean into the iterate
    sigma0: float = 0.8       # initial z-space proposal spread
    sigma_decay: float = 0.95
    sigma_min: float = 0.05
    # smooth-surrogate temperatures
    tau_feas: float = 0.02    # residual-load feasibility gate (load frac)
    tau_ms: float = 60.0      # delivery-budget verdict (ms)
    # forecast-uncertainty spreads (member 0 is always exact nominal)
    sigma_green: float = 0.08     # additive greenness noise (clipped [0,1])
    sigma_t_amb: float = 1.5      # additive ambient noise (degC)
    sigma_price: float = 0.25     # lognormal capacity-price factor
    sigma_events: float = 0.5     # lognormal events-per-day factor

    def __post_init__(self):
        if self.n_ens < 1:
            raise ValueError(f"n_ens must be >= 1, got {self.n_ens}")
        if self.cem_elite > self.cem_pop + 1:
            raise ValueError(
                f"cem_elite ({self.cem_elite}) cannot exceed cem_pop + 1 "
                f"({self.cem_pop + 1})")


class BidEnsemble(NamedTuple):
    """Per-hour forecast realisations, all (B, E).  Member 0 carries the
    nominal forecast bit-exactly (zero perturbation), so ``n_ens=1``
    degenerates to the grid search's deterministic objective."""

    green: torch.Tensor       # greenness realisations, clipped to [0, 1]
    t_amb: torch.Tensor       # ambient degC realisations
    price_rel: torch.Tensor   # capacity-price factor (median-1 lognormal)
    epd: torch.Tensor         # events-per-day realisations


class BidState(NamedTuple):
    """Optimiser carry: one lane per hour."""

    z: torch.Tensor         # (B, 3) unconstrained decision variables
    m: torch.Tensor         # (B, 3) Adam first moment
    v: torch.Tensor         # (B, 3) Adam second moment
    key: torch.Tensor       # (B,) int64 per-hour CEM proposal keys
    sigma: torch.Tensor     # (B,)   z-space proposal spread
    it: torch.Tensor        # ()     int32 step counter (Adam bias correction)
    best_mu: torch.Tensor   # (B,)   incumbent under the hard objective
    best_rho: torch.Tensor  # (B,)
    best_bid: torch.Tensor  # (B,)
    best_j: torch.Tensor    # (B,)


class BidResult(NamedTuple):
    mu: torch.Tensor          # (B,) armed operating fraction
    rho: torch.Tensor         # (B,) armed Tier-1 band
    bid: torch.Tensor         # (B,) committed capacity bid (<= rho)
    j: torch.Tensor           # (B,) final hard ensemble objective
    j_grid: torch.Tensor      # (B,) grid-search argmax objective (the init)
    history: np.ndarray       # (n_iter, B) best_j after every step


# ---------------------------------------------------------------------------
# Feasible decode / encode
# ---------------------------------------------------------------------------


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` with its gradient: half on each side of a tie."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def softmin(a, b, tau: float = _TAU_CAP) -> torch.Tensor:
    """Smooth minimum, strictly below min(a, b): a differentiable rho cap
    that keeps ``mu - rho > MIN_RESIDUAL_LOAD`` with strict inequality."""
    return -tau * torch.logaddexp(-a / tau, -b / tau)


def decode(z) -> tuple:
    """z (..., 3) -> strictly feasible (mu, rho, bid), each (...).

    mu in (MU_LO, MU_HI); rho under both the cap-table box RHO_MAX and
    the residual-load floor via the softmin cap; bid in (0, rho)."""
    z0, z1, z2 = _clip(tensor(z), -Z_CLIP, Z_CLIP).unbind(-1)
    mu = MU_LO + (MU_HI - MU_LO) * torch.sigmoid(z0)
    cap = softmin(torch.full_like(mu, RHO_MAX),
                  mu - tier3.MIN_RESIDUAL_LOAD)
    rho = cap * torch.sigmoid(z1)
    bid = rho * torch.sigmoid(z2)
    return mu, rho, bid


def _logit(p) -> torch.Tensor:
    p = _clip(p, 1e-6, 1.0 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


def encode(mu, rho, bid) -> torch.Tensor:
    """Best-effort inverse of :func:`decode` (grid cells sit on the box
    boundary, so the z is clipped; the incumbent tracking keeps the exact
    grid point regardless).  Returns (..., 3)."""
    mu = tensor(mu)
    rho, bid = tensor(rho, mu.device), tensor(bid, mu.device)
    z0 = _logit((mu - MU_LO) / (MU_HI - MU_LO))
    cap = softmin(torch.full_like(mu, RHO_MAX),
                  mu - tier3.MIN_RESIDUAL_LOAD)
    z1 = _logit(rho / torch.clamp(cap, min=1e-6))
    z2 = _logit(torch.where(rho > 0, bid / torch.clamp(rho, min=1e-6),
                            0.5))
    return _clip(torch.stack([z0, z1, z2], dim=-1), -Z_CLIP, Z_CLIP)


# ---------------------------------------------------------------------------
# Hard and smooth settlement objectives
# ---------------------------------------------------------------------------


def hard_objective(mu, rho, bid, green, t_amb, price_rel, epd, weights,
                   product_idx, clock_w, ckpt_cost_s, *, pue_aware: bool,
                   use_revenue: bool, use_workload: bool,
                   pue_design=pue_lib.PUE_DESIGN) -> torch.Tensor:
    """The exact selection objective at a (mu, rho, bid) split point.

    Op for op the sequence of ``tier3.point_objective``: with
    ``bid == rho`` and ``price_rel == 1`` the values are bit-identical to
    the grid search's J, which makes the grid-seeded incumbent a true
    lower bound.
    """
    q = tier3.q_ffr(mu, rho, t_amb, pue_aware=pue_aware,
                    pue_design=pue_design)
    J = weights[0] * q + weights[1] * tier3.cfe_score(mu, green)
    if use_revenue:
        rev = tier3.revenue_score(
            mu, bid, t_amb, product_idx, pue_aware=pue_aware,
            pue_design=pue_design, events_per_day=epd)
        J = J + weights[2] * (price_rel * rev)
    if use_workload:
        J = J + weights[3] * tier3.throughput_score(
            mu, rho, clock_w, product_idx, events_per_day=epd,
            ckpt_cost_s=ckpt_cost_s)
    return J


def soft_q_ffr(mu, rho, t_amb, *, pue_aware: bool,
               pue_design=pue_lib.PUE_DESIGN,
               tau_feas: float = 0.02) -> torch.Tensor:
    """Differentiable surrogate of ``tier3.q_ffr``: the hard feasibility
    ``where`` becomes a sigmoid gate and the band-size root is guarded
    (its slope is infinite at rho = 0), so the gradient is finite and
    nonzero on BOTH sides of the MIN_RESIDUAL_LOAD boundary."""
    mu = tensor(mu)
    rho = tensor(rho, mu.device)
    gate = torch.sigmoid((mu - rho - tier3.MIN_RESIDUAL_LOAD) / tau_feas)
    committed_meter = rho * pue_design
    if pue_aware:
        gain = pue_lib.ffr_meter_gain(mu, rho, t_amb, pue_design=pue_design)
        rho_it = rho * pue_design / torch.clamp(gain, min=1e-3)
        rho_it = torch.minimum(rho_it, mu - tier3.MIN_RESIDUAL_LOAD)
        delivered = pue_lib.ffr_meter_gain(
            mu, rho_it, t_amb, pue_design=pue_design) * rho_it
    else:
        delivered = pue_lib.ffr_meter_gain(
            mu, rho, t_amb, pue_design=pue_design) * rho
    accuracy = torch.clamp(
        delivered / torch.clamp(committed_meter, min=1e-6), 0.0, 1.0)
    q = torch.pow(torch.clamp(rho, min=1e-4) / RHO_MAX, 0.25) * accuracy
    return q * gate


def soft_revenue_score(mu, bid, t_amb, product_idx, *, pue_aware: bool,
                       pue_design=pue_lib.PUE_DESIGN,
                       events_per_day=tier3.EVENTS_PER_DAY_DEFAULT,
                       tau_ms: float = 60.0) -> torch.Tensor:
    """``tier3.revenue_score`` with the step delivery-budget verdict
    replaced by a sigmoid in the governor delivery time, so the clawback
    cliff has a usable gradient."""
    mu = tensor(mu)
    bid = tensor(bid, mu.device)
    v = tier3.event_verdict(mu, t_amb, bid, product_idx, pue_design,
                            pue_aware=pue_aware)
    shortfall = torch.clamp(1.0 - v["delivered_frac"], 0.0, 1.0)
    budget = take(markets.BUDGET_MS, product_idx)
    soft_ok = torch.sigmoid((budget - v["t_full_ms"]) / tau_ms)
    hard_miss = 1.0 - soft_ok
    ev_per_h = tensor(events_per_day, mu.device,
                      v["rho_it"].dtype) / 24.0
    at_risk = ev_per_h * tier3.PENALTY_WINDOW_H * (shortfall + hard_miss)
    net = (bid / RHO_MAX) * (1.0 - at_risk)
    return torch.clamp(net, -1.0, 1.0)


def soft_objective(mu, rho, bid, green, t_amb, price_rel, epd, weights,
                   product_idx, clock_w, ckpt_cost_s, *, pue_aware: bool,
                   use_revenue: bool, use_workload: bool,
                   pue_design=pue_lib.PUE_DESIGN, tau_feas: float = 0.02,
                   tau_ms: float = 60.0) -> torch.Tensor:
    """Smooth surrogate of :func:`hard_objective` (what Adam ascends)."""
    q = soft_q_ffr(mu, rho, t_amb, pue_aware=pue_aware,
                   pue_design=pue_design, tau_feas=tau_feas)
    J = weights[0] * q + weights[1] * tier3.cfe_score(mu, green)
    if use_revenue:
        rev = soft_revenue_score(
            mu, bid, t_amb, product_idx, pue_aware=pue_aware,
            pue_design=pue_design, events_per_day=epd, tau_ms=tau_ms)
        J = J + weights[2] * (price_rel * rev)
    if use_workload:
        J = J + weights[3] * tier3.throughput_score(
            mu, rho, clock_w, product_idx, events_per_day=epd,
            ckpt_cost_s=ckpt_cost_s)
    return J


def _weights(weights):
    """Selection weights as given (a tensor) or as Python floats at the
    precision given: float64 weights keep their digits."""
    if isinstance(weights, torch.Tensor):
        return weights
    return [float(x) for x in np.asarray(weights).reshape(-1)]


def ensemble_objective(mu, rho, bid, ens: BidEnsemble, weights,
                       product_idx, clock_w, ckpt_cost_s, *,
                       pue_aware: bool, use_revenue: bool = True,
                       use_workload: bool = False,
                       pue_design=pue_lib.PUE_DESIGN, smooth: bool = False,
                       tau_feas: float = 0.02,
                       tau_ms: float = 60.0) -> torch.Tensor:
    """Mean settlement objective over the ensemble axis (the last axis of
    ``ens``'s leaves; ``mu``, ``rho``, ``bid`` and the knobs broadcast
    against them).  ``smooth=True`` is the gradient surrogate;
    ``smooth=False`` is the exact tier3 terms (what CEM and the incumbent
    use).  This is the objective the gradcheck differentiates."""
    fn = soft_objective if smooth else hard_objective
    kw = dict(pue_aware=pue_aware, use_revenue=use_revenue,
              use_workload=use_workload, pue_design=pue_design)
    if smooth:
        kw.update(tau_feas=tau_feas, tau_ms=tau_ms)
    J = fn(mu, rho, bid, ens.green, ens.t_amb, ens.price_rel, ens.epd,
           _weights(weights), product_idx, clock_w, ckpt_cost_s, **kw)
    return J.mean(-1)


# ---------------------------------------------------------------------------
# Counter-based draws: the forecast ensemble and the CEM proposals
# ---------------------------------------------------------------------------


def _synth_ensemble(seed: int, green, t_amb, epd,
                    bcfg: BidConfig) -> BidEnsemble:
    """(B,) nominal forecasts -> (B, E) realisations, keyed by (seed,
    hour, member).  The ensemble is drawn ONCE and held fixed across
    iterations (common random numbers), which makes the incumbent
    monotone."""
    E = bcfg.n_ens
    dev, dt = green.device, green.dtype
    hours = torch.arange(green.shape[0], dtype=torch.int64, device=dev)
    live = (torch.arange(E, device=dev) > 0).to(dt)      # member 0: nominal
    eps = rnd.normal(seed, rnd.BID_ENSEMBLE, hours[:, None, None],
                     rnd.lanes((4, E), dev), dt) * live
    g, ta, e = green[:, None], t_amb[:, None], epd[:, None]
    return BidEnsemble(
        green=torch.clamp(g + bcfg.sigma_green * eps[:, 0], 0.0, 1.0),
        t_amb=ta + bcfg.sigma_t_amb * eps[:, 1],
        price_rel=torch.exp(bcfg.sigma_price * eps[:, 2]),
        epd=e * torch.exp(bcfg.sigma_events * eps[:, 3]))


def _proposal_keys(seed: int, n: int, device) -> torch.Tensor:
    """(B,) per-hour keys of the CEM stream, from (seed, hour)."""
    hours = torch.arange(n, dtype=torch.int64, device=device)
    return rnd.bits(seed, rnd.BID_PROPOSAL, 0, hours)


def _proposals(key: torch.Tensor, it: int, pop: int,
               dtype) -> torch.Tensor:
    """(B, pop, 3) z-space proposal normals of iteration ``it``, keyed by
    (seed, hour, iteration)."""
    return rnd.normal(key[:, None, None], rnd.BID_PROPOSAL, it,
                      rnd.lanes((pop, 3), key.device), dtype)


# ---------------------------------------------------------------------------
# Grid-seeded init + the opt step
# ---------------------------------------------------------------------------


class _Knobs(NamedTuple):
    """Per-hour knobs, all (B,), and the flags of the objective."""

    weights: list
    pue_design: torch.Tensor
    product_idx: torch.Tensor
    clock_w: torch.Tensor
    ckpt_cost_s: object
    pue_aware: bool
    use_revenue: bool
    use_workload: bool

    def objective(self, mu, rho, bid, ens: BidEnsemble, lead: int,
                  **kw) -> torch.Tensor:
        """The ensemble objective of points (B, *P) against the (B, E)
        ensemble, ``lead`` = len(P) axes between the hour and member
        axes."""
        def row(x):
            return x[(slice(None),) + (None,) * (lead + 1)]

        def pts(x):
            return x[..., None]

        e = BidEnsemble(*(x[(slice(None),) + (None,) * lead] for x in ens))
        return ensemble_objective(
            pts(mu), pts(rho), pts(bid), e, self.weights,
            row(self.product_idx), row(self.clock_w), self.ckpt_cost_s,
            pue_aware=self.pue_aware, use_revenue=self.use_revenue,
            use_workload=self.use_workload,
            pue_design=row(self.pue_design), **kw)


def _init_state(seed: int, ens: BidEnsemble, kn: _Knobs,
                bcfg: BidConfig) -> BidState:
    """Seed every hour at the hard-objective argmax over the grid search's
    own candidate mesh, in the same flatten/argmax order as
    ``tier3.select_operating_points``: with ``n_ens=1`` the seed IS the
    grid search's cell bit for bit."""
    dev, dt = ens.green.device, ens.green.dtype
    B = ens.green.shape[0]
    MU, RHO = tier3.grid_candidates(device=dev)                 # (6, R)
    J = kn.objective(MU, RHO, RHO, ens, lead=2)                 # (B, 6, R)
    flat = J.reshape(B, -1)
    idx = torch.argmax(flat, dim=-1)
    mu0 = MU.reshape(-1)[idx].to(dt)
    rho0 = RHO.reshape(-1)[idx].to(dt)
    zeros = torch.zeros((B, 3), dtype=dt, device=dev)
    return BidState(
        z=encode(mu0, rho0, rho0), m=zeros, v=zeros.clone(),
        key=_proposal_keys(seed, B, dev),
        sigma=torch.full((B,), bcfg.sigma0, dtype=dt, device=dev),
        it=torch.zeros((), dtype=torch.int32, device=dev),
        best_mu=mu0, best_rho=rho0, best_bid=rho0.clone(),
        best_j=flat.gather(-1, idx[:, None])[:, 0])


def _step(state: BidState, ens: BidEnsemble, eps: torch.Tensor,
          kn: _Knobs, bcfg: BidConfig) -> BidState:
    """ONE optimisation step for every hour: Adam on the smooth surrogate,
    a CEM cloud of the (B, cem_pop, 3) proposal normals ``eps`` under the
    hard objective, incumbent update.  Reads no value on the host."""
    t = (state.it + 1).to(state.z.dtype)
    # Adam ascent on the smooth surrogate: hours are independent, so the
    # gradient of the sum is every hour's own gradient
    with torch.enable_grad():
        z = state.z.detach().requires_grad_(True)
        mu, rho, bid = decode(z)
        soft = kn.objective(mu, rho, bid, ens, lead=0, smooth=True,
                            tau_feas=bcfg.tau_feas, tau_ms=bcfg.tau_ms)
        (g,) = torch.autograd.grad(soft.sum(), z)
    m2 = bcfg.beta1 * state.m + (1.0 - bcfg.beta1) * g
    v2 = bcfg.beta2 * state.v + (1.0 - bcfg.beta2) * g * g
    mh = m2 / (1.0 - bcfg.beta1 ** t)
    vh = v2 / (1.0 - bcfg.beta2 ** t)
    z_g = state.z + bcfg.lr * mh / (torch.sqrt(vh) + bcfg.eps)
    with torch.no_grad():
        # CEM cloud under the hard objective (gradient point included)
        zs = torch.cat([z_g[:, None],
                        z_g[:, None] + state.sigma[:, None, None] * eps],
                       dim=1)                                # (B, P+1, 3)
        mu_s, rho_s, bid_s = decode(zs)
        js = kn.objective(mu_s, rho_s, bid_s, ens, lead=1)   # (B, P+1)
        top_i = torch.topk(js, bcfg.cem_elite, dim=1).indices
        z_el = torch.gather(zs, 1, top_i[..., None].expand(-1, -1, 3)
                            ).mean(1)
        z2 = (1.0 - bcfg.cem_weight) * z_g + bcfg.cem_weight * z_el
        sigma2 = torch.clamp(state.sigma * bcfg.sigma_decay,
                             min=bcfg.sigma_min)
        # incumbent: running argmax under the hard objective
        bi = torch.argmax(js, dim=1)[:, None]
        jb = js.gather(1, bi)[:, 0]
        better = jb > state.best_j

        def pick(x, best):
            return torch.where(better, x.gather(1, bi)[:, 0], best)

        return BidState(
            z=z2, m=m2, v=v2, key=state.key, sigma=sigma2,
            it=state.it + 1,
            best_mu=pick(mu_s, state.best_mu),
            best_rho=pick(rho_s, state.best_rho),
            best_bid=pick(bid_s, state.best_bid),
            best_j=torch.where(better, jb, state.best_j))


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _check_shape(x: torch.Tensor, want: tuple, what: str) -> None:
    if tuple(x.shape) != want:
        raise ValueError(f"{what} must have shape {want}, "
                         f"got {tuple(x.shape)}")


def optimize_bids(greenness, t_amb, *, key: int = 0,
                  weights=(tier3.W_FFR, tier3.W_CFE, tier3.W_REV_DEFAULT),
                  product_idx=0,
                  events_per_day=tier3.EVENTS_PER_DAY_DEFAULT,
                  pue_design=pue_lib.PUE_DESIGN, clock_w=None,
                  ckpt_cost_s=workload_lib.DEFAULT_GRID_CKPT_S,
                  pue_aware: bool = True, use_revenue: bool = True,
                  use_workload: bool = False,
                  config: BidConfig = BidConfig(), ensemble=None,
                  proposals=None, device="cuda") -> BidResult:
    """Optimise hourly (mu, rho, bid) trajectories for a forecast window.

    ``greenness``/``t_amb`` are (B,) nominal hourly forecasts (scalars
    broadcast); ``weights`` follows the ``select_operating_points``
    convention including its 3 -> 4 padding.  ``key`` (an int) seeds the
    forecast ensemble and the CEM proposals (``scenarios.bidding_seeds``
    supplies per-scenario ints).  ``ensemble`` (a :class:`BidEnsemble` of
    (B, n_ens) tensors) and ``proposals`` ((n_iter, B, cem_pop, 3)
    standard normals) override those draws.  Everything runs on
    ``device``; the dtype follows ``greenness`` (float64 stays float64).

    Returns the incumbent under the hard ensemble objective per hour,
    the grid-search seed value ``j_grid`` (so ``j >= j_grid`` always),
    and the per-iteration incumbent ``history`` (monotone by
    construction).
    """
    dev = resolve_device(device)
    g = tensor(greenness, dev).reshape(-1)
    B = int(g.shape[0])

    def bc(x, dtype=g.dtype):
        x = (x.to(dev, dtype) if isinstance(x, torch.Tensor)
             else torch.as_tensor(np.asarray(x), dtype=dtype, device=dev))
        return x.reshape(-1).expand(B)

    if clock_w is None:
        clock_w = workload_lib.clock_weight("train")
    kn = _Knobs(weights=tier3._pad_weights(weights),
                pue_design=bc(pue_design),
                product_idx=bc(product_idx, torch.int64),
                clock_w=bc(clock_w), ckpt_cost_s=ckpt_cost_s,
                pue_aware=pue_aware, use_revenue=use_revenue,
                use_workload=use_workload)
    cfg = config
    if ensemble is None:
        ens = _synth_ensemble(int(key), g, bc(t_amb), bc(events_per_day),
                              cfg)
    else:
        ens = BidEnsemble(*(tensor(x, dev).to(g.dtype) for x in ensemble))
        for name, x in zip(BidEnsemble._fields, ens):
            _check_shape(x, (B, cfg.n_ens), f"ensemble.{name}")
    if proposals is not None:
        proposals = tensor(proposals, dev).to(g.dtype)
        _check_shape(proposals, (cfg.n_iter, B, cfg.cem_pop, 3),
                     "proposals (n_iter, B, cem_pop, 3)")
    with trace.span("bidding.optimize", hours=B, n_ens=cfg.n_ens,
                    n_iter=cfg.n_iter):
        state = _init_state(int(key), ens, kn, cfg)
        j_grid = state.best_j
        hist = []
        for i in range(cfg.n_iter):
            with trace.span("bidding.opt_step", iteration=i):
                eps = (_proposals(state.key, i, cfg.cem_pop, g.dtype)
                       if proposals is None else proposals[i])
                state = _step(state, ens, eps, kn, cfg)
            hist.append(state.best_j)
        # the one copy to the host: every iteration's incumbents at once
        history = (torch.stack(hist).cpu().numpy() if hist
                   else np.zeros((0, B), np.float32))
    for row in history:
        trace.metrics.observe("bidding.objective", float(row.mean()))
    return BidResult(mu=state.best_mu, rho=state.best_rho,
                     bid=state.best_bid, j=state.best_j, j_grid=j_grid,
                     history=history)


def bids_for_batch(cfg, batch, *, key=None,
                   config: BidConfig = BidConfig(), device="cuda") -> tuple:
    """Optimise per-scenario hourly trajectories for a ScenarioBatch.

    Runs :func:`optimize_bids` once over the flattened (N * H_max,) hour
    axis, with per-scenario greenness from the engine's own normalisation
    and one batch seed mixed from every scenario's
    ``scenarios.bidding_seeds``.  Returns ``(mu_h, bid_h)`` shaped
    (N, H_max), ready for ``engine_rollout(cfg, batch, ops=...)``: the
    capacity sold is the shaded ``bid``, which is what the settlement
    commits and sheds.
    """
    from repro_torch.grid.scenarios import bidding_seeds

    dev = resolve_device(device)
    batch = batch.to(dev)
    n, h_max = batch.n, batch.h_max
    green = tier3.greenness_from_ci(batch.ci, batch.mask)
    if key is None:
        # one batch seed mixed from every scenario's counter-based seed;
        # the per-hour keys inside the optimiser decorrelate each
        # scenario-hour's draws
        seeds = bidding_seeds(batch).cpu().numpy().astype(np.uint64)
        mix = np.bitwise_xor.reduce(
            seeds * np.arange(1, n + 1, dtype=np.uint64))
        key = int(mix & 0x7FFFFFFF)
    w_rev = cfg.w_rev if cfg.price_aware else 0.0

    def per_hour(x):
        return x[:, None].expand(n, h_max).reshape(-1)

    res = optimize_bids(
        green.reshape(-1), batch.t_amb.reshape(-1), key=key,
        weights=(tier3.W_FFR, tier3.W_CFE, w_rev, cfg.workload_weight),
        product_idx=per_hour(batch.product_idx),
        events_per_day=cfg.events_per_day,
        pue_design=per_hour(batch.pue_design),
        clock_w=per_hour(take(workload_lib.CLOCK_W, batch.mix_idx)),
        ckpt_cost_s=cfg.ckpt_cost_s, pue_aware=cfg.pue_aware,
        use_revenue=(w_rev != 0.0),
        use_workload=(cfg.workload_weight != 0.0), config=config,
        device=dev)
    return res.mu.reshape(n, h_max), res.bid.reshape(n, h_max)
