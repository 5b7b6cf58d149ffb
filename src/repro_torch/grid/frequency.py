"""1 Hz grid-frequency synthesis (the E9 event stream): the port of
``repro.grid.frequency``.

Every function works on a leading scenario axis.  Draws come from the
counter-based generator of ``repro_torch.random``, keyed by each
scenario's frequency seed, so a scenario's trace does not depend on the
batch it sits in.  Each event ramps down from 50 Hz at ``rocof`` Hz/s,
bottoms at ``nadir`` and recovers linearly over ``recovery_s``; events
are painted in ascending-time order, later events winning on overlap.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

import repro_torch.random as rnd
from repro_torch import resolve_device
from repro_torch._num import take, tensor
from repro_torch.grid.markets import FR_PRODUCTS, NOMINAL_HZ, PRODUCT_ORDER

MAX_EVENTS = 64
DEFAULT_ROCOF_HZ_S = 0.2
DEFAULT_EVENTS_PER_DAY = 4.0
RECOVERY_RANGE_S = (60.0, 600.0)

_NADIR_LO = np.asarray([FR_PRODUCTS[n].full_delivery_hz - 0.1
                        for n in PRODUCT_ORDER], np.float32)
_NADIR_HI = np.asarray([FR_PRODUCTS[n].trigger_hz - 0.02
                        for n in PRODUCT_ORDER], np.float32)


class EventBatch(NamedTuple):
    """Padded per-scenario event set; all fields (..., E)-shaped."""

    t0_s: torch.Tensor        # int32 event start second
    nadir_hz: torch.Tensor    # float32
    recovery_s: torch.Tensor  # float32
    valid: torch.Tensor       # bool, first-n entries (ascending t0) are real


def _seeds(seeds, device) -> torch.Tensor:
    return torch.as_tensor(seeds, dtype=torch.int64, device=device) \
        & rnd.MASK32


def _poisson(u: torch.Tensor, lam: torch.Tensor, k_max: int):
    """min(Poisson(lam), k_max) by inversion of the CDF at uniform ``u``
    (float64, so exp(-lam) stays representable for any horizon)."""
    k = torch.arange(k_max + 1, dtype=torch.float64, device=u.device)
    lam = lam.to(torch.float64).unsqueeze(-1)
    logp = torch.xlogy(k, lam) - lam - torch.lgamma(k + 1.0)
    cdf = torch.cumsum(torch.exp(logp), dim=-1)
    n = (cdf < u.to(torch.float64).unsqueeze(-1)).sum(-1)
    return torch.clamp(n, max=k_max)


def sample_events(seeds, n_seconds: int, product_idx,
                  events_per_day=DEFAULT_EVENTS_PER_DAY,
                  max_events: int = MAX_EVENTS, *,
                  device="cuda") -> EventBatch:
    """Poisson under-frequency events over ``n_seconds`` of each scenario:
    (N,) seeds and product indices -> an EventBatch of (N, E) fields."""
    dev = resolve_device(device)
    seeds = _seeds(seeds, dev)
    n_sc = seeds.shape[0]
    pidx = torch.as_tensor(product_idx, device=dev).long().expand(n_sc)
    rate = tensor(events_per_day, dev).expand(n_sc)
    lam = rate * n_seconds / 86_400.0
    u_n = rnd.uniform(seeds, rnd.EVENT_COUNT, 0,
                      torch.zeros(n_sc, dtype=torch.int64, device=dev))
    n = _poisson(u_n, lam, max_events)
    slot = torch.arange(max_events, device=dev)
    lanes = slot.expand(n_sc, max_events)
    sd = seeds[:, None]
    t_raw = rnd.uniform(sd, rnd.EVENT_TIME, 0, lanes) * float(n_seconds)
    valid = slot[None, :] < n[:, None]
    order = torch.sort(torch.where(valid, t_raw, torch.inf), dim=-1,
                       stable=True).indices
    lo = take(_NADIR_LO, pidx)[:, None]
    hi = take(_NADIR_HI, pidx)[:, None]
    nadir = lo + (hi - lo) * rnd.uniform(sd, rnd.EVENT_NADIR, 0, lanes)
    r0, r1 = RECOVERY_RANGE_S
    rec = r0 + (r1 - r0) * rnd.uniform(sd, rnd.EVENT_RECOVERY, 0, lanes)
    return EventBatch(
        t0_s=torch.gather(t_raw, -1, order).to(torch.int32),
        nadir_hz=torch.gather(nadir, -1, order),
        recovery_s=torch.gather(rec, -1, order),
        valid=valid)


def baseline_wander(seeds, n_seconds: int, *, device="cuda"):
    """(N, T): nominal 50 Hz plus the normalised random-walk wander
    (std ~10 mHz) of each scenario."""
    dev = resolve_device(device)
    seeds = _seeds(seeds, dev)
    t = torch.arange(n_seconds, dtype=torch.int64, device=dev)
    g = rnd.normal(seeds[:, None], rnd.FREQ_WANDER, 0, t[None, :])
    scale = torch.sqrt(torch.arange(1, n_seconds + 1, dtype=torch.float32,
                                    device=dev))
    return NOMINAL_HZ + 0.01 * torch.cumsum(g, dim=-1) / scale


def apply_events(f_base, events: EventBatch,
                 rocof_hz_s: float = DEFAULT_ROCOF_HZ_S):
    """Paint the event ramps onto (..., T) baseline traces (overwrite
    semantics, in event order): the reference's scan over the event axis
    as a loop over it."""
    f = torch.as_tensor(f_base, dtype=torch.float32).clone()
    idx = torch.arange(f.shape[-1], dtype=torch.int32, device=f.device)
    for e in range(events.t0_s.shape[-1]):
        t0 = events.t0_s[..., e:e + 1]
        nadir = events.nadir_hz[..., e:e + 1]
        rec = events.recovery_s[..., e:e + 1]
        valid = events.valid[..., e:e + 1]
        fall_s = torch.clamp(torch.floor((NOMINAL_HZ - nadir) / rocof_hz_s),
                             min=1.0).to(torch.int32)
        k = idx - t0
        v_fall = NOMINAL_HZ - rocof_hz_s * k
        kr = k - fall_s
        v_rec = nadir + (NOMINAL_HZ - nadir) * kr / rec
        f = torch.where(valid & (k >= 0) & (k < fall_s), v_fall, f)
        in_rec = (kr >= 0) & (kr < torch.floor(rec).to(torch.int32))
        f = torch.where(valid & in_rec, v_rec, f)
    return f


def synthesize_frequency_batch(seeds, product_idx, *, n_seconds: int,
                               events_per_day=DEFAULT_EVENTS_PER_DAY,
                               max_events: int = MAX_EVENTS,
                               device="cuda"):
    """(N,) seeds + (N,) product indices -> ((N, T) traces, EventBatch):
    Poisson events painted onto each scenario's baseline wander (the
    reference's per-scenario ``frequency_trace``, batched)."""
    events = sample_events(seeds, n_seconds, product_idx, events_per_day,
                           max_events, device=device)
    base = baseline_wander(seeds, n_seconds, device=device)
    return apply_events(base, events), events
