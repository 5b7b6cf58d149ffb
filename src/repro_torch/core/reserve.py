"""Seconds-tier reserve-market replay and settlement (E9): the port of
``repro.core.reserve``.

Replay a 1 Hz grid-frequency trace against the plant's activation
physics, detect per-product threshold crossings, verify each event's
delivery (time to full delivery through the cap governor against the
product's activation budget, the sustain window, the meter-level band)
and settle the committed band at the facility meter.

The detection state machine (armed / holding / released) runs one step
per second for N scenarios at once (:func:`reserve_replay_batch`); the
per-event verdict buffers are gathered afterwards from the trigger
flags and the per-hour physics table.  The activation physics is
``tier3.event_verdict``, shared with the selector and the engine, which
runs :func:`detection_step` fused into its tick.
:func:`reserve_replay_reference` is the per-event Python loop over numpy
arrays that the replay is held against.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

import repro_torch.core.tier3 as tier3_lib
import repro_torch.grid.markets as markets
from repro_torch import resolve_device
from repro_torch._num import take, tensor
from repro_torch.core.tier3 import event_verdict  # noqa: F401 (re-export)

E_MAX = 64                  # per-scenario event-buffer slots
DELIVERY_TOL = tier3_lib.DELIVERY_TOL
PENALTY_WINDOW_H = tier3_lib.PENALTY_WINDOW_H


class ReserveEvents(NamedTuple):
    """Fixed-size per-event verdict buffers; all fields (..., E)."""

    t_event_s: torch.Tensor       # int32 activation second (-1 if empty)
    t_full_ms: torch.Tensor       # trigger-to-full-delivery time
    sustain_s: torch.Tensor       # achievable hold inside the horizon
    delivered_mw: torch.Tensor    # meter-level delivered band
    delivered_frac: torch.Tensor  # delivered / committed (meter MW)
    budget_ok: torch.Tensor       # bool t_full_ms <= activation budget
    sustain_ok: torch.Tensor      # bool full min_duration_s fits
    delivered_ok: torch.Tensor    # bool delivered_frac >= 1 - DELIVERY_TOL
    compliant: torch.Tensor       # bool all three
    valid: torch.Tensor           # bool slot holds a real event


def detection_init(n: int, device):
    """Initial (in_event, hold) carry of N detection state machines."""
    return (torch.zeros(n, dtype=torch.bool, device=device),
            torch.zeros(n, dtype=torch.int32, device=device))


def detection_step(carry, below, in_hor, min_dur_i):
    """One 1 Hz tick of the two-word detection state machine.

    Returns the new (in_event, hold) carry plus the per-second
    (triggered, shedding) flags.
    """
    in_ev, hold = carry
    trig = ~in_ev & below & in_hor
    in_ev = in_ev | trig
    hold = torch.where(trig, min_dur_i, hold)
    hold = torch.where(in_ev, torch.clamp(hold - 1, min=0), hold)
    released = in_ev & (hold == 0) & ~below
    shed = in_ev & in_hor
    return (in_ev & ~released, hold), trig, shed


def event_times(trig: torch.Tensor, e_max: int):
    """(..., T) trigger flags -> (t_event (..., e_max), valid).

    The k-th trigger second is the first index where the running trigger
    count reaches k+1 (overflow slots land at T)."""
    T = trig.shape[-1]
    counts = torch.cumsum(trig.to(torch.int32), dim=-1)
    want = torch.arange(1, e_max + 1, dtype=torch.int32,
                        device=trig.device).expand(trig.shape[:-1] + (e_max,))
    t_ev = torch.searchsorted(counts.contiguous(), want.contiguous())
    t_ev = t_ev.to(torch.int32)
    return t_ev, t_ev < T


def assemble_events(v: dict, t_ev, valid, min_dur_f, valid_s,
                    design_mw) -> ReserveEvents:
    """Fixed-size verdict buffers from per-event physics ``v`` (leaves
    shaped like ``t_ev``)."""
    sustain_s = torch.minimum(min_dur_f, (valid_s - t_ev).to(torch.float32))
    sustain_ok = sustain_s >= min_dur_f
    compliant = v["budget_ok"] & sustain_ok & v["delivered_ok"]

    def gate(x, fill=0.0):
        return torch.where(valid, x, fill)

    return ReserveEvents(
        t_event_s=gate(t_ev, -1).to(torch.int32),
        t_full_ms=gate(v["t_full_ms"]),
        sustain_s=gate(sustain_s),
        delivered_mw=gate(v["delivered_unit"] * design_mw),
        delivered_frac=gate(v["delivered_frac"]),
        budget_ok=gate(v["budget_ok"], False),
        sustain_ok=gate(sustain_ok, False),
        delivered_ok=gate(v["delivered_ok"], False),
        compliant=gate(compliant, False),
        valid=valid,
    )


def _as_tensor(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype)
    return torch.from_numpy(np.array(x)).to(dev, dtype)


def reserve_replay_batch(freq, mu_h, t_amb_h, valid_s, product_idx, rho,
                         design_mw, pue_design, *, pue_aware: bool = True,
                         e_max: int = E_MAX, unroll: int = 8,
                         device="cuda") -> dict:
    """Replay N scenarios' 1 Hz frequency traces on ``device``; detect and
    verify their reserve events.  ``unroll`` (the reference's scan
    unroll) is accepted and has no effect: the loop over seconds runs
    eagerly.

    ``freq`` (N, T) Hz; ``mu_h``/``t_amb_h`` (N, H) hourly operating
    fraction and ambient; ``valid_s`` (N,) real seconds (ragged
    horizons); ``product_idx``, ``rho``, ``design_mw``, ``pue_design``
    (N,).  A new event starts when the frequency drops below the
    product's trigger while released; the site holds the shed for
    ``min_duration_s`` and releases at the first second where the window
    is complete and the frequency is back above the trigger.  Crossings
    inside a held window do not re-trigger.

    One :func:`detection_step` per second over the (N,) state; each
    hour's trigger and shed flags are written into preallocated (N, T)
    buffers, and the per-event verdicts are gathered from them and the
    per-hour physics table afterwards.  Returns ``events`` (N, e_max)
    and (N,) ``n_events``, ``active_s``, ``shed_it_mwh``.
    """
    dev = resolve_device(device)
    f32, i64 = torch.float32, torch.int64
    freq, mu_h, t_amb_h, rho, design_mw, pue_design = (
        _as_tensor(x, f32, dev)
        for x in (freq, mu_h, t_amb_h, rho, design_mw, pue_design))
    valid_s, pidx = (_as_tensor(x, i64, dev) for x in (valid_s, product_idx))
    N, T = freq.shape
    h_max = mu_h.shape[-1]
    trig_hz = take(markets.TRIGGER_HZ, pidx)
    min_dur_f = take(markets.MIN_DURATION_S, pidx)
    min_dur_i = min_dur_f.to(torch.int32)
    # the verdict of an event depends only on its trigger hour's
    # (mu, T_amb): one (N, H) table, gathered at the event hours below
    vh = event_verdict(mu_h, t_amb_h, rho[:, None], pidx[:, None],
                       pue_design[:, None], pue_aware=pue_aware)

    below_t = freq < trig_hz[:, None]
    in_hor_t = torch.arange(T, device=dev)[None, :] < valid_s[:, None]
    trig = torch.empty((N, T), dtype=torch.bool, device=dev)
    shed = torch.empty((N, T), dtype=torch.bool, device=dev)
    carry = detection_init(N, dev)
    for s0 in range(0, T, 3600):
        rows_t, rows_s = [], []
        for s in range(s0, min(s0 + 3600, T)):
            carry, tr, sh = detection_step(carry, below_t[:, s],
                                           in_hor_t[:, s], min_dur_i)
            rows_t.append(tr)
            rows_s.append(sh)
        trig[:, s0:s0 + len(rows_t)] = torch.stack(rows_t, dim=1)
        shed[:, s0:s0 + len(rows_s)] = torch.stack(rows_s, dim=1)

    t_ev, valid = event_times(trig, e_max)
    hour_ev = torch.clamp(t_ev // 3600, max=h_max - 1).long()
    v = {k: torch.gather(x, -1, hour_ev) for k, x in vh.items()}
    events = assemble_events(v, t_ev, valid, min_dur_f[:, None],
                             valid_s[:, None], design_mw[:, None])
    hour_sec = torch.clamp(torch.arange(T, device=dev) // 3600,
                           max=h_max - 1)
    shed_it_mwh = (torch.where(shed, vh["rho_it"][:, hour_sec], 0.0)
                   .sum(-1) * design_mw / 3600.0)
    return dict(events=events, n_events=valid.sum(-1).to(torch.int32),
                active_s=shed.sum(-1).to(torch.int32),
                shed_it_mwh=shed_it_mwh)


def reserve_replay(freq, mu_h, t_amb_h, valid_s, product_idx, rho,
                   design_mw, pue_design, *, pue_aware: bool = True,
                   e_max: int = E_MAX, unroll: int = 8,
                   device="cuda") -> dict:
    """One scenario's replay: ``freq`` (T,), ``mu_h``/``t_amb_h`` (H,),
    the rest scalars.  :func:`reserve_replay_batch` over a batch of one;
    the leaves lose the scenario axis.  ``unroll`` is accepted and has no
    effect (see :func:`reserve_replay_batch`)."""
    dev = resolve_device(device)
    out = reserve_replay_batch(
        *(_as_tensor(x, torch.float32, dev)[None]
          for x in (freq, mu_h, t_amb_h)),
        *([x] for x in (valid_s, product_idx, rho, design_mw, pue_design)),
        pue_aware=pue_aware, e_max=e_max, device=dev)
    return dict(events=ReserveEvents(*(x[0] for x in out["events"])),
                **{k: v[0] for k, v in out.items() if k != "events"})


def event_clawback(events: ReserveEvents, at_risk) -> torch.Tensor:
    """Revenue forfeited over a verdict buffer: each valid event loses
    its ``at_risk`` revenue in proportion to the delivery shortfall plus
    in full on a budget/sustain failure."""
    shortfall = torch.clamp(1.0 - events.delivered_frac, 0.0, 1.0)
    hard_miss = (~(events.budget_ok & events.sustain_ok)).to(torch.float32)
    return torch.where(events.valid, at_risk * (shortfall + hard_miss),
                       0.0).sum(-1)


def settle_reserve(events: ReserveEvents, product_idx, rho, design_mw,
                   pue_design, hours) -> dict:
    """Capacity-revenue / penalty settlement of one committed band per
    scenario: (N,) knobs, (N, E) events."""
    dev = events.valid.device
    price = take(markets.CAPACITY_PRICE_EUR_MW_H,
                 torch.as_tensor(product_idx, device=dev))
    committed_mw = (tensor(rho, dev) * tensor(design_mw, dev)
                    * tensor(pue_design, dev))
    capacity_eur = committed_mw * tensor(hours, dev) * price
    penalty_eur = event_clawback(
        events, (price * committed_mw * PENALTY_WINDOW_H)[..., None])
    return dict(
        committed_mw=committed_mw,
        capacity_eur=capacity_eur,
        penalty_eur=penalty_eur,
        net_eur=capacity_eur - penalty_eur,
        n_events=events.valid.sum(-1),
        n_compliant=(events.valid & events.compliant).sum(-1),
    )


# ---------------------------------------------------------------------------
# Per-event Python reference: independent control flow, shared physics
# ---------------------------------------------------------------------------


def reserve_replay_reference(freq, mu_h, t_amb_h, valid_s, product_idx, rho,
                             design_mw, pue_design, *,
                             pue_aware: bool = True,
                             e_max: int = E_MAX) -> dict:
    """The per-event shape of the replay: numpy crossing detection plus a
    Python loop over events, on the host.  The same detection semantics
    and the same per-hour physics (``tier3.event_verdict`` on float32
    host tensors) as :func:`reserve_replay`; the oracle the replay is
    held against.
    """
    p = markets.FR_PRODUCTS[markets.PRODUCT_ORDER[int(product_idx)]]
    trig_hz = np.float32(p.trigger_hz)
    min_dur_i = int(p.min_duration_s)
    min_dur_f = np.float32(p.min_duration_s)
    f = np.asarray(freq, np.float32)
    mu_h = np.asarray(mu_h, np.float32)
    t_amb_h = np.asarray(t_amb_h, np.float32)
    T, H = f.shape[0], mu_h.shape[0]
    valid_s = int(valid_s)
    design_mw_f = np.float32(design_mw)

    below = f < trig_hz
    cand = np.flatnonzero(below[:valid_s])

    # the same hoisted per-hour physics table the replay gathers from
    vh = {k: x.numpy() for k, x in event_verdict(
        torch.from_numpy(mu_h.copy()), torch.from_numpy(t_amb_h.copy()),
        float(np.float32(rho)), int(product_idx),
        float(np.float32(pue_design)), pue_aware=pue_aware).items()}

    def verdict(hour: int) -> dict:
        return {k: x[hour] for k, x in vh.items()}

    ev = dict(
        t_event_s=np.full(e_max, -1, np.int32),
        t_full_ms=np.zeros(e_max, np.float32),
        sustain_s=np.zeros(e_max, np.float32),
        delivered_mw=np.zeros(e_max, np.float32),
        delivered_frac=np.zeros(e_max, np.float32),
        budget_ok=np.zeros(e_max, bool),
        sustain_ok=np.zeros(e_max, bool),
        delivered_ok=np.zeros(e_max, bool),
        compliant=np.zeros(e_max, bool),
        valid=np.zeros(e_max, bool),
    )
    n, active_s = 0, 0
    shed_it_mwh = np.float32(0.0)
    ptr = 0
    while ptr < cand.size:
        t = int(cand[ptr])
        v = verdict(min(t // 3600, H - 1))
        if n < e_max:
            sustain_s = np.float32(min(min_dur_f, np.float32(valid_s - t)))
            sustain_ok = bool(sustain_s >= min_dur_f)
            ev["t_event_s"][n] = t
            ev["t_full_ms"][n] = v["t_full_ms"]
            ev["sustain_s"][n] = sustain_s
            ev["delivered_mw"][n] = np.float32(
                v["delivered_unit"] * design_mw_f)
            ev["delivered_frac"][n] = v["delivered_frac"]
            ev["budget_ok"][n] = bool(v["budget_ok"])
            ev["sustain_ok"][n] = sustain_ok
            ev["delivered_ok"][n] = bool(v["delivered_ok"])
            ev["compliant"][n] = (bool(v["budget_ok"]) and sustain_ok
                                  and bool(v["delivered_ok"]))
            ev["valid"][n] = True
            n += 1
        # release: first second >= t + min_dur - 1 (hold expired) with
        # frequency back above the trigger; otherwise the event runs to
        # the end of the trace
        s0 = t + min_dur_i - 1
        if s0 >= T:
            last = T - 1
        else:
            rel = np.flatnonzero(~below[s0:])
            last = s0 + int(rel[0]) if rel.size else T - 1
        for s in range(t, min(last, T - 1) + 1):
            if s < valid_s:
                vs = verdict(min(s // 3600, H - 1))
                active_s += 1
                shed_it_mwh = np.float32(
                    shed_it_mwh
                    + np.float32(vs["rho_it"] * design_mw_f) / 3600.0)
        ptr = int(np.searchsorted(cand, last + 1, side="left"))
    return dict(events=ReserveEvents(**ev), n_events=n, active_s=active_s,
                shed_it_mwh=shed_it_mwh)
