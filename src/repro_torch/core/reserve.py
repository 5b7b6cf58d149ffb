"""Seconds-tier reserve detection, verdicts and settlement: the port of
the engine's pieces of ``repro.core.reserve``.

The detection state machine (armed / holding / released) runs one step
per second for N scenarios at once; the per-event verdict buffers are
gathered afterwards from the trigger flags.  The activation physics is
``tier3.event_verdict``, shared with the selector.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

import repro_torch.core.tier3 as tier3_lib
import repro_torch.grid.markets as markets
from repro_torch._num import take, tensor
from repro_torch.core.tier3 import event_verdict  # noqa: F401 (re-export)

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
