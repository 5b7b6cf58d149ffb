"""Hourly schedule replay of the GridPilot-PUE dispatcher (paper
Algorithm 1): the port of the batched half of ``repro.core.dispatch``.

:func:`replay_schedule` integrates power and carbon of utilisation
schedules over the hour axis; :func:`signal_thresholds` and
:func:`schedule_from_threshold` build signal-ranked schedules.  All work
on the last (hour) axis with any leading axes.  The Algorithm-1
dispatcher class itself is not ported yet.
"""
from __future__ import annotations

import torch

import repro_torch.core.pue as pue_lib
import repro_torch.workload.model as workload_lib
from repro_torch._num import tensor


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
