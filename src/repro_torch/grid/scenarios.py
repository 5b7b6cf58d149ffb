"""Scenario-batch builder: the port of ``repro.grid.scenarios``.

A :class:`ScenarioBatch` stacks N scenarios -- each a (country, season,
seed, MW level, PUE design, FR product, committed band, event draw,
workload mix) with its synthesised hourly CI and ambient traces -- into
padded tensors with a leading scenario axis.  Ragged horizons are right-
padded and masked (``mask`` is 1.0 on valid hours).
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

import repro_torch.core.pue as pue_lib
from repro_torch import resolve_device
from repro_torch.grid.markets import PRODUCT_ORDER
from repro_torch.grid.signals import (COUNTRY_ORDER, synthesize_ci,
                                      synthesize_t_amb)
from repro_torch.random import MASK32
from repro_torch.workload.model import MIX_ORDER, mix_index

DEFAULT_HORIZON_H = 28 * 24
_PAD_T_AMB = pue_lib.T_REF


@dataclass(frozen=True)
class ScenarioSpec:
    """Host-side description of one replay scenario."""

    country: str
    seed: int = 0
    start_day: int = 15
    mw: float = 10.0
    pue_design: float = pue_lib.PUE_DESIGN
    horizon_h: int = DEFAULT_HORIZON_H
    product: str = "FFR"
    reserve_rho: float = 0.0
    event_seed: int = 0
    workload_mix: str = "train"


def product_specs(countries: Sequence[str] = tuple(COUNTRY_ORDER),
                  seeds: Sequence[int] = (0,),
                  start_days: Sequence[int] = (15,),
                  mw_levels: Sequence[float] = (10.0,),
                  pue_designs: Sequence[float] = (pue_lib.PUE_DESIGN,),
                  horizon_h: int = DEFAULT_HORIZON_H,
                  products: Sequence[str] = ("FFR",),
                  reserve_rhos: Sequence[float] = (0.0,),
                  event_seeds: Sequence[int] = (0,),
                  workload_mixes: Sequence[str] = ("train",)
                  ) -> list[ScenarioSpec]:
    """Cartesian scenario grid, in the reference's axis order."""
    return [
        ScenarioSpec(country=c, seed=s, start_day=d, mw=m, pue_design=pd,
                     horizon_h=horizon_h, product=p, reserve_rho=r,
                     event_seed=es, workload_mix=wm)
        for c, d, s, m, pd, p, r, es, wm in itertools.product(
            countries, start_days, seeds, mw_levels, pue_designs,
            products, reserve_rhos, event_seeds, workload_mixes)
    ]


@dataclass(frozen=True)
class ScenarioBatch:
    """N scenarios as padded tensors (leading axis = scenario)."""

    country_idx: torch.Tensor  # (N,) int32 index into COUNTRY_ORDER
    seed: torch.Tensor         # (N,) int64 (uint32 range)
    start_day: torch.Tensor    # (N,) int32
    mw: torch.Tensor           # (N,) float32
    pue_design: torch.Tensor   # (N,) float32
    hours: torch.Tensor        # (N,) int32 valid trace length
    ci: torch.Tensor           # (N, H_max) float32, right-padded with 0
    t_amb: torch.Tensor        # (N, H_max) float32, padded with T_REF
    mask: torch.Tensor         # (N, H_max) float32, 1.0 on valid hours
    product_idx: torch.Tensor  # (N,) int32 index into PRODUCT_ORDER
    reserve_rho: torch.Tensor  # (N,) float32 committed FR band
    event_seed: torch.Tensor   # (N,) int64 frequency-event draw
    mix_idx: torch.Tensor      # (N,) int32 index into MIX_ORDER

    @property
    def n(self) -> int:
        return int(self.ci.shape[0])

    @property
    def h_max(self) -> int:
        return int(self.ci.shape[1])

    @property
    def device(self) -> torch.device:
        return self.ci.device

    def __len__(self) -> int:
        return self.n

    def to(self, device) -> "ScenarioBatch":
        return ScenarioBatch(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})

    def spec(self, i: int) -> ScenarioSpec:
        h = {f.name: getattr(self, f.name)[i].item()
             for f in dataclasses.fields(self) if f.name not in
             ("ci", "t_amb", "mask")}
        return ScenarioSpec(
            country=COUNTRY_ORDER[h["country_idx"]], seed=h["seed"],
            start_day=h["start_day"], mw=h["mw"],
            pue_design=h["pue_design"], horizon_h=h["hours"],
            product=PRODUCT_ORDER[h["product_idx"]],
            reserve_rho=h["reserve_rho"], event_seed=h["event_seed"],
            workload_mix=MIX_ORDER[h["mix_idx"]])


def build_scenario_batch(specs: Sequence[ScenarioSpec],
                         h_max: int | None = None,
                         device="cuda") -> ScenarioBatch:
    """Synthesize every spec's traces (once per distinct trace key) and
    stack them into one padded batch on ``device``.  ``h_max`` overrides
    the padded hour axis and must cover the longest horizon."""
    dev = resolve_device(device)
    if not specs:
        raise ValueError("empty scenario list")
    h_need = max(s.horizon_h for s in specs)
    if h_max is None:
        h_max = h_need
    elif h_max < h_need:
        raise ValueError(
            f"h_max={h_max} is shorter than the longest horizon in the "
            f"spec slice ({h_need} h)")
    n = len(specs)
    ci = np.zeros((n, h_max), np.float32)
    t_amb = np.full((n, h_max), _PAD_T_AMB, np.float32)
    mask = np.zeros((n, h_max), np.float32)
    traces: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}
    for i, s in enumerate(specs):
        h = s.horizon_h
        k = (s.country, s.seed, s.start_day, h)
        if k not in traces:
            traces[k] = (synthesize_ci(s.country, h, s.seed, s.start_day),
                         synthesize_t_amb(s.country, h, s.seed, s.start_day))
        ci[i, :h], t_amb[i, :h] = traces[k]
        mask[i, :h] = 1.0

    def col(values, dtype):
        return torch.as_tensor(np.asarray(values), dtype=dtype, device=dev)

    return ScenarioBatch(
        country_idx=col([COUNTRY_ORDER.index(s.country) for s in specs],
                        torch.int32),
        seed=col([s.seed for s in specs], torch.int64) & MASK32,
        start_day=col([s.start_day for s in specs], torch.int32),
        mw=col(np.asarray([s.mw for s in specs], np.float32), torch.float32),
        pue_design=col(np.asarray([s.pue_design for s in specs], np.float32),
                       torch.float32),
        hours=col([s.horizon_h for s in specs], torch.int32),
        ci=col(ci, torch.float32),
        t_amb=col(t_amb, torch.float32),
        mask=col(mask, torch.float32),
        product_idx=col([PRODUCT_ORDER.index(s.product) for s in specs],
                        torch.int32),
        reserve_rho=col(np.asarray([s.reserve_rho for s in specs],
                                   np.float32), torch.float32),
        event_seed=col([s.event_seed for s in specs], torch.int64) & MASK32,
        mix_idx=col([mix_index(s.workload_mix) for s in specs], torch.int32),
    )


def scenario_chunk(specs: Sequence[ScenarioSpec], lo: int, hi: int, *,
                   h_max: int | None = None, device="cuda") -> ScenarioBatch:
    """Index-addressed chunk builder: stack specs ``[lo, hi)`` only."""
    if not (0 <= lo < hi <= len(specs)):
        raise ValueError(
            f"chunk [{lo}, {hi}) out of range for {len(specs)} specs")
    return build_scenario_batch(specs[lo:hi], h_max=h_max, device=device)


def frequency_seeds(batch: ScenarioBatch) -> torch.Tensor:
    """Per-scenario frequency-synthesis seed, wrapping at 2**32 as the
    reference's uint32 arithmetic does: scenarios that differ only in
    country or band draw the same grid-event day."""
    return (batch.event_seed * 100_003 + batch.seed) & MASK32


def bidding_seeds(batch: ScenarioBatch) -> torch.Tensor:
    """Per-scenario seed of the Tier-3 bidder's forecast ensemble
    (``repro_torch.optim.bidding``), wrapping at 2**32 like
    :func:`frequency_seeds`: a different multiplier and offset keep the
    bidder's perturbations from aliasing the grid-event day it is later
    settled against."""
    return (batch.event_seed * 1_000_003 + batch.seed * 97 + 7) & MASK32


def masked_quantile_sorted(xs: torch.Tensor, n_valid,
                           q: float) -> torch.Tensor:
    """Quantile along the last axis of an ascending-sorted ``xs`` whose
    first ``n_valid`` entries are the valid ones (invalid sorted to
    +inf), with linear interpolation at q * (n_valid - 1).  ``n_valid``
    is a number or a tensor of ``xs``' leading shape; the result has that
    shape.  Lets a sort paid for elsewhere (E8's schedule thresholds over
    the same signal) be reused."""
    n_valid = torch.as_tensor(n_valid, device=xs.device).unsqueeze(-1)
    pos = q / 100.0 * (n_valid.to(torch.float32) - 1.0)
    i0 = torch.clamp(torch.floor(pos).long(), 0, xs.shape[-1] - 1)
    i1 = torch.minimum(torch.clamp(i0 + 1, min=0), n_valid.long() - 1)
    i1 = torch.clamp(i1, min=0)
    w = pos - i0.to(torch.float32)
    xs = xs.expand(*n_valid.shape[:-1], xs.shape[-1])
    out = torch.gather(xs, -1, i0) * (1.0 - w) + torch.gather(xs, -1, i1) * w
    return out.squeeze(-1)


def masked_quantile(x: torch.Tensor, mask: torch.Tensor,
                    q: float) -> torch.Tensor:
    """Quantile of the masked entries of ``x`` along the last axis, with
    linear interpolation at q * (n_valid - 1)."""
    xs = torch.sort(torch.where(mask > 0, x, torch.inf), dim=-1).values
    return masked_quantile_sorted(xs, (mask > 0).sum(-1), q)
