"""The power<->throughput model every layer shares: the port of
``repro.workload.model``.

  :func:`throughput_frac`  power-cap -> throughput curve (DVFS above the
                           clock floor, duty-cycling below it), built on
                           the plant's DVFS physics,
  :func:`step_transient`   the step-synchronous power wave of
                           synchronised training,
  mix tables               per-mix clock sensitivity and token rates,
                           indexed by ``ScenarioBatch.mix_idx``.
"""
from __future__ import annotations

import numpy as np
import torch

import repro_torch.core.plant as plant
from repro_torch._num import clip, f32, where

MIX_ORDER = ("train", "inference", "balanced")
CLOCK_W = np.asarray([0.88, 0.15, 0.50], np.float32)
TOKENS_PER_MW_S = np.asarray([250e3, 400e3, 300e3], np.float32)

STEP_PERIOD_S_DEFAULT = 10.0
STEP_COMPUTE_FRAC = 0.8
DEFAULT_GRID_CKPT_S = 30.0

# DVFS / duty-cycle anchors, derived from the plant model in float32 (CPU
# tensors, so they equal the reference's float32 constants)
_ONE = torch.tensor(1.0)
P_FLOOR_FRAC = float(plant.power_model(torch.tensor(plant.F_MIN), _ONE)
                     / plant.TDP)
P_IDLE_FRAC = float(plant.P_IDLE / plant.TDP)
F_AT_TDP = float(plant.freq_at_cap(torch.tensor(plant.TDP), _ONE))
_MEM_AT_TDP = 0.45 + 0.55 * F_AT_TDP / plant.F_NOMINAL
del _ONE


def mix_index(mix: str) -> int:
    """MIX_ORDER index of a mix name (raises on unknown mixes)."""
    try:
        return MIX_ORDER.index(mix)
    except ValueError:
        raise ValueError(
            f"unknown workload mix {mix!r}; expected one of {MIX_ORDER}")


def clock_weight(mix: str) -> float:
    return float(CLOCK_W[mix_index(mix)])


def tokens_per_mw_s(mix: str) -> float:
    return float(TOKENS_PER_MW_S[mix_index(mix)])


def throughput_frac(clock_w, power_frac):
    """Normalised throughput in [0, 1] at per-chip power ``power_frac``
    (a fraction of TDP): DVFS blend of the clock- and HBM-bound branches
    by ``clock_w`` above the floor, duty-cycling below it."""
    p = f32(power_frac)
    clock_w = f32(clock_w)
    f = plant.freq_at_cap(clip(p, P_FLOOR_FRAC, 1.0) * plant.TDP, 1.0)
    clock = f / F_AT_TDP
    mem = (0.45 + 0.55 * f / plant.F_NOMINAL) / _MEM_AT_TDP
    r_dvfs = clock_w * clock + (1.0 - clock_w) * mem
    duty = clip((p - P_IDLE_FRAC) / (P_FLOOR_FRAC - P_IDLE_FRAC), 0.0, 1.0)
    return where(p < P_FLOOR_FRAC, duty * r_dvfs, r_dvfs)


def step_transient(t_s, period_s, amp):
    """Multiplicative step-synchronous load wave, mean 1 over a period;
    ``amp=0`` is exactly the constant 1."""
    t = f32(t_s)
    frac = (t % period_s) / period_s
    boost = amp * (1.0 - STEP_COMPUTE_FRAC) / STEP_COMPUTE_FRAC
    return where(frac < STEP_COMPUTE_FRAC, 1.0 + boost, 1.0 - amp)
