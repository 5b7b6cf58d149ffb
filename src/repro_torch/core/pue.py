"""Instantaneous four-component PUE model (paper Eq. 4): the port of
``repro.core.pue``.

    PUE(t, L, T_amb) = 1 + (P_chiller + P_pumps + P_air + P_misc) / P_IT

Every function broadcasts over any leading axes: ``load``, ``t_amb`` and
``pue_design`` may be Python numbers or tensors of broadcastable shapes
(the engine passes (N,) per-scenario values).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._num import clip, device_of, f32

PUE_DESIGN = 1.20
T_FREECOOL_HI = 25.0
T_FREECOOL_LO = 12.0
PUMP_FLOOR = 0.20
AIR_FLOOR = 0.15
T_REF = 18.0

CHILLER_SHARE = 0.55
PUMP_SHARE = 0.18
AIR_SHARE = 0.15
MISC_SHARE = 0.12


def free_cooling_fraction(t_amb, device=None):
    """f_fc(T_amb): 0 at >= 25 degC, 1 at <= 12 degC, linear between."""
    t = f32(t_amb, device)
    return clip((T_FREECOOL_HI - t) / (T_FREECOOL_HI - T_FREECOOL_LO),
                0.0, 1.0)


# the calibration ambient's chiller factor, folded once in float32, and
# in float64 for float64 inputs (as the reference computes it there)
_F_REF = np.float32(free_cooling_fraction(T_REF))
_CHILL_REF = float(np.float32(1.0) - np.float32(0.85) * _F_REF)
_CHILL_REF_F64 = 1.0 - 0.85 * free_cooling_fraction(T_REF)


def pue(load, t_amb, *, pue_design=PUE_DESIGN):
    """Instantaneous PUE at load = P_IT / P_IT_design and ambient t_amb."""
    dev = device_of(load, t_amb, pue_design)
    L = clip(f32(load, dev), 1e-3, 1.0)
    f_fc = free_cooling_fraction(t_amb, dev)
    wide = any(isinstance(v, torch.Tensor) and v.dtype == torch.float64
               for v in (L, pue_design, f_fc))
    # a number meets float64 inputs at full precision, as the reference's
    # weakly typed Python numbers do under x64
    oh = (float(pue_design) if wide and not isinstance(pue_design,
                                                        torch.Tensor)
          else f32(pue_design, dev)) - 1.0
    cop_penalty = 1.0 + 0.45 * (1.0 - L)
    chiller_scale = oh * CHILLER_SHARE / (_CHILL_REF_F64 if wide
                                          else _CHILL_REF)
    p_chiller = chiller_scale * L * cop_penalty * (1.0 - 0.85 * f_fc)
    p_pumps = oh * PUMP_SHARE * clip(L * L, PUMP_FLOOR)
    p_air = oh * AIR_SHARE * clip(L * L * L, AIR_FLOOR)
    p_misc = oh * MISC_SHARE
    return 1.0 + (p_chiller + p_pumps + p_air + p_misc) / L


def facility_power(p_it, p_it_design, t_amb, *,
                   pue_design=PUE_DESIGN):
    """Metered facility power for an IT draw ``p_it`` (same units)."""
    L = p_it / p_it_design
    return p_it * pue(L, t_amb, pue_design=pue_design)


def ffr_meter_gain(mu, rho, t_amb, *, pue_design=PUE_DESIGN):
    """Meter-side FFR delivery per unit of committed IT-side band:
    [F(mu) - F(mu - rho)] / rho, with F the facility power."""
    dev = device_of(mu, rho, t_amb, pue_design)
    mu = f32(mu, dev)
    rho = clip(f32(rho, dev), 1e-6)
    hi = facility_power(mu, 1.0, t_amb, pue_design=pue_design)
    lo = facility_power(clip(mu - rho, 0.02), 1.0, t_amb,
                        pue_design=pue_design)
    return (hi - lo) / rho
