"""Tier-1: per-chip discrete PID power-tracking loop at 200 Hz (paper
Eq. 1): the port of ``repro.core.pid``.

    u_k = p* + Kp e_k + Ki sum(e) dt + Kd (e_k - e_{k-1}),   e_k = p* - p_k

Gains (0.6, 0.05, 0.02), an anti-windup clamp of 50 W*s, output in the
[100, 300] W cap range, and a 200 W thermal fallback when the one-step
junction prediction exceeds 85 degC.

:func:`pid_step` runs the fused tick through ``kernels.ops.pid_update``:
the hand-written CUDA kernel on a CUDA device, its plain torch version on
the CPU.  The rollouts are Python loops over 5 ms ticks; every leading
axis of the state -- the scenario axis of :func:`pid_rollout_batch`, the
(S, H) product of :func:`pid_rollout_grid` -- is flattened into the
kernel's one chip axis, so each tick is one launch for the whole grid.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

import repro_torch.core.plant as plant_lib
from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.pid_update import PIDGains

KP, KI, KD = 0.6, 0.05, 0.02
DT_S = 1.0 / plant_lib.CONTROL_HZ
WINDUP_CLAMP = 50.0
U_MIN, U_MAX = plant_lib.CAP_MIN, plant_lib.CAP_MAX
T_PREDICT_LIMIT = plant_lib.T_FALLBACK
FALLBACK_CAP = plant_lib.CAP_FALLBACK
THERMAL_TAU = plant_lib.TAU_THERMAL

GAINS = PIDGains(kp=KP, ki=KI, kd=KD, windup=WINDUP_CLAMP, u_min=U_MIN,
                 u_max=U_MAX, t_amb_int=plant_lib.T_AMBIENT_INT,
                 r_th=plant_lib.R_TH, thermal_tau=THERMAL_TAU,
                 t_limit=T_PREDICT_LIMIT, fallback_cap=FALLBACK_CAP)


class PIDState(NamedTuple):
    integ: torch.Tensor     # integral of error, W*s
    prev_err: torch.Tensor  # e_{k-1}, W
    u: torch.Tensor         # last output (cap command), W


def init_pid(n: int, u0: float = U_MAX, *, device="cuda") -> PIDState:
    z = torch.zeros((n,), dtype=torch.float32, device=resolve_device(device))
    return PIDState(integ=z, prev_err=z.clone(), u=z + u0)


def predict_temp(temp, power, horizon_s: float = DT_S):
    """First-order junction prediction one horizon ahead."""
    t_inf = plant_lib.T_AMBIENT_INT + plant_lib.R_TH * power
    return t_inf + (temp - t_inf) * math.exp(-horizon_s / THERMAL_TAU)


def pid_step(state: PIDState, target, power, temp,
             dt_s: float = DT_S) -> tuple[PIDState, torch.Tensor]:
    """One 200 Hz tick; all arguments broadcast to a common shape.

    The five operands are broadcast, flattened to one contiguous (N,)
    chip axis for the fused kernel, and the outputs take the common shape
    back.  Returns (new_state, cap_command).
    """
    dev = state.integ.device
    ops_in = [torch.as_tensor(x, dtype=torch.float32).to(dev)
              if not isinstance(x, torch.Tensor) else x.to(torch.float32)
              for x in (target, power, temp, state.integ, state.prev_err)]
    shape = torch.broadcast_shapes(*(x.shape for x in ops_in))
    flat = [x.expand(shape).reshape(-1).contiguous() for x in ops_in]
    integ, err, u = ops.pid_update(*flat, GAINS, dt_s=dt_s)
    integ, err, u = (x.view(shape) for x in (integ, err, u))
    return PIDState(integ=integ, prev_err=err, u=u), u


def _as_state(state: PIDState, plant: plant_lib.PlantState, dev):
    state = PIDState(*(x.to(dev, torch.float32) for x in state))
    plant = plant_lib.PlantState(**{
        f.name: getattr(plant, f.name).to(dev, torch.float32)
        for f in dataclasses.fields(plant)})
    return state, plant


def _pid_rollout_impl(state, plant, targets, loads, tau_ms: float, device):
    """Closed loop over the tick axis, which is axis -2 of targets/loads
    (shape lead + (T, n)); state leaves have shape lead + (n,)."""
    dev = resolve_device(device)
    state, plant = _as_state(state, plant, dev)
    targets = torch.as_tensor(targets, dtype=torch.float32).to(dev)
    loads = torch.as_tensor(loads, dtype=torch.float32).to(dev)
    dt_ms = 1000.0 * DT_S
    trace = []
    for k in range(targets.shape[-2]):
        state, cap = pid_step(state, targets[..., k, :], plant.power,
                              plant.temp)
        plant = plant_lib.write_cap(plant, cap)
        plant = plant_lib.plant_step(plant, loads[..., k, :], dt_ms,
                                     tau_ms=tau_ms)
        trace.append(plant.power)
    return state, plant, torch.stack(trace, dim=-2)


def pid_rollout(state: PIDState, plant: plant_lib.PlantState, targets,
                loads, tau_ms: float = 6.0, *, device="cuda"):
    """Closed-loop rollout of PID + plant over a (T, n) target/load grid.

    Returns (final pid state, final plant state, power trace (T, n)).
    """
    return _pid_rollout_impl(state, plant, targets, loads, tau_ms, device)


def pid_rollout_batch(state: PIDState, plant: plant_lib.PlantState, targets,
                      loads, tau_ms: float = 6.0, *, device="cuda"):
    """:func:`pid_rollout` over a leading scenario axis: state leaves are
    (N, n), targets/loads (N, T, n), the power trace (N, T, n)."""
    return _pid_rollout_impl(state, plant, targets, loads, tau_ms, device)


def pid_rollout_grid(state: PIDState, plant: plant_lib.PlantState, targets,
                     loads, tau_ms: float = 6.0, *, device="cuda"):
    """:func:`pid_rollout` over the (scenario x host) product: state
    leaves are (S, H, n), targets/loads (S, H, T, n), the power trace
    (S, H, T, n).  The Tier-1 quasi-static check's sweep surface: every
    (target, load) cell must settle to min(demand, cap) inside a second.
    """
    return _pid_rollout_impl(state, plant, targets, loads, tau_ms, device)
