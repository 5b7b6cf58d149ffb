"""Fused Tier-1 fleet PID tick: the CUDA kernel and its plain version.

Port of the Pallas TPU kernel ``repro/kernels/pid_update.py`` (route:
CUDA C++ for sm_90a, ``csrc/pid_update.cu``, bound with ctypes).  The
kernel is bound by memory: 32 B read or written per chip.  The source's
head note says what its design does about that.

:func:`pid_update` launches the kernel on CUDA tensors and raises on
anything else; :func:`pid_update_ref` is the same function in plain torch
ops, the CPU path and the card's yardstick.  The gains and limits arrive
as a :class:`PIDGains` from ``repro_torch.core.pid``, which holds the
constants, so this module imports nothing of ``core``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

DT_S = 0.005


class PIDGains(NamedTuple):
    kp: float
    ki: float
    kd: float
    windup: float        # |integral| clamp, W*s
    u_min: float         # output range, W
    u_max: float
    t_amb_int: float     # thermal model: inlet degC
    r_th: float          #   junction rise per W
    thermal_tau: float   #   time constant, s
    t_limit: float       # thermal fallback threshold, degC
    fallback_cap: float  # cap under the fallback, W


def pid_update_ref(target, power, temp, integ, prev_err, gains: PIDGains,
                   *, dt_s: float = DT_S):
    """Plain torch version: returns (new_integ, new_prev_err, cap)."""
    g = gains
    err = target - power
    integ = torch.clamp(integ + err * dt_s, -g.windup, g.windup)
    deriv = err - prev_err
    u = target + g.kp * err + g.ki * integ + g.kd * deriv
    u = torch.clamp(u, g.u_min, g.u_max)
    t_inf = g.t_amb_int + g.r_th * power
    t_pred = t_inf + (temp - t_inf) * math.exp(-dt_s / g.thermal_tau)
    u = torch.where(t_pred > g.t_limit, torch.clamp(u, max=g.fallback_cap),
                    u)
    return integ, err, u


_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
             + [ctypes.c_float] * 12 + [ctypes.c_void_p])


def _launcher():
    lib = _build.load("pid_update")
    fn = lib.pid_update_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def pid_update(target, power, temp, integ, prev_err, gains: PIDGains, *,
               dt_s: float = DT_S):
    """Launch the CUDA kernel on five (N,) float32 contiguous tensors on
    one CUDA device; returns (new_integ, new_prev_err, cap).

    Adds one to ``pid_update.launches`` for each launch.  Raises on a CPU
    tensor, another dtype or shape, a non-contiguous tensor, mixed
    devices, or a launch the runtime refuses.
    """
    args = (target, power, temp, integ, prev_err)
    dev = target.device
    if dev.type != "cuda":
        raise ValueError(f"pid_update launches on CUDA tensors, got {dev}")
    n = target.shape[0] if target.dim() == 1 else -1
    for a in args:
        if a.device != dev or a.dtype != torch.float32 or a.dim() != 1 \
                or a.shape[0] != n or not a.is_contiguous():
            raise ValueError(
                "pid_update takes five contiguous (N,) float32 tensors on "
                f"one CUDA device, got {a.dtype} {tuple(a.shape)} on "
                f"{a.device} (contiguous={a.is_contiguous()})")
    outs = [torch.empty_like(target) for _ in range(3)]
    if n == 0:
        return tuple(outs)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[a.data_ptr() for a in args], *[o.data_ptr() for o in outs],
                n, dt_s, *gains, stream)
    if rc != 0:
        raise RuntimeError(f"pid_update launch failed: cudaError {rc}")
    pid_update.launches += 1
    return tuple(outs)


pid_update.launches = 0
