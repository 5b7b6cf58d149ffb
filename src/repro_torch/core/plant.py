"""Accelerator power/thermal plant: the port of ``repro.core.plant``.

Model (paper Sect. 5.1, E1):      P = P_idle + a*f + b*f^2*L + g*L
with a voltage floor at F_VMIN: below it the quadratic term degrades to
b*f*F_VMIN*L.  Demand-side moves follow a first-order response; with
``slew_w_ms`` set, cap-enforced drops go through the firmware governor's
multiplicative slew.  Thermal: first-order junction, tau = 8 s.

Constants are copies of the reference's; ``tests/test_torch_common.py``
pins each against ``repro.core.plant``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch._num import clip, const, device_of, f32, tensor, where

P_IDLE = 39.0
ALPHA = 0.027
BETA = 9.27e-5
GAMMA = 2.7
TDP = 300.0
CAP_MIN, CAP_MAX = 100.0, 300.0
F_MAX = 1530.0
F_MIN = 405.0
F_VMIN = 945.0
F_NOMINAL = 1480.0

GOV_SLEW = 0.00344     # 1/ms
ACTUATE_DELAY_MS = 5.0

TAU_THERMAL = 8.0      # s
T_AMBIENT_INT = 30.0   # degC
R_TH = 50.0 / 300.0    # degC/W
T_FALLBACK = 85.0      # degC
CAP_FALLBACK = 200.0   # W

CONTROL_HZ = 200.0     # Tier-1 tick

WORKLOADS = ("matmul", "inference", "bursty")

# (mean load, fast-noise sigma, slow-noise sigma, demand tau ms); tau makes
# settle(+/-2 % band) = 5 ms NVML window + 3 tau, the paper's E2 medians
_ARCHETYPES = {
    "matmul": dict(mean=0.97, fast_sigma=0.021, slow_sigma=0.012,
                   tau_ms=4.33),
    "inference": dict(mean=0.58, fast_sigma=0.008, slow_sigma=0.010,
                      tau_ms=5.33),
    "bursty": dict(mean=0.95, fast_sigma=0.008, slow_sigma=0.02, tau_ms=8.0),
}
BURSTY_PERIOD_S = 4.0
BURSTY_DUTY = 0.5
BURSTY_LOW = 0.05
BURSTY_EDGE_JITTER_S = 0.12
SLOW_FREQS_HZ = (0.031, 0.073, 0.127, 0.211)
BURSTY_JITTER_FREQ_HZ = 0.017


def workload_tau_ms(workload: str) -> float:
    return _ARCHETYPES[workload]["tau_ms"]


def workload_load(workload: str, t_s, phase=0.0, *, draws=None,
                  generator: Optional[torch.Generator] = None,
                  device="cuda") -> torch.Tensor:
    """Instantaneous utilisation L(t) of an archetype at the seconds
    ``t_s`` (any shape), on ``device``.

    Slow noise is a band-limited wander (four incommensurate sinusoids
    with random phases), fast noise is white; the bursty archetype is a
    4 s compute/idle square wave with a jittered edge.  The reference
    draws three things from a key: the four wave phases, the fast
    normals (the shape of ``t_s``) and the jitter phase.  ``draws`` takes
    those three buffers, ``(phases (4,), fast, jitter ())``; without it
    they are drawn from ``generator`` (torch's default generator when
    None) on the generator's device.
    """
    a = _ARCHETYPES[workload]
    dev = resolve_device(device)
    t = tensor(t_s, dev).float()
    if draws is None:
        gdev = generator.device if generator is not None else dev
        ph = torch.rand(4, generator=generator, device=gdev) * (
            2 * math.pi)
        fast = torch.randn(t.shape, generator=generator, device=gdev)
        jit = torch.rand((), generator=generator, device=gdev) * 6.28
        draws = (ph, fast, jit)
    ph, fast, jit = (tensor(x, dev).float() for x in draws)
    freqs = const(np.float32(SLOW_FREQS_HZ), dev)
    slow = torch.sin(2 * math.pi * freqs * t[..., None] + ph).sum(-1) / 2.0
    base = a["mean"] + a["slow_sigma"] * slow + a["fast_sigma"] * fast
    if workload == "bursty":
        jit_t = BURSTY_EDGE_JITTER_S * torch.sin(
            2 * math.pi * BURSTY_JITTER_FREQ_HZ * t + jit)
        frac = torch.remainder((t + jit_t) / BURSTY_PERIOD_S + phase, 1.0)
        base = torch.where(frac < BURSTY_DUTY, base,
                           BURSTY_LOW + 0.01 * fast)
    return torch.clamp(base, 0.0, 1.0)


def power_model(f_mhz, load, *, p_idle=P_IDLE, a=ALPHA, b=BETA, g=GAMMA):
    """Steady-state board power at SM clock ``f_mhz`` and utilisation
    ``load``, with the voltage floor below F_VMIN.

    A Python-number clock (the loops' F_NOMINAL) folds its terms on the
    host in float32, so no scalar is copied to the device per call."""
    if not isinstance(f_mhz, torch.Tensor):
        f = np.float32(f_mhz)
        f2 = f * f if f >= F_VMIN else f * np.float32(F_VMIN)
        c0 = np.float32(p_idle) + np.float32(a) * f
        c1 = np.float32(b) * f2
        L = f32(load)
        if not isinstance(L, torch.Tensor):
            L = np.float32(L)
            return float(c0 + c1 * L + np.float32(g) * L)
        return float(c0) + float(c1) * L + g * L
    dev = device_of(load, f_mhz)
    f = f32(f_mhz, dev)
    L = f32(load, dev)
    f2 = torch.where(f >= F_VMIN, f * f, f * F_VMIN)
    return p_idle + a * f + b * f2 * L + g * L


def freq_at_cap(cap, load, *, a=ALPHA, b=BETA, g=GAMMA, p_idle=P_IDLE):
    """SM clock the governor settles at so that P(f, L) == cap; branch-
    aware in the voltage floor, clipped to [F_MIN, F_MAX]."""
    dev = device_of(cap, load)
    cap = f32(cap, dev)
    L = clip(f32(load, dev), 1e-3)
    budget = cap - p_idle - g * L
    disc = a * a + 4.0 * b * L * clip(budget, 0.0)
    f_quad = (-a + disc ** 0.5) / (2.0 * b * L)
    f_lin = budget / (a + b * F_VMIN * L)
    f = where(f_quad >= F_VMIN, f_quad, f_lin)
    return clip(f, F_MIN, F_MAX)


@dataclasses.dataclass
class PlantState:
    """Per-chip plant state; every field has the chip shape."""

    power: torch.Tensor        # board power, W
    cap: torch.Tensor          # enforced power cap, W
    pending_cap: torch.Tensor  # cap written, still in the NVML latency window
    pending_ms: torch.Tensor   # time until the pending cap is active (ms)
    temp: torch.Tensor         # junction temperature, degC
    freq: torch.Tensor         # governor SM clock, MHz


def init_plant(n_chips: int, cap: float = CAP_MAX, *,
               device="cuda") -> PlantState:
    z = torch.zeros((n_chips,), dtype=torch.float32,
                    device=resolve_device(device))
    return PlantState(power=z + P_IDLE, cap=z + cap, pending_cap=z + cap,
                      pending_ms=z.clone(), temp=z + T_AMBIENT_INT,
                      freq=z + F_NOMINAL)


def write_cap(state: PlantState, cap) -> PlantState:
    """Queue a cap write (takes ACTUATE_DELAY_MS to reach the firmware)."""
    cap = f32(cap, state.cap.device)
    cap = (cap.expand(state.cap.shape) if isinstance(cap, torch.Tensor)
           else torch.full_like(state.cap, cap))
    cap = torch.clamp(cap, CAP_MIN, CAP_MAX)
    return dataclasses.replace(
        state, pending_cap=cap,
        pending_ms=torch.full_like(state.pending_ms, ACTUATE_DELAY_MS))


def _decay(dt: float, tau: float) -> float:
    """``1 - exp(-dt / tau)`` in float32, as the reference computes it."""
    e = np.exp(np.float32(-np.float32(dt) / np.float32(tau)))
    return float(np.float32(1.0) - np.float32(e))


def plant_step(state: PlantState, load, dt_ms, *, tau_ms: float = 6.0,
               slew_w_ms: Optional[float] = None,
               noise: Optional[torch.Tensor] = None) -> PlantState:
    """Advance the plant by ``dt_ms`` under per-chip utilisation ``load``.

    ``noise`` takes the place of the reference's ``noise_key``: standard
    normals of the chip shape, added at 0.35 W.  ``dt_ms`` is a Python
    number, so the blend factors are host constants and the step never
    waits for the device.
    """
    dt = float(np.float32(dt_ms))
    pend = torch.clamp(state.pending_ms - dt, min=0.0)
    cap = torch.where(pend <= 0.0, state.pending_cap, state.cap)

    demand = power_model(F_NOMINAL, load)
    target = torch.minimum(demand, cap)
    move = (target - state.power) * _decay(dt, tau_ms)
    if slew_w_ms is not None:
        cap_bound = (state.power > cap) & (target < state.power)
        max_drop = slew_w_ms * state.power * dt
        move = torch.where(cap_bound, torch.maximum(move, -max_drop), move)
    power = state.power + move
    if noise is not None:
        power = power + 0.35 * noise
    power = torch.clamp(power, P_IDLE * 0.9, TDP * 1.02)

    t_inf = T_AMBIENT_INT + R_TH * power
    temp = state.temp + (t_inf - state.temp) * _decay(dt / 1000.0,
                                                        TAU_THERMAL)
    freq = freq_at_cap(cap, clip(f32(load, power.device), 1e-3))
    return PlantState(power=power, cap=cap, pending_cap=state.pending_cap,
                      pending_ms=pend, temp=temp, freq=freq)


# r(f): iterations/s.  matmul ~ linear in clock; inference mostly HBM-bound;
# bursty = duty-cycled matmul.  r0 calibrated to the paper's best-point
# values (2.880 / 0.570 / 0.549 it/J at (150 W, 945 MHz)).
_R0 = {"matmul": 0.0905, "inference": 416.0, "bursty": 0.1186}


def _minimum(a, b):
    """``jnp.minimum`` for tensors or Python numbers."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        dev = device_of(a, b)
        return torch.minimum(tensor(a, dev), tensor(b, dev))
    return min(a, b)


def throughput(workload: str, f_mhz):
    """Iterations per second at SM clock ``f_mhz``."""
    f = f32(f_mhz)
    if workload == "inference":
        return _R0["inference"] * (0.45 + 0.55 * f / F_NOMINAL)
    r = _R0[workload] * f
    if workload == "bursty":
        r = r * BURSTY_DUTY * 2.0 * 0.5  # duty-cycled; idle in denominator
    return r


def iterations_per_joule(workload: str, cap, f_request):
    """Steady-state it/J at a (cap, requested clock) cell of the E1 sweep;
    ``cap`` and ``f_request`` are numbers or broadcastable tensors.

    bursty evaluates its ON phase at full load (the duty cycle is in time,
    not utilisation) and averages idle power into the denominator.
    """
    load = {"matmul": 1.0, "inference": 0.60, "bursty": 1.0}[workload]
    dev = device_of(cap, f_request)
    f_req = f32(f_request, dev)
    cap = f32(cap, dev)
    p_unc = power_model(f_req, load)
    f_eff = where(p_unc > cap, freq_at_cap(cap, load), f_req)
    p_eff = _minimum(power_model(f_eff, load), cap)
    if workload == "bursty":
        r = _R0["bursty"] * f_eff * BURSTY_DUTY
        p_avg = BURSTY_DUTY * p_eff + (1 - BURSTY_DUTY) * (P_IDLE + 15.0)
        return r / p_avg
    return throughput(workload, f_eff) / p_eff


# ---------------------------------------------------------------------------
# The card: drive the plant from a training step's cost
# ---------------------------------------------------------------------------
# The counterpart of the reference's "TPU adaptation", with the H100's own
# peaks (NVIDIA's data sheet, SXM part, dense; rated at the full 700 W
# power limit), not a TPU's.

H100_PEAK_FLOPS = 989e12    # bf16 tensor cores, dense
H100_HBM_BW = 3.35e12       # B/s


def load_from_cost_analysis(flops_per_step: float, bytes_per_step: float,
                            step_time_s: float) -> float:
    """Map a step's roofline occupancy onto plant utilisation:
    L = max(compute occupancy, memory occupancy) against one H100's
    peaks -- the busier unit pins board power, which is what the
    facility meter sees."""
    if step_time_s <= 0:
        return 1.0
    occ_c = flops_per_step / (H100_PEAK_FLOPS * step_time_s)
    occ_m = bytes_per_step / (H100_HBM_BW * step_time_s)
    return float(np.clip(max(occ_c, occ_m), 0.0, 1.0))


def attention_pairs(seq: int, window: int = 0) -> int:
    """(row, column) pairs one head's causal (and windowed) attention
    needs over a sequence."""
    if window <= 0 or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def train_step_cost(cfg, batch: int, seq: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one training step of a dense-family ``cfg`` on
    (batch, seq) tokens, from the config's shapes.

    FLOPs: 6 N T for the weight products (N the weights that enter a
    matrix product -- the projections, the MLP and the (tied) unembedding;
    T = batch x seq tokens) plus 3 x the attention forward's 4 B H D per
    visible pair per layer (the backward's products being twice the
    forward's; the plain attention computes all seq^2 pairs).  Bytes: AdamW's float32 traffic, each
    parameter, gradient and both moments read once and the parameter and
    moments written once (28 bytes per parameter).
    """
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    qf, kf = h * hd, cfg.n_kv_heads * hd
    per_layer = d * qf + 2 * d * kf + qf * d + 3 * d * cfg.d_ff
    n_mm = cfg.num_layers * per_layer + cfg.padded_vocab * d
    tokens = batch * seq
    pairs = attention_pairs(seq, cfg.sliding_window)
    attn = 3 * 4 * batch * h * hd * pairs * cfg.num_layers
    return 6.0 * n_mm * tokens + attn, 28.0 * cfg.param_count()
