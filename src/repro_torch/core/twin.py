"""Cluster digital twin, the pieces the engine runs: the port of
``repro.core.twin`` (host-load synthesis, the 1 Hz carry and tick).

At the 1 Hz tick, Tier-2 predicts each host's next-second power with
AR(4)/RLS and rebalances the per-chip caps inside the host envelope;
Tier-1 and the plant are quasi-static over the second (the PID settles
in < 30 ms, which ``pid_rollout_grid`` checks); an FFR activation sheds
the envelope to (mu - rho).  Every function carries a leading scenario
axis N: hosts are (N, H), chips (N, H, C).

Randomness is counter-based (``repro_torch.random``), keyed by the
scenario seed: the demand noise of hour ``b`` and the plant noise of
second ``t`` are the same numbers in any batch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

import repro_torch.core.ar4 as ar4_lib
import repro_torch.core.plant as plant_lib
import repro_torch.core.pue as pue_lib
import repro_torch.random as rnd
from repro_torch._num import const

LOAD_BLOCK_S = 3600
IDLE_FLOOR_W = 53.0   # FFR deep shed: P_idle + min clocks


class TwinMetrics(NamedTuple):
    host_power: torch.Tensor       # (N, H) W
    host_pred: torch.Tensor        # (N, H) W  Tier-2 one-step-ahead
    ar4_abs_err: torch.Tensor      # (N, H) W  a-priori |err|
    chip_power_mean: torch.Tensor  # (N,)
    chip_power_p95: torch.Tensor   # (N,)
    envelope: torch.Tensor         # (N,) W cluster envelope setpoint
    it_power: torch.Tensor         # (N,) W cluster IT power
    facility_power: torch.Tensor   # (N,) W at the meter
    ffr_active: torch.Tensor       # (N,) bool
    tracking_err: torch.Tensor     # (N,) |it - envelope| / envelope


class HostLoadParams(NamedTuple):
    """Per-scenario constants of the counter-based 1 Hz load synthesis."""

    mean: torch.Tensor        # (H,) archetype mean utilisation
    fast_sigma: torch.Tensor  # (H,) white-noise sigma
    slow_sigma: torch.Tensor  # (H,) band-limited wander sigma
    phases: torch.Tensor      # (N, H, 4) slow-wave phase offsets
    is_bursty: torch.Tensor   # (H,) bool: duty-cycled archetype
    duty_phase: torch.Tensor  # (H,) bursty duty-cycle phase offset
    jitter_ph: torch.Tensor   # (N, H) bursty edge-jitter phase
    seed: torch.Tensor        # (N,) int64: keys each block's white noise


def _host_kinds(n_hosts: int) -> np.ndarray:
    """Archetype mix: 50 % matmul-like, 30 % inference, 20 % bursty."""
    return np.array([0] * (n_hosts // 2)
                    + [1] * (3 * n_hosts // 10)
                    + [2] * (n_hosts - n_hosts // 2 - 3 * n_hosts // 10))


def host_load_params(n_hosts: int, seeds: torch.Tensor) -> HostLoadParams:
    """(N,) scenario seeds -> the constants of the per-second synthesis."""
    dev = seeds.device
    kinds = _host_kinds(n_hosts)
    stats = np.array([[plant_lib._ARCHETYPES[w][f] for w in
                       ("matmul", "inference", "bursty")]
                      for f in ("mean", "fast_sigma", "slow_sigma")],
                     np.float32)[:, kinds]
    sd = seeds[:, None]
    phases = rnd.uniform(sd[:, :, None], rnd.LOAD_PHASE, 0,
                         rnd.lanes((n_hosts, 4), dev)) * (2 * math.pi)
    jitter = rnd.uniform(sd, rnd.LOAD_JITTER, 0,
                         rnd.lanes((n_hosts,), dev)) * 6.28

    def t(x, dtype=torch.float32):
        return const(x, dev, dtype)

    return HostLoadParams(
        mean=t(stats[0]), fast_sigma=t(stats[1]), slow_sigma=t(stats[2]),
        phases=phases, is_bursty=t(kinds == 2, torch.bool),
        duty_phase=t(np.asarray(kinds * 0.37, np.float32)),
        jitter_ph=jitter, seed=seeds)


def host_loads_rows(p: HostLoadParams, tf: torch.Tensor,
                    fast: torch.Tensor) -> torch.Tensor:
    """Absolute seconds, (K,) shared by the N scenarios or (N, K) per
    scenario, + (N, K, H) white noise -> (N, K, H) demand rows:
    slow-wave wander, white noise and the bursty duty cycle."""
    tf = tf if tf.dim() == 2 else tf[None]                      # (1|N, K)
    freqs = const(np.float32(plant_lib.SLOW_FREQS_HZ), tf.device)
    ang = 2 * math.pi * freqs * tf[..., None]                   # (., K, 4)
    s_t, c_t = torch.sin(ang), torch.cos(ang)
    ph = p.phases[:, None]                                      # (N,1,H,4)
    slow = ((s_t[:, :, None] * torch.cos(ph)).sum(-1)
            + (c_t[:, :, None] * torch.sin(ph)).sum(-1)) / 2.0
    base = p.mean + p.slow_sigma * slow + p.fast_sigma * fast   # (N, K, H)
    ang_j = 2 * math.pi * plant_lib.BURSTY_JITTER_FREQ_HZ * tf  # (., K)
    jph = p.jitter_ph[:, None, :]
    jit_t = plant_lib.BURSTY_EDGE_JITTER_S * (
        torch.sin(ang_j)[..., None] * torch.cos(jph)
        + torch.cos(ang_j)[..., None] * torch.sin(jph))
    frac = torch.remainder((tf[..., None] + jit_t)
                           / plant_lib.BURSTY_PERIOD_S + p.duty_phase, 1.0)
    on = frac < plant_lib.BURSTY_DUTY
    bursty = torch.where(on, base, plant_lib.BURSTY_LOW + 0.01 * fast)
    return torch.clamp(torch.where(p.is_bursty, bursty, base), 0.0, 1.0)


def host_loads_block(p: HostLoadParams, b: int) -> torch.Tensor:
    """The (N, LOAD_BLOCK_S, H) demand rows of hour block ``b``."""
    dev = p.seed.device
    H = p.mean.shape[-1]
    tf = float(b * LOAD_BLOCK_S) + torch.arange(
        LOAD_BLOCK_S, dtype=torch.float32, device=dev)
    fast = rnd.normal(p.seed[:, None, None], rnd.LOAD_NOISE, b,
                      rnd.lanes((LOAD_BLOCK_S, H), dev))
    return host_loads_rows(p, tf, fast)


def host_loads_trace(n_hosts: int, n_seconds: int,
                     seeds: torch.Tensor) -> torch.Tensor:
    """Materialised (N, T, H) trace: the blocks of :func:`host_loads_block`
    concatenated."""
    p = host_load_params(n_hosts, seeds)
    nb = -(-n_seconds // LOAD_BLOCK_S)
    blocks = [host_loads_block(p, b) for b in range(nb)]
    return torch.cat(blocks, dim=1)[:, :n_seconds]


def plant_noise(seeds: torch.Tensor, t0, k: int, n_hosts: int,
                chips_per_host: int) -> torch.Tensor:
    """(N, k, H, C) standard normals of seconds t0..t0+k-1: the plant
    noise the twin tick adds at 2 W, keyed by (seed, second, chip).
    ``t0`` is an int for every scenario or an (N,) tensor, one start
    second per scenario."""
    dev = seeds.device
    if isinstance(t0, torch.Tensor):
        t = t0.to(dev, torch.int64)[:, None] + torch.arange(
            k, dtype=torch.int64, device=dev)
    else:
        t = torch.arange(t0, t0 + k, dtype=torch.int64, device=dev)[None]
    return rnd.normal(seeds[:, None, None, None], rnd.PLANT_NOISE,
                      t[:, :, None, None],
                      rnd.lanes((n_hosts, chips_per_host), dev))


def live_load_noise(seeds: torch.Tensor, t: torch.Tensor,
                    n_hosts: int) -> torch.Tensor:
    """(N, H) white noise of each scenario's own second ``t`` (N,): the
    online service's per-second demand draw, keyed by (seed, second,
    host).  The rollout draws a whole hour block at once instead
    (:func:`host_loads_block`)."""
    return rnd.normal(seeds[:, None], rnd.SERVICE_LOAD, t[:, None],
                      rnd.lanes((n_hosts,), seeds.device))


def twin_carry_init(n: int, n_hosts: int, chips_per_host: int, device):
    """Initial Tier-2 + plant carry of N scenarios: (rls, chip_power,
    caps)."""
    rls0 = ar4_lib.init_rls((n, n_hosts), device=device)
    shape = (n, n_hosts, chips_per_host)
    chip_power0 = torch.full(shape, plant_lib.P_IDLE, dtype=torch.float32,
                             device=device)
    caps0 = torch.full(shape, plant_lib.CAP_MAX, dtype=torch.float32,
                       device=device)
    return rls0, chip_power0, caps0


def twin_tick(n_hosts: int, chips_per_host: int, chip_tdp: float,
              pue_design, carry, load_h, mu, rho, ffr, t_amb, noise):
    """The 1 Hz fused Tier-2/Tier-1/plant update for one second of N
    scenarios.  ``load_h`` (N, H); ``mu``, ``rho``, ``ffr``, ``t_amb``,
    ``pue_design`` (N,); ``noise`` (N, H, C) standard normals.
    Returns (carry, TwinMetrics row)."""
    H, C = n_hosts, chips_per_host
    design_host = C * chip_tdp
    design_it_w = H * design_host
    rls, chip_power, caps = carry

    frac = torch.where(ffr, mu - rho, mu)
    envelope = frac * design_it_w
    host_env = (frac * design_host)[:, None].expand(-1, H)
    load_h = load_h * torch.where(
        ffr, frac / torch.clamp(mu, min=1e-3), 1.0)[:, None]

    pred = ar4_lib.predict(rls) * design_host
    caps = ar4_lib.host_rebalance(
        pred, host_env, torch.clamp(chip_power, min=plant_lib.P_IDLE),
        plant_lib.CAP_MIN, plant_lib.CAP_MAX)

    demand = plant_lib.power_model(plant_lib.F_NOMINAL,
                                   load_h[..., None]) + 2.0 * noise
    target = torch.minimum(demand, caps)
    shed_target = torch.minimum(
        torch.clamp(frac * chip_tdp, min=IDLE_FLOOR_W)[:, None, None], caps)
    target = torch.where(ffr[:, None, None],
                         torch.minimum(target, shed_target), target)
    chip_power = target

    host_power = chip_power.sum(-1)
    rls, abs_err_norm = ar4_lib.rls_update(rls, host_power / design_host)
    abs_err = abs_err_norm * design_host

    it = host_power.sum(-1)
    L = it / design_it_w
    fac = it * pue_lib.pue(L, t_amb, pue_design=pue_design)
    track = torch.abs(it - envelope) / torch.clamp(envelope, min=1.0)
    flat = chip_power.reshape(chip_power.shape[0], -1)
    out = TwinMetrics(
        host_power=host_power, host_pred=pred, ar4_abs_err=abs_err,
        chip_power_mean=flat.mean(-1),
        chip_power_p95=torch.quantile(flat, 0.95, dim=-1),
        envelope=envelope, it_power=it, facility_power=fac,
        ffr_active=ffr, tracking_err=track)
    return (rls, chip_power, caps), out
