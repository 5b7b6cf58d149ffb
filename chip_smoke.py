#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure ends the run with a
nonzero exit and no result line:

  build       compile every CUDA kernel of the port with nvcc (sm_90a)
              into build/kernels/
  kernel      each kernel against its plain torch version on the card at
              the main path's shapes, with its device time and the plain
              version's taken with a cold L2 (inputs cycled through more
              than the L2 holds), and the least time the card could take
              moving those bytes through HBM (the bound); the L2-warm
              time beside them
  tier1       the Tier-1 closed loop: pid_rollout_grid over the (4 targets
              x 3 loads) product, 32768 chips per cell (a ~10 MW site of
              300 W chips), 200 ticks = 1 s of the 200 Hz loop; counts the
              pid_update launches and checks that every cell settles to
              min(demand, target)
  engine      engine_rollout(reduce="summary") on the full E9 batch (288
              scenarios, 6 countries x 3 seeds x 2 products x 4 bands x 2
              event draws) over 24 h, or the longest whole number of hours
              the time budget allows (printed as a cut); then 100 ticks of
              engine_step with the host-sync detector set to raise
  cpu_vs_gpu  6 scenarios over 1 h on the CPU and on the card, with the
              same frequency, demand and plant-noise inputs
  sweep       engine_sweep over the 6 E9-fast specs in chunks of 5 against
              the monolithic rollout

Then a {"kernels": [...]} line, the card's name and power limit as
nvidia-smi reports them, and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
L2_BYTES = 50 * 2**20              # H100 SXM, where torch does not report it
ENGINE_BUDGET_S = 240.0            # wall time the 24 h rollout may spend
KERNEL_TOL = dict(atol=1e-4, rtol=1e-5)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(torch, fn, reps=100):
    """Median device time of one call of ``fn`` over ``reps`` calls, each
    between its own pair of CUDA events."""
    for _ in range(10):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profile_calls(torch, fn, reps):
    """Run ``fn`` ``reps`` times under torch.profiler (CUPTI): device time
    and kernel launches per call, and the five ops with the most host
    time (inflated by the profiler; for ranking only)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)

    kernels = [e for e in ev if e.device_type == cuda]
    top = sorted((e for e in ev if e.key.startswith("aten::")),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:5]
    return {
        "device_us_per_call": sum(dev_us(e) for e in kernels) / reps,
        "launches_per_call": sum(e.count for e in kernels) / reps,
        "kernels": {e.key[:60]: dev_us(e) / max(e.count, 1)
                    for e in sorted(kernels, key=dev_us, reverse=True)[:3]},
        "top_host_ops_us": {e.key: e.self_cpu_time_total / reps
                            for e in top},
    }


def all_finite(torch, tree) -> bool:
    if isinstance(tree, dict):
        return all(all_finite(torch, v) for v in tree.values())
    if isinstance(tree, tuple):
        return all(all_finite(torch, v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return bool(torch.isfinite(tree).all())
    return True


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    paths = _build.build_all(names)
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in _build.PTXAS_REPORT.items()}
    emit({"phase": "build", "kernels": names,
          "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(str(v), ROOT)
                        for k, v in paths.items()},
          "ptxas": ptxas})


def phase_kernel(torch):
    from repro_torch.core.pid import GAINS
    from repro_torch.kernels import pid_update as pk
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    for n in (7, 1024, 2500, 393_216):
        def u(lo, hi):
            return lo + (hi - lo) * torch.rand(n, device="cuda",
                                               generator=g)
        args = (u(100, 300), u(50, 310), u(30, 95), u(-60, 60), u(-50, 50))
        got = pk.pid_update(*args, GAINS)
        want = pk.pid_update_ref(*args, GAINS)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **KERNEL_TOL)
        worst = max(worst, err)
        rows.append({"n": n, "max_abs_err": err})
    launch_ms = cuda_time_ms(torch, lambda: pk.pid_update(*args, GAINS))
    plain_launch_ms = cuda_time_ms(
        torch, lambda: pk.pid_update_ref(*args, GAINS))
    n = args[0].numel()
    # Cold-L2 device time, to match the HBM bound: each call reads the
    # next of enough input sets that four L2s of traffic pass between two
    # reads of one set, and writes fresh outputs (kept alive, so the
    # allocator cannot hand back lines still in L2).
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 L2_BYTES)
    k = math.ceil(4 * l2 / (32 * n))
    sets = [tuple(torch.rand(n, device="cuda", generator=g) * 100 + 100
                  for _ in range(5)) for _ in range(k)]
    kept = []

    def cold(f):
        turn = itertools.count()

        def call(_i=0):
            kept.append(f(*sets[next(turn) % k], GAINS))
        return call

    prof_k = profile_calls(torch, cold(pk.pid_update), 100)
    kept.clear()
    prof_p = profile_calls(torch, cold(pk.pid_update_ref), 100)
    kept.clear()
    prof_w = profile_calls(torch, lambda i=0: pk.pid_update(*args, GAINS),
                           100)
    ms = prof_k["device_us_per_call"] / 1e3
    plain_ms = prof_p["device_us_per_call"] / 1e3
    bound_ms = 32.0 * n / HBM_BYTES_PER_S * 1e3
    rec = {"name": "pid_update", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/pid_update.cu",
           "replaces": "src/repro/kernels/pid_update.py:75",
           "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
           "n": n}
    emit({"phase": "kernel", "name": "pid_update", "checks": rows,
          "tol": KERNEL_TOL, "n": n, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": "bytes", "cold_sets": k,
          "l2_warm_ms": prof_w["device_us_per_call"] / 1e3,
          "launch_ms": launch_ms, "plain_launch_ms": plain_launch_ms,
          "plain_launches_per_call": prof_p["launches_per_call"],
          "library": "no single PyTorch call computes this function"})
    return rec


def phase_tier1(torch):
    import repro_torch.core.pid as pid
    import repro_torch.core.plant as plant
    from repro_torch.kernels.pid_update import pid_update
    targets_w, loads = (120.0, 180.0, 240.0, 300.0), (0.6, 0.8, 0.97)
    S, H, n, T = len(targets_w), len(loads), 32_768, 200
    dev = torch.device("cuda")

    def grid(x):
        return x.expand(S, H, n).contiguous()

    st = pid.PIDState(*(grid(x) for x in pid.init_pid(n, 250.0,
                                                      device=dev)))
    p0 = plant.init_plant(n, cap=300.0, device=dev)
    pl = plant.PlantState(**{k: grid(v) for k, v in vars(p0).items()})
    tg = torch.tensor(targets_w, device=dev)[:, None, None, None].expand(
        S, H, T, n)
    ld = torch.tensor(loads, device=dev)[None, :, None, None].expand(
        S, H, T, n)
    # warm-up on the first ticks (first launches of each op), not counted
    pid.pid_rollout_grid(st, pl, tg[:, :, :5], ld[:, :, :5], device=dev)
    torch.cuda.synchronize()
    pid_update.launches = 0
    t0 = time.perf_counter()
    _, _, trace = pid.pid_rollout_grid(st, pl, tg, ld, tau_ms=6.0,
                                       device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pid_update.launches
    if launches != T:
        raise RuntimeError(f"pid_update launched {launches} times in "
                           f"{T} ticks")
    final = trace[:, :, -1, :]
    demand = plant.power_model(plant.F_NOMINAL,
                               torch.tensor(loads, device=dev))
    expect = torch.minimum(demand[None, :],
                           torch.tensor(targets_w, device=dev)[:, None])
    torch.testing.assert_close(final, expect[:, :, None].expand_as(final),
                               rtol=0.02, atol=4.0)
    tail = (trace[:, :, -20:, :] - final[:, :, None, :]).abs().max()
    if float(tail) >= 4.0:
        raise RuntimeError(f"Tier-1 cells still move {float(tail)} W")
    emit({"phase": "tier1", "cells": [S, H], "chips_per_cell": n,
          "ticks": T, "launches": launches,
          "settled_w": final[:, :, 0].tolist(),
          "expect_w": expect.tolist(), "ms_per_tick": wall / T * 1e3,
          "wall_s": wall})
    return launches


def e9_specs(hours):
    from repro_torch.grid.scenarios import product_specs
    from repro_torch.grid.signals import COUNTRY_ORDER
    return product_specs(countries=tuple(COUNTRY_ORDER), seeds=(0, 1, 2),
                         horizon_h=hours, products=("FFR", "FCR-D"),
                         reserve_rhos=(0.0, 0.1, 0.2, 0.3),
                         event_seeds=(0, 1))


def phase_engine(torch):
    import repro_torch.core.engine as eng
    import repro_torch.core.twin as twin
    from repro_torch.grid.scenarios import build_scenario_batch
    cfg = eng.EngineConfig(n_hosts=2, chips_per_host=2, e_max=24,
                           events_per_day=4.0)
    # rate probe: one simulated hour of the full batch
    probe = build_scenario_batch(e9_specs(1), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.engine_rollout(cfg, probe, device="cuda")
    torch.cuda.synchronize()
    s_per_h = time.perf_counter() - t0
    hours = max(1, min(24, int(ENGINE_BUDGET_S // s_per_h)))
    batch = build_scenario_batch(e9_specs(hours), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.engine_rollout(cfg, batch, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all_finite(torch, out):
        raise RuntimeError("engine_rollout produced a non-finite output")
    n_events = int(out["n_events"].sum())
    if n_events <= 0:
        raise RuntimeError("no reserve event in the E9 batch")
    # the tick under the host-sync detector: any wait on the device raises
    params, _, _ = eng.engine_params(cfg, probe)
    state = eng.engine_init(cfg, probe.seed, device="cuda")
    lp = twin.host_load_params(cfg.n_hosts, probe.seed)
    rows = twin.host_loads_block(lp, 0)
    below = torch.zeros(probe.n, dtype=torch.bool, device="cuda")
    in_hor = torch.ones(probe.n, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(100):
            state, _ = eng.engine_step(cfg, params, state,
                                       (rows[:, t], below, in_hor, t))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # where a tick's time goes: 100 ticks under the profiler, their plant
    # noise drawn beforehand in one block as the rollout draws it per hour
    box = [state]
    noise = twin.plant_noise(probe.seed, 0, 100, cfg.n_hosts,
                             cfg.chips_per_host)

    def tick(t=0):
        box[0], _ = eng.engine_step(cfg, params, box[0],
                                    (rows[:, t], below, in_hor, t),
                                    noise=noise[:, t])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(100):
        tick(t)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 100 * 1e3
    prof = profile_calls(torch, tick, 100)
    tick_ms = wall / (hours * 3600) * 1e3
    emit({"phase": "engine", "scenarios": batch.n, "hours": hours,
          "cut": None if hours == 24 else
          f"horizon cut from 24 h to {hours} h by the time budget",
          "probe_s_per_hour": s_per_h, "wall_s": wall,
          "s_per_sim_hour": wall / hours,
          "ms_per_tick": tick_ms,
          "engine_step_ms": step_ms,
          "engine_step_device_busy_share":
              prof["device_us_per_call"] / 1e3 / step_ms,
          "tick_profile": prof,
          "n_events": n_events,
          "compliance": int(out["n_compliant"].sum()) / n_events,
          "net_eur": float(out["net_eur"].sum()),
          "it_mwh": float(out["it_mwh"].sum()),
          "sync_free_ticks": 100})


CPU_VS_GPU_TOL = {"energy": 1e-3, "rls": 2e-2}


def fast_specs():
    """The 6 E9-fast scenarios (SE/DE/PL x bands 0/0.2, FFR) over 1 h.
    Event draw 7 is the first whose trace crosses the FFR trigger inside
    the hour at 24 events/day, so the event paths are exercised."""
    from repro_torch.grid.scenarios import product_specs
    return product_specs(countries=("SE", "DE", "PL"), seeds=(0,),
                         horizon_h=1, products=("FFR",),
                         reserve_rhos=(0.0, 0.2), event_seeds=(7,))


def phase_cpu_vs_gpu(torch):
    import repro_torch.core.engine as eng
    import repro_torch.core.twin as twin
    from repro_torch.grid import frequency
    from repro_torch.grid.scenarios import (build_scenario_batch,
                                            frequency_seeds)
    cfg = eng.EngineConfig(n_hosts=2, chips_per_host=2, e_max=24,
                           events_per_day=24.0)
    specs = fast_specs()
    cpu_b = build_scenario_batch(specs, device="cpu")
    T = cpu_b.h_max * 3600
    freq, _ = frequency.synthesize_frequency_batch(
        frequency_seeds(cpu_b), cpu_b.product_idx, n_seconds=T,
        events_per_day=cfg.events_per_day, device="cpu")
    loads = eng.base_loads(cfg, cpu_b)
    noise = twin.plant_noise(cpu_b.seed, 0, T, cfg.n_hosts,
                             cfg.chips_per_host)
    kw = dict(reduce="summary", freq=freq, loads=loads, noise=noise)
    a = eng.engine_rollout(cfg, cpu_b, device="cpu", **kw)
    b = eng.engine_rollout(cfg, cpu_b, device="cuda", **kw)
    worst = {}
    for k, tol in (("it_mwh", "energy"), ("fac_mwh", "energy"),
                   ("net_eur", "energy"), ("capacity_eur", "energy"),
                   ("mean_mu", "energy"), ("chip_power_mean", "energy"),
                   ("tokens_mtok", "energy"), ("ar4_mae_norm", "rls"),
                   ("tracking_err_mean", "rls")):
        x, y = a[k].double(), b[k].cpu().double()
        torch.testing.assert_close(y, x, rtol=CPU_VS_GPU_TOL[tol], atol=0.0)
        worst[k] = float(((y - x).abs() / x.abs().clamp(min=1e-12)).max())
    for k in ("n_events", "n_compliant", "active_s"):
        if not torch.equal(a[k], b[k].cpu()):
            raise RuntimeError(f"cpu vs gpu: {k} differs")
    if not torch.equal(a["events"].t_event_s, b["events"].t_event_s.cpu()):
        raise RuntimeError("cpu vs gpu: event trigger seconds differ")
    emit({"phase": "cpu_vs_gpu", "scenarios": cpu_b.n, "hours": 1,
          "n_events": int(a["n_events"].sum()), "max_rel_err": worst,
          "tol": CPU_VS_GPU_TOL})


def phase_sweep(torch):
    import repro_torch.core.engine as eng
    from repro_torch.grid.scenarios import build_scenario_batch
    cfg = eng.EngineConfig(n_hosts=2, chips_per_host=2, e_max=24,
                           events_per_day=24.0)
    specs = fast_specs()
    swept = eng.engine_sweep(cfg, specs, chunk_size=5, device="cuda")
    batch = build_scenario_batch(specs, device="cuda")
    mono = eng.sweep_finalize(eng.chunk_summary(
        cfg, eng.engine_rollout(cfg, batch, device="cuda"), batch))
    worst = 0.0
    for k, v in mono.items():
        if isinstance(v, dict):
            continue
        d = abs(swept[k] - v) / max(abs(v), 1e-9)
        if d > 1e-5 and abs(swept[k] - v) > 1e-6:
            raise RuntimeError(f"sweep vs monolithic: {k} {swept[k]} {v}")
        worst = max(worst, d)
    emit({"phase": "sweep", "specs": len(specs), "chunk_size": 5,
          "max_rel_err": worst, "net_eur": swept["net_eur"],
          "n_events": swept["n_events"]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    phase_build()
    kernel_rec = phase_kernel(torch)
    kernel_rec["launches"] = phase_tier1(torch)
    phase_engine(torch)
    phase_cpu_vs_gpu(torch)
    phase_sweep(torch)
    emit({"kernels": [kernel_rec]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
