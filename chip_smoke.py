#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure ends the run with a
nonzero exit and no result line:

  build       compile every CUDA kernel of the port with nvcc (sm_90a)
              into build/kernels/, one nvcc per source, all at once
  kernel      each kernel against its plain torch version on the card at
              the main path's shapes, with its device time and the plain
              version's taken with a cold L2 (inputs cycled through more
              than the L2 holds), and the least time the card could take
              for the work (the bound); pid_update's L2-warm time; for
              flash_attention the time of one PyTorch call computing the
              same function (scaled_dot_product_attention, a yardstick
              the port never calls), also at zamba2-2.7b's head dim 80;
              ssd_scan at the reference's test shapes and at both
              full-width prefill calls (mamba2-1.3b, zamba2-2.7b) in f32
              and bf16, against its plain version and the sequential
              recurrence (no PyTorch call computes the SSD scan)
  tier1       the Tier-1 closed loop: pid_rollout_grid over the (4 targets
              x 3 loads) product, 32768 chips per cell (a ~10 MW site of
              300 W chips), 200 ticks = 1 s of the 200 Hz loop; counts the
              pid_update launches and checks that every cell settles to
              min(demand, target)
  prefill     Model.forward of qwen2-1.5b at full width (random weights
              from a seed, bf16 compute) on (2, 4096) tokens, last_only:
              ms per forward, peak memory, exactly 28 flash_attention
              launches, finite logits
  decode_vs_forward
              the same weights in f32 at B = 2, S = 64: teacher-forced
              decode_step logits against the full forward's (2e-3)
  serve       run_serve at full qwen2-1.5b width, 8 requests, 32 prompt
              and 32 decode tokens, GridPilot on: the FFR shed at decode
              step 16 with its trigger-to-thinning time under 700 ms
  prefill_ssm, decode_vs_forward_ssm, serve (mamba2-1.3b)
              the same three at full mamba2-1.3b width and depth: exactly
              48 ssd_scan launches per forward; decode against forward at
              S = 256 (a multiple of the 256-token SSD chunk)
  prefill_hybrid, decode_vs_forward_hybrid
              zamba2-2.7b at full width and depth: exactly 54 ssd_scan and
              9 flash_attention launches per forward; decode against
              forward at S = 256
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
TENSOR_CORE_BF16_FLOP_S = 989e12   # H100 SXM data sheet, dense
FP32_FLOP_S = 67e12                # H100 SXM data sheet, outside tensor cores
# flash_attention against its plain version: the reference's kernel
# tolerances (tests/test_kernels.py), f32 held to 1e-4 at S >= 1000
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}
FLASH_TOL_LONG_F32 = dict(atol=1e-4, rtol=1e-4)
PREFILL_SHAPE = (2, 4096, 12, 2, 128)    # qwen2-1.5b's heads at S = 4096
ZAMBA2_ATTN_SHAPE = (2, 4096, 32, 32, 80)  # zamba2-2.7b's shared block
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)  # tests/test_models.py
# ssd_scan: the reference's kernel tolerances (tests/test_kernels.py)
SSD_TOL = {"chunked": dict(atol=1e-4, rtol=1e-4),
           "oracle": dict(atol=5e-4, rtol=5e-3),
           "bfloat16": dict(atol=0.15, rtol=0.1)}
# (b, s, nh, hd, ds, chunk) of the prefill's calls at (2, 4096) tokens
SSD_PREFILL = {"mamba2-1.3b": (2, 4096, 64, 64, 128, 256),
               "zamba2-2.7b": (2, 4096, 80, 64, 64, 256)}


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


def profile_calls(torch, fn, reps, match=()):
    """Run ``fn`` ``reps`` times under torch.profiler (CUPTI): device time
    and kernel launches per call, the device time per call of the kernels
    whose name holds each string of ``match``, and the five ops with the
    most host time (inflated by the profiler; for ranking only)."""
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
        "matched_us_per_call": {m: sum(dev_us(e) for e in kernels
                                       if m in e.key) / reps
                                for m in match},
        "launches_per_call": sum(e.count for e in kernels) / reps,
        "kernels": {e.key[:60]: dev_us(e) / max(e.count, 1)
                    for e in sorted(kernels, key=dev_us, reverse=True)[:5]},
        "top_host_ops_us": {e.key: e.self_cpu_time_total / reps
                            for e in top},
    }


def cycled(sets, f, kept):
    """A call of ``f`` on the next of ``sets`` each time (the cold-L2
    pattern), its output kept alive so the allocator cannot hand back
    lines still in L2."""
    turn = itertools.count()

    def call(_i=0):
        kept.append(f(*sets[next(turn) % len(sets)]))
    return call


def l2_bytes(torch) -> int:
    return getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                   L2_BYTES)


def all_finite(torch, tree) -> bool:
    if isinstance(tree, dict):
        return all(all_finite(torch, v) for v in tree.values())
    if isinstance(tree, tuple):
        return all(all_finite(torch, v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return bool(torch.isfinite(tree).all())
    return True


def phase_build():
    import torch
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
          "ptxas": ptxas, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda})


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
    k = math.ceil(4 * l2_bytes(torch) / (32 * n))
    sets = [tuple(torch.rand(n, device="cuda", generator=g) * 100 + 100
                  for _ in range(5)) + (GAINS,) for _ in range(k)]
    kept = []
    prof_k = profile_calls(torch, cycled(sets, pk.pid_update, kept), 100)
    kept.clear()
    prof_p = profile_calls(torch, cycled(sets, pk.pid_update_ref, kept),
                           100)
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


def flash_cases():
    """(shape (B, S, H, Hkv, D), dtype name, window) of the kernel check:
    the reference's test shapes in both dtypes, its windows, the padded
    head_dim-128 GQA case, the prefill shape and zamba2-2.7b's shared
    block (head dim 80, window 4096)."""
    cases = [(shape, dt, 0) for shape in ((1, 128, 4, 4, 32),
                                          (2, 256, 4, 2, 64),
                                          (1, 256, 8, 1, 64),
                                          (2, 192, 6, 3, 16))
             for dt in ("float32", "bfloat16")]
    cases += [((1, 256, 2, 2, 32), "float32", w) for w in (32, 64, 100)]
    cases += [((1, 1000, 12, 2, 128), "float32", 0),
              (PREFILL_SHAPE, "bfloat16", 0),
              (ZAMBA2_ATTN_SHAPE, "bfloat16", 4096)]
    return cases


def flash_inputs(torch, g, shape, dtype):
    b, s, h, hkv, d = shape
    return tuple(torch.randn(b, s, n, d, device="cuda", generator=g)
                 .to(dtype) for n in (h, hkv, hkv))


def flash_bound_ms(shape, dtype, window=0):
    """The least time of one causal call: 4 B H D flop per visible
    (row, col) pair at the dtype's peak, against reading q, k, v once and
    writing o once at the HBM rate; the larger of the two."""
    b, s, h, hkv, d = shape
    rows = range(s)
    pairs = sum(min(i + 1, window) if window else i + 1 for i in rows)
    flops = 4.0 * b * h * d * pairs
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * b * s * d * (2 * h + 2 * hkv)
    peak = TENSOR_CORE_BF16_FLOP_S if dtype == "bfloat16" else FP32_FLOP_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes", flops, nbytes


def time_flash(torch, g, shape, window):
    """Cold-L2 device times at one bf16 shape (enough input sets that four
    L2s of traffic pass between two reads of one set): the kernel, its
    plain version and scaled_dot_product_attention on (B, H, S, D) copies
    laid out before the clock starts."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    q, k, v = flash_inputs(torch, g, shape, torch.bfloat16)
    set_bytes = sum(x.numel() * x.element_size() for x in (q, k, v))
    n_sets = math.ceil(4 * l2_bytes(torch) / set_bytes)
    sets = [flash_inputs(torch, g, shape, torch.bfloat16)
            for _ in range(n_sets)]
    sdpa_sets = [tuple(x.transpose(1, 2).contiguous() for x in st)
                 for st in sets]
    if 0 < window < shape[1]:
        raise ValueError("the causal SDPA yardstick computes the same "
                         "function only for a window of 0 or >= S")

    def kernel(q, k, v):
        return fa.flash_attention(q, k, v, causal=True, window=window)

    def plain(q, k, v):
        return fa.flash_attention_ref(q, k, v, causal=True, window=window)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    kept = []
    prof_k = profile_calls(torch, cycled(sets, kernel, kept), 20)
    kept.clear()
    prof_p = profile_calls(torch, cycled(sets, plain, kept), 3)
    kept.clear()
    prof_l = profile_calls(torch, cycled(sdpa_sets, sdpa, kept), 20)
    kept.clear()
    bound_ms, bound_by, flops, nbytes = flash_bound_ms(shape, "bfloat16",
                                                       window)
    ms = prof_k["device_us_per_call"] / 1e3
    return {"shape": list(shape), "dtype": "bfloat16", "window": window,
            "ms": ms, "plain_ms": prof_p["device_us_per_call"] / 1e3,
            "library_ms": prof_l["device_us_per_call"] / 1e3,
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6, "tflop_s": flops / (ms * 1e-3) / 1e12,
            "cold_sets": n_sets,
            "plain_launches_per_call": prof_p["launches_per_call"],
            "library_kernels": prof_l["kernels"]}


def phase_flash_kernel(torch):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(1)
    checks, worst = [], 0.0
    for shape, dt, window in flash_cases():
        dtype = getattr(torch, dt)
        q, k, v = flash_inputs(torch, g, shape, dtype)
        got = fa.flash_attention(q, k, v, causal=True, window=window)
        want = fa.flash_attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        tol = FLASH_TOL_LONG_F32 if dt == "float32" and shape[1] >= 1000 \
            else FLASH_TOL[dt]
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), **tol)
        worst = max(worst, err)
        checks.append({"shape": list(shape), "dtype": dt, "window": window,
                       "max_abs_err": err, "tol": tol})
        del q, k, v, got, want
    torch.cuda.empty_cache()
    t = time_flash(torch, g, PREFILL_SHAPE, 0)
    d80 = time_flash(torch, g, ZAMBA2_ATTN_SHAPE, ZAMBA2_ATTN_SHAPE[1])
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:139",
           "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
           "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
           "library_ms": t["library_ms"], "shape": list(PREFILL_SHAPE),
           "dtype": "bfloat16"}
    emit({"phase": "kernel", "name": "flash_attention", "checks": checks,
          **t, "library": "torch.nn.functional.scaled_dot_product_attention("
                          "is_causal=True, enable_gqa=True) on (B, H, S, D)",
          "head_dim_80": d80})
    return rec


def ssd_inputs(torch, g, b, s, nh, hd, ds, dtype):
    """x, dt = softplus(N), A = -exp(0.5 N), B, C as the reference's kernel
    tests draw them; x, B and C in ``dtype`` (B and C as the model passes
    them: halves of one (b, s, 2 ds) projection), dt and A float32."""
    def n(*shape):
        return torch.randn(*shape, device="cuda", generator=g)
    x = n(b, s, nh, hd).to(dtype)
    dt = torch.nn.functional.softplus(n(b, s, nh))
    A = -torch.exp(0.5 * n(nh))
    B, C = n(b, s, 2 * ds).to(dtype).chunk(2, dim=-1)
    return x, dt, A, B, C


def ssd_bound_ms(shape, dtype):
    """The least work of one call: C B^T once per (b, chunk) and, per
    head, (L * S) dt x, B^T (w x) and C . state, causal halves counted
    once; against reading x, dt, B, C once and writing y once.  Returns
    the bound at the dtype's peak (bf16: tensor cores, f32: the CUDA
    cores), which of the two sets it, the f32 CUDA-core time of the same
    operations, flop and bytes."""
    b, s, nh, hd, ds, q = shape
    nc = s // q
    tri = q * (q + 1) // 2
    macs = b * nc * (tri * ds + nh * (tri * hd + 2 * q * hd * ds))
    flops = 2.0 * macs
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * (2 * b * s * nh * hd + 2 * b * s * ds) + 4 * (b * s * nh
                                                                  + nh)
    peak = TENSOR_CORE_BF16_FLOP_S if dtype == "bfloat16" else FP32_FLOP_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            flops / FP32_FLOP_S * 1e3, flops, nbytes)


def phase_ssd_kernel(torch):
    """ssd_scan against its plain version (chunked, 1e-4 in f32) and the
    sequential recurrence (5e-4/5e-3 in f32, 0.15/0.1 in bf16), then its
    cold-L2 device time at both prefill calls in bf16."""
    from repro_torch.kernels import ssd_scan as sk
    g = torch.Generator(device="cuda").manual_seed(4)
    cases = [((1, 64, 4, 16, 16, 16), "float32"),
             ((2, 128, 8, 16, 32, 32), "float32"),
             ((1, 256, 16, 32, 64, 64), "float32"),
             ((2, 96, 4, 16, 16, 32), "float32"),
             ((1, 128, 4, 16, 32, 32), "bfloat16")]
    cases += [(shape, dt) for shape in SSD_PREFILL.values()
              for dt in ("float32", "bfloat16")]
    checks, worst = [], 0.0
    for shape, dt in cases:
        *dims, chunk = shape
        args = ssd_inputs(torch, g, *dims, getattr(torch, dt))
        got = sk.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        oracle = sk.ssd_ref(args[0].float(), *args[1:])
        row = {"shape": list(shape), "dtype": dt}
        if dt == "float32":
            want = sk.ssd_scan_ref(*args, chunk)[0]
            torch.testing.assert_close(got, want, **SSD_TOL["chunked"])
            torch.testing.assert_close(got, oracle, **SSD_TOL["oracle"])
            row["max_abs_err"] = float((got - want).abs().max())
            row["max_abs_err_oracle"] = float((got - oracle).abs().max())
            worst = max(worst, row["max_abs_err"])
        else:
            torch.testing.assert_close(got.float(), oracle,
                                       **SSD_TOL["bfloat16"])
            want = sk.ssd_scan_ref(*args, chunk)[0]
            row["max_abs_err"] = float((got.float() - want.float())
                                       .abs().max())
            row["max_abs_err_oracle"] = float((got.float() - oracle)
                                              .abs().max())
        row["y_absmax"] = float(oracle.abs().max())
        checks.append(row)
        del args, got, oracle, want
    torch.cuda.empty_cache()
    timed = {}
    for arch, shape in SSD_PREFILL.items():
        *dims, chunk = shape
        one = ssd_inputs(torch, g, *dims, torch.bfloat16)
        set_bytes = sum(x.numel() * x.element_size() for x in one)
        n_sets = math.ceil(4 * l2_bytes(torch) / set_bytes)
        sets = [ssd_inputs(torch, g, *dims, torch.bfloat16)
                for _ in range(n_sets)]
        kept = []
        prof_k = profile_calls(torch, cycled(
            sets, lambda *a: sk.ssd_scan(*a, chunk=chunk), kept), 10)
        kept.clear()
        prof_p = profile_calls(torch, cycled(
            sets, lambda *a: sk.ssd_scan_ref(*a, chunk)[0], kept), 3)
        kept.clear()
        bound_ms, bound_by, f32_ms, flops, nbytes = ssd_bound_ms(
            shape, "bfloat16")
        ms = prof_k["device_us_per_call"] / 1e3
        timed[arch] = {"shape": list(shape), "dtype": "bfloat16", "ms": ms,
                       "plain_ms": prof_p["device_us_per_call"] / 1e3,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "f32_cuda_core_bound_ms": f32_ms,
                       "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                       "tflop_s": flops / (ms * 1e-3) / 1e12,
                       "cold_sets": n_sets,
                       "plain_launches_per_call":
                           prof_p["launches_per_call"]}
        del one, sets
        torch.cuda.empty_cache()
    m = timed["mamba2-1.3b"]
    rec = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:105",
           "max_abs_err": worst, "ms": m["ms"], "plain_ms": m["plain_ms"],
           "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
           "library_ms": None, "shape": m["shape"], "dtype": "bfloat16"}
    emit({"phase": "kernel", "name": "ssd_scan", "checks": checks,
          "tol": SSD_TOL, "timed": timed,
          "library": "none: no PyTorch call computes the SSD scan"})
    return rec


def launch_counters():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"flash_attention": flash_attention, "ssd_scan": ssd_scan}


def count_launches(torch, fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before;
    returns its result and the counts just after."""
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def check_launches(phase, got, want):
    for name, n in want.items():
        if got[name] != n:
            raise RuntimeError(f"{phase}: {name} launched {got[name]} times, "
                               f"expected {n}")
    for name, n in got.items():
        if name not in want and n:
            raise RuntimeError(f"{phase}: {name} launched {n} times, "
                               "expected none")


def get_cfg(name):
    from repro_torch.configs import get_arch
    return get_arch(name)


def phase_prefill(torch, phase, cfg, expect):
    """Model.forward at full width and depth (random weights from a seed,
    bf16 compute) on (2, 4096) tokens, last_only; returns the launches of
    one forward and the (f32) parameters."""
    from repro_torch.models import build_model
    model = build_model(cfg, compute_dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in all_tensors(params))
    b, s = PREFILL_SHAPE[:2]
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                     device="cuda")}
    model.forward(params, batch, last_only=True)  # first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, launches = count_launches(
        torch, lambda: model.forward(params, batch, last_only=True))
    first_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_launches(phase, launches, expect)
    if tuple(logits.shape) != (b, 1, cfg.padded_vocab) or \
            not all_finite(torch, logits):
        raise RuntimeError(f"{phase}: logits {tuple(logits.shape)} are not "
                           "finite (B, 1, V)")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.forward(params, batch, last_only=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prof = profile_calls(
        torch, lambda i=0: model.forward(params, batch, last_only=True), 1,
        match=("flash_fwd", "ssd_scan_kernel"))
    ms = statistics.median(times)
    emit({"phase": phase, "arch": cfg.name, "params": n_params,
          "param_gb_f32": n_params * 4 / 1e9, "init_s": init_s,
          "batch": b, "seq": s, "compute_dtype": "bfloat16",
          "launches": launches, "ms_per_forward": ms,
          "first_ms": first_ms, "forwards_ms": times,
          "tokens_per_s": b * s / (ms * 1e-3), "peak_gb": peak_gb,
          "device_ms_per_forward": prof["device_us_per_call"] / 1e3,
          "kernel_device_ms": {k: v / 1e3 for k, v in
                               prof["matched_us_per_call"].items()},
          "launches_per_forward": prof["launches_per_call"],
          "top_kernels_us": prof["kernels"],
          "logits_absmax": float(logits[..., :cfg.vocab_size].abs().max())})
    return launches, params


def all_tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from all_tensors(v)
        else:
            yield v


def phase_decode_vs_forward(torch, phase, cfg, params, seq, expect):
    """Full width, f32: teacher-forced decode logits against the forward's
    (the kernels against the decode path, on the card, without JAX)."""
    from repro_torch.models import build_model
    model = build_model(cfg, compute_dtype=torch.float32, device="cuda")
    b = 2
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (b, seq), generator=g,
                           device="cuda")
    full, launches = count_launches(
        torch, lambda: model.forward(params, {"tokens": tokens}))
    check_launches(phase, launches, expect)
    cache = model.init_cache(b, seq)
    dec = []
    t0 = time.perf_counter()
    for i in range(seq):
        logits, cache = model.decode_step(params, cache, tokens[:, i])
        dec.append(logits)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / seq * 1e3
    dec = torch.stack(dec, 1)
    # where a decode step's time goes: one step on a cache of its own
    prof_cache = model.init_cache(b, 4)
    prof = profile_calls(torch, lambda i=0: model.decode_step(
        params, prof_cache, tokens[:, 0]), 2)
    v = cfg.vocab_size
    err = float((dec[..., :v] - full[..., :v]).abs().max())
    torch.testing.assert_close(dec, full, **DECODE_TOL)
    emit({"phase": phase, "arch": cfg.name, "batch": b, "seq": seq,
          "dtype": "float32", "depth": cfg.num_layers, "cut": None,
          "max_abs_err": err, "tol": DECODE_TOL, "launches": launches,
          "decode_ms_per_step": step_ms,
          "decode_device_ms_per_step": prof["device_us_per_call"] / 1e3,
          "decode_launches_per_step": prof["launches_per_call"],
          "decode_top_host_ops_us": prof["top_host_ops_us"],
          "logits_absmax": float(full[..., :v].abs().max())})


def phase_serve(torch, arch):
    """run_serve at full width with GridPilot on; returns nothing, fails
    unless the FFR shed lands at the middle decode step under budget."""
    from repro_torch.launch.serve import build_parser, run_serve
    from repro_torch.obs import trace
    args = build_parser().parse_args(["--gridpilot", "--arch", arch])
    trace.get_tracer().clear()
    out = run_serve(args, cfg=get_cfg(arch), device="cuda")
    budget_ms = 700.0  # FFR activation budget
    if out["shed_at"] != args.decode_tokens // 2 or \
            not out["active"] < out["batch"] or out["response_ms"] is None \
            or not out["response_ms"] < budget_ms:
        raise RuntimeError(f"serve: no FFR shed within budget: {out}")
    emit({"phase": "serve", "arch": args.arch, "requests": args.requests,
          "prompt_len": args.prompt_len,
          "decode_tokens": args.decode_tokens,
          "prefill_ms": out["t_prefill_s"] * 1e3,
          "decode_ms_per_tok": out["t_decode_s"] / args.decode_tokens * 1e3,
          "shed_at": out["shed_at"], "batch": out["batch"],
          "active": out["active"], "response_ms": out["response_ms"],
          "budget_ms": budget_ms,
          "sheds": trace.metrics.counters.get("serve.sheds")})


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
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    pid_rec = phase_kernel(torch)
    flash_rec = phase_flash_kernel(torch)
    ssd_rec = phase_ssd_kernel(torch)
    pid_rec["launches"] = phase_tier1(torch)

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    qwen2 = get_cfg("qwen2-1.5b")
    launches, params = phase_prefill(
        torch, "prefill", qwen2, {"flash_attention": qwen2.num_layers})
    flash_rec["launches"] = launches["flash_attention"]
    phase_decode_vs_forward(torch, "decode_vs_forward", qwen2, params, 64,
                            {"flash_attention": qwen2.num_layers})
    del params
    free()
    phase_serve(torch, "qwen2-1.5b")
    free()
    mamba2 = get_cfg("mamba2-1.3b")
    launches, params = phase_prefill(
        torch, "prefill_ssm", mamba2, {"ssd_scan": mamba2.num_layers})
    ssd_rec["launches"] = launches["ssd_scan"]
    phase_decode_vs_forward(torch, "decode_vs_forward_ssm", mamba2, params,
                            256, {"ssd_scan": mamba2.num_layers})
    del params
    free()
    phase_serve(torch, "mamba2-1.3b")
    free()
    zamba2 = get_cfg("zamba2-2.7b")
    hybrid = {"ssd_scan": zamba2.num_layers,
              "flash_attention": zamba2.num_layers // zamba2.hybrid_period}
    _, params = phase_prefill(torch, "prefill_hybrid", zamba2, hybrid)
    phase_decode_vs_forward(torch, "decode_vs_forward_hybrid", zamba2,
                            params, 256, hybrid)
    del params
    free()
    phase_engine(torch)
    phase_cpu_vs_gpu(torch)
    phase_sweep(torch)
    emit({"kernels": [pid_rec, flash_rec, ssd_rec]})
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
