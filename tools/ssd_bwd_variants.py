#!/usr/bin/env python3
"""Time builds of the SSD scan's backward side by side on one GPU.

    python3 tools/ssd_bwd_variants.py NAME=[SOURCE][:FLAGS] ...

Each NAME builds SOURCE (default: the port's csrc/ssd_scan_bwd.cu; e.g.
the source before the tensor-core path, written out beforehand with
``git show 2c87038:src/repro_torch/kernels/csrc/ssd_scan_bwd.cu`` into a
directory git ignores) with the extra nvcc FLAGS (space-separated) into
build/variants/NAME.so, all builds at once.  A build that exports
``ssd_scan_bwd_bf16_launch`` runs through the port's wrapper
(``ssd_scan.ssd_scan_bwd``, the tensor-core kernels on bf16 inputs); one
without it, as that earlier source, runs its f32-FMA kernels with its own
argument list (``ssd_scan.bwd_fma``).  Then, at mamba2-1.3b's and
zamba2-2.7b's training calls and mamba2-1.3b's prefill call in bf16 (B and
C halves of one projection, as the model passes them), each build: its
norm-relative error from the f32 inputs' gradient as a multiple of the
plain version's own (the smoke's 1.25x gate), whether two runs are
bitwise equal, and its cold-L2 CUPTI device time per call (the sum of its
kernels), in two rounds of alternating order; the plain version's time
once per call.  Compare builds only within one run: times move between
cards.  Prints one JSON line per (call, round, build), then the card's
name and power limit.
"""
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
from variants import build_variants  # noqa: E402


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as sk
    libs = build_variants(
        argv, str(_build.CSRC / "ssd_scan_bwd.cu"),
        lambda k: ("<64, 128>" in k or "<64, 64>" in k or "<" not in k)
        and ("_tc_" in k or "ssd_bwd_chunk<" in k))
    if libs is None:
        return 1

    def runner(lib):
        if hasattr(lib, "ssd_scan_bwd_bf16_launch"):
            def new(*a, chunk):
                _build._LOADED["ssd_scan_bwd"] = lib
                return sk.ssd_scan_bwd(*a, chunk=chunk)
            return new, sk.BWD_KERNELS[torch.bfloat16]
        fn = lib.ssd_scan_bwd_launch
        fn.argtypes, fn.restype = sk._BWD_ARGTYPES, ctypes.c_int

        def old(x, dt, A, B, C, dy, *, chunk):
            b, s, nh, _ = x.shape
            dev = x.device
            out = (torch.empty_like(x), torch.empty(b, s, nh, device=dev),
                   torch.empty(nh, device=dev),
                   torch.empty(B.shape, dtype=B.dtype, device=dev),
                   torch.empty(C.shape, dtype=C.dtype, device=dev))
            stream = torch.cuda.current_stream().cuda_stream
            errs = sk.bwd_fma(fn, x, dt, A, B, C, dy, chunk, out, stream)
            if any(errs):
                raise RuntimeError(f"launch failed: {list(errs)}")
            return out
        return old, sk.BWD_KERNELS[torch.float32]

    runs = {name: runner(lib) for name, lib in libs.items()}
    g = torch.Generator(device="cuda").manual_seed(6)
    calls = dict(cs.SSD_TRAIN)
    calls["prefill mamba2-1.3b"] = cs.SSD_PREFILL["mamba2-1.3b"]
    for call, shape in calls.items():
        *dims, chunk = shape
        first, f32 = cs.ssd_bwd_inputs(torch, g, *dims, torch.bfloat16)
        set_bytes = sum(t.numel() * t.element_size() for t in first)
        sets = [first] + [cs.ssd_bwd_inputs(torch, g, *dims,
                                            torch.bfloat16)[0]
                          for _ in range(math.ceil(
                              4 * cs.l2_bytes(torch) / set_bytes) - 1)]
        exact = sk.ssd_scan_bwd_ref(*f32, chunk)[:5]
        plain = sk.ssd_scan_bwd_ref(*first, chunk)[:5]
        plain_rel = [cs.rel_err(torch, p, e) for p, e in zip(plain, exact)]
        kept = []
        prof = cs.profile_calls(torch, cs.cycled(
            sets, lambda *a: sk.ssd_scan_bwd_ref(*a, chunk), kept), 2)
        plain_ms = prof["rounded_us_per_call"] / 1e3
        del plain, kept
        bound_ms, bound_by, _, _ = cs.ssd_bwd_bound_ms(shape, "bfloat16")
        for rnd, order in enumerate((list(runs), list(runs)[::-1])):
            for name in order:
                fn, names = runs[name]
                got = fn(*first, chunk=chunk)
                again = fn(*first, chunk=chunk)
                torch.cuda.synchronize()
                ratio = {n: cs.rel_err(torch, k, e) / max(p, 1e-30)
                         for n, k, e, p in zip(cs.SSD_BWD_NAMES, got, exact,
                                               plain_rel)}
                kept = []
                prof = cs.profile_calls(
                    torch, cs.cycled(sets, lambda *a: fn(*a, chunk=chunk),
                                     kept), 10,
                    groups={k: (k,) for k in names})
                ms = {k: v / 1e3 for k, v in prof["group_us_per_call"].items()}
                print(json.dumps({
                    "call": call, "shape": list(shape), "round": rnd,
                    "build": name, "ms": sum(ms.values()), "kernel_ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "err_vs_plain_ratio": ratio,
                    "bitwise_equal": all(torch.equal(a, b)
                                         for a, b in zip(got, again))}),
                    flush=True)
                del got, again, kept
        _build._LOADED.pop("ssd_scan_bwd", None)
        del sets, first, f32, exact
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
