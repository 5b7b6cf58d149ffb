#!/usr/bin/env python3
"""Time builds of the SSD scan's CUDA source side by side on one GPU.

    python3 tools/ssd_scan_variants.py NAME=[SOURCE][:FLAGS] ...

Each NAME builds SOURCE (default: the port's csrc/ssd_scan.cu; e.g. a
parent commit's copy unpacked with ``git archive``, exporting the C
interface that kernels/ssd_scan.py calls) with the extra nvcc
FLAGS (space-separated, e.g. ``-DX=1``) into build/variants/NAME.so, all
builds at once.  Then, at both full-width prefill calls in bf16 (B and C
strided as the model passes them), each build runs through the port's
wrapper: its norm-relative error against the f32 plain version, its
worst error against the sequential recurrence as a share of the 0.15 /
0.1 tolerance, and its cold-L2 CUPTI device time per device kernel (mean
per launch) and their sum, in two rounds of alternating order.  Compare
builds only within one run: times move between cards.  Prints one JSON
line per (call, round, build), then the card's name and power limit.
"""
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
        argv, str(_build.CSRC / "ssd_scan.cu"),
        lambda k: k.startswith(sk.KERNELS) and ("<64, " in k or "<" not in k))
    if libs is None:
        return 1
    g = torch.Generator(device="cuda").manual_seed(4)
    for arch, shape in cs.SSD_PREFILL.items():
        *dims, chunk = shape
        one = cs.ssd_inputs(torch, g, *dims, torch.bfloat16)
        set_bytes = sum(t.numel() * t.element_size() for t in one)
        n_sets = math.ceil(4 * cs.l2_bytes(torch) / set_bytes)
        sets = [cs.ssd_inputs(torch, g, *dims, torch.bfloat16)
                for _ in range(n_sets)]
        want = sk.ssd_scan_ref(one[0].float(), *one[1:], chunk)[0]
        oracle = sk.ssd_ref(one[0].float(), *one[1:])
        for rnd, order in enumerate((list(libs), list(libs)[::-1])):
            for name in order:
                _build._LOADED["ssd_scan"] = libs[name]
                got = sk.ssd_scan(*one, chunk=chunk).float()
                err = got - want
                ratio = (got - oracle).abs() / (0.15 + 0.1 * oracle.abs())
                kept = []
                prof = cs.profile_calls(torch, cs.cycled(
                    sets, lambda *a: sk.ssd_scan(*a, chunk=chunk), kept), 10,
                    match=sk.KERNELS)
                per_launch = prof["matched_us_per_launch"]
                print(json.dumps({
                    "call": arch, "round": rnd, "build": name,
                    "ms": sum(per_launch.values()) / 1e3,
                    "kernel_ms": {k: v / 1e3 for k, v in per_launch.items()},
                    "rel_err": float(err.norm() / want.norm()),
                    "oracle_share": float(ratio.max())}), flush=True)
        del sets, one, want, oracle
        torch.cuda.empty_cache()
    _build._LOADED.pop("ssd_scan", None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
