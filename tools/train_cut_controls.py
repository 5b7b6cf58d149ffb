#!/usr/bin/env python3
"""The training cut's gate and the scan backward's kernel checks against
deliberately wrong backward kernels, on one GPU.

    python3 tools/train_cut_controls.py [--seeds N] [ARCH ...]

Runs chip_smoke.py's 2-layer training cut (``cut_readings``, held by
``train_cut_check``) of each ARCH (default: zamba2-2.7b, mamba2-1.3b,
qwen2-1.5b) and the bf16 cases of the ``ssd_bwd`` phase's checks
(``ssd_bwd_checks``) on the port as it stands, then the same for
zamba2-2.7b on each control: a copy of the port under
build/cut_controls/NAME/ whose csrc/ssd_scan_bwd.cu has one term of the
tensor-core path's gradient removed (CONTROLS).  With ``--seeds N`` the
port's zamba2-2.7b cut is read again on the weights and batch of seeds 1
to N - 1.  Each tree runs in its own process (the kernels load from the
package's own build directory), which exits 3 when the cut's bf16 half
failed, 5 when only the kernel checks did, and 4 when only the cut's f32
half did (the f32 path runs the f32-FMA kernels, which no control
touches).  Prints one JSON line per (tree, arch): whether the gate passed
(else the leaves it failed on), whether its bf16 half alone passed, each
leaf's readings and each backward kernel call's against its plain
version; one per extra seed: each leaf that misses TRAIN_CUT_REL with
its kernels' and plain versions' bf16 distance from float64, and the
backward calls' worst; one per tree for the kernel checks; one line per
control saying which gates caught it; then the card's name and power
limit.  Exits 1 if the port fails a gate or the cut alone misses a
control.
"""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BWD = os.path.join("repro_torch", "kernels", "csrc", "ssd_scan_bwd.cu")
ARCHS = ("zamba2-2.7b", "mamba2-1.3b", "qwen2-1.5b")
CUT_FAILED = 3   # the cut's bf16 half failed
F32_ONLY = 4     # only the cut's f32 half failed
CHECKS_ONLY = 5  # only the scan backward's kernel checks failed
# name: (text of ssd_scan_bwd.cu, its replacement, the term removed), each
# in the tensor-core path's kernels
CONTROLS = {
    "no_state_dB": (
        "const float sc0 = sSc[r0], sc1 = sSc[r1];",
        "const float sc0 = side ? 0.f : sSc[r0], "
        "sc1 = side ? 0.f : sSc[r1];",
        "dB_j's end-state share u_j dt_j dS^T x_j"),
    "no_du_in_da": (
        "float da = sV[kDaT * Q + k] + sV[kEde * Q + k] + dEdec + "
        "sV[kUdu * Q + k];",
        "float da = sV[kDaT * Q + k] + sV[kEde * Q + k] + dEdec;",
        "da_k's sum_{j<k} u_j du_j (into ddt and dA)"),
    "dB_skips_head_0": (
        "for (int grp = 0; grp < a.ngroups; ++grp) {",
        "for (int grp = side; grp < a.ngroups; ++grp) {",
        "head group 0 (head 0 and the rest of its group) in dB's sum of W "
        "over groups"),
}


def one(src, archs, seeds=1):
    """The gates and readings of each arch on the port under ``src``, the
    zamba2-2.7b cut's readings at seeds 1 .. ``seeds`` - 1, and the kernel
    checks' bf16 cases; returns the exit code (0, CUT_FAILED, F32_ONLY or
    CHECKS_ONLY)."""
    sys.path.insert(0, src)
    sys.path.insert(1, ROOT)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.build_all(["flash_attention", "flash_attention_bwd", "ssd_scan",
                      "ssd_scan_bwd"])
    readings, f32_limit = cs.cut_readings, cs.TRAIN_CUT_F32_REL
    bad = bf16_bad = 0
    for arch in archs:
        cfg = cs.get_cfg(arch)
        shape = (2, 2048) if cfg.family == "dense" else (1, 2048)
        r = readings(torch, cfg, shape)
        torch.cuda.empty_cache()
        gates = {}
        for half, f32_rel in (("whole", f32_limit),
                              ("bf16_alone", float("inf"))):
            cs.TRAIN_CUT_F32_REL = f32_rel
            cs.cut_readings = lambda *a, r=r: r
            try:
                g = cs.train_cut_check(torch, cfg, arch, shape,
                                       conditioned=cfg.family == "hybrid")
                gates[half] = {"passed": True,
                               "held": sorted(g["held_by_conditioning"])}
            except RuntimeError as e:
                gates[half] = {"passed": False, "error": str(e)[:400]}
        print(json.dumps({"src": os.path.relpath(src, ROOT), "arch": arch,
                          "gate": gates["whole"],
                          "bf16_half_alone": gates["bf16_alone"],
                          "loss_kernels": r["loss_kernels"],
                          "loss_plain": r["loss_plain"],
                          "leaves": r["leaves"],
                          "backward_calls": r["backward_calls"]}),
              flush=True)
        bad += not gates["whole"]["passed"]
        bf16_bad += not gates["bf16_alone"]["passed"]
        cs.cut_readings, cs.TRAIN_CUT_F32_REL = readings, f32_limit
    for seed in range(1, seeds):
        r = readings(torch, cs.get_cfg("zamba2-2.7b"), (1, 2048), seed=seed)
        torch.cuda.empty_cache()
        print(json.dumps({
            "src": os.path.relpath(src, ROOT), "arch": "zamba2-2.7b",
            "seed": seed, "missed": {
                leaf: {k: v[k] for k in ("bf16", "kernels_bf16_from_f64",
                                         "plain_bf16_from_f64",
                                         "bf16_weights_move_f32")}
                for leaf, v in r["leaves"].items()
                if not v["bf16"] <= cs.TRAIN_CUT_REL},
            "backward_calls_worst": max(
                v for c in r["backward_calls"] for v in c["rel"].values())}),
            flush=True)
    try:
        cs.ssd_bwd_checks(torch, [c for c in cs.ssd_bwd_cases()
                                  if c[1] == "bfloat16"])
        checks = {"passed": True}
    except RuntimeError as e:
        checks = {"passed": False, "error": str(e)[:400]}
    print(json.dumps({"src": os.path.relpath(src, ROOT),
                      "ssd_bwd_bf16_checks": checks}), flush=True)
    if bf16_bad:
        return CUT_FAILED
    if not checks["passed"]:
        return CHECKS_ONLY
    return F32_ONLY if bad else 0


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    seeds = 1
    if argv[:1] == ["--seeds"]:
        seeds, argv = int(argv[1]), argv[2:]
    archs = argv or list(ARCHS)
    trees = [(None, os.path.join(ROOT, "src"), archs)]
    for name, (old, new, _) in CONTROLS.items():
        dst = os.path.join(ROOT, "build", "cut_controls", name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "src"), os.path.join(dst, "src"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = os.path.join(dst, "src", BWD)
        text = open(path).read()
        if text.count(old) != 1:
            print(f"{name}: {old!r} is not once in {BWD}", file=sys.stderr)
            return 1
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        trees.append((name, os.path.join(dst, "src"), ["zamba2-2.7b"]))
    rc = 0
    for name, src, tree_archs in trees:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", src, str(seeds if name is None else 1),
                            *tree_archs], cwd=ROOT)
        if name is None:
            if p.returncode != 0:
                print(f"the port: exit {p.returncode}", file=sys.stderr)
                rc = 1
            continue
        caught = p.returncode == CUT_FAILED
        print(json.dumps({"control": name, "removed": CONTROLS[name][2],
                          "caught_by_the_cut": caught,
                          "exit": p.returncode}), flush=True)
        rc |= not caught
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.exit(one(sys.argv[2], sys.argv[4:], int(sys.argv[3])))
    sys.exit(main(sys.argv[1:]))
