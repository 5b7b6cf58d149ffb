#!/usr/bin/env python3
"""The training cut's gate against deliberately wrong backward kernels, on
one GPU.

    python3 tools/train_cut_controls.py [ARCH ...]

Runs chip_smoke.py's 2-layer training cut (``cut_readings``, held by
``train_cut_check``) of each ARCH (default: zamba2-2.7b, mamba2-1.3b,
qwen2-1.5b) on the port as it stands, then of zamba2-2.7b on each control:
a copy of the port under build/cut_controls/NAME/ whose
csrc/ssd_scan_bwd.cu has one term of the gradient removed (CONTROLS).
Each tree runs in its own process (the kernels load from the package's own
build directory), which exits 3 when a gate fails.  Prints one JSON line
per (tree, arch): whether the gate passed (else the leaves it failed on),
whether its bf16 half alone passed, and each leaf's readings; one line per
control saying whether the gate caught it; then the card's name and power
limit.  Exits 1 if the port fails its gate or a control passes it.
"""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BWD = os.path.join("repro_torch", "kernels", "csrc", "ssd_scan_bwd.cu")
ARCHS = ("zamba2-2.7b", "mamba2-1.3b", "qwen2-1.5b")
GATE_FAILED = 3  # a tree's exit code when a gate failed
# name: (text of ssd_scan_bwd.cu, its replacement, the term removed)
CONTROLS = {
    "no_state_dB": (
        "for (int q = 0; q < RS; ++q) accB[r][q] *= w;",
        "for (int q = 0; q < RS; ++q) accB[r][q] *= 0.f;",
        "dB_j's end-state share u_j dt_j dS^T x_j"),
    "no_du_in_da": (
        "const float da = sDaT[tid] + sDe[k] + dEdec + du;",
        "const float da = sDaT[tid] + sDe[k] + dEdec;",
        "da_k's sum_{j<k} u_j du_j (into ddt and dA)"),
    "dB_skips_head_0": (
        "      sb += a.dbp[h * n_bsd + e];",
        "      if (h > 0) sb += a.dbp[h * n_bsd + e];",
        "head 0's partial of the sum of dB over heads"),
}


def one(src, archs):
    """The gate and readings of each arch on the port under ``src``."""
    sys.path.insert(0, src)
    sys.path.insert(1, ROOT)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.build_all(["flash_attention", "flash_attention_bwd", "ssd_scan",
                      "ssd_scan_bwd"])
    readings, f32_limit = cs.cut_readings, cs.TRAIN_CUT_F32_REL
    bad = 0
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
                          "leaves": r["leaves"]}), flush=True)
        bad += not gates["whole"]["passed"]
    return bad


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
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
                            "--one", src, *tree_archs], cwd=ROOT)
        if name is None:
            if p.returncode != 0:
                print(f"the port: exit {p.returncode}", file=sys.stderr)
                rc = 1
            continue
        caught = p.returncode == GATE_FAILED
        print(json.dumps({"control": name, "removed": CONTROLS[name][2],
                          "caught": caught, "exit": p.returncode}),
              flush=True)
        rc |= not caught
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.exit(GATE_FAILED if one(sys.argv[2], sys.argv[3:]) else 0)
    sys.exit(main(sys.argv[1:]))
