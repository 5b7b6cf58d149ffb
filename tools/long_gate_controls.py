#!/usr/bin/env python3
"""chip_smoke.py's long_500k and decode_32k decode gates against planted
faults, on one GPU.

    python3 tools/long_gate_controls.py

Each gate holds a bf16 decode step's logits to an f32 step's on the same
cache values, within the arch's fixed LONG_BF16_LIMIT, on a deep cache
(long_500k: mamba2-1.3b, zamba2-2.7b and the mixtral-8x22b 2-layer cut
from cur 524,280; decode_32k: qwen2-1.5b and yi-9b at cur 32,767) and on a
shallow one (bf16_floor).  This runs the smoke's own gate functions
(long_decode, decode_32k) at full width, with the limits lifted so that
every reading prints, on the port as it stands and on copies of it under
build/long_controls/NAME/ with one fault planted (FAULTS), each tree in a
process of its own.  Prints one JSON line per (tree, arch): the deep
steps' and the shallow cache's distances, the limit and whether the gate
fails; for the port also, on the shallow cache, the bf16 step's distance
from an f32 step on weights rounded to bf16 (what bf16 compute alone
moves) for the archs without experts; one line per fault with the gates
it fails; then the card's name and power limit.  Exits 1 if the port
fails a gate or a gate that a fault must fail passes.
"""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join("repro_torch", "models")
# (arch, gate): each gate's archs, in the smoke's order
GATES = (("mamba2-1.3b", "long_500k"), ("zamba2-2.7b", "long_500k"),
         ("mixtral-8x22b", "long_500k"), ("qwen2-1.5b", "decode_32k"),
         ("yi-9b", "decode_32k"))
# name: (file under repro_torch/models, its text, the replacement, what the
# fault does, the archs it reaches, the archs whose gate must fail).  The
# SSM state read through bf16 is a rounding-sized change, which a gate
# whose limit is the bf16 step's own rounding cannot see: it shows the
# gates' resolution, and no gate need fail on it
FAULTS = {
    "rope_positions_bf16": (
        "layers.py",
        "angles = positions[..., None].float() * freqs",
        "angles = positions[..., None].to(x.dtype).float() * freqs",
        "apply_rope's positions rounded to the compute dtype (524,280 to "
        "524,288 and 32,767 to 32,768 in bf16)",
        ("zamba2-2.7b", "mixtral-8x22b", "qwen2-1.5b", "yi-9b"),
        ("zamba2-2.7b", "mixtral-8x22b", "qwen2-1.5b", "yi-9b")),
    "ssm_state_read_bf16": (
        "ssd.py",
        'y = torch.einsum("bn,bhpn->bhp", C_mat.float(), ssm)',
        'y = torch.einsum("bn,bhpn->bhp", C_mat.float(), '
        "ssm.to(x.dtype).float())",
        "the decode step's SSM state read through the compute dtype",
        ("mamba2-1.3b", "zamba2-2.7b"), ()),
}
FAILED = 3  # the port failed a gate


def compute_share(torch, cs, cfg, params):
    """On bf16_floor's shallow cache: the bf16 step's largest row distance
    from an f32 step on ``params`` rounded to bf16, and that f32 step's
    from the f32 step on ``params``."""
    from repro_torch._tree import tree_map
    from repro_torch.models import build_model
    m16 = build_model(cfg, compute_dtype=torch.bfloat16, device="cuda")
    m32 = build_model(cfg, compute_dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(10)
    c16 = cs.seeded_cache(torch, m16, cs.FLOOR_ROWS, cs.FLOOR_SEQ,
                          cs.FLOOR_SEQ - 1, g)
    c32 = cs.as_f32_cache(torch, c16)
    c32r = cs.as_f32_cache(torch, c16)
    tok = torch.randint(0, cfg.vocab_size, (cs.FLOOR_ROWS,), generator=g,
                        device="cuda")
    rounded = tree_map(lambda p: p.to(torch.bfloat16).float(), params)
    l16 = m16.decode_step(params, c16, tok)[0]
    l32r = m32.decode_step(rounded, c32r, tok)[0]
    l32 = m32.decode_step(params, c32, tok)[0]
    v = cfg.vocab_size

    def worst(a, b):
        return max(cs.rel_norm(torch, a[i, :v], b[i, :v])
                   for i in range(cs.FLOOR_ROWS))
    return {"bf16_from_f32_on_bf16_weights": worst(l16, l32r),
            "f32_on_bf16_weights_from_f32": worst(l32r, l32)}


def one(src, archs):
    """Each arch's gate readings on the port under ``src``; returns 0, or
    FAILED where a gate failed."""
    sys.path.insert(0, src)
    sys.path.insert(1, ROOT)
    import dataclasses
    import torch
    import chip_smoke as cs
    from repro_torch.models import build_model
    limits = dict(cs.LONG_BF16_LIMIT)
    cs.LONG_BF16_LIMIT = {k: float("inf") for k in limits}
    port = os.path.realpath(src) == os.path.realpath(
        os.path.join(ROOT, "src"))
    failed = False
    for arch in archs:
        cfg = cs.get_cfg(arch)
        gate = dict(GATES)[arch]
        if cfg.is_moe:
            cfg = dataclasses.replace(cfg, num_layers=cs.MIXTRAL_CUT_LAYERS)
        params = build_model(cfg, device="cuda").init(0)
        if gate == "long_500k":
            r = cs.long_decode(torch, cfg, params)
            deep = r["bf16_rel_err"]
        else:
            r = cs.decode_32k(torch, cfg, params)
            deep = [r["row0_bf16_rel_err"]]
        limit = limits[arch]
        fails = not (max(deep) <= limit and r["bf16_floor"] <= limit)
        rec = {"src": os.path.relpath(src, ROOT), "arch": arch, "gate": gate,
               "deep": deep, "shallow": r["bf16_floor"], "limit": limit,
               "fails": fails}
        if port and not cfg.is_moe and arch != "yi-9b":
            # yi-9b's f32 weights (35 GB) do not fit twice beside its cache
            rec.update(compute_share(torch, cs, cfg, params))
        print(json.dumps(rec), flush=True)
        failed |= fails
        del params
        torch.cuda.empty_cache()
    return FAILED if failed else 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    trees = [(None, os.path.join(ROOT, "src"), [a for a, _ in GATES])]
    for name, (path, old, new, _, archs, _) in FAULTS.items():
        dst = os.path.join(ROOT, "build", "long_controls", name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "src"), os.path.join(dst, "src"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        file = os.path.join(dst, "src", PKG, path)
        text = open(file).read()
        if text.count(old) != 1:
            print(f"{name}: {old!r} is not once in {path}", file=sys.stderr)
            return 1
        with open(file, "w") as f:
            f.write(text.replace(old, new))
        trees.append((name, os.path.join(dst, "src"), list(archs)))
    rc = 0
    for name, src, archs in trees:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", src, *archs], cwd=ROOT,
                           capture_output=True, text=True)
        print(p.stdout, end="", flush=True)
        if p.returncode not in (0, FAILED):
            print(p.stderr[-3000:], file=sys.stderr)
            return 1
        failed = p.returncode == FAILED
        if name is None:
            if failed:
                print("the port fails a gate", file=sys.stderr)
                rc = 1
            continue
        caught = [json.loads(line)["arch"] for line in p.stdout.splitlines()
                  if line.startswith("{") and json.loads(line)["fails"]]
        must = FAULTS[name][5]
        print(json.dumps({"fault": name, "planted": FAULTS[name][3],
                          "reaches": FAULTS[name][4], "must_fail": must,
                          "failed_gates_of": caught}), flush=True)
        rc |= not set(must) <= set(caught)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.exit(one(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
