#!/usr/bin/env python3
"""Time builds of the attention backward's CUDA source side by side on one
GPU.

    python3 tools/flash_bwd_variants.py [--splits=LIST] \
        NAME=[SOURCE][:FLAGS] ...

Each NAME builds SOURCE (default: the port's csrc/flash_attention_bwd.cu;
e.g. a parent commit's copy unpacked with ``git archive``, exporting the C
interface that kernels/flash_attention.py calls; its ``#include
"hopper.cuh"`` resolves in the port's csrc/) with the extra nvcc FLAGS
(space-separated, e.g. ``-DX=1``) into build/variants/NAME.so, all builds
at once.  Then, at qwen2-1.5b's prefill call (2, 4096, 12, 2, 128) and
training call (2, 2048, ...) in bf16, causal, each build runs through the
port's wrappers: its worst error against autograd through the plain
version as a share of the 2e-2 tolerance, whether two runs are bitwise
equal, and its cold-L2 CUPTI device time per call of each wrapper (the
sum of its kernels) and of the pair, in two rounds of alternating order.
``--splits=LIST`` (comma-separated divisors of the GQA group, or ``auto``
for ``dkdv_splits``' choice, the default) runs each build once for each
entry, with flash_bwd_dkdv's split forced to it.  Compare builds only
within one run: times move between cards.  Prints one JSON line per
(call, round, build, splits), then the card's name and power limit.
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
    forced = ["auto"]
    for arg in [a for a in argv if a.startswith("--splits=")]:
        forced = arg.removeprefix("--splits=").split(",")
        argv.remove(arg)
    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    libs = build_variants(
        argv, str(_build.CSRC / "flash_attention_bwd.cu"),
        lambda k: "wgmma<128>" in k or "wgmma<80>" in k)
    if libs is None:
        return 1
    g = torch.Generator(device="cuda").manual_seed(5)
    auto_splits = fa.dkdv_splits
    runs = [(name, split) for name in libs for split in forced]
    groups = fa.BWD_KERNELS[torch.bfloat16]
    tol = cs.FLASH_BWD_TOL["bfloat16"]
    for call, shape in (("prefill", cs.PREFILL_SHAPE),
                        ("train", cs.TRAIN_ATTN_SHAPE)):

        def one_set():
            q, k, v = cs.flash_inputs(torch, g, shape, torch.bfloat16)
            do = torch.randn_like(q)
            o, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
            return q, k, v, o, do, lse
        first = one_set()
        set_bytes = sum(x.numel() * x.element_size() for x in first)
        sets = [first] + [one_set() for _ in range(
            math.ceil(4 * cs.l2_bytes(torch) / set_bytes) - 1)]
        q, k, v, o, do, lse = first
        want = cs.plain_grads(torch, q, k, v, do, 0)

        def bwd(q, k, v, o, do, lse):
            return fa.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
        for rnd, order in enumerate((runs, runs[::-1])):
            for name, split in order:
                _build._LOADED["flash_attention_bwd"] = libs[name]
                fa.dkdv_splits = auto_splits if split == "auto" else \
                    (lambda *_, n=int(split): n)
                got = bwd(*first)
                again = bwd(*first)
                share = max(float(((a.float() - w.float()).abs()
                                   / (tol["atol"] + tol["rtol"]
                                      * w.float().abs())).max())
                            for a, w in zip(got, want))
                kept = []
                prof = cs.profile_calls(torch, cs.cycled(sets, bwd, kept),
                                        10, groups=groups)
                ms = {m: v / 1e3 for m, v in
                      prof["group_us_per_call"].items()}
                print(json.dumps({
                    "call": call, "shape": list(shape), "round": rnd,
                    "build": name, "splits": fa.dkdv_splits(
                        shape[0], shape[3], shape[2] // shape[3], shape[1],
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count),
                    "pair_ms": sum(ms.values()), "ms": ms,
                    "tol_share": share,
                    "bitwise_equal": all(torch.equal(a, b)
                                         for a, b in zip(got, again))}),
                    flush=True)
                del got, again, kept
        del sets, first, want, q, k, v, o, do, lse
        torch.cuda.empty_cache()
    _build._LOADED.pop("flash_attention_bwd", None)
    fa.dkdv_splits = auto_splits
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
