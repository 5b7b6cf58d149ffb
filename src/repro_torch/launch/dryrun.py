"""Dry run of every (arch x shape) cell on the production meshes, off the
card: the port of ``repro.launch.dryrun``.

    python -m repro_torch.launch.dryrun --mesh single          # all cells
    python -m repro_torch.launch.dryrun --mesh multi --arch yi-9b \\
        --shape train_4k
    python -m repro_torch.launch.dryrun --mesh both

The reference lowers and compiles each cell on 512 placeholder host
devices.  The port runs one step of the cell's kind, through the same
``build_step_bundle`` as training and serving, as rank 0 of a ``fake``
process group of 256 (``--mesh single``, 16 x 16) or 512 (``multi``,
2 x 16 x 16) ranks on ``pod_mesh``, with every tensor on ``meta``:
nothing is allocated, no kernel launches and no byte moves, while the
step's shapes, placements and collectives are those of a real rank.

Each record has the reference's keys:

* ``memory.argument_size_bytes``: this rank's shards of the parameters
  and AdamW moments, its rows of the batch (or its ``cache_pspecs`` shard
  of the decode cache, ``StepBundle.abstract_cache``), and the 4-byte
  step counter or decode position, as the port holds them
  (``StepBundle``);
  ``temp_size_bytes``: the peak of what the step allocates beyond them,
  from ``torch.distributed._tools.mem_tracker.MemTracker`` on the meta
  tensors; ``output_size_bytes``: what the step returns that is not one
  of its arguments (parameters, moments and cache are updated in
  place); ``generated_code_size_bytes``: None (an eager step compiles
  nothing).
* ``cost.flops``: this rank's FLOPs, ``torch.utils.flop_counter``'s
  count of the torch ops plus, for the port's kernels, which run
  shape-only on ``meta`` (``kernels.ops``), the FLOPs of their bounds
  (``ops.META_FLOPS``: the attention's 4 B H D per visible pair forward
  and 3.5x that backward, the scan's and its gradient's least work);
  ``bytes_accessed`` -1.0, as the reference writes when XLA gives none
  (torch has no counterpart); ``transcendentals`` 0.0.
* ``collectives``: every collective of the step, functional (DTensor's
  gathers and reduce-scatters) or ``torch.distributed`` (the all-reduces
  of replicated gradients, loss, metrics and the gradient norm, the MoE
  loads), under the reference's op names and sized by output bytes as
  its ``collective_bytes`` sizes HLO (:func:`collective_bytes` here, over
  the recorded ops).

The numbers are the port's: every step computes its products on this
rank's ``model`` shards (``sharding/tp.py``), so a rank's FLOPs are its
batch rows through its share of the model, as the reference's
per-device cost analysis counts them (within XLA's count of elementwise
work, which ``FlopCounterMode`` leaves out); its collectives are the
FSDP gathers and reduce-scatters over the data axes and the
tensor-parallel all-reduces and gathers over ``model``, not GSPMD's
HLO; a decode step's cache is the rank's ``cache_pspecs`` shard: its
rows, and its kv heads or positions, SSM heads and conv channels.

Records go to ``build/dryrun/dryrun_<mesh>.json`` (``--out`` to change);
the exit status is 1 if any cell failed.  A cell's step runs op by op on
``meta`` (a train cell at full depth takes tens of seconds to minutes);
more than one runnable cell runs in as many processes as there are cores
this process may use (or cells, if fewer), each its own fake world; one
cell runs in this process.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

OUT_DIR = os.path.join("build", "dryrun")

# the reference's op names, from the torch ops' names
_OP_NAMES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
             ("reduce_scatter", "reduce-scatter"),
             ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
             ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
             ("broadcast", "collective-permute"),
             ("send", "collective-permute"))


def collective_bytes(records) -> dict:
    """Sum output bytes of every recorded collective, by op kind: the
    reference's accounting (``repro.launch.dryrun.collective_bytes``)
    over ``(op, output bytes)`` records instead of HLO text."""
    per_op: dict[str, int] = {}
    count: dict[str, int] = {}
    for op, nbytes in records:
        per_op[op] = per_op.get(op, 0) + int(nbytes)
        count[op] = count.get(op, 0) + 1
    return {"bytes_by_op": per_op, "count_by_op": count,
            "total_bytes": sum(per_op.values())}


def _op_name(func) -> str | None:
    name = str(func)
    if "c10d" not in name or "wait" in name or "barrier" in name:
        return None
    for key, op in _OP_NAMES:
        if key in name:
            return op
    return None


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def collective_recorder(records: list):
    """A dispatch mode that records ``(op, output bytes)`` of every
    collective: a functional collective's result, or a
    ``torch.distributed`` op's output argument (its first)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Rec(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            op = _op_name(func)
            if op is not None:
                name = str(func)
                where = out if "_c10d_functional" in name else args[0]
                records.append((op, _nbytes(where)))
            return out
    return Rec()


def fake_world(n: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``n`` ranks
    (collectives return at once, moving nothing); any group before it is
    destroyed."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def _meta_inputs(bundle) -> dict:
    """This rank's rows of the cell's batch on ``meta``."""
    from repro_torch.train.step import batch_rows
    shape, rules = bundle.shape, bundle.rules
    rows = batch_rows(rules, shape.global_batch,
                      bundle.mesh.get_coordinate())
    n = rows[1] - rows[0]
    return {k: torch.zeros((n,) + tuple(s.shape[1:]), dtype=s.dtype,
                           device="meta")
            for k, s in bundle.model.input_specs(shape).items()}


def _leaves(tree) -> list:
    from repro_torch._tree import leaves
    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def _args(bundle):
    """(step arguments, argument bytes) of the cell's kind on ``meta``."""
    from repro_torch.sharding import fsdp
    params, opt = bundle.abstract_state()
    batch = _meta_inputs(bundle)
    if bundle.kind == "train":
        # the 4-byte step counter beside the state's, as the reference's
        # int32 step argument
        args = (params, opt, batch, 0)
        return args, fsdp.shard_bytes((params, opt, batch)) + 4
    if bundle.kind == "prefill":
        return (params, batch), fsdp.shard_bytes((params, batch))
    # this rank's cache shard (``cache_pspecs``), and the 4-byte decode
    # position beside it, as the reference's int32 ``cur``
    cache = bundle.abstract_cache()
    return (params, cache, batch["tokens"]), fsdp.shard_bytes(
        (params, cache, batch["tokens"])) + 4


def run_cell(arch_name, shape_name, mesh, mesh_name: str,
             unroll: bool = False) -> dict:
    """One cell's record (see the module docstring) on ``mesh``, a
    ``DeviceMesh`` over a fake world.  ``arch_name`` and ``shape_name``
    are registered names, or an ``ArchConfig`` and a ``ShapeConfig`` (a
    reduced cell).  ``unroll`` is the reference's layer-scan unroll,
    which it needs for exact per-op costs: accepted, with no effect (the
    port's layer loops run eagerly, so its count is the unrolled one)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.kernels import ops
    from repro_torch.sharding import fsdp
    from repro_torch.train.step import build_step_bundle
    cfg = get_arch(arch_name) if isinstance(arch_name, str) else arch_name
    shape = SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    rec: dict = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "kind": shape.kind, "params": cfg.param_count(),
        "active_params": cfg.active_param_count(), "tokens": shape.tokens,
    }
    t0 = time.time()
    bundle = build_step_bundle(cfg, shape, device="meta", mesh=mesh,
                               unroll=unroll)
    args, arg_bytes = _args(bundle)
    records: list = []
    ops.META_FLOPS.clear()
    mem = MemTracker()
    mem.track_external(*[fsdp.local(x) for x in _leaves(args)])
    flops = FlopCounterMode(display=False)
    with mem, flops, collective_recorder(records):
        out = bundle.step_fn(*args)
    rec["run_s"] = round(time.time() - t0, 1)
    peak = mem.get_tracker_snapshot("peak")
    peak = max((v["Total"] for v in peak.values()), default=0)
    ids = {id(x) for x in _leaves(args)}
    rec["memory"] = {
        "argument_size_bytes": arg_bytes,
        "output_size_bytes": fsdp.shard_bytes(
            [x for x in _leaves(out) if id(x) not in ids]),
        "temp_size_bytes": max(peak - arg_bytes, 0),
        "generated_code_size_bytes": None,
    }
    rec["cost"] = {
        "flops": float(flops.get_total_flops()
                       + sum(ops.META_FLOPS.values())),
        "kernel_flops": {k: float(v) for k, v in ops.META_FLOPS.items()},
        "bytes_accessed": -1.0,
        "transcendentals": 0.0,
    }
    rec["collectives"] = collective_bytes(records)
    rec["status"] = "ok"
    return rec


_MESH: dict = {}


def _cell(job) -> dict:
    """One runnable cell's record in this process's fake world of its
    mesh (made on first use), or its failure."""
    from repro_torch.launch.mesh import pod_mesh
    arch, shape_name, mesh_name, unroll = job
    if _MESH.get("name") != mesh_name:
        multi = mesh_name == "multi"
        fake_world(512 if multi else 256)
        _MESH.update(name=mesh_name,
                     mesh=pod_mesh(multi_pod=multi, device="cpu"))
    try:
        return run_cell(arch, shape_name, _MESH["mesh"], mesh_name,
                        unroll=unroll)
    except Exception as e:  # noqa: BLE001 - record and continue
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "fail", "error": str(e)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--unroll", action="store_true",
                    help="the reference's flag (unroll the layer scan for "
                         "exact per-op accounting): accepted; the port's "
                         "layer loops always run unrolled")
    args = ap.parse_args(argv)

    from repro_torch.configs import dryrun_cells

    names = [m for m in ("single", "multi") if args.mesh in (m, "both")]
    results, jobs = [], []
    t_all = time.time()
    for mesh_name in names:
        for cfg, shape, ok, why in dryrun_cells():
            if args.arch and cfg.name != args.arch:
                continue
            if args.shape and shape.name != args.shape:
                continue
            if ok:
                jobs.append((cfg.name, shape.name, mesh_name,
                             args.unroll))
                results.append(None)
            else:
                print(f"SKIP {cfg.name} x {shape.name} [{mesh_name}]: "
                      f"{why}", flush=True)
                results.append({"arch": cfg.name, "shape": shape.name,
                                "mesh": mesh_name, "status": "skip",
                                "reason": why})
    workers = min(len(os.sched_getaffinity(0)), len(jobs))
    if workers > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(workers,
                                 mp_context=mp.get_context("spawn")) as ex:
            recs = list(ex.map(_cell, jobs))
    else:
        recs = [_cell(j) for j in jobs]
    if dist.is_initialized():
        dist.destroy_process_group()
    it = iter(recs)
    results = [r if r is not None else next(it) for r in results]
    for rec in results:
        cell = f"{rec['arch']} x {rec['shape']} [{rec['mesh']}]"
        if rec["status"] == "ok":
            mb = rec["memory"]["temp_size_bytes"] / 2**20
            print(f"OK   {cell}: flops={rec['cost']['flops']:.3e} "
                  f"coll={rec['collectives']['total_bytes']:.3e}B "
                  f"args={rec['memory']['argument_size_bytes'] / 2**30:.2f}"
                  f"GiB temp={mb:.0f}MiB ({rec['run_s']}s)", flush=True)
        elif rec["status"] == "fail":
            print(f"FAIL {cell}: {rec['error']}", flush=True)
    count = {k: sum(r["status"] == k for r in results)
             for k in ("ok", "skip", "fail")}

    suffix = args.mesh
    if args.arch or args.shape:
        suffix += f"_{args.arch or 'all'}_{args.shape or 'all'}"
    out = args.out or os.path.join(OUT_DIR, f"dryrun_{suffix}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"\n{count['ok']} ok / {count['skip']} skip / {count['fail']} "
          f"fail -> {out} ({time.time() - t_all:.1f} s)")
    return 1 if count["fail"] else 0


if __name__ == "__main__":
    sys.exit(main())
