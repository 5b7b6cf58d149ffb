"""The port's dry run (``repro_torch.launch.dryrun``): its cells, its
collective accounting against the reference's, reduced cells on fake
(2, 2) and (2, 2, 2) meshes -- their per-device argument bytes against
the reference's ``compiled.memory_analysis().argument_size_in_bytes``
for the same reduced bundles on a 2 x 2 mesh of XLA CPU devices (a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``)
-- and one full-size cell on the 16 x 16 fake mesh, all on ``meta``.
The decode cell's cache is the rank's ``cache_pspecs`` shard in both
packages."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_common import run_procs

# name -> (arch, its full plan or the reduced dp_only one, shape)
CELLS = {
    "fsdp_train": ("yi-9b", True, ("t", 32, 8, "train")),
    "zero1_train": ("qwen2-1.5b", False, ("t", 32, 8, "train")),
    "fsdp_prefill": ("mamba2-1.3b", True, ("p", 32, 8, "prefill")),
    "fsdp_decode": ("yi-9b", True, ("d", 32, 8, "decode")),
}
# the per-device FLOPs against the reference's cost analysis: fsdp_tp
# cells with no loop that XLA counts once (the train cell's plan at one
# microbatch), name -> (arch, its full plan's overrides, shape)
FLOP_CELLS = {
    "tp_train": ("yi-9b", dict(microbatches=1), ("t", 32, 8, "train")),
    "tp_prefill": ("yi-9b", {}, ("p", 32, 8, "prefill")),
    "tp_decode": ("yi-9b", {}, ("d", 32, 8, "decode")),
}
# the port's per-rank FLOPs over the reference's per-device count, on the
# 2 x 2 mesh: 0.756 (train) and 0.757 (prefill) measured.  XLA counts
# every elementwise op (norms, RoPE, softmax, activations) where the
# port's FlopCounterMode counts products and its kernels' bounds; the
# products on gathered leaves (an earlier commit's) read 1.45 and 1.43
FLOP_BAND = (0.70, 0.80)
# the decode cell (one token; the scores against the 32-position cache
# split by positions): 0.643 measured, and 1.286 where the decode step
# gathered every leaf whole and held a whole-width cache (the parent
# commit's: twice a rank's share)
DECODE_FLOP_BAND = (0.60, 0.70)


def _cfg(pkg_arch, arch, full_plan):
    cfg = pkg_arch(arch).reduced()
    return dataclasses.replace(cfg, plan=pkg_arch(arch).plan) if full_plan \
        else cfg


def _flop_cfg(pkg_arch, name):
    arch, over, _ = FLOP_CELLS[name]
    full = pkg_arch(arch)
    return dataclasses.replace(full.reduced(), plan=dataclasses.replace(
        full.plan, **over))


def _ref_worker(out_path):
    """Each cell's per-device argument bytes on a 2 x 2 mesh; each FLOP
    cell's per-device ``cost_analysis()["flops"]``."""
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.train.step import build_step_bundle
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for name, (arch, full, shape) in CELLS.items():
        cfg, sh = _cfg(get_arch, arch, full), ShapeConfig(*shape)
        b = build_step_bundle(cfg, sh, mesh)
        out[name] = b.lower().compile().memory_analysis() \
            .argument_size_in_bytes
    # per-device FLOPs of the layer scan unrolled (XLA counts a loop body
    # once), in the same compile pass's process
    for name, (_, _, shape) in FLOP_CELLS.items():
        b = build_step_bundle(_flop_cfg(get_arch, name), ShapeConfig(*shape),
                              mesh, unroll=True)
        ca = b.lower().compile().cost_analysis()
        out[name + "_flops"] = float((ca[0] if isinstance(ca, (list, tuple))
                                      else ca)["flops"])
    np.savez(out_path, **out)


@pytest.fixture
def fake():
    """Makes a fake world of n ranks in this process, gone after the
    test."""
    from repro_torch.launch import dryrun
    assert not dist.is_initialized()
    yield lambda n: dryrun.fake_world(n)
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names)


def test_dryrun_cells_cover_40():
    """tests/test_sharding.py's count, on the port's registry."""
    from repro_torch.configs import dryrun_cells
    cells = dryrun_cells()
    assert len(cells) == 40
    skipped = [c for c in cells if not c[2]]
    for cfg, shape, ok, why in skipped:
        assert shape.name == "long_500k" and not cfg.sub_quadratic
    assert len(skipped) == 7
    assert len([c for c in cells if c[2]]) == 33


def test_collective_bytes_follows_the_references_rule():
    """tests/test_sharding.py's HLO cases as recorded collectives: the
    same counts and output bytes as the reference's parser."""
    from repro_torch.launch.dryrun import collective_bytes
    hlo = """
  %ag = bf16[8,128]{1,0} all-gather(%x), replica_groups={}
  %ar.1 = f32[256]{0} all-reduce(%y), to_apply=%add
  %rs = f32[16,16]{1,0} reduce-scatter(%z), dimensions={0}
  %a2a = bf16[4,64]{1,0} all-to-all(%w), dimensions={0}
  %cp = u8[1024]{0} collective-permute(%v), source_target_pairs={{0,1}}
  %notacoll = f32[9] add(%a, %b)
"""
    records = [("all-gather", 8 * 128 * 2), ("all-reduce", 256 * 4),
               ("reduce-scatter", 16 * 16 * 4), ("all-to-all", 4 * 64 * 2),
               ("collective-permute", 1024)]
    got = collective_bytes(records)
    assert got["count_by_op"] == {
        "all-gather": 1, "all-reduce": 1, "reduce-scatter": 1,
        "all-to-all": 1, "collective-permute": 1}
    assert got["bytes_by_op"]["all-gather"] == 8 * 128 * 2
    assert got["total_bytes"] == sum(got["bytes_by_op"].values())
    keep = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as r_dryrun  # sets XLA_FLAGS
    finally:
        if keep is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = keep
    assert got == r_dryrun.collective_bytes(hlo)


def test_recorder_sizes_collectives_by_output(fake):
    """The recorder sizes each collective by its output: an all-gather's
    gathered tensor, a reduce-scatter's shard, an all-reduce's tensor, on
    a fake world of four (functional and torch.distributed ops alike)."""
    import torch.distributed._functional_collectives as funcol
    from repro_torch.launch.dryrun import collective_recorder
    fake(4)
    x = torch.zeros(8, 3, device="meta")
    rec = []
    with collective_recorder(rec):
        funcol.all_gather_tensor(x, 0, [0, 1, 2, 3])
        funcol.reduce_scatter_tensor(x, "sum", 0, [0, 1, 2, 3])
        dist.all_reduce(x)
        dist.all_gather_into_tensor(torch.empty(32, 3, device="meta"), x)
    assert rec == [("all-gather", 32 * 3 * 4), ("reduce-scatter", 2 * 3 * 4),
                   ("all-reduce", 8 * 3 * 4), ("all-gather", 32 * 3 * 4)]


@pytest.fixture(scope="module")
def ref_args(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "ref.npz"
    run_procs([["tests/test_torch_dryrun.py", str(out)]],
              [dict(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                    JAX_PLATFORMS="cpu")], timeout=300)
    return dict(np.load(out))


def _run(name, mesh, tag, batch=None):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import run_cell
    arch, full, (sname, seq, b, kind) = CELLS[name]
    return run_cell(_cfg(get_arch, arch, full),
                    ShapeConfig(sname, seq, batch or b, kind), mesh, tag)


def test_reduced_cells_on_2x2_match_the_references_arguments(fake,
                                                             ref_args):
    fake(4)
    mesh = _mesh((2, 2), ("data", "model"))
    for name in CELLS:
        rec = _run(name, mesh, "2x2")
        assert rec["status"] == "ok", name
        assert rec["cost"]["flops"] > 0 and rec["memory"][
            "temp_size_bytes"] > 0, name
        assert rec["memory"]["argument_size_bytes"] == ref_args[name], name
    kinds = _run("fsdp_train", mesh, "2x2")["collectives"]["count_by_op"]
    assert kinds["all-gather"] > 0 and kinds["reduce-scatter"] > 0


@pytest.mark.parametrize("name", list(FLOP_CELLS))
def test_rank_flops_on_2x2_match_the_references_cost_analysis(fake,
                                                              ref_args,
                                                              name):
    """The port's per-rank FLOPs on the fake 2 x 2 mesh, its products on
    each rank's ``model`` shards, against the reference's per-device
    count of its GSPMD-partitioned step (FLOP_BAND, DECODE_FLOP_BAND)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import run_cell
    fake(4)
    _, _, shape = FLOP_CELLS[name]
    rec = run_cell(_flop_cfg(get_arch, name), ShapeConfig(*shape),
                   _mesh((2, 2), ("data", "model")), "2x2", unroll=True)
    ratio = rec["cost"]["flops"] / ref_args[name + "_flops"]
    lo, hi = DECODE_FLOP_BAND if shape[3] == "decode" else FLOP_BAND
    assert lo <= ratio <= hi, ratio
    assert rec["collectives"]["count_by_op"]["all-reduce"] > 0


def test_run_cell_takes_registered_names(fake):
    """``run_cell(arch_name, shape_name, mesh, mesh_name, unroll=)`` as the
    reference's (a decode cell of the registry on a fake 2 x 2 mesh)."""
    from repro_torch.launch.dryrun import run_cell
    fake(4)
    rec = run_cell("smollm-135m", "decode_32k", _mesh((2, 2), ("data",
                                                             "model")),
                   "2x2", unroll=True)
    assert rec["status"] == "ok" and rec["arch"] == "smollm-135m" and \
        rec["shape"] == "decode_32k" and rec["kind"] == "decode"


def test_reduced_cells_on_2x2x2_run(fake):
    fake(8)
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    # 16 rows: 4 a rank over (pod, data), whole for 4 microbatches
    for name in CELLS:
        assert _run(name, mesh, "2x2x2", 16)["status"] == "ok", name


def test_full_size_cell_on_the_pod_mesh(fake):
    """qwen2-1.5b x decode_32k on the 16 x 16 fake mesh: nothing is
    allocated; a rank holds the whole (replicated, dp_only) parameters,
    its 8 of the 128 rows' cache and the 4-byte decode position."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import pod_mesh
    from repro_torch.models import build_model
    fake(256)
    cfg = get_arch("qwen2-1.5b")
    rec = run_cell(cfg, SHAPES["decode_32k"], pod_mesh(device="cpu"),
                   "single")
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    model = build_model(cfg, device="meta")
    from repro_torch._tree import tree_map
    sizes = []
    tree_map(lambda s: sizes.append(4 * int(np.prod(s.shape))),
             model.specs())
    params = sum(sizes)
    cache = sum(int(np.prod(s.shape)) * s.dtype.itemsize
                for s in model.cache_specs(8, 32768).values())
    assert rec["memory"]["argument_size_bytes"] == params + cache + 8 * 4 \
        + 4
    assert rec["cost"]["flops"] > 2 * 8 * cfg.param_count()


if __name__ == "__main__":
    # the reference's side of ``ref_args``:
    #   python tests/test_torch_dryrun.py <out.npz>
    _ref_worker(*sys.argv[1:])
