"""Sharded training state (``repro_torch.sharding.fsdp``,
``train/step.py`` on a mesh) against the replicated step and the
reference, in float32 on the CPU:

- gloo ranks (processes under the REPRO_* contract, ``run_procs``) on
  (data, model) meshes (2, 1) and (1, 2) (two worlds of two, here) and
  (2, 2) (a world of four, ``tests/test_torch_fsdp_2x2.py``, with the
  reference), for every family's reduced config with the plan set to
  ``fsdp_tp`` (the MoE under ``moe_mode`` ``ep`` and ``tp``), remat
  ``dots`` and two microbatches, and for ``dp_only`` (ZeRO-1 moments);
- each rank's local shard shape of every parameter and moment leaf
  against the shard shape of the reference's ``param_pspecs`` /
  ``opt_pspecs`` on that mesh, and its resident bytes against the sum of
  its shards;
- three steps' loss, metrics and ``grad_norm``, and every leaf after
  them, against the single-process replicated port step on the global
  batch (``tests/test_torch_train.py``'s tolerances), and against the
  reference's jitted ``build_step_bundle(cfg, shape, mesh)`` step on a
  2 x 2 mesh of XLA CPU devices (``tests/test_torch_fsdp_2x2.py``);
- the gather's dtypes (cast before it, the gradient in the leaf's), and
  its collectives on CUDA tensors over gloo on a card (the ``cuda``
  test);
- checkpoints: sharded state written and read back replicated, replicated
  state read back sharded, and a sharded ``Trainer`` saving (every rank
  gathers, rank 0 writes, no rank hangs) and resuming replicated, and the
  reverse, against one replicated run.

MoE dispatch groups are formed from each rank's tokens; they are the
reference's groups where a rank's microbatch holds whole groups (as at
the production ``train_4k`` shapes), so the MoE cases run with
16-token groups in both packages (``GROUP_SIZE``).
"""
import contextlib
import dataclasses
import functools
import os
import pathlib
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_common import (CPU, flat_arrays, free_port, nested_arrays,
                               run_procs)

# name -> (arch, plan mode, moe mode)
CASES = {
    "dense": ("qwen2-1.5b", "fsdp_tp", "tp"),
    "moe_ep": ("olmoe-1b-7b", "fsdp_tp", "ep"),
    "moe_tp": ("mixtral-8x22b", "fsdp_tp", "tp"),
    "ssm": ("mamba2-1.3b", "fsdp_tp", "tp"),
    "hybrid": ("zamba2-2.7b", "fsdp_tp", "tp"),
    "vlm": ("phi-3-vision-4.2b", "fsdp_tp", "tp"),
    "encdec": ("whisper-medium", "fsdp_tp", "tp"),
    "zero1": ("qwen2-1.5b", "dp_only", "tp"),
}
MESHES = ((2, 1), (1, 2))
BATCH, SEQ, MICRO = 8, 16, 2
STEPS = (150, 151, 152)
GROUP = 16                                 # MoE dispatch group (tokens)
METRICS = ("loss", "ce", "zloss", "aux", "grad_norm")
LOSS_F32 = dict(rtol=1e-5, atol=1e-7)      # tests/test_torch_train.py
STEP_F32 = dict(rtol=1e-4, atol=1e-7)
CKPT_CASE, CKPT_MESH = "ssm", (2, 1)
TRAINER_ARCH = "mamba2-1.3b"               # the trainer's fsdp_tp case
F32 = dict(compute_dtype=torch.float32)


@contextlib.contextmanager
def f32_trainers():
    """Trainers built meanwhile (``resize`` too) compute in float32, so
    their steps meet the replicated step at the f32 tolerances."""
    from repro_torch.train import step, trainer
    f32 = functools.partial(step.build_step_bundle, model_kw=F32)
    with mock.patch.object(trainer, "build_step_bundle", f32):
        yield


def _plan(pkg_plan, mode, moe):
    return pkg_plan(mode=mode, moe_mode=moe, remat="dots",
                    microbatches=MICRO)


def port_cfg(case):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShardingPlan
    arch, mode, moe = CASES[case]
    return dataclasses.replace(get_arch(arch).reduced(),
                               plan=_plan(ShardingPlan, mode, moe))


def ref_cfg(case):
    from repro.configs import get_arch
    from repro.configs.base import ShardingPlan
    arch, mode, moe = CASES[case]
    return dataclasses.replace(get_arch(arch).reduced(),
                               plan=_plan(ShardingPlan, mode, moe))


def _tag(shape):
    return "x".join(map(str, shape))


# ---------------------------------------------------------------------------
# The port's side (also run inside the rank processes)
# ---------------------------------------------------------------------------


def _port_state(inputs, device=CPU):
    from repro_torch import convert
    params = convert.model_params(nested_arrays(inputs, "params"), device)
    opt = convert.adamw_state({"step": inputs["step"],
                               "mu": nested_arrays(inputs, "mu"),
                               "nu": nested_arrays(inputs, "nu")}, device)
    return params, opt


def _batch(inputs, lo=0, hi=BATCH):
    return {k: torch.as_tensor(inputs[k][lo:hi])
            for k in ("tokens", "embeds", "frames") if k in inputs}


def _placed(bundle, inputs):
    """The inputs' state placed by the bundle's placements."""
    from repro_torch._tree import tree_map
    from repro_torch.optim import AdamWState
    from repro_torch.sharding import fsdp
    params, opt = _port_state(inputs)

    def put(tree, places):
        return tree_map(lambda t, pl: fsdp.place(t, bundle.mesh, pl),
                        tree, places)
    return put(params, bundle.param_placements), AdamWState(
        step=opt.step, mu=put(opt.mu, bundle.opt_placements.mu),
        nu=put(opt.nu, bundle.opt_placements.nu))


def _shape_cfg():
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig("fsdp", SEQ, BATCH, "train")


@functools.lru_cache(maxsize=None)
def port_replicated(case):
    """The single-process replicated port step on the global batch:
    metrics per step, and every leaf after the steps (once per case)."""
    inputs = _inputs(case)
    import repro_torch.models.moe as moe
    import repro_torch.train.step as st
    b = st.build_step_bundle(port_cfg(case), _shape_cfg(), device=CPU,
                             model_kw=dict(compute_dtype=torch.float32))
    params, opt = _port_state(inputs)
    keep, moe.GROUP_SIZE = moe.GROUP_SIZE, GROUP
    try:
        rows = []
        for step in STEPS:
            params, opt, m = b.step_fn(params, opt, _batch(inputs), step)
            rows.append([float(m.get(k, 0.0)) for k in METRICS])
    finally:
        moe.GROUP_SIZE = keep
    return {"metrics": np.asarray(rows), **flat_arrays(params, "params"),
            **flat_arrays(opt.mu, "mu"), **flat_arrays(opt.nu, "nu")}


def _run_sharded(case, mesh, inputs, rank):
    """One case on ``mesh``: this rank's local shapes and bytes, the
    metrics of STEPS, and (rank 0) every leaf gathered after them."""
    import repro_torch.train.step as st
    from repro_torch._tree import leaves_with_paths
    from repro_torch.sharding import fsdp
    b = st.build_step_bundle(port_cfg(case), _shape_cfg(), device=CPU,
                             mesh=mesh,
                             model_kw=dict(compute_dtype=torch.float32))
    params, opt = _placed(b, inputs)
    out = {}
    for name, tree in (("params", params), ("mu", opt.mu), ("nu", opt.nu)):
        for path, x in leaves_with_paths(tree):
            out[f"shape/{name}/" + "/".join(path)] = np.asarray(
                fsdp.local(x).shape)
    out["bytes"] = np.asarray([fsdp.shard_bytes((params, opt.mu, opt.nu)),
                               b.state_bytes()])
    rows = st.batch_rows(b.rules, BATCH, mesh.get_coordinate(), MICRO)
    batch = {k: v[rows] for k, v in _batch(inputs).items()}
    rows = []
    for step in STEPS:
        params, opt, m = b.step_fn(params, opt, batch, step)
        rows.append([float(m.get(k, 0.0)) for k in METRICS])
    out["metrics"] = np.asarray(rows)
    whole = fsdp.full_leaves((params, opt.mu, opt.nu), keep=rank == 0)
    if rank == 0:
        from repro_torch._tree import unflatten_like
        p, mu, nu = unflatten_like((params, opt.mu, opt.nu), whole)
        out.update(flat_arrays(p, "params"))
        out.update(flat_arrays(mu, "mu"))
        out.update(flat_arrays(nu, "nu"))
    return out, b, (params, opt)


def _checkpoints(bundle, state, inputs, ckpt_dir, rank):
    """Sharded -> replicated and replicated -> sharded round trips:
    whether every leaf came back equal on this rank."""
    import torch.distributed as dist
    from repro_torch._tree import leaves, unflatten_like
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.sharding import fsdp
    params, opt = state
    whole = fsdp.full_leaves(state, keep=True)
    if rank == 0:
        save_checkpoint(str(ckpt_dir / "sharded"), 3,
                        unflatten_like(state, whole))
    dist.barrier()
    rep, _, _ = restore_checkpoint(str(ckpt_dir / "sharded"), state,
                                   device=CPU)
    ok_rep = all(torch.equal(a, b) for a, b in zip(leaves(rep), whole))
    back, _, _ = restore_checkpoint(str(ckpt_dir / "sharded"), state,
                                    device=CPU,
                                    shardings=bundle.state_shardings())
    ok_back = all(torch.equal(fsdp.local(a), fsdp.local(b))
                  and type(a) is type(b)
                  for a, b in zip(leaves(back), leaves(state)))
    # replicated -> sharded: the test process wrote the inputs' state
    sh, _, _ = restore_checkpoint(str(ckpt_dir / "replicated"), state,
                                  device=CPU,
                                  shardings=bundle.state_shardings())
    want = _placed(bundle, inputs)
    ok_sh = all(torch.equal(fsdp.local(a), fsdp.local(b))
                for a, b in zip(leaves(sh), leaves(want)))
    return np.asarray([ok_rep, ok_back, ok_sh])


def _trainer_runs(mesh, ckpt_dir, rank):
    """A sharded Trainer's 3 steps (a checkpoint at the end), resumed
    replicated to step 5 on rank 0; a replicated Trainer's 3 steps
    (written by the test process) resumed sharded to step 5."""
    import torch.distributed as dist
    from repro_torch.sharding import fsdp
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg, shape = _trainer_cfg()
    out = {}
    with f32_trainers():
        t = Trainer(cfg, shape, mesh, TrainerConfig(
            steps=3, log_every=0, ckpt_dir=str(ckpt_dir / "t_sharded")),
            device=CPU)
        init = t.init_state()
        whole = fsdp.full_leaves(init, keep=rank == 0)
        h = t.train()["history"]
        out["sharded_first"] = np.asarray([x["loss"] for x in h])
        dist.barrier()
        if rank == 0:
            out.update({f"init/{i}": w.numpy()
                        for i, w in enumerate(whole)})
            t2 = t.resize(CPU)
            t2.tcfg = TrainerConfig(steps=5, log_every=0,
                                    ckpt_dir=str(ckpt_dir / "t_sharded"))
            out["replicated_then"] = np.asarray(
                [x["loss"] for x in t2.train()["history"]])
        dist.barrier()
        t3 = Trainer(cfg, shape, tcfg=TrainerConfig(
            steps=5, log_every=0, ckpt_dir=str(ckpt_dir / "t_replicated")),
            device=CPU).resize(mesh)
        out["sharded_then"] = np.asarray([x["loss"]
                                          for x in t3.train()["history"]])
    return out


def _trainer_cfg():
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig, ShardingPlan
    cfg = dataclasses.replace(get_arch(TRAINER_ARCH).reduced(),
                              plan=ShardingPlan(mode="fsdp_tp",
                                                microbatches=MICRO))
    return cfg, ShapeConfig("t", SEQ, BATCH, "train")


def _worker(job_dir, out_dir, tag):
    """One rank of the world of the mesh ``tag``: every case on that mesh
    (``2x1``), and on CKPT_MESH the checkpoints; or with ``trainer:2x1``
    the trainer runs alone."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    import repro_torch.models.moe as moe
    from repro_torch.launch.mesh import ensure_distributed
    torch.set_num_threads(1)
    assert ensure_distributed(CPU)
    role, _, mesh_tag = tag.rpartition(":")
    shape = tuple(int(x) for x in mesh_tag.split("x"))
    rank = dist.get_rank()
    job_dir = pathlib.Path(job_dir)
    moe.GROUP_SIZE = GROUP
    mesh = DeviceMesh(CPU, torch.arange(dist.get_world_size())
                      .reshape(shape), mesh_dim_names=("data", "model"))
    out = {}
    if role == "trainer":
        out.update({f"trainer/{k}": v for k, v in
                    _trainer_runs(mesh, job_dir, rank).items()})
    for case in CASES if not role else ():
        inputs = dict(np.load(job_dir / f"{case}.npz"))
        rec, b, state = _run_sharded(case, mesh, inputs, rank)
        out.update({f"{case}/{tag}/{k}": v for k, v in rec.items()})
        if (case, shape) == (CKPT_CASE, CKPT_MESH):
            out["ckpt"] = _checkpoints(b, state, inputs, job_dir, rank)
    dist.destroy_process_group()
    np.savez(pathlib.Path(out_dir) / f"{role or mesh_tag}_rank{rank}.npz",
             **out)


# ---------------------------------------------------------------------------
# The reference's side
# ---------------------------------------------------------------------------


def _ref_worker(job_dir, out_path, cases):
    """The reference's jitted sharded step on a 2 x 2 mesh of XLA CPU
    devices, for the comma-separated ``cases``, STEPS from the inputs."""
    import jax
    import jax.numpy as jnp
    import repro.models.moe as r_moe
    from repro.configs.base import ShapeConfig
    from repro.optim import AdamWState
    from repro.train.step import build_step_bundle
    from jax.sharding import AxisType
    r_moe.GROUP_SIZE = GROUP
    # GSPMD's axes, which the reference was written for: JAX 0.9's
    # make_mesh defaults to explicit axes, under which the fsdp_tp
    # embedding gather does not resolve its output sharding
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for case in cases.split(","):
        inputs = dict(np.load(pathlib.Path(job_dir) / f"{case}.npz"))
        b = build_step_bundle(ref_cfg(case),
                              ShapeConfig("fsdp", SEQ, BATCH, "train"), mesh,
                              model_kw=dict(compute_dtype=jnp.float32))
        tree = lambda k: jax.tree.map(jnp.asarray, nested_arrays(inputs, k))
        params = tree("params")
        opt = AdamWState(step=jnp.int32(inputs["step"]), mu=tree("mu"),
                         nu=tree("nu"))
        batch = {k: jnp.asarray(inputs[k]) for k in ("tokens", "embeds",
                                                     "frames")
                 if k in inputs}
        f = b.jitted()
        # placed as the step returns them, so it compiles once
        params, opt, batch = jax.device_put((params, opt, batch),
                                            b.in_shardings[:3])
        rows = []
        with mesh:
            for step in STEPS:
                params, opt, m = f(params, opt, batch, jnp.int32(step))
                rows.append([float(m.get(k, 0.0)) for k in METRICS])
        out[f"{case}/metrics"] = np.asarray(rows)
        for name, t in (("params", params), ("mu", opt.mu), ("nu", opt.nu)):
            out.update({f"{case}/{k}": v for k, v in flat_arrays(
                jax.tree.map(np.asarray, t), name).items()})
    np.savez(out_path, **out)


@functools.lru_cache(maxsize=None)
def _inputs(case):
    """The reference's parameter tree filled with numpy draws, a moment
    state past warm-up, and the batch (tests/test_torch_models.py,
    tests/test_torch_train.py)."""
    from test_torch_models import _batch_np, _params_np
    from test_torch_train import _adamw_np
    rc = ref_cfg(case)
    st_np = _adamw_np(rc)
    return {"step": st_np["step"], **flat_arrays(_params_np(rc), "params"),
            **flat_arrays(st_np["mu"], "mu"), **flat_arrays(st_np["nu"], "nu"),
            **_batch_np(rc, b=BATCH, s=SEQ, seed=5)}


@functools.lru_cache(maxsize=None)
def _ref_shard_shapes(case, shape):
    """Each leaf's shard shape under the reference's param_pspecs and
    opt_pspecs on a (data, model) mesh of ``shape``."""
    import jax
    from jax.sharding import AbstractMesh
    from repro.models import build_model
    from repro.sharding.rules import MeshRules
    from repro.train.step import opt_pspecs, param_pspecs
    mesh = AbstractMesh(shape, ("data", "model"))
    model = build_model(ref_cfg(case))
    rules = MeshRules(ref_cfg(case).plan, mesh)
    sizes = dict(zip(("data", "model"), shape))
    shapes = {k[2:]: s.shape for k, s in flat_arrays(
        jax.tree.map(lambda s: np.empty(s.shape, np.int8),
                     model.abstract_params()), "x").items()}
    is_spec = dict(is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))

    def split(spec_tree, name):
        out = {}
        specs = jax.tree.leaves_with_path(spec_tree, **is_spec)
        for path, spec in specs:
            key = "/".join(str(getattr(p, "key", p)) for p in path)
            dims = list(shapes[key])
            for d, e in enumerate(spec):
                for a in (e if isinstance(e, tuple) else (e,)):
                    if a is not None:
                        dims[d] //= sizes[a]
            out[f"shape/{name}/{key}"] = tuple(dims)
        return out
    opt = opt_pspecs(model, rules)
    return {**split(param_pspecs(model, rules), "params"),
            **split(opt.mu, "mu"), **split(opt.nu, "nu")}


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


def write_inputs(d):
    """Every case's inputs, also written under ``d`` for the ranks."""
    inputs = {case: _inputs(case) for case in CASES}
    for case, v in inputs.items():
        np.savez(d / f"{case}.npz", **v)
    return inputs


def launch(d, meshes, *, ref=False, trainer=False):
    """One world of ranks per mesh of ``meshes``, with ``trainer`` one
    more for the trainer's runs on CKPT_MESH, and with ``ref`` the
    reference, all at once, on the inputs under ``d``.  Returns ({tag, or
    "trainer": [each rank's record]}, the reference's record or None)."""
    worker = ["tests/test_torch_fsdp.py"]
    argvs, envs = [], []
    jobs = [_tag(m) for m in meshes]
    jobs += ["trainer:" + _tag(CKPT_MESH)] if trainer else []
    for job in jobs:
        n, port = int(np.prod([int(x) for x in job.split(":")[-1]
                               .split("x")])), free_port()
        for r in range(n):
            argvs.append(worker + ["worker", str(d), str(d), job])
            envs.append(dict(REPRO_COORD_ADDR=f"127.0.0.1:{port}",
                             REPRO_NUM_PROCESSES=str(n),
                             REPRO_PROCESS_ID=str(r)))
    # the reference's cases in two processes: its compiles take longest
    halves = (list(CASES)[::2], list(CASES)[1::2]) if ref else ()
    for i, cases in enumerate(halves):
        argvs.append(worker + ["ref", str(d), str(d / f"ref{i}.npz"),
                               ",".join(cases)])
        envs.append(dict(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                         JAX_PLATFORMS="cpu"))
    run_procs(argvs, envs, timeout=400)
    ranks = {job.split(":")[0]: [
        dict(np.load(d / f"{job.split(':')[0]}_rank{r}.npz"))
        for r in range(int(np.prod([int(x) for x in job.split(":")[-1]
                                    .split("x")])))]
        for job in jobs}
    refs = {}
    for i in range(len(halves)):
        refs.update(np.load(d / f"ref{i}.npz"))
    return ranks, refs if ref else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks on MESHES, after writing the replicated
    checkpoint the (2, 1) ranks restore sharded and the replicated
    trainer's first three steps they resume."""
    d = tmp_path_factory.mktemp("fsdp")
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.train.trainer import Trainer, TrainerConfig
    inputs = write_inputs(d)
    save_checkpoint(str(d / "replicated"), 3,
                    _port_state(inputs[CKPT_CASE]))
    cfg, shape = _trainer_cfg()
    with f32_trainers():
        Trainer(cfg, shape, tcfg=TrainerConfig(
            steps=3, log_every=0, ckpt_dir=str(d / "t_replicated")),
            device=CPU).train()
    ranks, _ = launch(d, MESHES, trainer=True)
    return inputs, ranks


def _rank_recs(runs, shape):
    return runs[1][_tag(shape)]


def _leaves_close(got, want, prefix_got, prefix_want, tol, label):
    keys = [k for k in want if k.startswith(prefix_want + "params/")
            or k.startswith(prefix_want + "mu/")
            or k.startswith(prefix_want + "nu/")]
    assert keys, label
    for k in keys:
        np.testing.assert_allclose(
            got[prefix_got + k[len(prefix_want):]], want[k], **tol,
            err_msg=f"{label}: {k}")


def check_shard_shapes(recs, case, shape):
    """Each rank's local shapes equal the reference's shard shapes, and
    its resident bytes the sum of its shards by placement."""
    want = _ref_shard_shapes(case, shape)
    for r, rec in enumerate(recs):
        pre = f"{case}/{_tag(shape)}/"
        got = {k[len(pre):]: tuple(v) for k, v in rec.items()
               if k.startswith(pre + "shape/")}
        assert got == want, f"rank {r}"
        held, by_placement = rec[pre + "bytes"]
        assert held == by_placement, f"rank {r}: {held} != {by_placement}"


def check_replicated(recs, case, shape):
    """Every rank's metrics and rank 0's leaves against the replicated
    single-process port step."""
    want = port_replicated(case)
    pre = f"{case}/{_tag(shape)}/"
    for r, rec in enumerate(recs):
        np.testing.assert_allclose(rec[pre + "metrics"], want["metrics"],
                                   **LOSS_F32, err_msg=f"rank {r}")
    _leaves_close(recs[0], want, pre, "", STEP_F32, f"{case} on {shape}")


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("case", list(CASES))
def test_local_shards_are_the_references_shard_shapes(runs, case, shape):
    check_shard_shapes(_rank_recs(runs, shape), case, shape)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_the_replicated_step(runs, case, shape):
    check_replicated(_rank_recs(runs, shape), case, shape)


def test_checkpoints_round_trip_between_sharded_and_replicated(runs):
    for r, rec in enumerate(_rank_recs(runs, CKPT_MESH)):
        ok_rep, ok_back, ok_sh = rec["ckpt"]
        assert ok_rep, f"rank {r}: sharded -> replicated"
        assert ok_back, f"rank {r}: sharded -> sharded"
        assert ok_sh, f"rank {r}: replicated -> sharded"


def test_trainer_saves_sharded_and_resumes_either_way(runs):
    """A sharded trainer's init equals the replicated init; its run and
    both resumed runs give the losses of one replicated 5-step run."""
    from repro_torch._tree import leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg, shape = _trainer_cfg()
    with f32_trainers():
        t = Trainer(cfg, shape, tcfg=TrainerConfig(steps=5, log_every=0),
                    device=CPU)
        init = leaves(t.init_state())
        want = np.asarray([h["loss"] for h in t.train()["history"]])
    recs = runs[1]["trainer"]
    for i, x in enumerate(init):
        np.testing.assert_array_equal(recs[0][f"trainer/init/{i}"],
                                      x.numpy())
    for r, rec in enumerate(recs):
        np.testing.assert_allclose(rec["trainer/sharded_first"], want[:3],
                                   **LOSS_F32, err_msg=f"rank {r}")
        np.testing.assert_allclose(rec["trainer/sharded_then"], want[3:],
                                   **LOSS_F32, err_msg=f"rank {r}")
    np.testing.assert_allclose(recs[0]["trainer/replicated_then"], want[3:],
                               **LOSS_F32)


def test_gather_in_bf16_takes_its_gradient_in_float32(monkeypatch):
    """``fsdp.gather`` casts the shard and gathers it in the compute
    dtype; the gradient comes back summed over the Partial axes in the
    leaf's own float32 (on a world of one here)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import fsdp
    for var in ("REPRO_COORD_ADDR", "REPRO_NUM_PROCESSES",
                "REPRO_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    mesh = make_local_mesh(CPU)
    try:
        x = torch.arange(12.0).reshape(4, 3)
        w = fsdp.place(x, mesh, (Shard(0), Shard(1)))
        w.requires_grad_(True)
        with fsdp.grad_partial(mesh, ("data",)):
            y = fsdp.gather(w, torch.bfloat16)
            (3 * y.float()).sum().backward()
        assert y.dtype == torch.bfloat16 and torch.equal(y.float(), x)
        g = fsdp.local(w.grad)
        assert g.dtype == torch.float32 and torch.equal(
            g, torch.full_like(x, 3.0))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_gather_collectives_take_cuda_tensors_over_gloo():
    """The gathers and reduce-scatters are torch.distributed's
    collectives, which gloo (the backend of ranks sharing a card) takes
    on CUDA tensors -- not DTensor's redistribution, which faults there
    on torch 2.11: a gloo world of one on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    import torch.distributed as dist
    from repro_torch.sharding import fsdp
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        w = torch.arange(12.0, device="cuda").reshape(4, 3)
        got = fsdp._all_gather(w, 1, None, 1)
        assert got.is_cuda and torch.equal(got, w)
        red = fsdp._reduce_scatter(3 * w, 0, None, 1)
        assert red.is_cuda and torch.equal(red, 3 * w)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    # rank and reference entry points of the module fixture:
    #   python tests/test_torch_fsdp.py worker|ref <args...>
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    {"worker": _worker, "ref": _ref_worker}[sys.argv[1]](*sys.argv[2:])
