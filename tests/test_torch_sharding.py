"""The port's sharding rules (``repro_torch.sharding.rules``) and partition
specs (``repro_torch.train.step``) against the reference's, on JAX
``AbstractMesh`` shapes (1, 1), (2, 4), (4, 2) with axes (data, model)
and (2, 16, 16) with axes (pod, data, model): no device is needed, as
both rule sets read only a mesh's axis names and sizes.

The rules are held on every ``ParamSpec`` of all ten arch configs (the
reference builds every family; both rule sets get the reference model's
axes and shapes), which covers expert parallelism on olmoe-1b-7b and TP
experts on mixtral-8x22b.  The spec trees of a ``StepBundle`` are held
leaf by leaf for all ten, every family of which the port builds.  Then
``layers.shard``'s resolution, DTensor placements, and the elastic
checkpoint restore onto a (1, 1) ``DeviceMesh``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as RP

import repro.models.layers as r_layers
import repro.train.step as r_step
from repro.configs import get_arch as r_arch
from repro.configs import list_archs
from repro.configs.base import SHAPES as R_SHAPES
from repro.models import build_model as r_build
from repro.sharding.rules import MeshRules as RMeshRules
import repro_torch.models.api as p_api
import repro_torch.train.step as p_step
from repro_torch.configs import get_arch as p_arch
from repro_torch.configs.base import SHAPES as P_SHAPES
from repro_torch.models import build_model as p_build
from repro_torch.models.layers import resolve_spec, shard
from repro_torch.sharding.rules import MeshRules, P, placements

from test_torch_common import CPU

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
ARCHS = list_archs()
# the archs whose family the port builds: every one
BUILT = [a for a in ARCHS if r_arch(a).family in p_api.FAMILIES]


def _abstract(shape, axes):
    return AbstractMesh(shape, axes)


def _rules(arch, mesh):
    """The reference's and the port's rules for ``arch`` on ``mesh``; the
    port's plan is its own config's, which must equal the reference's."""
    rplan, pplan = r_arch(arch).plan, p_arch(arch).plan
    assert dataclasses.asdict(rplan) == dataclasses.asdict(pplan)
    return RMeshRules(rplan, mesh), MeshRules(pplan, mesh)


def _param_specs(arch):
    is_spec = dict(is_leaf=lambda x: isinstance(x, r_layers.ParamSpec))
    return jax.tree.leaves(r_build(r_arch(arch)).specs(), **is_spec)


def test_built_families_are_the_six():
    """Once the six archs of the dense, SSM and hybrid families; now all
    ten, the MoE, VLM and enc-dec families with them."""
    assert sorted(BUILT) == sorted(
        ["command-r-plus-104b", "mamba2-1.3b", "qwen2-1.5b",
         "smollm-135m", "yi-9b", "zamba2-2.7b", "olmoe-1b-7b",
         "mixtral-8x22b", "phi-3-vision-4.2b", "whisper-medium"])
    assert len(set(BUILT)) == len(ARCHS) == 10


@pytest.mark.parametrize("mesh_shape,axes", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_equal_the_reference(arch, mesh_shape, axes):
    mesh = _abstract(mesh_shape, axes)
    ref, port = _rules(arch, mesh)
    assert port.data_axes == ref.data_axes
    assert port.tp_axis == ref.tp_axis
    specs = _param_specs(arch)
    assert specs
    for s in specs:
        for fn in ("param", "opt"):
            want = tuple(getattr(ref, fn)(s.axes, s.shape))
            got = getattr(port, fn)(s.axes, s.shape)
            assert tuple(got) == want, (fn, s)
            assert isinstance(got, P)
        for axes_ in (s.axes, ("batch",) + tuple(s.axes)):
            assert tuple(port.activation(*axes_)) == tuple(
                ref.activation(*axes_)), axes_
    for nd in (1, 3):
        assert tuple(port.batch(nd)) == tuple(ref.batch(nd))


def test_ep_and_indivisible_cases():
    """The EP override, ZeRO-1 on dp_only and the drop of an axis that
    does not divide, at hand-picked shapes (tests/test_sharding.py)."""
    from repro_torch.configs.base import ShardingPlan
    m = _abstract((2, 4), ("data", "model"))
    ep = MeshRules(ShardingPlan(mode="fsdp_tp", moe_mode="ep"), m)
    assert ep.param(("layers", "experts", "embed", "moe_mlp"),
                    (16, 64, 2048, 1024)) == (None, "model", "data", None)
    tp = MeshRules(ShardingPlan(mode="fsdp_tp"), m)
    assert tp.param(("embed", "kv_feat"), (4096, 6)) == ("data", None)
    dp = MeshRules(ShardingPlan(mode="dp_only"), m)
    assert dp.param(("embed", "mlp"), (512, 2048)) == (None, None)
    assert dp.opt(("embed", "mlp"), (512, 2048)) == (("data", "model"), None)
    assert dp.opt(("embed",), (6,)) == ("data",)
    assert dp.opt(("embed",), (7,)) == (None,)
    assert P(("data",), [], ["a", "b"]) == ("data", None, ("a", "b"))


def _tree_equal(want, got, what):
    """A reference spec tree (dicts of PartitionSpec) against the port's,
    leaf by leaf."""
    isp = dict(is_leaf=lambda x: isinstance(x, RP))
    flat, _ = jax.tree_util.tree_flatten_with_path(want, **isp)
    assert len(flat) == len(jax.tree.leaves(got, **dict(
        is_leaf=lambda x: isinstance(x, P)))), what
    for path, spec in flat:
        node = got
        for k in path:
            node = node[k.key] if hasattr(k, "key") else getattr(node, k.name)
        assert tuple(node) == tuple(spec), (what, path)


@pytest.mark.parametrize("arch", BUILT)
def test_step_spec_trees_equal_the_reference(arch):
    """param_pspecs, opt_pspecs, batch_pspecs_for_shape and cache_pspecs
    of every shape kind, at every mesh shape.  The port's decode cache
    keeps its position counter ``cur`` as a host int, so its spec tree has
    no ``cur`` leaf."""
    rc, pc = r_arch(arch), p_arch(arch)
    rm, pm = r_build(rc), p_build(pc, device=CPU)
    for mesh_shape, axes in MESHES:
        ref, port = _rules(arch, _abstract(mesh_shape, axes))
        _tree_equal(r_step.param_pspecs(rm, ref),
                    p_step.param_pspecs(pm, port), "param")
        ro, po = r_step.opt_pspecs(rm, ref), p_step.opt_pspecs(pm, port)
        assert tuple(po.step) == tuple(ro.step) == ()
        _tree_equal(ro.mu, po.mu, "mu")
        _tree_equal(ro.nu, po.nu, "nu")
        for name, shape in R_SHAPES.items():
            pshape = P_SHAPES[name]
            want = r_step.batch_pspecs_for_shape(rm, ref, shape)
            got = p_step.batch_pspecs_for_shape(pm, port, pshape)
            assert {k: tuple(v) for k, v in got.items()} == {
                k: tuple(v) for k, v in want.items()}, name
            if shape.kind != "decode":
                continue
            b = shape.global_batch
            want = r_step.cache_pspecs(rc, ref, rm.cache_specs(
                b, shape.seq_len), b)
            got = p_step.cache_pspecs(pc, port, pm.cache_specs(
                b, shape.seq_len), b)
            assert set(want) - set(got) == {"cur"}, name
            assert {k: tuple(v) for k, v in got.items()} == {
                k: tuple(want[k]) for k in got}, name
        for bs in (1, 6, 256):
            assert tuple(p_step.batch_pspec(port, bs, 2)) == tuple(
                r_step.batch_pspec(ref, bs, 2))
            assert p_step.batch_axes_for(port, bs) == \
                r_step.batch_axes_for(ref, bs)
    assert {k: tuple(v) for k, v in p_step.metrics_spec(pm).items()} == {
        k: tuple(v) for k, v in r_step.metrics_spec(rm).items()}


def test_batch_share_tiles_the_batch():
    """Each rank's rows under batch_pspec: the widest dividing prefix of
    the data axes, row-major, the rest of the mesh replicating it."""
    from repro_torch.configs.base import ShardingPlan
    rules = MeshRules(ShardingPlan(mode="dp_only"),
                      _abstract((2, 4), ("data", "model")))
    rows = [p_step.batch_share(rules, 16, (d, m))
            for d in range(2) for m in range(4)]
    assert rows == [(2 * i, 2 * i + 2) for i in range(8)]
    # 6 rows divide over data (2) only: model ranks share their row block
    rows = {p_step.batch_share(rules, 6, (d, m))
            for d in range(2) for m in range(4)}
    assert rows == {(0, 3), (3, 6)}


SHARD_CASES = [("batch", "model", ("data", "model")),
               ("data", "heads", None), (("pod", "data"), "vocab", "model"),
               ("data", ("data", "model"), "model")]


@pytest.mark.parametrize("mesh_shape,axes", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
def test_shard_resolution_equals_the_reference(monkeypatch, mesh_shape,
                                               axes):
    """The spec ``layers.shard`` constrains to, captured from the
    reference under an abstract mesh, against ``resolve_spec``: logical
    names ("batch", "heads", "vocab") resolve to None, as do axes that do
    not divide the dimension."""
    import jax.numpy as jnp
    mesh = _abstract(mesh_shape, axes)
    sizes = dict(zip(axes, mesh_shape))
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, p: (seen.append(p), x)[1])
    for spec in SHARD_CASES:
        x = jnp.zeros((4, 6, 8))
        with jax.sharding.use_abstract_mesh(mesh):
            r_layers.shard(x, *spec)
        want = tuple(seen.pop())
        assert tuple(P(*resolve_spec(spec, x.shape, sizes))) == want, spec


@pytest.fixture
def world_of_one(monkeypatch):
    from repro_torch.launch.mesh import make_local_mesh
    for var in ("REPRO_COORD_ADDR", "REPRO_NUM_PROCESSES",
                "REPRO_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    yield make_local_mesh(CPU)
    dist.destroy_process_group()


def test_shard_redistributes_a_dtensor(world_of_one):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = world_of_one
    x = torch.arange(24.0).reshape(4, 6)
    assert shard(x, "data", "model") is x         # a plain tensor
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    out = shard(d, "batch", "model")
    assert out.placements == (Replicate(), Shard(1))
    assert torch.equal(out.full_tensor(), x)
    assert placements(mesh, P(("data", "model"), None)) == (Shard(0),
                                                            Shard(0))


def test_elastic_restore_onto_mesh(tmp_path, world_of_one):
    """Restore with ``(DeviceMesh, spec)`` shardings: each leaf a DTensor
    placed by the rules (tests/test_ckpt.py's elastic case), through a
    NamedTuple state as the trainer saves it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.configs.base import ShardingPlan
    from repro_torch.optim import AdamWState
    mesh = world_of_one
    rules = MeshRules(ShardingPlan(mode="dp_only"), mesh)
    t = AdamWState(step=torch.tensor(3, dtype=torch.int32),
                   mu={"w": torch.ones(8, 4)}, nu={"w": 2 * torch.ones(8, 4)})
    save_checkpoint(str(tmp_path), 2, t)
    sh = AdamWState(step=(mesh, P()), mu={"w": (mesh, P("data", None))},
                    nu={"w": (mesh, rules.opt(("embed", "mlp"), (8, 4)))})
    got, step, _ = restore_checkpoint(str(tmp_path), t, device=CPU,
                                      shardings=sh)
    assert step == 2
    for leaf in (got.step, got.mu["w"], got.nu["w"]):
        assert isinstance(leaf, DTensor) and leaf.device_mesh is mesh
    assert got.mu["w"].placements == (Shard(0), Replicate())
    assert got.nu["w"].placements == (Shard(0), Shard(0))
    assert torch.equal(got.nu["w"].full_tensor(), t.nu["w"])
    assert int(got.step.full_tensor()) == 3
    np.testing.assert_array_equal(got.mu["w"].to_local().numpy(),
                                  np.ones((8, 4), np.float32))
