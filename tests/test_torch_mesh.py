"""The port's mesh layer (``repro_torch.launch.mesh``): every case of
``tests/test_mesh.py`` on the port, the two-rank env contract on gloo,
``make_local_mesh`` as a world of one, the data-parallel launcher on two
ranks, and a walk of the reference's public names of the mesh, sharding,
step and compression modules."""
import importlib
import inspect
import json

import pytest
import torch
import torch.distributed as dist

from test_torch_common import CPU, ROOT, run_ranks
from repro_torch.launch import mesh as mesh_lib


@pytest.fixture
def no_group():
    """The test starts and ends with no process group in this process."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# -- process_slice -----------------------------------------------------------


def test_process_slice_is_identity_single_process(no_group):
    assert mesh_lib.process_slice(7) == (0, 7)
    assert mesh_lib.process_slice(0) == (0, 0)


@pytest.mark.parametrize("n_total,n_proc", [(10, 3), (7, 2), (5, 5),
                                            (3, 4), (100, 7)])
def test_process_slice_partitions_exactly(monkeypatch, n_total, n_proc):
    """Slices tile [0, n_total) exactly, balanced to within one element,
    for every process id -- including more processes than work."""
    slices = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: n_proc)
    for pid in range(n_proc):
        monkeypatch.setattr(dist, "get_rank", lambda p=pid: p)
        slices.append(mesh_lib.process_slice(n_total))
    assert slices[0][0] == 0 and slices[-1][1] == n_total
    sizes = [hi - lo for lo, hi in slices]
    assert sum(sizes) == n_total
    assert max(sizes) - min(sizes) <= 1
    for (_, hi), (lo, _) in zip(slices, slices[1:]):
        assert hi == lo                      # contiguous, no gaps/overlap


# -- distributed env contract ------------------------------------------------


def _set_env(monkeypatch, addr=None, n=None, pid=None):
    for var, val in ((mesh_lib.COORD_ADDR_ENV, addr),
                     (mesh_lib.NUM_PROCESSES_ENV, n),
                     (mesh_lib.PROCESS_ID_ENV, pid)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, str(val))


def test_distributed_env_absent(monkeypatch):
    _set_env(monkeypatch)
    assert mesh_lib.distributed_env() is None


def test_distributed_env_complete(monkeypatch):
    _set_env(monkeypatch, "127.0.0.1:1234", 2, 1)
    assert mesh_lib.distributed_env() == ("127.0.0.1:1234", 2, 1)


def test_distributed_env_partial_is_an_error(monkeypatch):
    """Address without count/id must fail loudly, not silently fall back
    to a single-process sweep of the full scenario range."""
    _set_env(monkeypatch, addr="127.0.0.1:1234")
    with pytest.raises(RuntimeError, match=mesh_lib.NUM_PROCESSES_ENV):
        mesh_lib.distributed_env()
    _set_env(monkeypatch, addr="127.0.0.1:1234", n=2)
    with pytest.raises(RuntimeError, match=mesh_lib.PROCESS_ID_ENV):
        mesh_lib.distributed_env()


def test_distributed_env_pid_out_of_range(monkeypatch):
    _set_env(monkeypatch, "127.0.0.1:1234", 2, 2)
    with pytest.raises(RuntimeError, match="out of range"):
        mesh_lib.distributed_env()


def test_ensure_distributed_noop_without_env(monkeypatch, no_group):
    _set_env(monkeypatch)
    assert mesh_lib.ensure_distributed(CPU) is False
    assert not dist.is_initialized()


def test_ensure_distributed_two_ranks_on_gloo(tmp_path):
    """Two processes under the REPRO_* contract on a free localhost port:
    one gloo group of two, each rank its slice and one CPU lane."""
    run_ranks(["tests/test_torch_common.py", "ensure", str(tmp_path)],
              timeout=120)
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    assert [r["rank"] for r in recs] == [0, 1]
    for r in recs:
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["sum"] == 3.0 and r["devices"] == ["cpu"]
        assert r["local_mesh"] == [2, 1]
    assert [tuple(r["slice"]) for r in recs] == [(0, 4), (4, 7)]


def test_choose_backend():
    assert mesh_lib.choose_backend("cpu", 1) == "gloo"
    n = torch.cuda.device_count()
    assert mesh_lib.choose_backend("cuda", n + 1) == "gloo"  # shared card


# -- resolve_mesh ------------------------------------------------------------


def test_resolve_local_scenario_mesh():
    mesh = mesh_lib.resolve_mesh("local", device=CPU)
    assert mesh.axis_names == (mesh_lib.SCENARIO_AXIS,)
    assert mesh.devices == (torch.device(CPU),)
    assert mesh.shape == {mesh_lib.SCENARIO_AXIS: 1}


def test_resolve_local_caps_device_count():
    mesh = mesh_lib.resolve_mesh("local", n_devices=1, device=CPU)
    assert len(mesh.devices) == 1


def test_resolve_mesh_passthrough():
    mesh = mesh_lib.ScenarioMesh((CPU, CPU))
    assert mesh_lib.resolve_mesh(mesh) is mesh
    assert mesh.shape == {"scenario": 2}
    assert mesh.devices == (torch.device(CPU),) * 2
    with pytest.raises(ValueError, match="one device"):
        mesh_lib.ScenarioMesh(())


def test_resolve_auto_is_local_without_env(monkeypatch, no_group):
    _set_env(monkeypatch)
    mesh = mesh_lib.resolve_mesh("auto", device=CPU)
    assert mesh.axis_names == (mesh_lib.SCENARIO_AXIS,)


def test_resolve_distributed_requires_env(monkeypatch, no_group):
    _set_env(monkeypatch)
    with pytest.raises(RuntimeError, match=mesh_lib.COORD_ADDR_ENV):
        mesh_lib.resolve_mesh("distributed", device=CPU)


def test_resolve_mesh_rejects_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        mesh_lib.resolve_mesh("cluster", device=CPU)


def test_resolve_local_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        mesh_lib.resolve_mesh("local")


# -- training meshes, deprecated shims ---------------------------------------


def test_make_local_mesh_is_a_world_of_one(monkeypatch, no_group):
    _set_env(monkeypatch)
    mesh = mesh_lib.make_local_mesh(CPU)
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    again = mesh_lib.make_local_mesh(CPU)    # reuses the group
    assert tuple(again.shape) == (1, 1)


def test_pod_mesh_needs_its_world(monkeypatch, no_group):
    _set_env(monkeypatch)
    with pytest.raises(ValueError, match="256 devices"):
        mesh_lib.pod_mesh(device=CPU)
    mesh_lib.make_local_mesh(CPU)
    with pytest.raises(ValueError, match="512 devices.*world has 1"):
        mesh_lib.pod_mesh(multi_pod=True, device=CPU)


def test_make_scenario_mesh_shim_warns_and_delegates():
    with pytest.deprecated_call(match="resolve_mesh"):
        mesh = mesh_lib.make_scenario_mesh(1, device=CPU)
    assert mesh.axis_names == (mesh_lib.SCENARIO_AXIS,)
    assert len(mesh.devices) == 1


def test_make_production_mesh_shim_warns_and_delegates(no_group):
    # the pod topology needs 256 ranks: the warning must still fire before
    # the delegated pod_mesh sizing error
    with pytest.deprecated_call(match="pod_mesh"), \
            pytest.raises(ValueError, match="devices"):
        mesh_lib.make_production_mesh(device=CPU)


def test_importing_the_mesh_starts_nothing():
    """Importing the mesh layer initialises no process group and no
    CUDA context."""
    import os
    import subprocess
    import sys
    code = ("import torch, torch.distributed as dist; "
            "import repro_torch.launch.mesh, repro_torch.sharding, "
            "repro_torch.train.step, repro_torch.core.engine; "
            "assert not dist.is_initialized(); "
            "assert not torch.cuda.is_initialized()")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr


def test_launcher_trains_data_parallel_on_two_ranks():
    """``launch.train`` under the REPRO_* contract: a gloo world of two,
    each rank on half of every batch."""
    outs = run_ranks(["-m", "repro_torch.launch.train", "--steps", "2",
                      "--batch", "4", "--seq", "16", "--device", CPU])
    for out in outs:
        assert "done: 2 steps" in out, out
    assert outs[0].splitlines()[-1] == outs[1].splitlines()[-1]


# -- the reference's public names resolve in the port ------------------------

# names of the reference's modules that the port does not define, by
# design (ROADMAP §C): JAX's jit/lower surface and its NamedSharding
# helpers, whose place the port's DTensor placements take
_BY_DESIGN = {"MeshRules.named", "MeshRules.spec_tree_to_shardings",
              "StepBundle.jitted", "StepBundle.lower",
              "StepBundle.donate_argnums"}


def _public(mod):
    for name, obj in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj):
            if obj.__module__ == mod.__name__:
                yield name, obj
        elif name.isupper():
            yield name, obj


@pytest.mark.parametrize("module", ["launch.mesh", "sharding.rules",
                                    "train.step", "optim.compress"])
def test_reference_public_names_resolve_in_the_port(module):
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    missing = []
    for name, obj in _public(ref):
        if not hasattr(port, name):
            missing.append(name)
            continue
        if inspect.isclass(obj):
            missing += [f"{name}.{m}" for m in vars(obj)
                        if not m.startswith("_")
                        and not hasattr(getattr(port, name), m)]
        elif not callable(obj):
            assert getattr(port, name) == obj, name
    assert set(missing) <= _BY_DESIGN, missing


# -- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_two_lanes_on_one_card_match_one_lane():
    """engine_rollout split over two lanes of one card (N = 3, padded to
    4) against mesh=None, and the sweep's lanes: the same numbers to
    float32 reassociation, counts exact."""
    import repro_torch.core.engine as eng
    from repro_torch.grid.scenarios import build_scenario_batch, \
        product_specs
    card = _card()
    cfg = eng.EngineConfig(n_hosts=2, chips_per_host=2, e_max=8,
                           events_per_day=48.0)
    specs = product_specs(countries=("DE", "SE", "PL"), seeds=(1,),
                          horizon_h=1, reserve_rhos=(0.2,),
                          event_seeds=(3,))
    batch = build_scenario_batch(specs, device=card)
    lanes = mesh_lib.ScenarioMesh((card, card))
    whole = eng.engine_rollout(cfg, batch, device=card)
    split = eng.engine_rollout(cfg, batch, mesh=lanes, device=card)
    for k in ("it_mwh", "fac_mwh", "net_eur", "mean_mu", "chip_power_mean"):
        torch.testing.assert_close(split[k], whole[k], rtol=1e-3, atol=1e-4)
    for k in ("n_events", "active_s", "n_compliant"):
        assert torch.equal(split[k], whole[k]), k
    swept = eng.engine_sweep(cfg, specs, chunk_size=3, mesh=lanes,
                             device=card)
    mono = eng.sweep_finalize(eng.chunk_summary(cfg, whole, batch))
    assert swept["n_scenarios"] == 3.0
    assert swept["n_events"] == mono["n_events"]
    assert swept["net_eur"] == pytest.approx(mono["net_eur"], rel=1e-3,
                                             abs=1e-4)


@pytest.mark.cuda
def test_compressed_psum_on_nccl_world_of_one(monkeypatch, no_group):
    """A world of one on NCCL: the shared scale is the rank's own, so the
    all-reduced payload is q x s exactly, through an int32 SUM."""
    from repro_torch.optim import compressed_psum, quantize_int8
    card = _card()
    for var in (mesh_lib.COORD_ADDR_ENV, mesh_lib.NUM_PROCESSES_ENV,
                mesh_lib.PROCESS_ID_ENV):
        monkeypatch.delenv(var, raising=False)
    mesh = mesh_lib.make_local_mesh("cuda")
    assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(1000, 33, device=card, generator=g)
    q, s = quantize_int8(x)
    out = compressed_psum({"x": q}, {"x": s})["x"]
    assert out.is_cuda
    assert torch.equal(out, q.float() * s)
