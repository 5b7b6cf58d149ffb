"""The int8 error-feedback data-parallel step (``make_compressed_train_step``,
``compressed_psum``) and the data-parallel trainer, against the
reference, on reduced qwen2-1.5b (2 layers, d 64) in float32:

- a world of one (a gloo group on an in-memory store) in this process
  against the reference's step on a (1, 1) mesh;
- two gloo ranks (processes under the REPRO_* contract) against the
  reference on a (2, 1) mesh of two XLA CPU devices, run in a subprocess
  with ``XLA_FLAGS=--xla_force_host_platform_device_count=2``;
- ``compressed_psum`` alone on two ranks against numpy;
- the plain data-parallel step and ``Trainer`` on two ranks against one
  process on the whole batch.

Where the two frameworks' float32 gradients straddle a rounding
boundary, an element of the int8 payload can differ by one step of the
shared scale; so residuals (the payload's error) and parameters are held
to one shared-scale quantum elementwise, the loss and the all-reduced
gradient's norm at 1e-5.  The
elements that needed more than float32 noise are counted, printed
(``-s``) and held to at most one in a thousand.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_common import (COMPRESSED_STEPS, CPU, flat_arrays,
                               port_compressed_run, ref_compressed_run,
                               run_procs, free_port)
from test_torch_models import _params_np
from test_torch_train import _adamw_np
from repro.configs import get_arch as r_arch
import repro_torch.train.step as st
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_local_mesh

ARCH = "qwen2-1.5b"
STEP_F32 = dict(rtol=1e-4, atol=1e-7)     # tests/test_torch_train.py


def _inputs(batch=4, seq=16):
    rc = r_arch(ARCH).reduced()
    st_np = _adamw_np(rc)
    tok = np.random.default_rng(7).integers(0, rc.vocab_size, (batch, seq))
    return {"tokens": tok.astype(np.int32), "step": st_np["step"],
            **flat_arrays(_params_np(rc), "params"),
            **flat_arrays(st_np["mu"], "mu"),
            **flat_arrays(st_np["nu"], "nu")}


def _sorted_leaves(keys):
    """Leaf paths in the trees' flattening order (dict keys sorted at
    every level)."""
    return sorted(keys, key=lambda k: tuple(k.split("/")))


def _check_compressed(got, ref, rank, label):
    """One rank's losses, residual and parameters after the steps against
    the reference's (its residual's row ``rank``)."""
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=1e-5)
    res_keys = _sorted_leaves(k for k in got if k.startswith("res/"))
    quantum = dict(zip(res_keys, np.max(got["scales"], axis=0)))
    used = total = 0
    for k in res_keys + [k for k in got if k.startswith("params/")]:
        q = quantum["res/" + k.split("/", 1)[1]]
        want = ref[k][rank] if k.startswith("res/") else ref[k]
        err = np.abs(got[k].astype(np.float64) - want)
        noise = 1e-5 * np.abs(want).max() + 1e-7
        assert err.max() <= q + noise, (k, err.max(), q)
        used += int((err > noise).sum())
        total += err.size
    print(f"{label} rank {rank}: {used} of {total} elements of the "
          f"residuals and parameters needed the quantum")
    # a straddled boundary is rare; a wrong gradient moves most elements
    # (each residual is within half a quantum of 0 whatever its gradient)
    assert used <= 1e-3 * total, (label, rank, used, total)


@pytest.fixture
def world_of_one(monkeypatch):
    for var in ("REPRO_COORD_ADDR", "REPRO_NUM_PROCESSES",
                "REPRO_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    yield make_local_mesh(CPU)
    dist.destroy_process_group()


def test_compressed_step_world_of_one_matches_reference(world_of_one):
    inputs = _inputs()
    ref = ref_compressed_run(inputs)
    got = port_compressed_run(inputs)
    assert got["rows"].tolist() == [0, 4]
    assert ref["res/embed"].shape[0] == 1
    _check_compressed(got, ref, 0, "world of one")


def test_compressed_step_launches_two_collectives_a_leaf(world_of_one,
                                                         monkeypatch):
    """A MAX and a SUM per parameter leaf, and one mean each for loss, ce,
    zloss and aux: 2 x leaves + 4 all-reduces a step, the gradient's in
    int32."""
    cfg = get_arch(ARCH).reduced()
    shape = ShapeConfig("c", 16, 2, "train")
    b = st.build_step_bundle(cfg, shape, device=CPU, mesh=world_of_one,
                             compressed=True)
    params = b.model.init(0)
    from repro_torch.optim import adamw_init
    opt, res = adamw_init(params), st.init_residual(b.model, b.rules)
    calls, orig = [], dist.all_reduce

    def counting(t, *a, **kw):
        calls.append((t.dtype, t.numel()))
        return orig(t, *a, **kw)

    monkeypatch.setattr(dist, "all_reduce", counting)
    tokens = torch.zeros((2, 16), dtype=torch.int32)
    params, opt, res2, m = b.step_fn(params, opt, res, {"tokens": tokens}, 0)
    leaves = len(flat_arrays(params, "p"))
    assert len(calls) == 2 * leaves + 4
    assert sum(k == torch.int32 for k, _ in calls) == leaves
    assert sum(c for d, c in calls if d == torch.int32) == sum(
        v.size for v in flat_arrays(params, "p").values())
    assert res2 is res and set(m) >= {"loss", "ce", "zloss", "aux", "lr"}


def test_compressed_step_refuses_what_it_cannot_run(world_of_one):
    from repro_torch.configs.base import ShardingPlan
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import MeshRules
    model = build_model(get_arch(ARCH).reduced(), device=CPU)
    fsdp = MeshRules(ShardingPlan(mode="fsdp_tp"), world_of_one)
    with pytest.raises(ValueError, match="dp_only"):
        st.make_compressed_train_step(model, fsdp)
    with pytest.raises(ValueError, match="needs a mesh"):
        st.build_step_bundle(get_arch(ARCH).reduced(),
                             ShapeConfig("c", 16, 2, "train"), device=CPU,
                             compressed=True)


def test_trainer_on_a_world_of_one_mesh(world_of_one, tmp_path):
    """A data-parallel trainer on a world of one takes the whole batch and
    runs the single-device trainer's numbers; resize onto a mesh restores
    through the checkpoint and records the mesh."""
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_arch("smollm-135m").reduced()
    shape = ShapeConfig("dp", 16, 4, "train")
    one = Trainer(cfg, shape, tcfg=TrainerConfig(steps=3, log_every=0),
                  device=CPU).train()
    tc = TrainerConfig(steps=3, log_every=0, ckpt_dir=str(tmp_path))
    t = Trainer(cfg, shape, world_of_one, tc, device=CPU)
    assert t.health.n_hosts == 1 and t._rows == (0, 4)
    dp = t.train()
    assert [h["loss"] for h in dp["history"]] == [
        h["loss"] for h in one["history"]]
    t2 = Trainer(cfg, shape, tcfg=TrainerConfig(steps=5, log_every=0,
                                                ckpt_dir=str(tmp_path)),
                 device=CPU).resize(world_of_one)
    out = t2.train()
    ev = [e for e in t2.events if e["event"] in ("resized", "restored")]
    assert ev[0]["mesh"] == "{'data': 1, 'model': 1}"
    assert ev[1]["event"] == "restored" and ev[1]["step"] == 3
    assert [h["step"] for h in out["history"]] == [3, 4]
    with pytest.raises(ValueError, match="cpu mesh"):
        Trainer(cfg, shape, world_of_one, tc, device="meta")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two port ranks (the compressed step, the plain data-parallel step,
    a data-parallel Trainer, compressed_psum) and the reference on two
    XLA devices, all at once."""
    d = tmp_path_factory.mktemp("two_ranks")
    np.savez(d / "in.npz", **_inputs())
    port = free_port()
    worker = ["tests/test_torch_common.py"]
    envs = [dict(REPRO_COORD_ADDR=f"127.0.0.1:{port}",
                 REPRO_NUM_PROCESSES="2", REPRO_PROCESS_ID=str(r))
            for r in range(2)]
    envs.append(dict(XLA_FLAGS="--xla_force_host_platform_device_count=2",
                     JAX_PLATFORMS="cpu"))
    run_procs([worker + ["data_parallel", str(d / "in.npz"), str(d)]] * 2
              + [worker + ["ref_compressed", str(d / "in.npz"),
                           str(d / "ref.npz")]], envs, timeout=300)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return ranks, dict(np.load(d / "ref.npz"))


def _part(rec, prefix):
    return {k[len(prefix) + 1:]: v for k, v in rec.items()
            if k.startswith(prefix + "/")}


def test_compressed_step_two_ranks_matches_reference(two_ranks):
    ranks, ref = two_ranks
    assert ref["res/embed"].shape[0] == 2
    for r, rec in enumerate(ranks):
        got = _part(rec, "compressed")
        assert got["rows"].tolist() == [2 * r, 2 * r + 2]
        _check_compressed(got, ref, r, "two ranks")
    # the merged update is the same on both ranks; the residuals are not
    a, b = (_part(x, "compressed") for x in ranks)
    for k in a:
        if k.startswith("params/"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.array_equal(a["res/embed"], b["res/embed"])


def test_compressed_psum_two_ranks_matches_numpy(two_ranks):
    """A MAX of the scales, each rank's payload requantised to it (round
    half to even), an int32 SUM, times the shared scale."""
    ranks, _ = two_ranks
    for k in ("leaf0", "leaf1", "leaf2"):
        qs = [x[f"psum/q/{k}"].astype(np.float32) for x in ranks]
        ss = [np.float32(x[f"psum/s/{k}"]) for x in ranks]
        sh = max(ss)
        total = sum(np.clip(np.round((q * s) / sh), -127, 127)
                    .astype(np.int32) for q, s in zip(qs, ss))
        want = total.astype(np.float32) * sh
        for x in ranks:
            np.testing.assert_array_equal(x[f"psum/out/{k}"], want)


def test_data_parallel_step_two_ranks_equals_whole_batch(two_ranks):
    """Each rank's half batch, gradients, loss and metrics averaged with
    all_reduce: the step of one process on the whole batch."""
    ranks, _ = two_ranks
    for rec in ranks:
        single, dp = _part(rec, "single"), _part(rec, "dp")
        np.testing.assert_allclose(dp["loss"], single["loss"], rtol=1e-5)
        for k in single:
            if k.startswith("params/"):
                np.testing.assert_allclose(dp[k], single[k], **STEP_F32,
                                           err_msg=k)


def test_data_parallel_trainer_two_ranks_equals_single(two_ranks):
    ranks, _ = two_ranks
    for rec in ranks:
        np.testing.assert_allclose(rec["dp/trainer_loss"],
                                   rec["single/trainer_loss"], rtol=1e-5)
    assert len(ranks[0]["dp/trainer_loss"]) == 3
    np.testing.assert_array_equal(ranks[0]["dp/trainer_loss"],
                                  ranks[1]["dp/trainer_loss"])
    assert COMPRESSED_STEPS == (150, 151)
