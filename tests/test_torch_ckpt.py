"""The port's checkpoint manager: ``tests/test_ckpt.py``'s cases that need
no mesh, restore on a given device, bfloat16 leaves, and interchange with
``repro.ckpt`` -- a checkpoint written by either package restores in the
other, and the two manifests of the same state are identical (the port
spells leaf paths as the reference does, NamedTuple fields as
``.name``)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt as r_ckpt
from repro.optim import AdamWState as RAdamWState
from repro_torch.ckpt import (CheckpointManager, restore_checkpoint,
                              save_checkpoint)
from repro_torch.optim import AdamWState

CPU = "cpu"


def _tree(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": scale * torch.randn(16, 8, generator=g),
        "nested": {"b": scale * torch.randn(7, generator=g),
                   "scalar": torch.tensor(3.5)},
        "step": torch.tensor(11, dtype=torch.int32),
    }


def _leaves(t):
    from repro_torch._tree import leaves
    return leaves(t)


def test_roundtrip(tmp_path):
    t = _tree(0)
    save_checkpoint(str(tmp_path), 5, t, n_shards=3)
    got, step, extra = restore_checkpoint(str(tmp_path), t, device=CPU)
    assert step == 5 and extra == {}
    for a, b in zip(_leaves(t), _leaves(got)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert list(got) == list(t)  # the caller's key order


def test_shard_split_and_concat(tmp_path):
    t = {"big": torch.arange(101 * 3, dtype=torch.float32).reshape(101, 3)}
    save_checkpoint(str(tmp_path), 1, t, n_shards=4)
    shard_dirs = [d for d in os.listdir(tmp_path / "step_00000001")
                  if d.startswith("shard_")]
    assert len(shard_dirs) == 4
    got, _, _ = restore_checkpoint(str(tmp_path), t, device=CPU)
    assert torch.equal(got["big"], t["big"])


def test_restore_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree(1)
    for s in (1, 2, 3, 4):
        mgr.save(s, {k: (v + s if k != "nested" else v)
                     for k, v in t.items()})
    assert mgr.latest_step() == 4
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(dirs) == 2  # GC kept the last two
    got, step, _ = mgr.restore(t, device=CPU)
    assert step == 4
    torch.testing.assert_close(got["w"], t["w"] + 4)


def test_crash_mid_save_invisible(tmp_path):
    t = _tree(2)
    save_checkpoint(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "step_00000099.tmp")
    _, step, _ = restore_checkpoint(str(tmp_path), t, device=CPU)
    assert step == 1


def test_extra_metadata(tmp_path):
    t = {"w": torch.zeros(3)}
    save_checkpoint(str(tmp_path), 7, t, extra={"loss": 1.25})
    _, _, extra = restore_checkpoint(str(tmp_path), t, device=CPU)
    assert extra == {"loss": 1.25}


def test_restore_checks_structure_and_device(tmp_path):
    t = _tree(3)
    save_checkpoint(str(tmp_path), 1, t)
    with pytest.raises(ValueError, match="leaf count"):
        restore_checkpoint(str(tmp_path), {"w": t["w"]}, device=CPU)
    bad = dict(t, w=torch.zeros(8, 16))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), bad, device=CPU)
    with pytest.raises(RuntimeError, match="cuda"):
        restore_checkpoint(str(tmp_path), t)  # the default: the card


def test_bfloat16_leaves_roundtrip(tmp_path):
    t = {"w": torch.randn(9, 4).to(torch.bfloat16)}
    save_checkpoint(str(tmp_path), 1, t, n_shards=2)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        assert json.load(f)["leaves"][0]["dtype"] == "bfloat16"
    got, _, _ = restore_checkpoint(str(tmp_path), t, device=CPU)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t["w"])


# ---------------------------------------------------------------------------
# Interchange with repro.ckpt
# ---------------------------------------------------------------------------


def _state_np(seed=4):
    """(params, AdamW state) as numpy: the trainer's checkpoint tree."""
    rng = np.random.default_rng(seed)
    p = {"layers": {"wq": rng.standard_normal((3, 8, 8)).astype(np.float32),
                    "ln1": rng.standard_normal((3, 8)).astype(np.float32)},
         "embed": rng.standard_normal((10, 8)).astype(np.float32),
         "final_norm": np.ones(8, np.float32)}
    m = {k: (v if not isinstance(v, dict) else dict(v))
         for k, v in p.items()}
    return p, {"step": np.int32(42), "mu": m, "nu": m}


def _ref_tree(p, o):
    j = lambda t: jax.tree.map(jnp.asarray, t)
    return (j(p), RAdamWState(step=jnp.int32(o["step"]), mu=j(o["mu"]),
                              nu=j(o["nu"])))


def _port_tree(p, o):
    t = lambda d: {k: t(v) if isinstance(v, dict)
                   else torch.from_numpy(np.array(v)) for k, v in d.items()}
    return (t(p), AdamWState(step=torch.tensor(int(o["step"]),
                                               dtype=torch.int32),
                             mu=t(o["mu"]), nu=t(o["nu"])))


def _manifest(root, step):
    with open(os.path.join(root, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_manifests_are_identical(tmp_path):
    p, o = _state_np()
    r_ckpt.save_checkpoint(str(tmp_path / "ref"), 3, _ref_tree(p, o),
                           extra={"loss": 2.0})
    save_checkpoint(str(tmp_path / "port"), 3, _port_tree(p, o),
                    extra={"loss": 2.0})
    want, got = _manifest(tmp_path / "ref", 3), _manifest(tmp_path / "port",
                                                          3)
    assert got == want
    assert "1/.mu/layers/wq" in [leaf["path"] for leaf in got["leaves"]]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    p, o = _state_np(5)
    r_ckpt.save_checkpoint(str(tmp_path), 9, _ref_tree(p, o))
    like = _port_tree(*_state_np(6))
    (gp, go), step, _ = restore_checkpoint(str(tmp_path), like, device=CPU)
    assert step == 9 and int(go.step) == 42
    np.testing.assert_array_equal(gp["layers"]["wq"].numpy(),
                                  p["layers"]["wq"])
    np.testing.assert_array_equal(go.nu["embed"].numpy(), o["nu"]["embed"])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    p, o = _state_np(7)
    save_checkpoint(str(tmp_path), 2, _port_tree(p, o))
    like = _ref_tree(*_state_np(8))
    (gp, go), step, _ = r_ckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 2 and int(go.step) == 42
    np.testing.assert_array_equal(np.asarray(gp["embed"]), p["embed"])
    np.testing.assert_array_equal(np.asarray(go.mu["layers"]["ln1"]),
                                  o["mu"]["layers"]["ln1"])
