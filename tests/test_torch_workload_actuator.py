"""The port's workload actuator and checkpoint cost model against
``tests/test_workload.py``'s cases, the Marconi100 trace synthesiser
against ``repro.data.m100`` job for job, and the package's exports."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.core.tier3  # noqa: F401  (the reference's own import order:
import repro.workload as r_wl  # workload.model and core import each other)
from repro.data.m100 import synthesize_m100_trace as r_m100
from repro_torch import workload as wl
from repro_torch.ckpt import CheckpointManager
from repro_torch.data import synthesize_m100_trace
from repro_torch.workload import (CkptCostModel, PowerActuator, RUN_FULL,
                                  ckpt_cost, duty_run_quota)


def test_duty_run_quota_edge_cases():
    # the old trainer: int(round(0.05 * 10)) == 0 (half-even) -> shed ALL
    assert duty_run_quota(0.05, 10) == 1
    assert duty_run_quota(0.05, 20) == 1
    assert duty_run_quota(0.25, 10) == 2
    assert duty_run_quota(0.0, 10) == 0
    assert duty_run_quota(-0.1, 10) == 0
    assert duty_run_quota(1.0, 10) == 10
    assert duty_run_quota(1.5, 10) == 10
    assert duty_run_quota(0.999, 10) == 9
    assert duty_run_quota(0.39, 10) == 3
    assert duty_run_quota(0.3, 10) == 3
    assert duty_run_quota(0.7, 10) == 7


def test_duty_run_quota_monotone_bounded_and_as_reference():
    for k in (1, 3, 10, 16, 100):
        duties = np.linspace(0.0, 1.0, 97)
        quotas = [duty_run_quota(d, k) for d in duties]
        assert all(b >= a for a, b in zip(quotas, quotas[1:]))
        assert all(0 <= q <= k for q in quotas)
        assert quotas == [r_wl.duty_run_quota(d, k) for d in duties]
    with pytest.raises(ValueError, match="positive"):
        duty_run_quota(0.5, 0)


class _Plan:
    """Duck-typed PowerPlan stand-in."""

    def __init__(self, mu=0.9, duty=1.0, shed=False):
        self.mu, self.duty_cycle, self.ffr_shed = mu, duty, shed


def test_actuator_no_plan_runs_full():
    a = PowerActuator()
    assert a.decide(0, None) is RUN_FULL
    assert a.decide(7, None).throughput_frac == 1.0


def test_actuator_caps_without_shedding():
    a = PowerActuator(mix="train")
    d = a.decide(3, _Plan(mu=0.6))
    assert d.run and d.power_frac == pytest.approx(0.6)
    assert d.throughput_frac == pytest.approx(
        float(wl.throughput_frac(wl.clock_weight("train"), 0.6)), abs=1e-6)


def test_actuator_shed_runs_quota_per_window():
    a = PowerActuator(duty_quantum_steps=10)
    plan = _Plan(mu=0.5, duty=0.05, shed=True)
    assert sum(a.decide(s, plan).run for s in range(10)) == 1
    assert a.decide(0, plan).throughput_frac == pytest.approx(
        float(wl.throughput_frac(a.clock_w, 0.5)) / 10.0, abs=1e-6)


def test_actuator_quantum_configurable():
    a = PowerActuator(duty_quantum_steps=20)
    plan = _Plan(duty=0.05, shed=True)
    assert sum(a.decide(s, plan).run for s in range(20)) == 1
    with pytest.raises(ValueError, match="duty_quantum_steps"):
        PowerActuator(duty_quantum_steps=0)


@pytest.mark.parametrize("mix", ["train", "inference", "balanced"])
def test_actuator_decisions_match_reference(mix):
    ra, pa = r_wl.PowerActuator(mix=mix, duty_quantum_steps=8), \
        PowerActuator(mix=mix, duty_quantum_steps=8)
    for plan in (_Plan(0.9, 1.0, False), _Plan(0.45, 0.3, True),
                 _Plan(1.2, 0.05, True), _Plan(-0.1, 0.5, True)):
        for s in range(16):
            got, want = pa.decide(s, plan), ra.decide(s, plan)
            assert got.run == want.run and got.grid_ckpt == want.grid_ckpt
            np.testing.assert_allclose(
                [got.power_frac, got.throughput_frac],
                [want.power_frac, want.throughput_frac], rtol=1e-6)


def _tree():
    return {"w": torch.arange(24, dtype=torch.float32).reshape(6, 4),
            "b": torch.ones(4, dtype=torch.float16),
            "step": torch.tensor(7, dtype=torch.int32)}


def test_ckpt_bytes_match_real_manifest(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), n_shards=2)
    path = mgr.save(3, tree)
    assert ckpt_cost.checkpoint_bytes(path) == ckpt_cost.tree_bytes(tree)
    with open(os.path.join(path, "manifest.json")) as f:
        assert ckpt_cost.manifest_bytes(json.load(f)) == 24 * 4 + 4 * 2 + 4
    restored, step, _ = mgr.restore({k: torch.zeros_like(v)
                                     for k, v in tree.items()}, device="cpu")
    assert step == 3
    for k in tree:
        assert restored[k].shape == tree[k].shape
        assert restored[k].dtype == tree[k].dtype
    assert ckpt_cost.tree_bytes(restored) == ckpt_cost.tree_bytes(tree)
    # numpy trees count the same, as in the reference
    np_tree = {k: v.numpy() for k, v in tree.items()}
    assert ckpt_cost.tree_bytes(np_tree) == r_wl.tree_bytes(np_tree)


def test_ckpt_cost_seconds():
    m = CkptCostModel(write_bps=1e9, read_bps=2e9, overhead_s=1.0)
    assert m.save_seconds(2e9) == pytest.approx(3.0)
    assert m.restore_seconds(2e9) == pytest.approx(2.0)
    assert m.grid_event_seconds(2e9) == pytest.approx(5.0)
    assert ckpt_cost.grid_event_cost_s(_tree(), m) == pytest.approx(
        m.grid_event_seconds(ckpt_cost.tree_bytes(_tree())))
    assert dataclasses.asdict(CkptCostModel()) == dataclasses.asdict(
        r_wl.CkptCostModel())


def test_m100_trace_matches_reference():
    got = synthesize_m100_trace(200, 48.0, 64, seed=3)
    want = r_m100(200, 48.0, 64, seed=3)
    assert len(got) == len(want) > 100
    for g, w in zip(got, want):
        for f in ("jid", "submit_h", "duration_h", "nodes", "power_node_w",
                  "elastic", "d_max_h"):
            assert getattr(g, f) == getattr(w, f), f


def test_workload_package_exports_the_reference_names():
    assert set(wl.__all__) == set(r_wl.__all__)
