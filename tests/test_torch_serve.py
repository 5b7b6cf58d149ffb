"""The port's serving path against ``repro``: the shed of
``tests/test_serve_shed.py`` on ``repro_torch.launch.serve.run_serve``
(an FFR trigger fired mid-decode thins the batch within one decode step,
metered through ``repro_torch.obs.trace``), the controller's power plans,
and the safety island's trigger round trip."""
import argparse
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_common import CPU, ROOT
import repro.core.controller as r_ctl
import repro.core.island as r_island
import repro.core.tier3 as r_tier3
from repro.grid import markets
from repro.launch.serve import build_parser as r_build_parser
import repro_torch.core.controller as p_ctl
import repro_torch.core.island as p_island
from repro_torch.launch.serve import build_parser, run_serve
from repro_torch.obs import trace

PORT = 47651  # own port: must not collide with the reference's tests


def _args(**kw):
    defaults = dict(arch="smollm-135m", requests=4, prompt_len=4,
                    decode_tokens=8, gridpilot=True, island_port=PORT)
    defaults.update(kw)
    return argparse.Namespace(**defaults)


def test_island_port_flag():
    ap = build_parser()
    assert ap.parse_args([]).island_port == 47311  # the reference's default
    assert ap.parse_args(["--island-port", "47619"]).island_port == 47619
    assert vars(ap.parse_args([])) == vars(r_build_parser().parse_args([]))


def test_ffr_shed_thins_batch_and_is_traced():
    trace.get_tracer().clear()
    out = run_serve(_args(), device=CPU)

    # the shed actually happened, mid-decode, within the same step
    assert out["shed_at"] == 8 // 2
    assert out["active"] < out["batch"]
    assert out["active"] >= 1
    assert out["device"] == "cpu"

    # the shed is a traced event carrying the thinning and its latency
    evs = trace.get_tracer().events("serve.shed")
    assert len(evs) == 1
    at = evs[0]["attrs"]
    assert at["batch_from"] == 4 and at["batch_to"] == out["active"]
    assert 0.0 < at["duty_cycle"] < 1.0

    # trigger-to-thinning response span exists and beats the FFR budget
    spans = trace.get_tracer().spans("serve.ffr_response")
    assert len(spans) == 1
    resp_ms = spans[0]["wall_s"] * 1e3
    assert resp_ms == pytest.approx(out["response_ms"])
    budget_ms = float(
        markets.BUDGET_MS[markets.PRODUCT_ORDER.index("FFR")])
    assert resp_ms < budget_ms, (
        f"serve shed response {resp_ms:.1f} ms exceeds the "
        f"{budget_ms:.0f} ms FFR budget")

    assert trace.get_tracer().spans("serve.prefill")
    dec = trace.get_tracer().spans("serve.decode")
    assert dec and dec[0]["attrs"]["batch_final"] == out["active"]
    assert trace.metrics.counters.get("serve.sheds") == 1
    assert trace.metrics.summary("serve.decode_ms_per_tok")["count"] == 1


def test_ffr_shed_on_the_ssm_family():
    """mamba2 serves through decode_step and its SSM state: the FFR shed
    thins the batch at the same step, under the budget."""
    trace.get_tracer().clear()
    out = run_serve(_args(arch="mamba2-1.3b"), device=CPU)
    assert out["shed_at"] == 8 // 2
    assert 1 <= out["active"] < out["batch"]
    assert out["response_ms"] < float(
        markets.BUDGET_MS[markets.PRODUCT_ORDER.index("FFR")])
    assert len(trace.get_tracer().events("serve.shed")) == 1
    assert trace.metrics.counters.get("serve.sheds") == 1


def test_no_gridpilot_no_shed():
    trace.get_tracer().clear()
    out = run_serve(_args(gridpilot=False, decode_tokens=4), device=CPU)
    assert out["shed_at"] is None and out["active"] == out["batch"]
    assert not trace.get_tracer().events("serve.shed")


def test_run_serve_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        run_serve(_args(gridpilot=False))


@pytest.mark.parametrize("mu,rho", [(0.9, 0.3), (0.6, 0.2), (0.4, 0.3),
                                    (0.5, 0.0)])
@pytest.mark.parametrize("ffr_shed", [False, True])
def test_power_plan_matches_reference(mu, rho, ffr_shed):
    got = p_ctl.plan_from_operating_point(mu, rho, ffr_shed=ffr_shed)
    want = r_ctl.plan_from_operating_point(mu, rho, ffr_shed=ffr_shed)
    assert got == p_ctl.PowerPlan(**vars(want))
    assert got.effective_fraction == want.effective_fraction


def test_poll_ffr_sheds_from_the_current_operating_point():
    gp = p_ctl.GridPilot(n_hosts=2, chips_per_host=2, start_island=False,
                         device=CPU)
    ref = r_ctl.GridPilot(n_hosts=2, chips_per_host=2, start_island=False)
    assert gp.poll_ffr() is None
    np.testing.assert_array_equal(gp.island.table, ref.island.table)
    for g in (gp, ref):
        g.island.trigger_count += 1  # as the island thread does
    assert gp.poll_ffr() == p_ctl.PowerPlan(**vars(ref.poll_ffr()))
    assert gp.poll_ffr() is None
    pred = gp.observe_host_power(np.array([0.5, 0.7], np.float32))
    np.testing.assert_allclose(
        pred.numpy(), ref.observe_host_power(np.array([0.5, 0.7])))
    assert pred.device.type == "cpu"


def test_island_trigger_round_trip():
    assert p_island.encode_trigger(23, 49.5) == r_island.encode_trigger(
        23, 49.5)
    rows = r_tier3.cap_table(3, 900.0, 100.0, 300.0).reshape(-1)
    isl = p_island.SafetyIsland(4, np.repeat(rows[:, None], 4, axis=1),
                                port=PORT + 1)
    isl.start()
    try:
        time.sleep(0.05)
        n0 = isl.trigger_count
        isl.send_trigger(op_index=0, freq_hz=49.9)  # above 49.7: no FFR
        isl.send_trigger(op_index=23, freq_hz=49.5)
        assert isl.wait_for_trigger(n0, timeout_s=2.0)
        assert isl.trigger_count == n0 + 1
        np.testing.assert_array_equal(isl.caps, isl.table[23])
        assert isl.stats.count == 1
    finally:
        isl.stop()
    assert not isl._thread.is_alive()


def test_serving_path_imports_neither_jax_nor_repro():
    code = ("import sys; import repro_torch.launch.serve, "
            "repro_torch.models, repro_torch.core.controller; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
