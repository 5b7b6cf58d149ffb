"""The port's report renderers and CLI against ``repro.obs.report``.

The cases of ``tests/test_obs.py`` that cover the report run on the
port: a telemetry dict from the port's engine saved, loaded and rendered,
and host-side trace records rendered.  The same telemetry dict and the
same trace records render to identical text in both packages.
"""
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_common import CPU, ROOT
import repro_torch.core.engine as eng
from repro_torch.grid.scenarios import build_scenario_batch, product_specs
from repro_torch.obs import report as report_lib
from repro_torch.obs import trace as trace_lib

CFG = eng.EngineConfig(n_hosts=3, chips_per_host=2, e_max=8,
                       events_per_day=48.0, telemetry=True)


@pytest.fixture(scope="module")
def telemetry():
    """The port's telemetry dict of a small batch (both products, an event
    draw that triggers inside the first hour), as numpy."""
    specs = product_specs(countries=("DE", "SE"), seeds=(2,), horizon_h=1,
                          products=("FFR", "FCR-D"), reserve_rhos=(0.2,),
                          event_seeds=(3,))
    out = eng.engine_rollout(CFG, build_scenario_batch(specs, device=CPU),
                             device=CPU)
    return {k: v.numpy() for k, v in out["telemetry"].items()}


def _render(mod, tel):
    buf = io.StringIO()
    mod.render_telemetry(tel, out=buf)
    return buf.getvalue()


def _records():
    tr = trace_lib.Tracer()
    with tr.span("serve.decode", steps=4):
        tr.event("serve.shed", batch_from=4, batch_to=3)
    tr.metrics.inc("serve.sheds")
    return tr.records + [
        dict(kind="counter", name="serve.sheds", value=1.0),
        dict(kind="counter", name="service.ticks", value=600.0),
        dict(kind="counter", name="service.triggers", value=31.0),
        dict(kind="observation", name="service.trigger_to_target_ms",
             count=31, mean=1.7, p50=1.6, p95=1.9, p99=2.0, max=2.3),
        dict(kind="observation", name="service.step_ms", count=600,
             mean=1.5, p50=1.5, p95=1.8, p99=1.9, max=2.4)]


def test_report_roundtrip_and_render(telemetry, tmp_path):
    tel = telemetry
    path = str(tmp_path / "tel.json")
    report_lib.save_telemetry(tel, path)
    loaded = report_lib.load_telemetry(path)
    np.testing.assert_allclose(loaded["resp_hist"], tel["resp_hist"])

    rows = report_lib.response_rows(loaded)
    assert rows, "expected at least one product row"
    n_events = int(np.asarray(tel["resp_valid"]).sum())
    assert n_events > 0
    assert sum(r["n_events"] for r in rows) == n_events
    for r in rows:
        assert 0.0 <= r["compliance"] <= 1.0
        assert r["p50_ms"] <= r["p95_ms"] <= r["max_ms"] + 1e-9

    text = _render(report_lib, loaded)
    assert "deadline" in text
    assert "FFR" in text and "FCR-D" in text


def test_report_saves_tensor_leaves(telemetry, tmp_path):
    path = str(tmp_path / "tel_t.json")
    report_lib.save_telemetry({k: torch.as_tensor(v)
                               for k, v in telemetry.items()}, path)
    loaded = report_lib.load_telemetry(path)
    for k, v in telemetry.items():
        np.testing.assert_array_equal(loaded[k], v)


def test_report_renders_trace_records():
    buf = io.StringIO()
    report_lib.render_trace(_records(), out=buf)
    text = buf.getvalue()
    assert "serve.decode" in text and "serve.shed" in text
    assert "online service" in text and "700 ms" in text


def test_telemetry_renders_as_the_reference_does(telemetry):
    """One telemetry dict, both renderers: identical text.  The port's
    own dict, and the reference's dict of the same batch."""
    import jax
    import repro.core.engine as r_eng
    from repro.grid.scenarios import build_scenario_batch as r_build
    from repro.grid.scenarios import product_specs as r_specs
    from repro.obs import report as r_report
    assert _render(report_lib, telemetry) == _render(r_report, telemetry)
    r_cfg = r_eng.EngineConfig(n_hosts=2, chips_per_host=2, e_max=8,
                               events_per_day=48.0, telemetry=True)
    rb = r_build(r_specs(countries=("PL",), seeds=(2,), horizon_h=1,
                         products=("FFR",), reserve_rhos=(0.2,),
                         event_seeds=(3,)))
    ref_tel = jax.tree.map(np.asarray,
                           r_eng.engine_rollout(r_cfg, rb)["telemetry"])
    assert _render(report_lib, ref_tel) == _render(r_report, ref_tel)


def test_trace_renders_as_the_reference_does():
    from repro.obs import report as r_report
    a, b = io.StringIO(), io.StringIO()
    report_lib.render_trace(_records(), out=a)
    r_report.render_trace(_records(), out=b)
    assert a.getvalue() == b.getvalue()


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                           *args], env=env, capture_output=True, text=True,
                          timeout=120)


def test_cli_renders_saved_telemetry_and_traces(telemetry, tmp_path):
    path = str(tmp_path / "tel.json")
    report_lib.save_telemetry(telemetry, path)
    res = _cli("--telemetry", path)
    assert res.returncode == 0, res.stderr
    assert res.stdout == _render(report_lib,
                                 report_lib.load_telemetry(path))
    tr = trace_lib.Tracer()
    with tr.span("dispatch.run", horizon_h=2):
        pass
    jsonl = tr.export_jsonl(str(tmp_path / "trace.jsonl"))
    res = _cli("--trace", jsonl)
    assert res.returncode == 0 and "dispatch.run" in res.stdout


def test_sweep_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        report_lib.sweep_telemetry(fast=True)
    res = _cli("--sweep", "--fast")
    assert res.returncode != 0 and "cuda" in res.stderr


def test_sweep_telemetry_shape_on_the_cpu(monkeypatch):
    """``sweep_telemetry`` builds the E9 batch, runs the port's engine with
    the taps on and returns numpy leaves; the rollout is replaced by a
    1 h batch here to keep the test short."""
    calls = {}
    real = eng.engine_rollout

    def short(cfg, batch, **kw):
        calls["n"], calls["h"] = batch.n, batch.h_max
        calls["telemetry"] = cfg.telemetry
        small = build_scenario_batch(product_specs(
            countries=("SE",), horizon_h=1), device=CPU)
        return real(dataclasses.replace(cfg, n_hosts=2), small, **kw)

    monkeypatch.setattr(eng, "engine_rollout", short)
    tel = report_lib.sweep_telemetry(fast=True, device=CPU)
    assert calls == {"n": 6, "h": 6, "telemetry": True}
    assert all(isinstance(v, np.ndarray) for v in tel.values())
    assert "resp_hist" in tel and tel["hour_n"].shape == (1, 1)


def test_sweep_telemetry_hours_cut_the_horizon(monkeypatch):
    """``hours=`` cuts the fast slice's 6 h (the rollout stubbed as in
    test_sweep_telemetry_shape_on_the_cpu)."""
    seen = {}
    real = eng.engine_rollout

    def short(cfg, batch, **kw):
        seen["n"], seen["h"] = batch.n, batch.h_max
        small = build_scenario_batch(product_specs(
            countries=("SE",), horizon_h=1), device=CPU)
        return real(dataclasses.replace(cfg, n_hosts=2), small, **kw)

    monkeypatch.setattr(eng, "engine_rollout", short)
    report_lib.sweep_telemetry(fast=True, device=CPU, hours=2)
    assert seen == {"n": 6, "h": 2}
