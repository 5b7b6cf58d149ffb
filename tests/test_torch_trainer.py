"""The port's trainer: ``tests/test_train_integration.py`` on the port --
the FFR trigger sheds steps, the pipeline is seekable, the duty quantum,
the grid-event checkpoint, the telemetry buffer, stragglers -- and the
reference's three slow cases (loss decreases, a restart continues, a
resize restores), unmarked here: on reduced smollm-135m at (4, 64) each
takes a few seconds on the CPU.  Also the launcher's CLI."""
import time

import numpy as np
import pytest
import torch

from test_torch_common import CPU
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.controller import PowerPlan
from repro_torch.train.trainer import HostHealth, Trainer, TrainerConfig

SHAPE = ShapeConfig("tiny", 64, 4, "train")
ISLAND_PORT = 47671        # the reference's tests use 47521


def _trainer(steps=12, device=CPU, **kw):
    cfg = get_arch("smollm-135m").reduced()
    return Trainer(cfg, SHAPE, tcfg=TrainerConfig(steps=steps, log_every=0,
                                                  **kw), device=device)


def test_loss_decreases():
    out = _trainer(steps=25).train()
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 25
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert all(np.isfinite(l) for l in losses)


def test_checkpoint_restart_continues(tmp_path):
    out1 = _trainer(steps=10, ckpt_dir=str(tmp_path), ckpt_every=5).train()
    t2 = _trainer(steps=14, ckpt_dir=str(tmp_path), ckpt_every=5)
    out2 = t2.train()
    assert any(e["event"] == "restored" for e in t2.events)
    assert out2["history"][0]["step"] >= 10
    # the restart continues the same run: an unbroken run to 14 steps
    # takes the same losses at steps 10-13
    full = _trainer(steps=14).train()["history"]
    np.testing.assert_allclose([h["loss"] for h in out2["history"]],
                               [h["loss"] for h in full[10:]], rtol=1e-5)
    assert len(out1["history"]) == 10


def test_elastic_resize_restores(tmp_path):
    t1 = _trainer(steps=6, ckpt_dir=str(tmp_path), ckpt_every=3)
    t1.train()
    t2 = t1.resize(CPU)
    t2.tcfg = TrainerConfig(steps=10, log_every=0, ckpt_dir=str(tmp_path))
    t2.ckpt = t1.ckpt
    out = t2.train()
    assert any(e["event"] == "resized" for e in t2.events)
    assert any(e["event"] == "restored" for e in t2.events)
    assert out["history"][-1]["step"] >= 8


def test_ffr_trigger_sheds_steps():
    from repro_torch.core.controller import GridPilot
    gp = GridPilot(n_hosts=1, chips_per_host=1, island_port=ISLAND_PORT,
                   device=CPU)
    try:
        gp.hourly_plan(np.full(24, 300.0), np.full(24, 15.0))
        t = _trainer(steps=20)
        t.gp = gp
        gp.fire_test_trigger()  # before training: the first poll sees it
        time.sleep(0.05)
        out = t.train()
        assert out["skipped"] > 0
        assert any(e["event"] == "ffr_shed" for e in out["events"])
        assert all(np.isfinite(h["loss"]) for h in out["history"])
    finally:
        gp.close()


def test_data_pipeline_seekable():
    from repro_torch.data.tokens import TokenPipeline
    p = TokenPipeline(batch=2, seq=16, vocab=100, seed=3, device=CPU)
    a, b, c = (p.batch_at(s)["tokens"] for s in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.max()) < 100 and a.dtype == torch.int32
    it = p.iterate(7)
    try:
        assert torch.equal(next(it)["tokens"], a)
        assert torch.equal(next(it)["tokens"], c)
    finally:
        it.close()


def test_pipeline_token_override():
    from repro_torch.data.tokens import TokenPipeline
    ref = np.arange(32, dtype=np.int32).reshape(2, 16)
    p = TokenPipeline(batch=2, seq=16, vocab=100, device=CPU,
                      tokens=lambda step: ref + step)
    np.testing.assert_array_equal(p.batch_at(3)["tokens"].numpy(), ref + 3)
    # a dict carries the reference's embeds or frames beside the tokens
    frames = np.linspace(-1, 1, 2 * 5 * 4, dtype=np.float32).reshape(2, 5, 4)
    p = TokenPipeline(batch=2, seq=16, vocab=100, device=CPU,
                      tokens=lambda step: {"tokens": ref + step,
                                           "frames": frames * step})
    got = p.batch_at(2)
    assert set(got) == {"tokens", "frames"}
    assert got["tokens"].dtype == torch.int32
    assert got["frames"].dtype == torch.float32
    np.testing.assert_array_equal(got["frames"].numpy(), frames * 2)


@pytest.mark.parametrize("key", ["embeds", "frames"])
def test_data_pipeline_draws_frontend_inputs(key):
    """The VLM's embeds and the enc-dec family's frames: the same for the
    same (seed, step), 0.02 x standard normals (mean 0, spread 0.02)."""
    from repro_torch.data.tokens import TokenPipeline, synthetic_batch
    kw = {"embeds": dict(frontend_tokens=64), "frames": dict(
        encoder_seq=64)}[key]
    p = TokenPipeline(batch=2, seq=16, vocab=100, seed=3, d_model=128,
                      device=CPU, **kw)
    a, b, c = (p.batch_at(s) for s in (7, 7, 8))
    assert set(a) == {"tokens", key}
    assert tuple(a[key].shape) == (2, 64, 128)
    assert a[key].dtype == torch.float32
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    assert torch.equal(a[key], synthetic_batch(3, 7, 2, 16, 100, d_model=128,
                                               **kw)[key])
    # the tokens are the token-only pipeline's
    assert torch.equal(a["tokens"], TokenPipeline(
        batch=2, seq=16, vocab=100, seed=3, device=CPU).batch_at(7)["tokens"])
    x = a[key].double()
    assert abs(float(x.mean())) < 5e-4
    assert float(x.std()) == pytest.approx(0.02, rel=0.02)


class _FakeGP:
    """Duck-typed GridPilot stand-in for the trainer's power hooks."""

    def __init__(self, n_hosts=3, chips_per_host=2, chip_tdp=300.0,
                 plans=()):
        self.n_hosts = n_hosts
        self.chips_per_host = chips_per_host
        self.chip_tdp = chip_tdp
        self._plans = list(plans)
        self.observed = []

    def poll_ffr(self):
        return self._plans.pop(0) if self._plans else None

    def observe_host_power(self, buf):
        self.observed.append(np.array(buf, copy=True))


def _shed_plan(duty):
    return PowerPlan(mu=0.5, rho=0.1, duty_cycle=duty, replica_scale=1.0,
                     cap_tokens_frac=1.0, ffr_shed=True)


def test_duty_quantum_configurable_and_small_duty_runs():
    t = _trainer(steps=2, duty_quantum_steps=20)
    t.gp = _FakeGP()
    t.plan = _shed_plan(0.05)
    assert sum(t._apply_power_plan(s) for s in range(20)) == 1
    t10 = _trainer(steps=2)
    t10.gp = _FakeGP()
    t10.plan = _shed_plan(0.05)
    assert sum(t10._apply_power_plan(s) for s in range(10)) == 1
    assert 0.0 < t10.last_decision.throughput_frac < 1.0


def test_grid_event_arms_checkpoint(tmp_path):
    t = _trainer(steps=2, ckpt_dir=str(tmp_path))
    t.gp = _FakeGP(plans=[_shed_plan(0.2)])
    t._apply_power_plan(0)
    assert t._pending_grid_ckpt
    assert any(e["event"] == "ffr_shed" for e in t.events)
    t2 = _trainer(steps=2)  # no ckpt_dir -> nothing to arm
    t2.gp = _FakeGP(plans=[_shed_plan(0.2)])
    t2._apply_power_plan(0)
    assert not t2._pending_grid_ckpt


def test_grid_event_checkpoint_saved_before_the_shed(tmp_path):
    """The armed save runs at the step the shed plan arrives, before the
    first skipped step; the first step run after it is 'resumed'."""
    t = _trainer(steps=12, ckpt_dir=str(tmp_path), duty_quantum_steps=4)
    t.gp = _FakeGP(plans=[None, None, _shed_plan(0.25)])
    out = t.train()
    names = [(e["step"], e["event"]) for e in out["events"]]
    assert (2, "ffr_shed") in names and (2, "grid_ckpt") in names
    assert (4, "resumed") in names
    assert out["skipped"] == 8      # steps 2-3, 5-7, 9-11: 1 run in 4
    assert [h["step"] for h in out["history"]] == [0, 1, 4, 8]


def test_telemetry_host_power_buffer_hoisted():
    from repro_torch.core.plant import load_from_cost_analysis
    t = _trainer(steps=2)
    gp = _FakeGP(n_hosts=3, chips_per_host=2, chip_tdp=300.0)
    t.gp = gp
    t.telemetry(0.1, 1e13, 1e10)
    buf = t._host_power_buf
    t.telemetry(0.1, 1e13, 1e10)
    assert t._host_power_buf is buf
    load = load_from_cost_analysis(1e13, 1e10, 0.1)
    assert 0.0 < load < 1.0
    np.testing.assert_allclose(
        gp.observed[-1], np.full(3, load * 2 * 300.0, np.float32),
        rtol=1e-6)
    t.plan = _shed_plan(0.5)
    t.last_decision = t.actuator.decide(0, t.plan)
    t.telemetry(0.001, 1e15, 1e12)  # saturated load -> capped at mu
    np.testing.assert_allclose(
        gp.observed[-1], np.full(3, 0.5 * 2 * 300.0, np.float32), rtol=1e-6)


def test_straggler_detection():
    h = HostHealth(n_hosts=4)
    h.step_times = [0.1] * 20
    assert not h.deadline_exceeded(0.15, 3.0)
    assert h.deadline_exceeded(0.45, 3.0)
    h.last_beat[2] -= 100.0
    assert h.stragglers(30.0) == [2]


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(get_arch("smollm-135m").reduced(), SHAPE)


def test_launcher_cli(capsys):
    from repro_torch.launch.train import main
    assert main(["--steps", "3", "--batch", "2", "--seq", "32",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "skipped 0" in out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi-3-vision-4.2b",
                                  "whisper-medium"])
def test_launcher_cli_trains_moe_vlm_and_encdec(arch, capsys):
    """The MoE, VLM and enc-dec families through the launcher (reduced, on
    the CPU): the trainer's pipeline draws the VLM's embeds (its seq less
    the frontend positions) and whisper's frames, every step runs, the
    losses finite."""
    from repro_torch.launch.train import main
    assert main(["--arch", arch, "--steps", "3", "--batch", "2", "--seq",
                 "32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "skipped 0" in out
    done = out[out.index("done:"):]
    first, last = (float(v) for v in
                   done.split("loss ")[1].split(",")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_launcher_cli_trains_ssm_and_hybrid(arch, capsys):
    """The SSM and hybrid families through the launcher (reduced, on the
    CPU): every step runs, the first and last losses finite."""
    from repro_torch.launch.train import main
    assert main(["--arch", arch, "--steps", "6", "--batch", "2", "--seq",
                 "32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "done: 6 steps" in out and "skipped 0" in out
    done = out[out.index("done:"):]
    first, last = (float(v) for v in
                   done.split("loss ")[1].split(",")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)


def test_trainer_takes_the_references_positional_order(monkeypatch):
    """``Trainer(cfg, shape, mesh, tcfg)``, as ``examples/quickstart.py``
    calls the reference's, on a CPU world of one: it trains a step."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    for var in ("REPRO_COORD_ADDR", "REPRO_NUM_PROCESSES",
                "REPRO_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    mesh = make_local_mesh(CPU)
    try:
        t = Trainer(get_arch("smollm-135m").reduced(), SHAPE, mesh,
                    TrainerConfig(steps=1, log_every=0), device=CPU)
        assert t.mesh is mesh and t.tcfg.steps == 1
        out = t.train()
    finally:
        dist.destroy_process_group()
    assert [h["step"] for h in out["history"]] == [0]
    assert np.isfinite(out["history"][0]["loss"])
