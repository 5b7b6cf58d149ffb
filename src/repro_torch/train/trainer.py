"""The training loop with GridPilot power hooks, fault tolerance and
restart: the port of ``repro.train.trainer`` on one device.

Power integration (the paper's composition, Sect. 1.1): the trainer holds
a ``PowerPlan`` from the GridPilot controller and actuates it through the
shared workload model (``repro_torch.workload``) -- the same power-cap ->
throughput curve the offline engine accumulates and Tier-3 prices:

  * power cap / duty cycle -- a :class:`PowerActuator` maps the plan to
    per-step :class:`StepDecision`s: during an FFR activation the trainer
    skips the sheddable fraction of steps (a skipped step is an exact,
    checkpoint-consistent shed boundary), the shed quantum
    ``duty_quantum_steps`` and floor-quantised, so a small positive duty
    never sheds everything,
  * checkpoint / resume -- a new shed plan saves a grid-event checkpoint
    first (the dead time ``tier3.throughput_score`` charges per event),
    and the first step after a shed window records a ``resumed`` event,
  * restart -- a trainer whose checkpoint directory holds a step restores
    from it (``restored``) and continues; :meth:`Trainer.resize` rebuilds
    the trainer on another device and restores through the checkpoint.

Fault tolerance: per-host heartbeats and a step deadline (a multiple of
the median step time) flag stragglers (``straggler_step``).

The reference's data-parallel half -- Tier-3's mu mapped to the
data-parallel width, re-lowering the step on a wider mesh -- needs a mesh
and waits for ROADMAP A11; here the trainer runs on one device
(``device=``, default ``"cuda"``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.plant import load_from_cost_analysis
from repro_torch.data.tokens import TokenPipeline
from repro_torch.obs import trace
from repro_torch.optim import adamw_init
from repro_torch.train.step import build_step_bundle
from repro_torch.workload import RUN_FULL, PowerActuator, StepDecision


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    # straggler mitigation
    step_deadline_factor: float = 3.0   # x median step time
    heartbeat_timeout_s: float = 30.0
    # power
    poll_power_every: int = 1
    # workload actuation: the duty-cycle shed window (duty quantised to
    # 1/duty_quantum_steps), the fleet's workload mix (indexes the shared
    # throughput model), and whether a shed boundary saves a grid-event
    # checkpoint before honouring the plan
    duty_quantum_steps: int = 10
    workload_mix: str = "train"
    grid_event_ckpt: bool = True


@dataclass
class HostHealth:
    """Heartbeat ledger for straggler/failure detection."""

    n_hosts: int
    last_beat: np.ndarray = field(default=None)  # type: ignore[assignment]
    step_times: list = field(default_factory=list)

    def __post_init__(self):
        if self.last_beat is None:
            self.last_beat = np.full(self.n_hosts, time.monotonic())

    def beat(self, host: int) -> None:
        self.last_beat[host] = time.monotonic()

    def stragglers(self, timeout_s: float) -> list[int]:
        now = time.monotonic()
        return [i for i, t in enumerate(self.last_beat)
                if now - t > timeout_s]

    def deadline_exceeded(self, dt: float, factor: float) -> bool:
        if len(self.step_times) < 5:
            return False
        med = float(np.median(self.step_times[-50:]))
        return dt > factor * med


class Trainer:
    """Single-process trainer on one device (bf16 compute over float32
    parameters, the model's defaults)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 tcfg: TrainerConfig = TrainerConfig(),
                 gridpilot=None, seed: int = 0, *, device="cuda"):
        self.cfg = cfg
        self.shape = shape
        self.device = resolve_device(device)
        self.tcfg = tcfg
        self.gp = gridpilot
        self.seed = seed
        self.plan = None
        self.health = HostHealth(n_hosts=1)
        self.skipped_steps = 0
        self.events: list[dict] = []
        # workload actuation state (shared model; see module docstring)
        self.actuator = PowerActuator(
            mix=tcfg.workload_mix,
            duty_quantum_steps=tcfg.duty_quantum_steps)
        self.last_decision: StepDecision = RUN_FULL
        self._pending_grid_ckpt = False
        self._shed_active = False
        self._host_power_buf: Optional[np.ndarray] = None

        self.bundle = build_step_bundle(cfg, shape, device=self.device)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)

    # -- state ------------------------------------------------------------
    def init_state(self):
        """Parameters drawn from ``seed`` and zero AdamW moments, on the
        trainer's device."""
        params = self.bundle.model.init(self.seed)
        return params, adamw_init(params)

    def _pipeline(self) -> TokenPipeline:
        c = self.cfg
        return TokenPipeline(batch=self.shape.global_batch,
                             seq=self.shape.seq_len, vocab=c.vocab_size,
                             seed=self.seed, device=self.device)

    # -- events ------------------------------------------------------------
    def _event(self, step: int, name: str, **attrs) -> dict:
        """Record a trainer event in both streams: the host-side span
        tracer (``train.<name>``) and ``self.events``.  One dict backs
        both, so the ``{"step", "event", ...}`` schema is the same."""
        rec = trace.event(f"train.{name}", step=step, event=name, **attrs)
        self.events.append(rec)
        return rec

    # -- power hooks --------------------------------------------------------
    def _apply_power_plan(self, step: int) -> bool:
        """True if this step should run (False = shed/skip).

        The plan -> decision mapping is the shared workload actuator's;
        the decision lands in ``self.last_decision``.  A new shed plan is
        a grid-event boundary: it arms a checkpoint save, which the train
        loop executes before the shed window starts.
        """
        if self.gp is None:
            return True
        shed_plan = self.gp.poll_ffr()
        if shed_plan is not None:
            self.plan = shed_plan
            self._event(step, "ffr_shed", duty=shed_plan.duty_cycle)
            trace.metrics.inc("train.ffr_sheds")
            if shed_plan.ffr_shed and self.tcfg.grid_event_ckpt and self.ckpt:
                self._pending_grid_ckpt = True
        self.last_decision = self.actuator.decide(step, self.plan)
        return self.last_decision.run

    def telemetry(self, step_time_s: float, flops: float, bytes_: float):
        """Export step telemetry to Tier-2 (host-power estimation): the
        observed utilisation on the card's peaks, capped at the plan's
        power budget, times the hosts' TDP, into a buffer allocated
        once."""
        if self.gp is None:
            return
        load = load_from_cost_analysis(flops, bytes_, step_time_s)
        if self.plan is not None:
            load = min(load, self.last_decision.power_frac)
        buf = self._host_power_buf
        if buf is None or buf.shape[0] != self.gp.n_hosts:
            buf = self._host_power_buf = np.empty(self.gp.n_hosts,
                                                  np.float32)
        buf.fill(load * self.gp.chips_per_host * self.gp.chip_tdp)
        self.gp.observe_host_power(buf)

    # -- the loop ------------------------------------------------------------
    def train(self, params=None, opt=None,
              on_step: Optional[Callable] = None) -> dict:
        tcfg = self.tcfg
        if params is None:
            params, opt = self.init_state()
        start_step = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            (params, opt), start_step, _ = self.ckpt.restore(
                (params, opt), device=self.device)
            self._event(start_step, "restored")

        step_fn = self.bundle.step_fn
        pipe = self._pipeline()
        history = []
        step = start_step

        for batch in map(pipe.batch_at, range(start_step, tcfg.steps)):
            run = self._apply_power_plan(step)
            if self._pending_grid_ckpt and self.ckpt:
                # grid-event checkpoint: persist state BEFORE honouring
                # the shed plan (the dead time tier3.throughput_score
                # prices)
                with trace.span("train.grid_ckpt", step=step):
                    self.ckpt.save(step, (params, opt),
                                   extra={"grid_event": True})
                self._event(step, "grid_ckpt")
                self._pending_grid_ckpt = False
            if not run:
                self.skipped_steps += 1
                trace.metrics.inc("train.skipped_steps")
                self._shed_active = True
                step += 1
                continue
            if self._shed_active:
                self._event(step, "resumed")
                self._shed_active = False
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch, step)
            loss = float(metrics["loss"])  # waits for the step's work
            dt = time.perf_counter() - t0
            self.health.step_times.append(dt)
            trace.metrics.observe("train.step_ms", dt * 1e3)
            for h in range(self.health.n_hosts):
                self.health.beat(h)
            if self.health.deadline_exceeded(dt, tcfg.step_deadline_factor):
                self._event(step, "straggler_step", dt=dt)
            history.append({"step": step, "loss": loss, "dt": dt,
                            "thr": self.last_decision.throughput_frac})
            if on_step:
                on_step(step, metrics)
            if tcfg.log_every and step % tcfg.log_every == 0:
                print(f"  step {step:5d} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)", flush=True)
            if self.ckpt and step > start_step and step % tcfg.ckpt_every == 0:
                self.ckpt.save(step, (params, opt), extra={"loss": loss})
            step += 1

        if self.ckpt:
            self.ckpt.save(step, (params, opt))
        return {"params": params, "opt": opt, "history": history,
                "skipped": self.skipped_steps, "events": self.events}

    # -- restart on another device -------------------------------------------
    def resize(self, device) -> "Trainer":
        """Rebuild the trainer on ``device``; its ``train()`` restores the
        parameters and moments there through the checkpoint manager (a
        checkpoint written on one device restores on another)."""
        t = Trainer(self.cfg, self.shape, self.tcfg, gridpilot=self.gp,
                    seed=self.seed, device=device)
        t.events = self.events + [trace.event(
            "train.resized", event="resized", device=str(t.device))]
        return t
