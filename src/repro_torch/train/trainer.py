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
    the trainer on another device or mesh and restores through the
    checkpoint (a checkpoint written at one data-parallel width restores
    at another).

Fault tolerance: per-host heartbeats and a step deadline (a multiple of
the median step time) flag stragglers (``straggler_step``).

Sharded training: on a ``mesh`` (a ``DeviceMesh`` over the world, e.g.
``launch.mesh.make_local_mesh()``) each rank takes its ``batch_pspec``
share of every batch, and the parameters and AdamW moments are placed by
the arch's plan (``train/step.py``, ``sharding/fsdp.py``): FSDP over the
data axes and shards over ``model`` for ``fsdp_tp``, replicated
parameters and ZeRO-1 moments for ``dp_only``.  The values are the ones
the reference's pjit computes on the global batch.  A checkpoint gathers
each leaf on every rank and rank 0 writes it; a restore places each leaf
by the plan, so state written at one width (or replicated) restores at
another.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import resolve_device
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.plant import load_from_cost_analysis
from repro_torch.data.tokens import TokenPipeline
from repro_torch.obs import trace
from repro_torch._tree import unflatten_like
from repro_torch.sharding import fsdp
from repro_torch.train.step import batch_rows, build_step_bundle
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
    """Trainer on one device, or one rank of a ``mesh`` (bf16 compute over
    float32 parameters, the model's defaults)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, mesh=None,
                 tcfg: TrainerConfig = TrainerConfig(),
                 gridpilot=None, seed: int = 0, *, device="cuda"):
        self.cfg = cfg
        self.shape = shape
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a trainer on "
                             f"{self.device}")
        self.mesh = mesh
        self.tcfg = tcfg
        self.gp = gridpilot
        self.seed = seed
        self.plan = None
        world = 1 if mesh is None else mesh.size()
        self.health = HostHealth(n_hosts=max(world // 8, 1))
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

        self.bundle = build_step_bundle(cfg, shape, device=self.device,
                                        mesh=mesh)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)
        # this rank's rows of every batch, and whether it writes the
        # checkpoints (every rank gathers the state, rank 0 writes)
        self._rows = (0, shape.global_batch) if mesh is None else \
            batch_rows(self.bundle.rules, shape.global_batch,
                       mesh.get_coordinate(), cfg.plan.microbatches)
        self._writes = mesh is None or mesh.get_rank() == 0

    # -- state ------------------------------------------------------------
    def init_state(self):
        """Parameters drawn from ``seed`` and zero AdamW moments, on the
        trainer's device; on a mesh placed by the plan, leaf by leaf
        (``StepBundle.init_state``)."""
        return self.bundle.init_state(self.seed)

    def _pipeline(self) -> TokenPipeline:
        c = self.cfg
        front = c.frontend_tokens if c.frontend != "none" else 0
        return TokenPipeline(
            batch=self.shape.global_batch, seq=self.shape.seq_len - front,
            vocab=c.vocab_size, seed=self.seed, frontend_tokens=front,
            d_model=c.d_model if front or c.family == "encdec" else 0,
            encoder_seq=c.encoder_seq if c.family == "encdec" else 0,
            device=self.device)

    def _local(self, batch: dict) -> dict:
        """This rank's share of a global batch (``step.batch_rows``)."""
        if isinstance(self._rows, tuple):
            lo, hi = self._rows
            return {k: v[lo:hi] for k, v in batch.items()}
        return {k: v[self._rows.to(v.device)] for k, v in batch.items()}

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
                (params, opt), device=self.device,
                shardings=self.bundle.state_shardings())
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
                    self._save(step, (params, opt),
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
            params, opt, metrics = step_fn(params, opt, self._local(batch),
                                           step)
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
                self._save(step, (params, opt), extra={"loss": loss})
            step += 1

        if self.ckpt:
            self._save(step, (params, opt))
        return {"params": params, "opt": opt, "history": history,
                "skipped": self.skipped_steps, "events": self.events}

    def _save(self, step: int, tree, extra=None) -> None:
        """Every rank of a mesh takes part in gathering each leaf whole;
        the writer saves."""
        if self.mesh is not None:
            flat = fsdp.full_leaves(tree, keep=self._writes)
            tree = unflatten_like(tree, flat) if self._writes else None
        if self._writes:
            self.ckpt.save(step, tree, extra=extra)

    # -- elastic re-width / restart on another device ------------------------
    def resize(self, new_mesh) -> "Trainer":
        """Rebuild the trainer on a new ``DeviceMesh`` (its device kind
        and this rank's card) or, where ``new_mesh`` is a device, on that
        device; its ``train()`` restores the parameters and moments there
        through the checkpoint manager (a checkpoint written at one width
        or device restores at another)."""
        mesh = new_mesh if isinstance(new_mesh, DeviceMesh) else None
        t = Trainer(self.cfg, self.shape, mesh, self.tcfg,
                    gridpilot=self.gp, seed=self.seed,
                    device=self.device if mesh is not None else new_mesh)
        where = ({"device": str(t.device)} if mesh is None else
                 {"mesh": str(dict(zip(mesh.mesh_dim_names, mesh.shape)))})
        t.events = self.events + [trace.event(
            "train.resized", event="resized", **where)]
        return t
