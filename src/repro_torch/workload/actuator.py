"""Online actuator surface: PowerPlan -> per-step run/derate decisions; the
port of ``repro.workload.actuator``.

A :class:`PowerActuator` holds the workload mix and the duty quantum and
turns the controller's plan into a :class:`StepDecision` (run/skip, the
power-cap fraction, and the shared workload model's throughput at that
cap), so the live trainer and the offline engine derate through the same
curve.  The duty quota takes the floor, never ``round()``: the old
half-even rounding turned a 5 % duty into a quota of 0 and shed every
step.

Plain Python on the hot path: the trainer calls this every step and must
never wait on the device for it (the throughput curve is evaluated on
host tensors).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import repro_torch.workload.model as model


def duty_run_quota(duty: float, k: int) -> int:
    """Steps to RUN out of every ``k`` under duty cycle ``duty``: the
    floor of ``duty * k``, but at least one for any positive duty."""
    if k <= 0:
        raise ValueError(f"duty quantum k must be positive, got {k}")
    if duty <= 0.0:
        return 0
    if duty >= 1.0:
        return k
    return max(1, int(math.floor(duty * k + 1e-9)))


class StepDecision(NamedTuple):
    """What one training step should do under the current plan."""

    run: bool                # execute the step (False = shed/skip)
    power_frac: float        # per-chip power budget as fraction of TDP
    throughput_frac: float   # model throughput at that budget (incl. duty)
    grid_ckpt: bool          # save a checkpoint before honouring the plan


RUN_FULL = StepDecision(run=True, power_frac=1.0, throughput_frac=1.0,
                        grid_ckpt=False)


@dataclass
class PowerActuator:
    """Maps (PowerPlan, step index) -> StepDecision via the shared model.

    ``duty_quantum_steps`` is the shed window k.  ``plan`` is duck-typed
    (anything with ``mu``/``duty_cycle``/``ffr_shed``), so this module
    never imports the controller.
    """

    mix: str = "train"
    duty_quantum_steps: int = 10

    def __post_init__(self):
        self.clock_w = model.clock_weight(self.mix)
        if self.duty_quantum_steps <= 0:
            raise ValueError("duty_quantum_steps must be positive, got "
                             f"{self.duty_quantum_steps}")

    def throughput_at(self, power_frac: float) -> float:
        return float(model.throughput_frac(self.clock_w, power_frac))

    def decide(self, step: int, plan: Optional[Any],
               grid_ckpt: bool = False) -> StepDecision:
        """One step's decision.  ``grid_ckpt=True`` marks a plan boundary
        where the caller should save before honouring the shed."""
        if plan is None:
            return RUN_FULL
        power_frac = min(max(float(plan.mu), 0.0), 1.0)
        thr = self.throughput_at(power_frac)
        if not plan.ffr_shed:
            return StepDecision(run=True, power_frac=power_frac,
                                throughput_frac=thr, grid_ckpt=grid_ckpt)
        k = self.duty_quantum_steps
        quota = duty_run_quota(float(plan.duty_cycle), k)
        run = (step % k) < quota
        return StepDecision(run=run, power_frac=power_frac,
                            throughput_frac=thr * quota / k,
                            grid_ckpt=grid_ckpt)
