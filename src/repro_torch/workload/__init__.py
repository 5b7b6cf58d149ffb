"""The port's workload layer, with the names of ``repro.workload``:

``model``      the DVFS/duty-cycle throughput curve, the step-synchronous
               transient and the workload-mix tables,
``ckpt_cost``  checkpoint/restore dead time from real ``repro_torch.ckpt``
               manifests,
``actuator``   the online surface: PowerPlan -> per-step StepDecision.
"""
from repro_torch.workload.actuator import (PowerActuator, RUN_FULL,
                                           StepDecision, duty_run_quota)
from repro_torch.workload.ckpt_cost import (CkptCostModel, checkpoint_bytes,
                                            grid_event_cost_s,
                                            manifest_bytes, tree_bytes)
from repro_torch.workload.model import (CLOCK_W, DEFAULT_GRID_CKPT_S,
                                        MIX_ORDER, STEP_PERIOD_S_DEFAULT,
                                        TOKENS_PER_MW_S, clock_weight,
                                        mix_index, step_transient,
                                        throughput_frac, tokens_per_mw_s)

__all__ = [
    "PowerActuator", "RUN_FULL", "StepDecision", "duty_run_quota",
    "CkptCostModel", "checkpoint_bytes", "grid_event_cost_s",
    "manifest_bytes", "tree_bytes",
    "CLOCK_W", "DEFAULT_GRID_CKPT_S", "MIX_ORDER", "STEP_PERIOD_S_DEFAULT",
    "TOKENS_PER_MW_S", "clock_weight", "mix_index", "step_transient",
    "throughput_frac", "tokens_per_mw_s",
]
