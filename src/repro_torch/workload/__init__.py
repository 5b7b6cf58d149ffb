"""The power<->throughput workload model of the port (``model``): the
DVFS/duty-cycle throughput curve, the step-synchronous transient and the
workload-mix tables.  The reference package's ``actuator`` and
``ckpt_cost`` belong to the training stack and are not ported yet."""
from repro_torch.workload.model import (CLOCK_W, DEFAULT_GRID_CKPT_S,
                                        MIX_ORDER, STEP_PERIOD_S_DEFAULT,
                                        TOKENS_PER_MW_S, clock_weight,
                                        mix_index, step_transient,
                                        throughput_frac, tokens_per_mw_s)

__all__ = [
    "CLOCK_W", "DEFAULT_GRID_CKPT_S", "MIX_ORDER", "STEP_PERIOD_S_DEFAULT",
    "TOKENS_PER_MW_S", "clock_weight", "mix_index", "step_transient",
    "throughput_frac", "tokens_per_mw_s",
]
