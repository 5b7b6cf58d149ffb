"""GridPilot core in PyTorch: the tiers, the twin and the rollout engine.

The primary surface is the unified rollout engine (``engine``):
EngineConfig -> engine_init -> engine_rollout -> settlement.  The
per-tier modules are its building blocks: Tier-1 (``pid``, on the
hand-written ``pid_update`` kernel on a card), Tier-2 (``ar4``), Tier-3
(``tier3``), the safety island (``island``), the PUE model (``pue``),
Algorithm 1 dispatch (``dispatch``), the plant (``plant``), the cluster
twin (``twin``), the reserve replay and settlement (``reserve``) and the
serving-side composition (``controller``).

The package's names are those of ``repro.core`` and resolve lazily
(PEP 562): importing the package imports no submodule, so ``grid`` and
``core`` can import each other's modules without a cycle.
"""
_EXPORTS = {
    # unified rollout engine (the primary surface)
    "EngineConfig": "engine", "EngineParams": "engine",
    "EngineState": "engine", "engine_init": "engine",
    "engine_step": "engine", "engine_rollout": "engine",
    "summarize_rollout": "engine",
    # streaming sweep executor
    "engine_sweep": "engine", "summary_init": "engine",
    "chunk_summary": "engine", "summary_merge": "engine",
    "sweep_finalize": "engine",
    # serving-side composition
    "GridPilot": "controller", "PowerPlan": "controller",
    "plan_from_operating_point": "controller",
    # per-tier building blocks
    "PlantState": "plant", "init_plant": "plant", "plant_step": "plant",
    "power_model": "plant", "load_from_cost_analysis": "plant",
    "PIDState": "pid", "init_pid": "pid", "pid_step": "pid",
    "pid_rollout": "pid", "pid_rollout_batch": "pid",
    "RLSState": "ar4", "init_rls": "ar4", "predict": "ar4",
    "rls_update": "ar4",
    "Tier3Selector": "tier3", "OperatingPoint": "tier3", "q_ffr": "tier3",
    "cap_table": "tier3", "event_verdict": "tier3",
    "greenness_from_ci": "tier3", "revenue_score": "tier3",
    "select_operating_points": "tier3",
    "instantaneous_pue": ("pue", "pue"), "facility_power": "pue",
    "free_cooling_fraction": "pue",
    "SafetyIsland": "island", "PythonSupervisor": "island",
    "GridPilotDispatcher": "dispatch", "Job": "dispatch",
    "replay_schedule": "dispatch", "schedule_from_threshold": "dispatch",
    "signal_thresholds": "dispatch",
    "ReserveEvents": "reserve", "reserve_replay": "reserve",
    "reserve_replay_batch": "reserve",
    "reserve_replay_reference": "reserve", "settle_reserve": "reserve",
    "TwinConfig": "twin", "TwinInputs": "twin", "TwinScenario": "twin",
    "net_co2_decomposition": "twin", "prepare_scenario": "twin",
    "run_twin": "twin", "run_twin_batch": "twin",
    "stack_scenarios": "twin", "summarize_twin": "twin",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        spec = _EXPORTS[name]
        mod, attr = spec if isinstance(spec, tuple) else (spec, name)
        return getattr(importlib.import_module(f"repro_torch.core.{mod}"),
                       attr)
    raise AttributeError(
        f"module 'repro_torch.core' has no attribute {name!r}")
