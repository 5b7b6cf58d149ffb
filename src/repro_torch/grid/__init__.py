"""Grid signals, reserve products, frequency synthesis and scenario
batches of the port.

The package's names are those of ``repro.grid`` and resolve lazily
(PEP 562), so importing the package imports none of its modules.
"""
_EXPORTS = {
    "COUNTRIES": "signals", "COUNTRY_ORDER": "signals",
    "GridSignals": "signals", "synthesize_ci": "signals",
    "synthesize_t_amb": "signals", "make_grid": "signals",
    "FR_PRODUCTS": "markets", "PRODUCT_ORDER": "markets",
    "FFRTriggerGen": "markets",
    "EventBatch": "frequency", "apply_events": "frequency",
    "sample_events": "frequency",
    "synthesize_frequency_batch": "frequency",
    "ScenarioBatch": "scenarios", "ScenarioSpec": "scenarios",
    "build_scenario_batch": "scenarios", "masked_quantile": "scenarios",
    "product_specs": "scenarios", "scenario_chunk": "scenarios",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(f"repro_torch.grid.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(
        f"module 'repro_torch.grid' has no attribute {name!r}")
