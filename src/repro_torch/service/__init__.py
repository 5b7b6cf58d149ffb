"""Online multi-site control service (the always-on serving surface), the
port of ``repro.service``.

``state``    -- SiteStore: stacked per-site EngineState updated in place,
                one batched engine step (a CUDA graph on a card),
                capture-once admit/evict churn.
``server``   -- ServiceServer: asyncio dispatch loop, UDP/in-process feed
                ingestion, island-bypass FFR triggers, per-site quarantine.
``loadgen``  -- LoadGen: Poisson trigger storms for benchmarks and tests.

Exports resolve lazily (PEP 562) so ``python -m repro_torch.service.server``
does not import the submodule twice.
"""
_EXPORTS = {
    "SiteStore": "state", "StoreState": "state", "SiteStepOut": "state",
    "ServiceConfig": "server", "ServiceServer": "server",
    "TICK_MAGIC": "server", "encode_tick": "server", "demo_batch": "server",
    "LoadGen": "loadgen", "LoadGenConfig": "loadgen",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(
            f"repro_torch.service.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(
        f"module 'repro_torch.service' has no attribute {name!r}")
