"""Two-sided observability of the port.

In-graph: ``telemetry`` (accumulators the engine folds when
``EngineConfig.telemetry=True``).  Host-side: ``trace`` (span/counter
registry with JSONL export) and ``python -m repro_torch.obs.report``
(latency-budget compliance tables).  The package's names are those of
``repro.obs``.
"""
from repro_torch.obs import telemetry, trace
from repro_torch.obs.trace import event, get_tracer, metrics, profile, span

__all__ = [
    "telemetry", "trace",
    "span", "event", "metrics", "get_tracer", "profile",
]
