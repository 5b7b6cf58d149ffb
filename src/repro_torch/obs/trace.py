"""Host-side tracing: span/counter registry with JSONL export.

The measurement substrate of the control plane.  The in-graph half of the
observability subsystem (``repro.obs.telemetry``) meters what happens
*inside* the fused rollout; this module meters everything around it --
wall-clock spans of dispatch/train/serve/benchmark phases, point events
(the trainer's ``ffr_shed`` / ``grid_ckpt`` markers, the serving loop's
batch-thinning), and scalar counters/observations -- and exports all of
it as machine-readable JSONL so ``python -m repro.obs.report`` (or any
``jq`` one-liner) can render latency tables from a run after the fact.

Design constraints, in order:

  * zero setup: a module-level default :class:`Tracer` (``obs.trace.span``
    / ``obs.trace.event`` / ``obs.metrics``) so call sites are one-liners,
  * cheap enough for per-step use: recording a span is two
    ``perf_counter`` calls and one dict append (no I/O until
    :meth:`Tracer.export_jsonl`),
  * schema-stable records: every line is one JSON object with a ``kind``
    (``span`` | ``event`` | ``counter`` | ``observation``), a ``name``, a
    unix ``ts``, and a flat ``attrs`` dict; spans add ``wall_s`` (full
    float precision -- sub-10 ms spans are exactly the scale of the
    paper's 97.2 ms claim) and ``parent`` (the enclosing span's name).

An opt-in :func:`profile` hook wraps a block in ``torch.profiler``
when a directory is given (or ``REPRO_TORCH_PROFILE_DIR`` is set), so the
same call sites can produce device-level traces without code changes.

The port's copy of ``repro.obs.trace``: the recorder is numpy and the
standard library; :func:`device_context` and :func:`profile` read torch.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np


class Metrics:
    """Counter + observation registry (host-side scalars).

    ``inc`` accumulates monotonic counters; ``observe`` appends to a
    per-name series summarised on demand (count/mean/p50/p95/max).
    """

    def __init__(self):
        self._counters: dict[str, float] = {}
        self._series: dict[str, list[float]] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, by: float = 1.0) -> float:
        with self._lock:
            v = self._counters.get(name, 0.0) + float(by)
            self._counters[name] = v
        return v

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._series.setdefault(name, []).append(float(value))

    @property
    def counters(self) -> dict[str, float]:
        return dict(self._counters)

    def series(self, name: str) -> list[float]:
        """Copy of one observation series (windowed consumers -- e.g. the
        service load generator's timed-phase percentiles -- slice it)."""
        with self._lock:
            return list(self._series.get(name, ()))

    def summary(self, name: str) -> dict:
        xs = np.asarray(self._series.get(name, ()), np.float64)
        if xs.size == 0:
            return dict(name=name, count=0)
        return dict(
            name=name, count=int(xs.size), total=float(xs.sum()),
            mean=float(xs.mean()), min=float(xs.min()), max=float(xs.max()),
            p50=float(np.percentile(xs, 50)),
            p95=float(np.percentile(xs, 95)),
            p99=float(np.percentile(xs, 99)),
        )

    def all_summaries(self) -> list[dict]:
        return [self.summary(n) for n in sorted(self._series)]

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._series.clear()


class Tracer:
    """Span/event recorder with a thread-local span stack.

    Spans nest: the record's ``parent`` is the name of the enclosing span
    on the same thread (or None at top level).  The context manager
    yields the record's mutable ``attrs`` dict so call sites can attach
    results discovered mid-span (e.g. the post-shed batch size).
    """

    def __init__(self, metrics: Optional[Metrics] = None):
        self.records: list[dict] = []
        self.metrics = metrics if metrics is not None else Metrics()
        self._local = threading.local()
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, **attrs):
        """Time a block; record {kind, name, ts, wall_s, parent, attrs}."""
        stack = self._stack()
        rec = dict(kind="span", name=name, ts=time.time(),
                   parent=stack[-1] if stack else None, attrs=dict(attrs))
        stack.append(name)
        t0 = time.perf_counter()
        try:
            yield rec["attrs"]
        finally:
            rec["wall_s"] = time.perf_counter() - t0
            stack.pop()
            with self._lock:
                self.records.append(rec)
            self.metrics.observe(f"span.{name}", rec["wall_s"])

    def event(self, name: str, **attrs) -> dict:
        """Record a point event; returns the (mutable) attrs dict."""
        rec = dict(kind="event", name=name, ts=time.time(), attrs=attrs)
        with self._lock:
            self.records.append(rec)
        return attrs

    # -- querying ----------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> list[dict]:
        return [r for r in self.records if r["kind"] == "span"
                and (name is None or r["name"] == name)]

    def events(self, name: Optional[str] = None) -> list[dict]:
        return [r for r in self.records if r["kind"] == "event"
                and (name is None or r["name"] == name)]

    # -- export ------------------------------------------------------------
    def export_jsonl(self, path: str) -> str:
        """Write every record plus counter/observation summaries, one JSON
        object per line (the schema the report CLI and CI consume)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec, default=float) + "\n")
            for name, v in sorted(self.metrics.counters.items()):
                f.write(json.dumps(dict(kind="counter", name=name,
                                        value=v)) + "\n")
            for s in self.metrics.all_summaries():
                f.write(json.dumps(dict(kind="observation", **s)) + "\n")
        return path

    def clear(self) -> None:
        with self._lock:
            self.records.clear()
        self.metrics.clear()


# -- module-level default registry (the one-liner surface) ------------------
_TRACER = Tracer()
metrics = _TRACER.metrics
span = _TRACER.span
event = _TRACER.event


def get_tracer() -> Tracer:
    return _TRACER


def device_context() -> dict:
    """Backend context stamped into reports and traces."""
    import torch

    if not torch.cuda.is_available():
        return dict(backend="cpu", n_devices=1, device_kind="cpu",
                    process_count=1)
    return dict(
        backend="cuda",
        n_devices=torch.cuda.device_count(),
        device_kind=torch.cuda.get_device_name(0),
        process_count=1,
    )


PROFILE_ENV = "REPRO_TORCH_PROFILE_DIR"


@contextmanager
def profile(out_dir: Optional[str] = None):
    """Opt-in ``torch.profiler`` trace around a block, exported as a
    Chrome trace into ``out_dir``.

    Enabled when ``out_dir`` is given or ``REPRO_TORCH_PROFILE_DIR`` is
    set; otherwise a no-op, so call sites can wrap hot paths
    unconditionally.
    """
    out_dir = out_dir or os.environ.get(PROFILE_ENV)
    if not out_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity

    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield out_dir
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def kernel_base(key: str) -> str:
    """The bare function name of a ``torch.profiler`` kernel key:
    ``flash_bwd_dq_wgmma`` for "void (anonymous
    namespace)::flash_bwd_dq_wgmma<128>(CUtensorMap_st, ...)"."""
    name = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip().split("::")[-1]


def read_jsonl(path: str) -> list[dict]:
    """Load an exported trace (skips blank/corrupt lines defensively)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out
