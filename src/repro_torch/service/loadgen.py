"""Load generator for the online control service: the port's copy of
``repro.service.loadgen`` (numpy; it drives the server, not the device).

Drives a :class:`~repro_torch.service.server.ServiceServer` through its own
asyncio dispatch loop with

  * a bulk frequency feed every tick (every site gets a fresh sample, so
    nobody goes stale under load),
  * per-site Poisson FFR trigger arrivals, each taking the island bypass
    through :meth:`ServiceServer.ingest_trigger`,
  * periodic *storms*: many simultaneous triggers on one tick -- the
    worst case the p99 gate has to survive,
  * frequency dips that persist for a few ticks after each trigger so
    the engine's detection layer sees a realistic under-frequency
    excursion, not a single-sample glitch.

``drive`` returns the stats dict the benchmark and the CLI print:
ticks/sec through the batched step and p50/p99 trigger-to-target
latency pulled from the ``repro_torch.obs`` metrics registry.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.grid import markets
from repro_torch.obs import trace


@dataclass(frozen=True)
class LoadGenConfig:
    n_ticks: int = 120
    warmup_ticks: int = 1          # capture tick, excluded from timing
    trigger_rate_per_site_day: float = 200.0   # Poisson arrival rate
    storm_every: int = 0           # every N ticks, a simultaneous burst
    storm_sites: int = 0           # sites triggered at once in a storm
    nadir_hz: float = 49.5         # trigger/dip frequency
    dip_ticks: int = 3             # ticks the feed stays at the nadir
    freq_sigma_hz: float = 0.01    # ambient feed noise around nominal
    seed: int = 0


class LoadGen:
    """Poisson trigger storms + bulk feed, injected via ``serve(on_tick=)``."""

    def __init__(self, cfg: LoadGenConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.n_triggers = 0
        self.n_storms = 0

    def _feed_and_trigger(self, server, slots: np.ndarray,
                          dip_left: np.ndarray, tick: int,
                          triggers: bool = True) -> None:
        cfg = self.cfg
        # ambient feed: every site samples near nominal each tick
        freqs = self.rng.normal(markets.NOMINAL_HZ, cfg.freq_sigma_hz,
                                slots.size).astype(np.float32)
        if not triggers:
            server.feed_frequency(freqs, slots)
            return
        # Poisson arrivals (one tick = one simulated second)
        p = cfg.trigger_rate_per_site_day / 86400.0
        hit = self.rng.random(slots.size) < p
        if cfg.storm_every > 0 and tick > 0 and tick % cfg.storm_every == 0:
            burst = self.rng.choice(
                slots.size, min(cfg.storm_sites, slots.size), replace=False)
            hit[burst] = True
            self.n_storms += 1
        dip_left[hit] = cfg.dip_ticks
        freqs[dip_left > 0] = cfg.nadir_hz
        np.maximum(dip_left - 1, 0, out=dip_left)
        server.feed_frequency(freqs, slots)
        for s in slots[hit]:
            server.ingest_trigger(int(s), cfg.nadir_hz)
        self.n_triggers += int(hit.sum())

    async def drive(self, server, slots: Sequence[int],
                    stale_slots: Optional[Sequence[int]] = None) -> dict:
        """Run warmup + timed ticks through ``server.serve``.

        ``stale_slots`` are admitted sites deliberately left out of the
        feed -- they must end up quarantined, not stall the fleet.
        """
        cfg = self.cfg
        fed = np.asarray([s for s in slots
                          if not stale_slots or s not in set(stale_slots)],
                         np.int64)
        dip_left = np.zeros(fed.size, np.int64)

        def on_tick(srv, k):
            self._feed_and_trigger(srv, fed, dip_left, k)

        if cfg.warmup_ticks > 0:
            # feed-only warmup: the capture tick must not pollute the
            # trigger-to-target distribution the benchmark gates on
            await server.serve(
                n_ticks=cfg.warmup_ticks,
                on_tick=lambda srv, k: self._feed_and_trigger(
                    srv, fed, dip_left, k, triggers=False))
        n0 = len(trace.metrics.series("service.trigger_to_target_ms"))
        t0 = time.perf_counter()
        last = await server.serve(n_ticks=cfg.n_ticks, on_tick=on_tick)
        wall = time.perf_counter() - t0

        # percentiles over THIS run's observations only (the registry is
        # process-global; earlier suites' latencies must not leak in)
        lat = np.asarray(trace.metrics.series(
            "service.trigger_to_target_ms")[n0:], np.float64)
        return dict(
            ticks=cfg.n_ticks,
            wall_s=wall,
            ticks_per_s=cfg.n_ticks / max(wall, 1e-9),
            n_sites=len(slots),
            n_triggers=self.n_triggers,
            n_storms=self.n_storms,
            n_resolved=int(lat.size),
            p50_trigger_to_target_ms=(
                float(np.percentile(lat, 50)) if lat.size else 0.0),
            p99_trigger_to_target_ms=(
                float(np.percentile(lat, 99)) if lat.size else 0.0),
            max_trigger_to_target_ms=(
                float(lat.max()) if lat.size else 0.0),
            n_quarantined_final=last.get("n_quarantined", 0),
        )
