"""Online control service: the engine as a stateful real-time server, the
port of ``repro.service.server``.

``python -m repro_torch.service.server --sites 64 --ticks 120``
(``--device cpu`` runs it without a card)

An asyncio dispatch loop around a
:class:`~repro_torch.service.state.SiteStore`:

  * **ingestion** -- live frequency/price/CI ticks arrive as UDP
    datagrams (the frequency/trigger messages share the
    ``repro_torch.core.island`` wire encoding, so a TSO feed that speaks to
    the safety island speaks to the service unchanged; price/CI ticks get
    a sibling ``GTK!`` format) or through the in-process feed methods the
    tests and the load generator drive,
  * **sub-second FFR triggers** take the deterministic island bypass: one
    precomputed per-site cap-row write into the numpy register file,
    recorded as a per-site ``serve.ffr_response`` span -- no torch, no
    allocation on the decide path.  The physics catches up at the next
    batched tick (the Tier-2 correction), and the full
    trigger-to-physics-applied latency is observed as
    ``service.trigger_to_target_ms``, which includes the tick's one copy
    of (trig, shed) to the host: the number held against the 700 ms FFR
    budget,
  * **the tick** advances every resident site with the SiteStore's single
    batched ``engine_step`` (a CUDA graph replay on a card),
  * **graceful degradation** -- a site whose feed goes stale past
    ``late_after_s`` is quarantined *individually* (its lane freezes, the
    rest of the fleet keeps ticking -- no global stall) and rejoins
    automatically on the next fresh tick.
"""
from __future__ import annotations

import argparse
import asyncio
import struct
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

import repro_torch.core.plant as plant_lib
import repro_torch.core.tier3 as tier3_lib
from repro_torch.core.engine import EngineConfig
from repro_torch.core.island import (FFR_FREQ_THRESHOLD, TRIGGER_FMT,
                                     TRIGGER_MAGIC, TRIGGER_SIZE)
from repro_torch.grid import markets
from repro_torch.grid.scenarios import ScenarioBatch
from repro_torch.obs import trace
from repro_torch.service.state import SiteStore

# price/CI tick datagram: magic, site slot, freq Hz, price EUR/MWh, CI g/kWh
TICK_MAGIC = 0x47544B21  # "GTK!"
TICK_FMT = "<IIfff"
TICK_SIZE = struct.calcsize(TICK_FMT)
NOMINAL_HZ = markets.NOMINAL_HZ


def encode_tick(slot: int, freq_hz: float, price: float = 0.0,
                ci: float = 0.0) -> bytes:
    return struct.pack(TICK_FMT, TICK_MAGIC, slot & 0xFFFFFFFF,
                       freq_hz, price, ci)


@dataclass(frozen=True)
class ServiceConfig:
    """Static service knobs (the engine config rides along)."""

    engine: EngineConfig = field(default_factory=EngineConfig)
    capacity: int = 64
    horizon_h: int = 24
    tick_hz: float = 0.0          # 0 = free-running (bench mode)
    late_after_s: float = 5.0     # feed staleness before quarantine
    port: Optional[int] = None    # UDP ingestion (None = in-process only)
    host: str = "127.0.0.1"
    seed: int = 0
    device: str = "cuda"          # where the SiteStore lives


class _Ingest(asyncio.DatagramProtocol):
    def __init__(self, server: "ServiceServer"):
        self.server = server

    def datagram_received(self, data: bytes, addr) -> None:
        self.server.ingest_datagram(data)


class ServiceServer:
    """The always-on surface: SiteStore + feeds + island register file."""

    def __init__(self, cfg: ServiceConfig):
        self.cfg = cfg
        self.store = SiteStore(cfg.engine, cfg.capacity, cfg.horizon_h,
                               seed=cfg.seed, device=cfg.device)
        S, n_chips = cfg.capacity, cfg.engine.n_chips
        # island-analogue register file + precomputed per-site cap rows
        self.caps = np.full((S, n_chips), plant_lib.CAP_MAX, np.float32)
        self.armed_caps = np.full((S, n_chips), plant_lib.CAP_MAX,
                                  np.float32)
        self.shed_caps = np.full((S, n_chips), plant_lib.CAP_MAX,
                                 np.float32)
        # per-slot feed state (numpy, preallocated -- no per-tick growth)
        self.freq_hz = np.full(S, NOMINAL_HZ, np.float32)
        self.price = np.zeros(S, np.float32)
        self.ci = np.zeros(S, np.float32)
        self.trig_hz = np.full(S, markets.TRIGGER_HZ[0], np.float32)
        self.budget_ms = np.full(S, markets.BUDGET_MS[0], np.float32)
        self.last_tick_ns = np.zeros(S, np.int64)
        self.pending_trig_ns = np.zeros(S, np.int64)
        self.slot_active = np.zeros(S, bool)
        self.quarantined = np.zeros(S, bool)
        self._prev_shed = np.zeros(S, bool)
        self.tick_count = 0
        self._transport = None

    # -- churn ---------------------------------------------------------------
    def admit_sites(self, batch: ScenarioBatch) -> list[int]:
        """Admit a batch of sites; arms their island cap rows."""
        slots = self.store.admit_batch(batch)
        tab = self.store.site_tables(slots)
        pi = batch.product_idx.cpu().numpy()
        for i, s in enumerate(slots):
            mu0, rho0 = float(tab["mu0"][i]), float(tab["rho0"][i])
            resid = max(mu0 - rho0, tier3_lib.MIN_RESIDUAL_LOAD)
            tdp = self.cfg.engine.chip_tdp
            self.armed_caps[s] = np.clip(mu0 * tdp, plant_lib.CAP_MIN,
                                         plant_lib.CAP_MAX)
            self.shed_caps[s] = np.clip(resid * tdp, plant_lib.CAP_MIN,
                                        plant_lib.CAP_MAX)
            self.caps[s] = self.armed_caps[s]
            self.trig_hz[s] = markets.TRIGGER_HZ[pi[i]]
            self.budget_ms[s] = markets.BUDGET_MS[pi[i]]
            self.freq_hz[s] = NOMINAL_HZ
            self.last_tick_ns[s] = 0
            self.pending_trig_ns[s] = 0
            self.quarantined[s] = False
            self._prev_shed[s] = False
            self.slot_active[s] = True
        trace.metrics.inc("service.admitted", len(slots))
        return slots

    def evict_site(self, slot: int) -> None:
        self.store.evict(slot)
        self.slot_active[slot] = False
        self.quarantined[slot] = False
        self.pending_trig_ns[slot] = 0
        trace.metrics.inc("service.evicted")

    # -- ingestion (in-process feed; the UDP path lands here too) ------------
    def ingest_trigger(self, slot: int, freq_hz: float = 49.5) -> float:
        """Sub-second FFR trigger: the deterministic island bypass.

        One precomputed cap-row write into the register file -- the
        actuator interface, exactly the SafetyIsland's hot path -- then
        the trigger is queued for the next batched tick (the physics-side
        Tier-2 correction).  Numpy only: no torch call on this path.
        Returns the bypass write time in ms; the whole response is a
        per-site ``serve.ffr_response`` span.
        """
        with trace.span("serve.ffr_response", site=int(slot)) as at:
            t0 = time.perf_counter_ns()
            self.caps[slot] = self.shed_caps[slot]
            if self.pending_trig_ns[slot] == 0:
                self.pending_trig_ns[slot] = t0
            dt_ms = (time.perf_counter_ns() - t0) * 1e-6
            at["island_ms"] = dt_ms
        trace.metrics.inc("service.triggers")
        trace.metrics.observe("service.island_write_ms", dt_ms)
        return dt_ms

    def ingest_tick(self, slot: int, freq_hz: Optional[float] = None,
                    price: Optional[float] = None,
                    ci: Optional[float] = None) -> None:
        """One site's live feed sample (freshness + latest values)."""
        if freq_hz is not None:
            self.freq_hz[slot] = freq_hz
        if price is not None:
            self.price[slot] = price
        if ci is not None:
            self.ci[slot] = ci
        self.last_tick_ns[slot] = time.perf_counter_ns()

    def feed_frequency(self, freqs: np.ndarray,
                       slots: Optional[Sequence[int]] = None) -> None:
        """Bulk in-process feed: one multiplexed TSO frame for many sites
        (what the load generator drives -- per-site Python calls would
        dominate a thousand-site tick)."""
        now = time.perf_counter_ns()
        if slots is None:
            self.freq_hz[:] = freqs
            self.last_tick_ns[self.slot_active] = now
        else:
            idx = np.asarray(list(slots), np.int64)
            self.freq_hz[idx] = freqs
            self.last_tick_ns[idx] = now

    def ingest_datagram(self, data: bytes) -> None:
        """Wire ingestion: island-encoded trigger/frequency datagrams plus
        the ``GTK!`` price/CI tick format."""
        if len(data) >= TICK_SIZE:
            magic, slot, f, p, c = struct.unpack_from(TICK_FMT, data, 0)
            if magic == TICK_MAGIC and slot < self.cfg.capacity:
                self.ingest_tick(slot, freq_hz=f, price=p, ci=c)
                return
        if len(data) >= TRIGGER_SIZE:
            magic, slot, f = struct.unpack_from(TRIGGER_FMT, data, 0)
            if magic != TRIGGER_MAGIC or slot >= self.cfg.capacity:
                return
            if f < FFR_FREQ_THRESHOLD:
                self.ingest_trigger(slot, f)
            self.ingest_tick(slot, freq_hz=f)

    # -- the tick ------------------------------------------------------------
    def step_once(self) -> dict:
        """One service tick: quarantine sweep, batched engine step,
        trigger-to-target resolution, cap-row restore."""
        now = time.perf_counter_ns()
        # late-tick detection -> per-site quarantine, never a global stall
        seen = self.last_tick_ns > 0
        late = (self.slot_active & seen
                & (now - self.last_tick_ns
                   > int(self.cfg.late_after_s * 1e9)))
        newly = late & ~self.quarantined
        recovered = self.quarantined & ~late
        if newly.any():
            trace.metrics.inc("service.quarantined", int(newly.sum()))
            for s in np.nonzero(newly)[0]:
                trace.event("service.quarantine", site=int(s))
        if recovered.any():
            trace.metrics.inc("service.recovered", int(recovered.sum()))
        self.quarantined = late

        below = ((self.freq_hz < self.trig_hz)
                 | (self.pending_trig_ns > 0)) & self.slot_active
        enabled = ~self.quarantined
        t0 = time.perf_counter()
        self.store.step(below, enabled)
        # the tick's one copy to the host: (trig, shed) together
        trig, shed = self.store.fetch_flags()
        t_done_ns = time.perf_counter_ns()
        step_ms = (time.perf_counter() - t0) * 1e3

        # resolve trigger-to-target: pending triggers consumed by this
        # tick (quarantined lanes stay pending until they rejoin)
        consumed = (self.pending_trig_ns > 0) & enabled & self.slot_active
        for s in np.nonzero(consumed)[0]:
            trace.metrics.observe(
                "service.trigger_to_target_ms",
                (t_done_ns - self.pending_trig_ns[s]) * 1e-6)
        self.pending_trig_ns[consumed] = 0

        # restore armed cap rows when a shed window closes
        done = self._prev_shed & ~shed
        if done.any():
            self.caps[done] = self.armed_caps[done]
        np.copyto(self._prev_shed, shed)

        self.tick_count += 1
        trace.metrics.inc("service.ticks")
        trace.metrics.observe("service.step_ms", step_ms)
        return dict(tick=self.tick_count, step_ms=step_ms,
                    n_run=int((self.slot_active & enabled).sum()),
                    n_quarantined=int(self.quarantined.sum()),
                    n_shedding=int(shed.sum()),
                    n_triggered=int(trig.sum()),
                    n_resolved=int(consumed.sum()))

    # -- the dispatch loop ---------------------------------------------------
    async def serve(self, n_ticks: Optional[int] = None,
                    duration_s: Optional[float] = None,
                    on_tick=None) -> dict:
        """Run the dispatch loop: drain datagrams, feed, tick, repeat.

        ``on_tick(server, tick_index)`` (sync or async) runs before each
        batched step -- the hook the load generator injects feeds and
        trigger storms through.
        """
        loop = asyncio.get_running_loop()
        if self.cfg.port is not None and self._transport is None:
            self._transport, _ = await loop.create_datagram_endpoint(
                lambda: _Ingest(self),
                local_addr=(self.cfg.host, self.cfg.port))
        period = 1.0 / self.cfg.tick_hz if self.cfg.tick_hz > 0 else 0.0
        t_end = (time.perf_counter() + duration_s
                 if duration_s is not None else None)
        ticks = 0
        last = {}
        while True:
            t0 = time.perf_counter()
            if on_tick is not None:
                r = on_tick(self, ticks)
                if asyncio.iscoroutine(r):
                    await r
            last = self.step_once()
            ticks += 1
            if n_ticks is not None and ticks >= n_ticks:
                break
            if t_end is not None and time.perf_counter() >= t_end:
                break
            # yield to the event loop so datagrams drain between ticks
            await asyncio.sleep(
                max(period - (time.perf_counter() - t0), 0.0))
        return last

    def close(self) -> None:
        if self._transport is not None:
            self._transport.close()
            self._transport = None

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        self.close()


def demo_batch(n_sites: int, horizon_h: int = 24,
               products: Sequence[str] = ("FFR",),
               device="cuda") -> ScenarioBatch:
    """A round-robin multi-country site population for the quickstart,
    tests, and the load generator."""
    from repro_torch.grid.scenarios import ScenarioSpec, build_scenario_batch
    from repro_torch.grid.signals import COUNTRY_ORDER

    specs = [
        ScenarioSpec(country=COUNTRY_ORDER[i % len(COUNTRY_ORDER)],
                     seed=i, horizon_h=horizon_h,
                     product=products[i % len(products)],
                     reserve_rho=0.2, mw=10.0)
        for i in range(n_sites)
    ]
    return build_scenario_batch(specs, device=device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service.server",
        description="online multi-site control service")
    ap.add_argument("--sites", type=int, default=64)
    ap.add_argument("--capacity", type=int, default=None,
                    help="slot capacity (default: --sites)")
    ap.add_argument("--horizon-h", type=int, default=24)
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--tick-hz", type=float, default=0.0,
                    help="tick pacing (0 = free-running)")
    ap.add_argument("--port", type=int, default=None,
                    help="UDP ingestion port (default: in-process feed)")
    ap.add_argument("--trigger-rate", type=float, default=4.0,
                    help="Poisson FFR triggers per site-day")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the site store (default cuda; "
                         "cpu runs without a card)")
    return ap


def main(argv=None) -> int:
    from repro_torch.service.loadgen import LoadGen, LoadGenConfig

    args = build_parser().parse_args(argv)
    cfg = ServiceConfig(capacity=args.capacity or args.sites,
                        horizon_h=args.horizon_h, tick_hz=args.tick_hz,
                        port=args.port, seed=args.seed, device=args.device)
    server = ServiceServer(cfg)
    try:
        slots = server.admit_sites(demo_batch(args.sites, args.horizon_h,
                                              device=args.device))
        gen = LoadGen(LoadGenConfig(
            n_ticks=args.ticks, trigger_rate_per_site_day=args.trigger_rate,
            seed=args.seed))
        stats = asyncio.run(gen.drive(server, slots))
    finally:
        server.close()
    print(f"served {stats['ticks']} ticks x {len(slots)} sites on "
          f"{server.store.device}: "
          f"{stats['ticks_per_s']:.1f} ticks/s, "
          f"{stats['n_triggers']} triggers, "
          f"p50/p99 trigger-to-target "
          f"{stats['p50_trigger_to_target_ms']:.1f}/"
          f"{stats['p99_trigger_to_target_ms']:.1f} ms "
          f"(budget {markets.BUDGET_MS[0]:.0f} ms), "
          f"{stats['n_quarantined_final']} quarantined")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
