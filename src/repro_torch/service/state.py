"""SiteStore: persistent per-site ``EngineState`` for the online service,
the port of ``repro.service.state``.

The offline rollout replays whole horizons; the service instead holds a
*resident* population of sites -- every site's
:class:`~repro_torch.core.engine.EngineState` stacked along a leading site
axis -- and advances all of them together with ONE batched
:func:`~repro_torch.core.engine.engine_step` per tick:

  * the store is a fixed-capacity :class:`StoreState` of tensors
    allocated once on the store's device; the tick writes every new value
    back into that storage with ``copy_`` (``data_ptr`` stays put, pinned
    in ``tests/test_torch_service.py``), which is what the reference's
    ``donate_argnums`` gives it,
  * sites are admitted and evicted **by slot index** (``index_copy_`` into
    the same tensors): churn changes data, never shapes,
  * lanes are independent: an inactive (or quarantined) lane's state is
    frozen bit-exactly by a per-lane ``torch.where``, so admitting or
    evicting neighbours never perturbs a surviving site's trajectory,
  * on a CUDA device the tick is a CUDA graph, captured once on first use
    (warmed up on a side stream with every lane frozen) and replayed every
    tick after: ``below`` and ``enabled`` are copied into static input
    buffers before each replay, and :class:`SiteStepOut` holds views into
    static output buffers.  Those views stay valid until the next
    :meth:`SiteStore.step` overwrites them -- copy what must outlive the
    tick, as with the reference's donated buffers.
    :meth:`SiteStore.step_cache_size` counts the captures (1 across
    churn, trigger patterns and quarantine); on the CPU it counts how
    often the tick's program was prepared, also 1.

Per-tick demand is synthesised from the same ``twin.HostLoadParams``
constants the rollout uses, with the white noise drawn per second from a
stream keyed by (seed, second, host) (the reference folds the second into
the site's key): each site is at its own point in its life, so no hour
block can be shared.  In production this input is *measured* telemetry;
the synthesis is the stand-in feed.  ``step(fast=..., noise=...)`` takes
the demand noise and the plant noise from the caller instead, which is how
parity tests replay the reference's draws; the choice is data on the
device (a flag buffer), so it reuses the one captured graph.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

import repro_torch.core.engine as engine_lib
import repro_torch.core.twin as twin_lib
from repro_torch import resolve_device
from repro_torch.core.engine import EngineConfig, EngineParams, EngineState
from repro_torch.grid.scenarios import ScenarioBatch

_WARMUP_TICKS = 2   # eager ticks on a side stream before the capture


class StoreState(NamedTuple):
    """Everything the batched tick touches, stacked along a site axis."""

    engine: EngineState            # every leaf (S, ...)
    params: EngineParams           # per-site hourly tables, (S, ...)
    load: twin_lib.HostLoadParams  # per-site demand-synthesis constants
    mw: torch.Tensor               # (S,) site IT design power
    active: torch.Tensor           # (S,) bool: slot holds a live site
    t: torch.Tensor                # (S,) int64 seconds since admission


class SiteStepOut(NamedTuple):
    """Per-site per-tick outputs the server consumes (all (S,)).  Views
    into the store's static output buffers: valid until the next step."""

    trig: torch.Tensor          # a reserve event triggered this tick
    shed: torch.Tensor          # the shed is being served this tick
    load: torch.Tensor          # cluster L at the start of the tick
    it_mw: torch.Tensor         # site IT power (MW) after the tick
    tracking_err: torch.Tensor  # twin tracking error


def _zeros_params(capacity: int, h_max: int, dev) -> EngineParams:
    def z_h():
        return torch.zeros((capacity, h_max), dtype=torch.float32,
                           device=dev)

    return EngineParams(
        mu_h=z_h(), rho_h=z_h(), t_amb_h=z_h(), rho_it_h=z_h(),
        min_dur_i=torch.zeros(capacity, dtype=torch.int32, device=dev),
        pue_design=torch.ones(capacity, dtype=torch.float32, device=dev),
        clock_w=torch.zeros(capacity, dtype=torch.float32, device=dev))


def _own_storage(tree):
    """The tree with every leaf in storage of its own (``engine_init``
    shares one zero tensor among the accumulators)."""
    return pytree.tree_map(lambda x: x.clone(), tree)


class SiteStore:
    """Fixed-capacity resident store of per-site engine state.

    The hot path is :meth:`step`; admission and eviction are the slow
    path.  ``capacity`` and the schedule horizon are fixed at
    construction -- churn changes data, never shapes.  Everything lives on
    ``device`` (default CUDA, which raises without a card).
    """

    def __init__(self, cfg: EngineConfig, capacity: int, horizon_h: int,
                 *, seed: int = 0, device="cuda"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.cfg = cfg
        self.capacity = capacity
        self.horizon_h = int(horizon_h)
        self.sched_s = self.horizon_h * 3600
        self.device = dev = resolve_device(device)
        seeds = (torch.arange(capacity, dtype=torch.int64, device=dev)
                 + seed * capacity) & 0xFFFFFFFF
        self.state = _own_storage(StoreState(
            engine=engine_lib.engine_init(cfg, seeds, device=dev),
            params=_zeros_params(capacity, self.horizon_h, dev),
            load=twin_lib.host_load_params(cfg.n_hosts, seeds),
            mw=torch.zeros(capacity, dtype=torch.float32, device=dev),
            active=torch.zeros(capacity, dtype=torch.bool, device=dev),
            t=torch.zeros(capacity, dtype=torch.int64, device=dev)))
        S, H, C = capacity, cfg.n_hosts, cfg.chips_per_host

        def buf(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # static inputs: (below, enabled) rows, the caller's draws and the
        # flag choosing them; static outputs: (trig, shed) rows + floats
        self._inputs = buf(2, S, dtype=torch.bool)
        self._fast_in = buf(S, H)
        self._noise_in = buf(S, H, C)
        self._use_fast = buf(dtype=torch.bool)
        self._use_noise = buf(dtype=torch.bool)
        self._flags = buf(2, S, dtype=torch.bool)
        self._floats = buf(3, S)
        pin = dev.type == "cuda"
        self._inputs_host = torch.zeros((2, S), dtype=torch.bool,
                                        pin_memory=pin)
        self._flags_host = (torch.zeros((2, S), dtype=torch.bool,
                                        pin_memory=True)
                            if pin else self._flags)
        self.out = SiteStepOut(trig=self._flags[0], shed=self._flags[1],
                               load=self._floats[0], it_mw=self._floats[1],
                               tracking_err=self._floats[2])
        self._graph = None
        self._prepared = 0
        self._free = list(range(capacity - 1, -1, -1))

    # -- occupancy ----------------------------------------------------------
    @property
    def n_active(self) -> int:
        return self.capacity - len(self._free)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    # -- slow path: churn by index ------------------------------------------
    def admit_batch(self, batch: ScenarioBatch) -> list[int]:
        """Admit every scenario in ``batch`` into free slots; returns the
        slot indices (the site handles the server routes by)."""
        if batch.h_max != self.horizon_h:
            raise ValueError(
                f"admitted batch horizon {batch.h_max} h != store horizon "
                f"{self.horizon_h} h (fixed at construction)")
        if batch.n > len(self._free):
            raise ValueError(
                f"admit of {batch.n} sites exceeds {len(self._free)} free "
                f"slots (capacity {self.capacity})")
        dev, cfg = self.device, self.cfg
        batch = batch.to(dev)
        params, _, _ = engine_lib.engine_params(cfg, batch)
        new = StoreState(
            engine=engine_lib.engine_init(cfg, batch.seed, device=dev),
            params=params,
            load=twin_lib.host_load_params(cfg.n_hosts, batch.seed),
            mw=batch.mw, active=None, t=None)
        slots = [self._free.pop() for _ in range(batch.n)]
        idx = torch.tensor(slots, dtype=torch.int64, device=dev)
        st = self.state
        for dst, src in zip(pytree.tree_leaves((st.engine, st.params)),
                            pytree.tree_leaves((new.engine, new.params))):
            dst.index_copy_(0, idx, src.to(dst.dtype))
        for name in ("phases", "jitter_ph", "seed"):  # per-site load rows
            getattr(st.load, name).index_copy_(0, idx,
                                               getattr(new.load, name))
        st.mw.index_copy_(0, idx, new.mw)
        st.active.index_fill_(0, idx, True)
        st.t.index_fill_(0, idx, 0)
        return slots

    def evict(self, slot: int) -> None:
        """Free ``slot``.  The lane's state stays in place (frozen by the
        active mask), so eviction is one write into the mask."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        self.state.active[slot] = False
        self._free.append(slot)

    # -- hot path ------------------------------------------------------------
    def _tick(self) -> None:
        """The batched tick on the static buffers: reads the inputs and the
        state, writes the state back in place and the outputs into their
        buffers.  The function the CUDA graph captures; it reads no value
        on the host."""
        cfg, st = self.cfg, self.state
        below, enabled = self._inputs
        run = st.active & enabled
        t_sched = torch.remainder(st.t, self.sched_s)
        lp = st.load
        fast = torch.where(self._use_fast, self._fast_in,
                           twin_lib.live_load_noise(lp.seed, st.t,
                                                    cfg.n_hosts))
        row = twin_lib.host_loads_rows(
            lp, t_sched.to(torch.float32)[:, None], fast[:, None])[:, 0]
        noise = torch.where(
            self._use_noise, self._noise_in,
            twin_lib.plant_noise(st.engine.seed, st.t, 1, cfg.n_hosts,
                                 cfg.chips_per_host)[:, 0])
        new, (sec, m) = engine_lib.engine_step(
            cfg, st.params, st.engine, (row, below, run, t_sched),
            noise=noise)
        # the outputs first: ``sec.load`` is the state's own last_load
        torch.stack([sec.trig & run, sec.shed & run], out=self._flags)
        torch.stack([torch.where(run, sec.load, 0.0),
                     torch.where(run, m.it_power / cfg.design_it_w * st.mw,
                                 0.0),
                     torch.where(run, m.tracking_err, 0.0)],
                    out=self._floats)
        # freeze non-running lanes bit-exactly (churn independence), in
        # the store's own storage
        for dst, src in zip(pytree.tree_leaves(st.engine),
                            pytree.tree_leaves(new)):
            go = run.reshape((-1,) + (1,) * (dst.dim() - 1))
            dst.copy_(torch.where(go, src, dst))
        st.t.add_(run.to(torch.int64))

    def _capture(self) -> None:
        """Warm the tick up on a side stream with every lane frozen (the
        state does not move), then capture it as a CUDA graph."""
        keep = self._inputs.clone()
        self._inputs[1].fill_(False)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_TICKS):
                self._tick()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._inputs.copy_(keep)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._tick()
        self._graph = graph

    def step(self, below=None, enabled=None, *, fast=None,
             noise=None) -> SiteStepOut:
        """One batched tick over every lane.

        ``below``/``enabled`` (S,) bool default to all-clear/all-enabled.
        ``fast`` (S, H) and ``noise`` (S, H, C) replace the tick's demand
        white noise and plant noise.  Returns :class:`SiteStepOut`, views
        into static buffers that the next step overwrites."""
        host = self._inputs_host.numpy()
        host[0] = False if below is None else np.asarray(below, bool)
        host[1] = True if enabled is None else np.asarray(enabled, bool)
        self._inputs.copy_(self._inputs_host)
        for flag, buf, x in ((self._use_fast, self._fast_in, fast),
                             (self._use_noise, self._noise_in, noise)):
            flag.fill_(x is not None)
            if x is not None:
                buf.copy_(torch.as_tensor(x, dtype=torch.float32))
        if self._prepared == 0:
            if self.device.type == "cuda":
                self._capture()
            self._prepared += 1
        if self._graph is not None:
            self._graph.replay()
        else:
            self._tick()
        return self.out

    def fetch_flags(self) -> np.ndarray:
        """(2, S) bool host copy of the last tick's (trig, shed): the one
        copy to the host a tick needs (it waits for the tick).  The array
        is a view that the next fetch overwrites."""
        if self._flags_host is not self._flags:
            self._flags_host.copy_(self._flags)
        return self._flags_host.numpy()

    # -- introspection (tests/bench) ----------------------------------------
    def snapshot(self) -> EngineState:
        """Host copy of the stacked engine state (numpy arrays)."""
        return pytree.tree_map(lambda x: x.detach().cpu().numpy().copy(),
                               self.state.engine)

    def site_tables(self, slots: Sequence[int]) -> dict:
        """Host view of admitted sites' hour-0 operating points (the rows
        the server arms its island register file from)."""
        idx = np.asarray(list(slots), np.int64)
        p = self.state.params

        def host(x):
            return x.detach().cpu().numpy()

        return dict(mu0=host(p.mu_h)[idx, 0], rho0=host(p.rho_h)[idx, 0],
                    min_dur_s=host(p.min_dur_i)[idx],
                    mw=host(self.state.mw)[idx])

    def step_cache_size(self) -> int:
        """How many times the hot tick was captured as a CUDA graph (on
        the CPU: prepared).  1 == churn never re-captured: the no-retrace
        gate."""
        return self._prepared

    def clear_step_cache(self) -> None:
        """Drop the captured tick; the next step captures it anew."""
        self._graph = None
        self._prepared = 0
