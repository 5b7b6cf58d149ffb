"""The safety-island bypass (paper Sect. 3.2): the port's copy of
``repro.core.island`` (numpy and UDP on localhost; no torch, no JAX).

The paper's island is <400 lines of real-time C pinned to an isolated core
(SCHED_FIFO prio 80) that reads a TSO UDP trigger and writes precomputed
per-GPU caps via NVML, bypassing the Python supervisor.  This keeps the
*architecture* -- an out-of-band, allocation-free, pre-resolved dispatch
path:

  * all lookups precomputed into flat numpy arrays at arm() time,
  * a dedicated UDP socket read into a preallocated buffer,
  * cap writes = one vectorised store into a preallocated register file
    (the NVML-write analogue the plant simulator consumes),
  * optional SCHED_FIFO + CPU pinning when the container permits it.

The contrast path (``PythonSupervisor``) routes the same trigger through a
realistic supervisor stack -- queue hop, dict dispatch, JSON telemetry,
logging -- whose tail latency under allocation churn
(``AllocationChurn``) is what fails TSO pre-qualification in the paper
(p99 > 250 ms there).
"""
from __future__ import annotations

import gc
import json
import logging
import os
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

TRIGGER_MAGIC = 0x46465221  # "FFR!"
TRIGGER_FMT = "<IIf"        # magic, op-point index, grid frequency Hz
TRIGGER_SIZE = struct.calcsize(TRIGGER_FMT)
FFR_FREQ_THRESHOLD = 49.7   # Hz (Nordic FFR activation)
DEFAULT_PORT = 47117


def encode_trigger(op_index: int, freq_hz: float) -> bytes:
    return struct.pack(TRIGGER_FMT, TRIGGER_MAGIC, op_index, freq_hz)


def _try_realtime() -> bool:
    """Best-effort SCHED_FIFO + core pinning (needs privileges)."""
    ok = False
    try:
        os.sched_setscheduler(0, os.SCHED_FIFO, os.sched_param(80))
        ok = True
    except (PermissionError, OSError):
        pass
    try:
        cores = sorted(os.sched_getaffinity(0))
        if len(cores) > 1:
            os.sched_setaffinity(0, {cores[-1]})
    except OSError:
        pass
    return ok


@dataclass
class IslandStats:
    """Preallocated latency log (ns).  No allocation on the hot path."""

    capacity: int = 4096
    recv_ns: np.ndarray = field(default=None)  # type: ignore[assignment]
    decide_ns: np.ndarray = field(default=None)  # type: ignore[assignment]
    write_ns: np.ndarray = field(default=None)  # type: ignore[assignment]
    count: int = 0

    def __post_init__(self):
        self.recv_ns = np.zeros(self.capacity, np.int64)
        self.decide_ns = np.zeros(self.capacity, np.int64)
        self.write_ns = np.zeros(self.capacity, np.int64)


class SafetyIsland:
    """Deterministic FR dispatch: UDP trigger -> precomputed cap write.

    The register file (`caps`) is the actuator interface: the plant (or a
    real NVML shim) reads it.  `table` rows are armed per operating point
    by Tier-3; the trigger only selects a precomputed row -- L_decide is a
    single index, exactly the paper's "<50 us lookup".
    """

    def __init__(self, n_chips: int, cap_table: np.ndarray,
                 port: int = DEFAULT_PORT, host: str = "127.0.0.1"):
        # cap_table: (n_ops, n_chips) float32, fully precomputed.
        assert cap_table.ndim == 2 and cap_table.shape[1] == n_chips
        self.table = np.ascontiguousarray(cap_table, np.float32)
        self.caps = np.ascontiguousarray(self.table[0].copy())  # register file
        self.armed_row = 0
        self.trigger_count = 0
        self.last_trigger_ns = 0
        self.stats = IslandStats()
        self._buf = bytearray(64)
        self._host, self._port = host, port
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.realtime = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 16)
        self._sock.bind((self._host, self._port))
        self._sock.settimeout(0.2)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="safety-island")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def arm(self, op_index: int) -> None:
        """Tier-3 arms the current operating row (slow path, allowed)."""
        self.armed_row = int(op_index)

    # -- hot path -----------------------------------------------------------
    def _run(self) -> None:
        self.realtime = _try_realtime()
        gc_was = gc.isenabled()
        gc.disable()  # the island never allocates; keep the collector away
        buf = self._buf
        table = self.table
        caps = self.caps
        stats = self.stats
        unpack = struct.unpack_from
        try:
            while not self._stop.is_set():
                try:
                    n = self._sock.recv_into(buf, TRIGGER_SIZE)
                except socket.timeout:
                    continue
                except OSError:
                    break
                t0 = time.perf_counter_ns()
                if n < TRIGGER_SIZE:
                    continue
                magic, op_idx, freq = unpack(TRIGGER_FMT, buf, 0)
                if magic != TRIGGER_MAGIC or freq >= FFR_FREQ_THRESHOLD:
                    continue
                row = op_idx if op_idx < table.shape[0] else self.armed_row
                t1 = time.perf_counter_ns()
                caps[:] = table[row]  # the "NVML write": one vector store
                t2 = time.perf_counter_ns()
                i = stats.count % stats.capacity
                stats.recv_ns[i] = t0
                stats.decide_ns[i] = t1 - t0
                stats.write_ns[i] = t2 - t1
                stats.count += 1
                self.trigger_count += 1
                self.last_trigger_ns = t2
        finally:
            if gc_was:
                gc.enable()

    # -- client side ----------------------------------------------------------
    def send_trigger(self, op_index: int = 0xFFFFFFFF,
                     freq_hz: float = 49.5) -> int:
        """Fire a TSO trigger.  Returns send timestamp (ns)."""
        payload = encode_trigger(op_index & 0xFFFFFFFF, freq_hz)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            t = time.perf_counter_ns()
            s.sendto(payload, (self._host, self._port))
        finally:
            s.close()
        return t

    def wait_for_trigger(self, prev_count: int, timeout_s: float = 1.0) -> bool:
        deadline = time.perf_counter() + timeout_s
        while self.trigger_count <= prev_count:
            if time.perf_counter() > deadline:
                return False
            time.sleep(0.0002)
        return True


# ---------------------------------------------------------------------------
# The contrast path: a realistic Python supervisor stack
# ---------------------------------------------------------------------------


class PythonSupervisor:
    """Routes the same trigger through the full supervisor stack.

    Queue hop -> policy dict dispatch -> telemetry JSON -> logging -> cap
    write.  This is the "without the bypass" arm of E7: correct, but its
    tail is at the mercy of allocation churn and the GC.
    """

    def __init__(self, n_chips: int, cap_table: np.ndarray):
        self.table = cap_table
        self.caps = cap_table[0].copy()
        self.q: "queue.Queue[tuple]" = queue.Queue()
        self.log = logging.getLogger("gridpilot.supervisor")
        self.events: list = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.done_ns: "queue.Queue[int]" = queue.Queue()

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.q.put(None)
        if self._thread:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            item = self.q.get()
            if item is None:
                break
            op_idx, freq, t_send = item
            # policy resolution (dict-of-dicts dispatch, as a real stack does)
            policy = {
                "product": "FFR",
                "threshold": FFR_FREQ_THRESHOLD,
                "op_index": int(op_idx),
                "freq": float(freq),
            }
            if policy["freq"] < policy["threshold"]:
                row = policy["op_index"] % self.table.shape[0]
                new_caps = self.table[row].tolist()  # allocation, like prod
                self.caps = np.asarray(new_caps, np.float32)
                event = {
                    "ts": time.time(),
                    "kind": "ffr_activation",
                    "caps": new_caps[:8],
                    "row": row,
                }
                self.events.append(json.dumps(event))  # telemetry serialise
                self.log.debug("FFR activation row=%s", row)
            self.done_ns.put(time.perf_counter_ns())

    def send_trigger(self, op_index: int = 0, freq_hz: float = 49.5) -> int:
        t = time.perf_counter_ns()
        self.q.put((op_index, freq_hz, t))
        return t

    def wait_done(self, timeout_s: float = 2.0) -> int:
        return self.done_ns.get(timeout=timeout_s)


class AllocationChurn:
    """Background allocation + GC pressure standing in for the rest of a
    busy supervisor process (metric scrapes, schedulers, RPC handlers).

    A large retained object graph makes every gen-2 collection a long
    stop-the-world pause that the GIL imposes on the supervisor thread --
    the mechanism behind the paper's "p99 > 250 ms" Python-path failure.
    The island never sees it: its hot path allocates nothing and runs
    with the collector disabled.
    """

    def __init__(self, retained_objects: int = 1_500_000, hz: float = 50.0):
        self.retained_objects = retained_objects
        self.hz = hz
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        # the long-lived heap a real supervisor carries (job tables,
        # metric registries, config trees)
        retained = [(i, str(i), {"j": i}) for i in
                    range(self.retained_objects // 3)]
        junk: list = []
        k = 0
        while not self._stop.is_set():
            junk.append([{"k": i, "v": os.urandom(256)} for i in range(512)])
            if len(junk) > 8:
                junk = junk[-4:]
            k += 1
            if k % 16 == 0:
                gc.collect()  # full collection scans the retained heap
            time.sleep(1.0 / self.hz)
        del retained
