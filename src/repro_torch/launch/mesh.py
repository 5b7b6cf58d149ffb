"""Mesh resolution on ``torch.distributed``: the port of
``repro.launch.mesh``.

Importing this module initialises neither CUDA nor a process group;
devices and groups are touched inside the functions only.

:func:`resolve_mesh` is the single entry point of the engine's
``mesh=`` argument:

  ``"local"``        a :class:`ScenarioMesh` over this process's cards
                     (capped by ``n_devices``), or the CPU with
                     ``device="cpu"``,
  ``"distributed"``  initialise ``torch.distributed`` from the
                     ``REPRO_COORD_ADDR`` / ``REPRO_NUM_PROCESSES`` /
                     ``REPRO_PROCESS_ID`` environment and return the
                     scenario mesh this process computes on,
  ``"auto"``         ``"distributed"`` when the environment is set, else
                     ``"local"``,
  a ``ScenarioMesh`` validated and returned as it is.

torch has no single program across processes, so the reference's CPU
semantics hold on every backend: ``resolve_mesh("distributed")`` returns
this process's local slice (its card, or the CPU), each process sweeps
its :func:`process_slice` of the scenario index range, and the
per-process aggregates combine through ``engine.summary_merge`` (order
never matters).  No host ever builds the global batch.

**Backend.**  :func:`ensure_distributed` picks NCCL when the caller's
device is a card and this machine has a card for every rank of the world
(rank ``r`` takes card ``r % device_count``); gloo on the CPU and where
ranks share a card, which NCCL refuses.  The compute stays on the
caller's device whatever the backend; ``torch.distributed.get_backend()``
reads the choice.

:func:`make_local_mesh` is the training side: a ``DeviceMesh`` with axes
``("data", "model")`` over the world, a world of one on an in-memory
store when no environment is set.
"""
from __future__ import annotations

import datetime
import os
import warnings
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch import resolve_device

SCENARIO_AXIS = "scenario"

# environment contract for multi-process runs (set per process by the
# launcher)
COORD_ADDR_ENV = "REPRO_COORD_ADDR"
NUM_PROCESSES_ENV = "REPRO_NUM_PROCESSES"
PROCESS_ID_ENV = "REPRO_PROCESS_ID"

# every rendezvous and collective gives up after this long, so a rank
# that never arrives fails the run instead of hanging it
DIST_TIMEOUT = datetime.timedelta(seconds=120)


def distributed_env() -> tuple[str, int, int] | None:
    """(coordinator address, process count, process id) from the env, or
    None when this is not a multi-process launch.  Process count and id
    must come together with the address; a partial set is an error, not a
    silent single-process fallback."""
    addr = os.environ.get(COORD_ADDR_ENV)
    if addr is None:
        return None
    try:
        n = int(os.environ[NUM_PROCESSES_ENV])
        pid = int(os.environ[PROCESS_ID_ENV])
    except KeyError as e:
        raise RuntimeError(
            f"{COORD_ADDR_ENV} is set but {e.args[0]} is not: a "
            "multi-process launch needs all three of "
            f"{COORD_ADDR_ENV}/{NUM_PROCESSES_ENV}/{PROCESS_ID_ENV}") from e
    if not (0 <= pid < n):
        raise RuntimeError(
            f"{PROCESS_ID_ENV}={pid} out of range for "
            f"{NUM_PROCESSES_ENV}={n}")
    return addr, n, pid


def choose_backend(device, world_size: int) -> str:
    """NCCL when ``device`` is a card and every rank of ``world_size``
    has a card of its own on this machine; gloo otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _init_group(device, rank: int, world_size: int, **where) -> None:
    backend = choose_backend(device, world_size)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=DIST_TIMEOUT, **where)


def ensure_distributed(device="cuda") -> bool:
    """Initialise ``torch.distributed`` from the environment, once.

    Returns True when this process is part of a multi-process run (after
    initialisation), False for a plain single-process launch.  Safe to
    call repeatedly; the first call blocks until every process reaches
    the coordinator, at most ``DIST_TIMEOUT``.
    """
    env = distributed_env()
    if env is None:
        return False
    if not dist.is_initialized():
        addr, n, pid = env
        _init_group(device, pid, n, init_method=f"tcp://{addr}")
    return True


def process_slice(n_total: int) -> tuple[int, int]:
    """This process's contiguous ``[lo, hi)`` slice of a global scenario
    index range, balanced to within one element across processes.  The
    identity slice when no process group exists."""
    if dist.is_initialized():
        n_proc, pid = dist.get_world_size(), dist.get_rank()
    else:
        n_proc, pid = 1, 0
    base, rem = divmod(n_total, n_proc)
    lo = pid * base + min(pid, rem)
    return lo, lo + base + (1 if pid < rem else 0)


@dataclass(frozen=True)
class ScenarioMesh:
    """A 1-D mesh of scenario lanes: one ``torch.device`` per lane, under
    the axis name ``"scenario"``.  A device may appear more than once (two
    lanes on one card)."""

    devices: tuple
    axis_names: tuple = (SCENARIO_AXIS,)

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a ScenarioMesh needs at least one device")
        if len(self.axis_names) != 1:
            raise ValueError(f"a ScenarioMesh has one axis, got "
                             f"{self.axis_names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> dict:
        """Axis name -> size, as the reference's ``Mesh.shape``."""
        return {self.axis_names[0]: len(self.devices)}


def _local_devices(device, n_devices: int | None = None) -> tuple:
    dev = resolve_device(device)
    if dev.type != "cuda":
        return (dev,)
    devs = tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))
    return devs if n_devices is None else devs[:n_devices]


def resolve_mesh(kind="auto", *, n_devices: int | None = None,
                 device="cuda") -> ScenarioMesh:
    """Resolve ``kind`` into a scenario mesh (see the module docstring).

    ``n_devices`` caps the card count of ``"local"``.  ``"distributed"``
    returns one lane on this process's device: its card
    (``rank % device_count``) or the CPU.
    """
    if isinstance(kind, ScenarioMesh):
        return kind
    if kind == "auto":
        kind = "distributed" if distributed_env() is not None else "local"
    if kind == "distributed":
        if not ensure_distributed(device):
            raise RuntimeError(
                f"resolve_mesh('distributed') needs {COORD_ADDR_ENV}/"
                f"{NUM_PROCESSES_ENV}/{PROCESS_ID_ENV} in the environment")
        devs = _local_devices(device)
        return ScenarioMesh((devs[dist.get_rank() % len(devs)],))
    if kind == "local":
        return ScenarioMesh(_local_devices(device, n_devices))
    raise ValueError(
        f"resolve_mesh kind must be 'auto', 'local', 'distributed' or a "
        f"ScenarioMesh, got {kind!r}")


# ---------------------------------------------------------------------------
# Training meshes, deprecated shims
# ---------------------------------------------------------------------------


def _world_mesh(shape: tuple, axes: tuple, device):
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    need = 1
    for s in shape:
        need *= s
    if n != need:
        raise ValueError(
            f"a {dict(zip(axes, shape))} mesh needs {need} devices, the "
            f"world has {n}")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_local_mesh(device="cuda"):
    """A ``DeviceMesh`` with axes ``("data", "model")`` over the world:
    ``(n // 2, 2)`` for n >= 4 ranks, ``(n, 1)`` otherwise.  The world
    comes from the ``REPRO_*`` environment, or is a world of one on an
    in-memory store (no port, no network)."""
    dev = resolve_device(device)
    if not ensure_distributed(dev) and not dist.is_initialized():
        _init_group(dev, 0, 1, store=dist.HashStore())
    n = dist.get_world_size()
    shape = (n // 2, 2) if n >= 4 else (n, 1)
    return _world_mesh(shape, ("data", "model"), dev)


def pod_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks): the
    production training topology.  Raises ``ValueError`` when the world
    has another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        need = 512 if multi_pod else 256
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs {need} "
                         "devices, and no process group exists")
    return _world_mesh(shape, axes, device)


def make_scenario_mesh(n_devices: int | None = None, *, device="cuda"):
    """Deprecated: use ``resolve_mesh("local", n_devices=...)`` (or
    ``"auto"``, which also covers multi-process launches)."""
    warnings.warn(
        "make_scenario_mesh is deprecated; use "
        "repro_torch.launch.mesh.resolve_mesh('local'|'auto'|'distributed')",
        DeprecationWarning, stacklevel=2)
    return resolve_mesh("local", n_devices=n_devices, device=device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """Deprecated alias of :func:`pod_mesh`."""
    warnings.warn(
        "make_production_mesh is deprecated; use "
        "repro_torch.launch.mesh.pod_mesh(multi_pod=...)",
        DeprecationWarning, stacklevel=2)
    return pod_mesh(multi_pod=multi_pod, device=device)
