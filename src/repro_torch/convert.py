"""Carry the reference's state into the port.

What a user brings from the JAX package is state -- a scenario batch,
Tier-1/plant/Tier-2 state, an engine carry, an event set -- and, for the
served workload, model parameters and a decode cache.  Each function
takes that state as a plain dict of numpy arrays (field name -> array,
nested for nested state) and returns the port's object with tensors on
``device``.  Nothing here imports JAX: the caller turns its arrays into
numpy first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.ar4 import RLSState
from repro_torch.core.engine import EngineAccum, EngineState
from repro_torch.core.pid import PIDState
from repro_torch.core.plant import PlantState
from repro_torch.core.twin import HostLoadParams, _host_kinds
from repro_torch.grid.frequency import EventBatch
from repro_torch.grid.scenarios import ScenarioBatch
from repro_torch.random import MASK32

_INT32_FIELDS = ("country_idx", "start_day", "hours", "product_idx",
                 "mix_idx")
_SEED_FIELDS = ("seed", "event_seed")


def _t(x, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=dev)


def scenario_batch(d: dict, device="cuda") -> ScenarioBatch:
    """A ``repro.grid.scenarios.ScenarioBatch`` as numpy fields."""
    dev = resolve_device(device)
    out = {}
    for k, v in d.items():
        if k in _SEED_FIELDS:
            out[k] = _t(np.asarray(v).astype(np.int64), torch.int64,
                        dev) & MASK32
        elif k in _INT32_FIELDS:
            out[k] = _t(v, torch.int32, dev)
        else:
            out[k] = _t(v, torch.float32, dev)
    return ScenarioBatch(**out)


def pid_state(d: dict, device="cuda") -> PIDState:
    dev = resolve_device(device)
    return PIDState(**{k: _t(d[k], torch.float32, dev)
                       for k in PIDState._fields})


def plant_state(d: dict, device="cuda") -> PlantState:
    dev = resolve_device(device)
    return PlantState(**{k: _t(v, torch.float32, dev) for k, v in d.items()})


def rls_state(d: dict, device="cuda") -> RLSState:
    dev = resolve_device(device)
    return RLSState(theta=_t(d["theta"], torch.float32, dev),
                    P=_t(d["P"], torch.float32, dev),
                    hist=_t(d["hist"], torch.float32, dev),
                    steps=_t(d["steps"], torch.int32, dev))


def event_batch(d: dict, device="cuda") -> EventBatch:
    dev = resolve_device(device)
    return EventBatch(t0_s=_t(d["t0_s"], torch.int32, dev),
                      nadir_hz=_t(d["nadir_hz"], torch.float32, dev),
                      recovery_s=_t(d["recovery_s"], torch.float32, dev),
                      valid=_t(d["valid"], torch.bool, dev))


def engine_state(d: dict, seed, device="cuda") -> EngineState:
    """A reference ``EngineState`` of N scenarios (leaves with a leading
    N axis).  Its PRNG ``key`` has no counterpart: the port's plant noise
    is keyed by the (N,) ``seed`` instead."""
    dev = resolve_device(device)
    return EngineState(
        rls=rls_state(d["rls"], dev),
        chip_power=_t(d["chip_power"], torch.float32, dev),
        caps=_t(d["caps"], torch.float32, dev),
        seed=_t(np.asarray(seed).astype(np.int64), torch.int64, dev)
        & MASK32,
        last_load=_t(d["last_load"], torch.float32, dev),
        in_event=_t(d["in_event"], torch.bool, dev),
        hold=_t(d["hold"], torch.int32, dev),
        acc=EngineAccum(**{k: _t(d["acc"][k], torch.float32, dev)
                           for k in EngineAccum._fields}))


def host_load_params(d: dict, seed, device="cuda") -> HostLoadParams:
    """The reference's ``HostLoadParams`` of N scenarios (leading N axis
    on every field).  Its ``fast_key`` has no counterpart: the port keys
    each block's white noise by the (N,) ``seed``."""
    dev = resolve_device(device)
    n_hosts = np.asarray(d["mean"]).shape[-1]
    return HostLoadParams(
        mean=_t(np.asarray(d["mean"])[0], torch.float32, dev),
        fast_sigma=_t(np.asarray(d["fast_sigma"])[0], torch.float32, dev),
        slow_sigma=_t(np.asarray(d["slow_sigma"])[0], torch.float32, dev),
        phases=_t(d["phases"], torch.float32, dev),
        is_bursty=_t(_host_kinds(n_hosts) == 2, torch.bool, dev),
        duty_phase=_t(np.asarray(d["duty_phase"])[0], torch.float32, dev),
        jitter_ph=_t(d["jitter_ph"], torch.float32, dev),
        seed=_t(np.asarray(seed).astype(np.int64), torch.int64, dev)
        & MASK32)


def model_params(params: dict, device="cuda") -> dict:
    """A reference model's parameter pytree (nested dicts of numpy
    arrays, layer-stacked as the reference stores them) as the same
    nested dict of tensors, dtypes kept."""
    dev = resolve_device(device)
    return {k: model_params(v, dev) if isinstance(v, dict)
            else torch.as_tensor(np.array(v), device=dev)
            for k, v in params.items()}


def decode_cache(cache: dict, device="cuda") -> dict:
    """A reference decode cache (``k``/``v``/``pos_buf``, ``ssm``/``conv``
    or both, and ``cur``, as numpy) as the port's: tensors with their
    dtypes kept, ``cur`` a Python int."""
    dev = resolve_device(device)
    out = {k: torch.as_tensor(np.array(v), device=dev)
           for k, v in cache.items() if k != "cur"}
    out["cur"] = int(np.asarray(cache["cur"]))
    return out
