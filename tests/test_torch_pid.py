"""Tier-1 PID in the port against ``repro.core.pid``: the fused step
(windup, saturation, thermal fallback, broadcasting), the three
closed-loop rollouts, and the quasi-static settling check."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU, assert_close, n, np_tree
from repro.core import pid as r_pid
from repro.core import plant as r_plant
from repro_torch import convert
from repro_torch.core import pid, plant

TOL = dict(rtol=1e-5, atol=1e-4)


def _port_state(ref_pid, ref_plant):
    return (convert.pid_state(np_tree(ref_pid), CPU),
            convert.plant_state(np_tree(ref_plant), CPU))


@pytest.mark.parametrize("target,power,temp", [
    (300.0, 100.0, 40.0),      # large error: output saturates high
    (100.0, 300.0, 40.0),      # saturates low
    (250.0, 240.0, 60.0),      # in range
    (300.0, 295.0, 92.0),      # thermal fallback to 200 W
])
def test_pid_step_matches_reference_with_broadcast_scalars(target, power,
                                                           temp):
    ref_s, ref_u = r_pid.pid_step(r_pid.init_pid(4), jnp.float32(target),
                                  jnp.float32(power), jnp.float32(temp))
    st, u = pid.pid_step(pid.init_pid(4, device=CPU), target, power, temp)
    assert tuple(u.shape) == (4,)
    assert_close(n(u), ref_u, **TOL)
    for f in ("integ", "prev_err", "u"):
        assert_close(n(getattr(st, f)), getattr(ref_s, f), **TOL, msg=f)
    assert float(u.min()) >= pid.U_MIN - 1e-4
    assert float(u.max()) <= pid.U_MAX + 1e-4
    if temp > 85.0:
        assert float(u.max()) <= pid.FALLBACK_CAP + 1e-4


def test_anti_windup_clamp_matches_reference():
    ref_s, st = r_pid.init_pid(3), pid.init_pid(3, device=CPU)
    tgt = np.array([300.0, 100.0, 200.0], np.float32)
    pwr = np.array([100.0, 300.0, 199.0], np.float32)
    for _ in range(300):
        ref_s, _ = r_pid.pid_step(ref_s, jnp.asarray(tgt), jnp.asarray(pwr),
                                  jnp.float32(40.0))
        st, _ = pid.pid_step(st, torch.from_numpy(tgt),
                             torch.from_numpy(pwr), 40.0)
    assert np.abs(n(st.integ)).max() <= pid.WINDUP_CLAMP + 1e-4
    assert_close(n(st.integ), ref_s.integ, **TOL)


def _rollout_pair(p0, target, ticks, tau, load=0.97, chips=1):
    ref_st = r_pid.init_pid(chips, p0)
    ref_pl = dataclasses.replace(r_plant.init_plant(chips, cap=300.0),
                                 power=jnp.full((chips,), p0))
    tg = np.full((ticks, chips), target, np.float32)
    ld = np.full((ticks, chips), load, np.float32)
    return ref_st, ref_pl, tg, ld


@pytest.mark.parametrize("p0,target,tau", [(280.0, 200.0, 6.0),
                                           (150.0, 250.0, 6.0),
                                           (280.0, 200.0, 9.7)])
def test_pid_rollout_matches_reference(p0, target, tau):
    ref_st, ref_pl, tg, ld = _rollout_pair(p0, target, 120, tau)
    r_fin, r_plf, r_tr = r_pid.pid_rollout(ref_st, ref_pl, tg, ld,
                                           tau_ms=tau)
    st, pl = _port_state(ref_st, ref_pl)
    fin, plf, tr = pid.pid_rollout(st, pl, torch.from_numpy(tg),
                                   torch.from_numpy(ld), tau_ms=tau,
                                   device=CPU)
    assert tuple(tr.shape) == (120, 1)
    assert_close(n(tr), r_tr, **TOL)
    for f in ("power", "cap", "temp", "freq"):
        assert_close(n(getattr(plf, f)), getattr(r_plf, f), rtol=1e-5,
                     atol=1e-3, msg=f)
    assert_close(n(fin.integ), r_fin.integ, **TOL)


def _stack(trees):
    return jax.tree.map(lambda *a: jnp.stack(a), *trees)


def test_pid_rollout_batch_matches_reference():
    cells = [(280.0, 200.0, 0.97), (150.0, 260.0, 0.6), (250.0, 120.0, 0.9)]
    pairs = [_rollout_pair(p0, tgt, 100, 6.0, ld, chips=2)
             for p0, tgt, ld in cells]
    ref_st = _stack([p[0] for p in pairs])
    ref_pl = _stack([p[1] for p in pairs])
    tg = np.stack([p[2] for p in pairs])
    ld = np.stack([p[3] for p in pairs])
    _, _, r_tr = r_pid.pid_rollout_batch(ref_st, ref_pl, tg, ld, tau_ms=6.0)
    st, pl = _port_state(ref_st, ref_pl)
    _, _, tr = pid.pid_rollout_batch(st, pl, torch.from_numpy(tg),
                                     torch.from_numpy(ld), device=CPU)
    assert tuple(tr.shape) == (3, 100, 2)
    assert_close(n(tr), r_tr, **TOL)


_GRID_TARGETS = (120.0, 180.0, 240.0, 300.0)
_GRID_LOADS = (0.6, 0.8, 0.97)


def _grid_inputs(chips, ticks):
    S, H = len(_GRID_TARGETS), len(_GRID_LOADS)
    ref_st = _stack([_stack([r_pid.init_pid(chips, 250.0)] * H)] * S)
    ref_pl = _stack([_stack([r_plant.init_plant(chips, cap=300.0)] * H)] * S)
    tg = np.broadcast_to(np.asarray(_GRID_TARGETS, np.float32)[
        :, None, None, None], (S, H, ticks, chips)).copy()
    ld = np.broadcast_to(np.asarray(_GRID_LOADS, np.float32)[
        None, :, None, None], (S, H, ticks, chips)).copy()
    return ref_st, ref_pl, tg, ld


def test_pid_rollout_grid_matches_reference():
    ref_st, ref_pl, tg, ld = _grid_inputs(2, 100)
    _, _, r_tr = r_pid.pid_rollout_grid(ref_st, ref_pl, tg, ld, tau_ms=6.0)
    st, pl = _port_state(ref_st, ref_pl)
    _, _, tr = pid.pid_rollout_grid(st, pl, torch.from_numpy(tg),
                                    torch.from_numpy(ld), device=CPU)
    assert tuple(tr.shape) == (4, 3, 100, 2)
    assert_close(n(tr), r_tr, **TOL)


def test_quasi_static_settling_over_full_product():
    """Within one twin tick (200 Tier-1 ticks) every (target, load) cell
    settles to min(demand, target): the 1 Hz engine's assumption."""
    ref_st, ref_pl, tg, ld = _grid_inputs(1, 200)
    st, pl = _port_state(ref_st, ref_pl)
    _, _, tr = pid.pid_rollout_grid(st, pl, torch.from_numpy(tg),
                                    torch.from_numpy(ld), device=CPU)
    final = n(tr)[:, :, -1, 0]
    demand = n(plant.power_model(plant.F_NOMINAL,
                                 torch.tensor(_GRID_LOADS)))
    expect = np.minimum(demand[None, :], np.asarray(_GRID_TARGETS)[:, None])
    np.testing.assert_allclose(final, expect, rtol=0.02, atol=4.0)
    tail = n(tr)[:, :, -20:, 0]
    assert np.abs(tail - final[:, :, None]).max() < 4.0


def test_rollouts_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs there")
    st, pl = pid.init_pid(1, device=CPU), plant.init_plant(1, device=CPU)
    x = torch.ones(3, 1)
    for fn in (pid.pid_rollout, pid.pid_rollout_batch, pid.pid_rollout_grid):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(st, pl, x, x)
    with pytest.raises(RuntimeError, match="cuda"):
        pid.init_pid(1)


def test_predict_temp_matches_reference():
    temp = np.linspace(30, 95, 50, dtype=np.float32)
    power = np.linspace(50, 310, 50, dtype=np.float32)
    assert_close(n(pid.predict_temp(torch.from_numpy(temp),
                                    torch.from_numpy(power), 0.5)),
                 r_pid.predict_temp(temp, power, 0.5), **TOL)
