"""The plant's workload archetypes and the paper's Tier-1 and island
experiments (E1, E2, E4, E7) on the port, against ``repro.core.plant``
and the reference's bench functions.

``workload_load`` is held on the reference's own draws (its key split
into the four wave phases, the fast normals and the jitter phase) at
1e-5; the E1 surface, an E2 settle and a short E4 closed loop against
the reference at 1e-3.  The island's contrast path
(``PythonSupervisor``, ``AllocationChurn``) is checked by its round
trips.
"""
import json

import numpy as np
import pytest
import torch

from test_torch_common import CPU, assert_close, n
import repro_torch.core.island as island_lib
import repro_torch.core.plant as plant
import repro_torch.experiments as ex

CAPS = np.array([100., 125., 150., 200., 250., 300.])
FREQS = np.array([810., 945., 1080., 1215., 1380., 1530.])


def _ref_draws(key, shape):
    """The three buffers the reference's ``workload_load`` draws from a
    key, as numpy."""
    import jax
    import jax.numpy as jnp
    k1, k2, k3 = jax.random.split(key, 3)
    return (np.asarray(jax.random.uniform(k1, (4,), minval=0.0,
                                          maxval=2 * jnp.pi)),
            np.asarray(jax.random.normal(k2, shape)),
            np.asarray(jax.random.uniform(k3, (), maxval=6.28)))


def test_workload_archetype_means():
    t = np.arange(0, 60.0, 0.01, dtype=np.float32)
    g = torch.Generator().manual_seed(0)
    for w, lo, hi in [("matmul", 0.9, 1.0), ("inference", 0.5, 0.65),
                      ("bursty", 0.35, 0.62)]:
        L = plant.workload_load(w, t, generator=g, device=CPU)
        assert L.shape == t.shape and L.device.type == "cpu"
        assert lo < float(L.mean()) < hi, w
    p = plant.power_model(plant.F_NOMINAL, plant.workload_load(
        "inference", t, generator=g, device=CPU))
    assert float(p.mean()) < 200.0


@pytest.mark.parametrize("workload", ["matmul", "inference", "bursty"])
@pytest.mark.parametrize("phase", [0.0, 0.33])
def test_workload_load_matches_reference_on_its_draws(workload, phase):
    import jax
    import repro.core.plant as r_plant
    t = np.arange(0, 60.0, 0.01, dtype=np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(r_plant.workload_load(workload, t, key, phase=phase))
    got = plant.workload_load(workload, t, phase=phase,
                              draws=_ref_draws(key, t.shape), device=CPU)
    assert_close(n(got), want, 1e-5, atol=1e-6)


def test_workload_tau_and_throughput_match_reference():
    import repro.core.plant as r_plant
    assert plant.WORKLOADS == r_plant.WORKLOADS
    assert plant._R0 == r_plant._R0
    f = np.linspace(405.0, 1530.0, 7, dtype=np.float32)
    for w in plant.WORKLOADS:
        assert plant.workload_tau_ms(w) == r_plant.workload_tau_ms(w)
        assert_close(n(plant.throughput(w, torch.from_numpy(f))),
                     np.asarray(r_plant.throughput(w, f)), 1e-6)
        assert_close(plant.throughput(w, 945.0),
                     float(r_plant.throughput(w, 945.0)), 1e-6)


@pytest.mark.parametrize("workload", ["matmul", "inference", "bursty"])
def test_iterations_per_joule_matches_reference(workload):
    """The E1 surface, as one tensor call and cell by cell in numbers."""
    import repro.core.plant as r_plant
    want = np.array([[float(r_plant.iterations_per_joule(workload, c, f))
                      for f in FREQS] for c in CAPS])
    grid = plant.iterations_per_joule(
        workload, torch.tensor(CAPS, dtype=torch.float32)[:, None],
        torch.tensor(FREQS, dtype=torch.float32)[None, :])
    assert_close(n(grid), want, 1e-5)
    cells = np.array([[plant.iterations_per_joule(workload, c, f)
                       for f in FREQS] for c in CAPS])
    assert_close(cells, want, 1e-5)


def test_e1_best_point_is_150w_945mhz():
    combined = np.zeros((6, 6))
    for w in plant.WORKLOADS:
        grid = np.array([[float(plant.iterations_per_joule(w, c, f))
                          for f in FREQS] for c in CAPS])
        combined += grid / grid.max()
        assert grid[2, 1] >= 0.95 * grid.max(), w
    i, j = np.unravel_index(np.argmax(combined), combined.shape)
    assert (CAPS[i], FREQS[j]) == (150.0, 945.0)


def test_e1_best_point_values_match_paper():
    vals = {w: float(plant.iterations_per_joule(w, 150.0, 945.0))
            for w in plant.WORKLOADS}
    assert vals["inference"] == pytest.approx(2.880, rel=0.02)
    assert vals["matmul"] == pytest.approx(0.570, rel=0.02)
    assert vals["bursty"] == pytest.approx(0.549, rel=0.02)


@pytest.mark.parametrize("workload", ["matmul", "inference", "bursty"])
def test_e2_settle_matches_reference_bench(workload):
    from benchmarks import e2_step_response as r_e2
    want = r_e2.settle_ms(workload, n_trials=6, seed=2)
    got = ex.e2_settle_ms(workload, n_trials=6, seed=2, device=CPU)
    assert_close(got, want, 1e-3)
    # the paper's medians within the reference bench's own reach
    assert abs(np.median(got) - ex.E2_PAPER_MS[workload]) <= 3.0


@pytest.mark.parametrize("workload", ["matmul", "bursty"])
def test_short_e4_loop_matches_reference_bench(workload):
    """2.5 s of the closed loop (Tier-2 twice, 500 PID ticks) on the
    reference's loads, two seeds as one batch."""
    import jax.numpy as jnp
    import repro.core.plant as r_plant
    from benchmarks import e4_closed_loop as r_e4
    n_ticks = 500
    env = r_e4._envelope(n_ticks)
    loads = jnp.stack([r_e4._loads(workload, s, n_ticks) for s in (0, 1)])
    tau = r_plant.workload_tau_ms(workload)
    want = np.asarray(r_e4._replay_batch(loads, jnp.asarray(env, jnp.float32),
                                         tau))
    got = ex.e4_replay_batch(np.asarray(loads), env, tau, device=CPU)
    assert_close(n(got), want, 1e-3)


def test_e4_loads_and_flags():
    loads = ex.e4_loads("bursty", (0, 1), 400, device=CPU)
    assert tuple(loads.shape) == (2, 400, ex.E4_CHIPS)
    again = ex.e4_loads("bursty", (1,), 400, device=CPU)
    assert torch.equal(loads[1], again[0])    # a seed draws its own numbers
    errs = {"inference": np.array([1.0]), "matmul": np.array([4.9]),
            "bursty": np.array([5.1])}
    assert all(ex.e4_in_band(errs).values())
    errs["bursty"] = np.array([4.0])
    assert not ex.e4_in_band(errs)["bursty_above_band"]


def test_e7_settle_matches_reference_bench():
    from benchmarks import e7_fr_latency as r_e7
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    for w in plant.WORKLOADS:
        for _ in range(2):
            want = r_e7.settle_ms_sim(w, ra)
            got = ex.settle_ms_sim(w, rb, device=CPU)
            assert got == want
            assert 80.0 < got < 110.0


def test_e7_island_trials_under_budget():
    """Three triggers per workload through the port's island on UDP: the
    caps land and every trial is under the FFR budget."""
    res = ex.e7_island_trials(47664, trials_per_workload=3, device=CPU)
    lat = np.concatenate([res["per_workload"][w] for w in plant.WORKLOADS])
    assert lat.size == 9 and (lat < ex.E7_BUDGET_MS).all()
    assert len(res["dispatch_us"]) == 9


def test_python_supervisor_round_trips():
    table = ex.e7_cap_table()
    sup = island_lib.PythonSupervisor(3, table)
    sup.start()
    try:
        for row, hz in ((23, 49.45), (5, 49.6), (7, 49.9)):
            t0 = sup.send_trigger(op_index=row, freq_hz=hz)
            t1 = sup.wait_done(timeout_s=2.0)
            assert t1 >= t0
        # the two under-frequency triggers activate, the third does not
        assert len(sup.events) == 2
        ev = json.loads(sup.events[-1])
        assert ev["kind"] == "ffr_activation" and ev["row"] == 5
        np.testing.assert_array_equal(sup.caps, table[5])
        assert sup.caps.dtype == np.float32
    finally:
        sup.stop()


def test_supervisor_under_allocation_churn():
    rng = np.random.default_rng(0)
    lat = ex.e7_supervisor_trials(rng, 5, retained_objects=30_000)
    assert lat.shape == (5,) and (lat >= 0).all()
    churn = island_lib.AllocationChurn(retained_objects=3_000, hz=200.0)
    churn.start()
    churn.stop()
    assert not churn._thread.is_alive()


def test_workload_load_default_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        plant.workload_load("matmul", np.arange(4.0))
    with pytest.raises(RuntimeError, match="cuda"):
        ex.e2_settle_ms("matmul", n_trials=1)
