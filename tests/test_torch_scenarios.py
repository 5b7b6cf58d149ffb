"""Scenario inputs of the port: the batch builder (exact arrays), event
painting (exact on a given EventBatch), and the port's own counter-based
draws, checked by distribution and for independence of the batch."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_common import CPU, assert_close, n, np_tree, port_specs
import repro.grid.frequency as r_freq
import repro.grid.scenarios as r_scen
from repro_torch import convert
import repro_torch.core.engine as eng
import repro_torch.core.twin as twin
import repro_torch.grid.frequency as freq
import repro_torch.grid.scenarios as scen
from repro_torch.core.plant import _ARCHETYPES


def _ragged_specs():
    specs = r_scen.product_specs(countries=("SE", "DE", "PL"), seeds=(0, 4),
                                 horizon_h=30, products=("FFR", "FCR-D"),
                                 reserve_rhos=(0.0, 0.2), event_seeds=(1,),
                                 workload_mixes=("train", "balanced"))
    return [dataclasses.replace(s, horizon_h=6 + 5 * (i % 5),
                                mw=5.0 + i, pue_design=1.1 + 0.01 * i)
            for i, s in enumerate(specs)]


@pytest.mark.parametrize("h_max", [None, 40])
def test_build_scenario_batch_gives_the_same_arrays(h_max):
    specs = _ragged_specs()
    rb = r_scen.build_scenario_batch(specs, h_max=h_max)
    pb = scen.build_scenario_batch(port_specs(specs), h_max=h_max,
                                   device=CPU)
    assert (pb.n, pb.h_max) == (rb.n, rb.h_max)
    for f in dataclasses.fields(rb):
        np.testing.assert_array_equal(n(getattr(pb, f.name)),
                                      np.asarray(getattr(rb, f.name)),
                                      err_msg=f.name)
    assert pb.spec(7) == port_specs([rb.spec(7)])[0]
    with pytest.raises(ValueError, match="h_max"):
        scen.build_scenario_batch(port_specs(specs), h_max=5, device=CPU)
    with pytest.raises(ValueError, match="empty"):
        scen.build_scenario_batch([], device=CPU)


def test_scenario_chunk_and_seeds_match_reference():
    specs = port_specs(_ragged_specs())
    ch = scen.scenario_chunk(specs, 3, 9, h_max=40, device=CPU)
    full = scen.build_scenario_batch(specs, h_max=40, device=CPU)
    assert torch.equal(ch.ci, full.ci[3:9])
    with pytest.raises(ValueError, match="out of range"):
        scen.scenario_chunk(specs, 5, 99, device=CPU)
    # seeds that wrap at 2**32 in the reference's uint32 arithmetic
    big = [dataclasses.replace(s, seed=2**31 - 1 - i, event_seed=50_000 + i)
           for i, s in enumerate(_ragged_specs()[:4])]
    rb = r_scen.build_scenario_batch(big)
    pb = scen.build_scenario_batch(port_specs(big), device=CPU)
    np.testing.assert_array_equal(n(scen.frequency_seeds(pb)),
                                  np.asarray(r_scen.frequency_seeds(rb)))


def test_masked_quantile_matches_reference():
    x = np.random.default_rng(2).uniform(0, 100, (5, 30)).astype(np.float32)
    mask = (np.arange(30)[None, :] < np.array([30, 20, 7, 2, 1])[:, None])
    mask = mask.astype(np.float32)
    for q in (0.0, 50.0, 95.0, 100.0):
        want = jax.vmap(lambda a, m: r_scen.masked_quantile(a, m, q))(x, mask)
        got = scen.masked_quantile(torch.from_numpy(x),
                                   torch.from_numpy(mask), q)
        assert_close(n(got), want, rtol=1e-6, atol=1e-5)


def test_apply_events_matches_reference_exactly():
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    T = 4 * 3600
    evs = jax.vmap(lambda k, p: r_freq.sample_events(k, T, p, 60.0, 16))(
        keys, np.array([0, 1, 0, 1, 0, 1], np.int32))
    base = jax.vmap(lambda k: r_freq.baseline_wander(k, T))(keys)
    want = jax.vmap(r_freq.apply_events)(base, evs)
    got = freq.apply_events(torch.from_numpy(np.asarray(base)),
                            convert.event_batch(np_tree(evs), CPU))
    assert int(np.asarray(evs.valid).sum()) > 6
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_sample_events_count_matches_poisson_rate():
    """Mean event count over many seeds against lambda, and the draws'
    ranges: ascending valid times, nadirs inside the product window."""
    seeds = torch.arange(4000)
    T, rate = 6 * 3600, 12.0
    ev = freq.sample_events(seeds, T, torch.zeros(4000, dtype=torch.long),
                            rate, 64, device=CPU)
    lam = rate * T / 86_400.0
    counts = n(ev.valid).sum(-1)
    assert abs(counts.mean() - lam) < 4 * np.sqrt(lam / 4000)
    assert abs(counts.var() - lam) < 0.15 * lam
    t0 = np.where(n(ev.valid), n(ev.t0_s), 10**9)
    assert (np.diff(np.sort(t0, -1), axis=-1) >= 0).all()
    assert (np.diff(t0, axis=-1) >= 0).all()
    v = n(ev.valid)
    assert (n(ev.t0_s)[v] >= 0).all() and (n(ev.t0_s)[v] < T).all()
    nad = n(ev.nadir_hz)[v]
    assert nad.min() >= freq._NADIR_LO[0] - 1e-4
    assert nad.max() <= freq._NADIR_HI[0] + 1e-4
    rec = n(ev.recovery_s)[v]
    assert rec.min() >= 60.0 and rec.max() <= 600.0


def test_own_demand_rows_and_plant_noise_by_distribution():
    seeds = torch.arange(64)
    loads = n(twin.host_loads_trace(10, 3600, seeds))          # (N, T, H)
    kinds = twin._host_kinds(10)
    means = loads.mean((0, 1))
    for h, k in enumerate(kinds):
        arch = _ARCHETYPES[("matmul", "inference", "bursty")[k]]
        if k == 2:      # 50 % duty between the mean and the low level
            assert abs(means[h] - 0.5 * (arch["mean"] + 0.05)) < 0.03
        else:
            assert abs(means[h] - arch["mean"]) < 0.01
    z = n(twin.plant_noise(seeds, 0, 600, 3, 2))
    assert abs(z.mean()) < 0.01 and abs(z.std() - 1.0) < 0.01
    w = n(freq.baseline_wander(seeds, 3600, device=CPU))
    assert abs(w.mean() - 50.0) < 0.005 and 0.003 < w.std() < 0.03


def test_a_scenario_draws_the_same_numbers_in_any_batch():
    """The counter-based draws are keyed by the scenario's own seed: the
    same spec in two different batches gets bitwise-identical inputs."""
    specs = port_specs(r_scen.product_specs(
        countries=("SE", "DE"), seeds=(3, 8), horizon_h=2,
        reserve_rhos=(0.1,), event_seeds=(2, 5)))
    a = scen.build_scenario_batch(specs, device=CPU)
    b = scen.build_scenario_batch([specs[5], specs[0], specs[6]],
                                  device=CPU)
    cfg = eng.EngineConfig(n_hosts=3, events_per_day=30.0)
    fa, _ = freq.synthesize_frequency_batch(
        scen.frequency_seeds(a), a.product_idx, n_seconds=7200,
        events_per_day=30.0, device=CPU)
    fb, _ = freq.synthesize_frequency_batch(
        scen.frequency_seeds(b), b.product_idx, n_seconds=7200,
        events_per_day=30.0, device=CPU)
    la, lb = eng.base_loads(cfg, a), eng.base_loads(cfg, b)
    na = twin.plant_noise(a.seed, 3590, 20, 3, 2)
    nb = twin.plant_noise(b.seed, 3590, 20, 3, 2)
    for i, j in ((5, 0), (0, 1), (6, 2)):
        assert torch.equal(fa[i], fb[j])
        assert torch.equal(la[i], lb[j])
        assert torch.equal(na[i], nb[j])
    assert not torch.equal(fa[0], fa[1])
