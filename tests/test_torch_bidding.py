"""The port's Tier-3 bidder against ``repro.optim.bidding``.

Case for case the suite of ``tests/test_bidding.py`` on the port:

* **Properties** (hypothesis via the ``_hypothesis_compat`` shim): every
  bid satisfies the residual-load floor and the cap-table box; the
  incumbent is monotone over iterations; the final objective is >= the
  grid search's on the same ensemble; a real iteration budget strictly
  improves on the grid.
* **Parity fixture**: one member, zero iterations is the port's
  ``select_operating_points`` bit for bit.
* **Batch wiring**: ``bids_for_batch`` replayed through the port's
  ``engine_rollout`` (at 1 h, so it runs in tier 1).

The reference's ``BID_TRACE_COUNT`` test has no counterpart: the port
traces nothing, so there is no compile cache to pin.

Against the reference itself: ``decode``/``encode`` and the hard and
smooth objectives pointwise, one opt step from the reference's own state,
ensemble and CEM draws, and a whole FAST run on the reference's draws
(replayed through the ``ensemble=`` and ``proposals=`` overrides).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from test_torch_common import CPU, assert_close, n, np_tree, port_config
import repro_torch.core.tier3 as tier3
import repro_torch.grid.markets as markets
import repro_torch.workload.model as wl
from repro_torch import convert
from repro_torch.optim import bidding

FAST = bidding.BidConfig(n_ens=4, n_iter=6, cem_pop=8, cem_elite=3)
B = 8
POINT = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference, imported here and not at the top: the card's
    machine, which runs this file's ``cuda`` tests, has no JAX."""
    import jax
    import jax.numpy as jnp
    import repro.core.pue as pue
    import repro.core.tier3 as r_tier3
    import repro.workload.model as r_wl
    from repro.optim import bidding as r_bid
    return SimpleNamespace(jax=jax, jnp=jnp, pue=pue, tier3=r_tier3,
                           wl=r_wl, bid=r_bid,
                           FAST=r_bid.BidConfig(n_ens=4, n_iter=6,
                                                cem_pop=8, cem_elite=3))


def _forecast(seed: int):
    rng = np.random.default_rng(seed)
    green = rng.uniform(0.0, 1.0, B).astype(np.float32)
    t_amb = rng.uniform(-5.0, 30.0, B).astype(np.float32)
    return green, t_amb


def _optimize(seed: int, **kw):
    green, t_amb = _forecast(seed)
    kw.setdefault("config", FAST)
    return bidding.optimize_bids(green, t_amb, key=seed, device=CPU, **kw)


# ---------------------------------------------------------------------------
# Properties
# ---------------------------------------------------------------------------


@given(st.integers(0, 2 ** 16))
@settings(max_examples=20, deadline=None)
def test_bids_satisfy_floor_and_box(seed):
    res = _optimize(seed)
    mu, rho, bid = map(n, (res.mu, res.rho, res.bid))
    eps = 1e-6
    assert np.all(mu >= bidding.MU_LO - eps)
    assert np.all(mu <= bidding.MU_HI + eps)
    assert np.all(rho >= -eps)
    assert np.all(rho <= tier3.RHO_MAX + eps)
    assert np.all(mu - rho >= tier3.MIN_RESIDUAL_LOAD - eps)
    assert np.all(bid >= -eps)
    assert np.all(bid <= rho + eps)


@given(st.integers(0, 2 ** 16))
@settings(max_examples=10, deadline=None)
def test_objective_monotone_over_iterations(seed):
    res = _optimize(seed)
    assert res.history.shape == (FAST.n_iter, B)
    # running argmax under a FIXED ensemble (common random numbers):
    # exactly non-decreasing, no tolerance needed
    assert np.all(np.diff(res.history, axis=0) >= 0.0)
    assert np.all(res.history[0] >= n(res.j_grid))


@given(st.integers(0, 2 ** 16))
@settings(max_examples=10, deadline=None)
def test_final_objective_beats_grid_search_on_same_ensemble(seed):
    res = _optimize(seed)
    assert np.all(n(res.j) >= n(res.j_grid))


def test_optimizer_strictly_improves_on_grid_with_budget():
    """With a real iteration budget the continuous search finds off-grid
    points the mesh cannot express."""
    rng = np.random.default_rng(7)
    green = rng.uniform(0.0, 1.0, B).astype(np.float32)
    t_amb = rng.uniform(-5.0, 30.0, B).astype(np.float32)
    cfg = bidding.BidConfig(n_ens=8, n_iter=32)
    res = bidding.optimize_bids(green, t_amb, key=7, config=cfg, device=CPU)
    j, j_grid = n(res.j), n(res.j_grid)
    assert np.all(j >= j_grid)
    assert np.any(j > j_grid)


def test_workload_weighted_objective_also_feasible():
    res = _optimize(11, weights=(0.5, 0.3, 0.2, 0.2), use_workload=True)
    mu, rho = n(res.mu), n(res.rho)
    assert np.all(mu - rho >= tier3.MIN_RESIDUAL_LOAD - 1e-6)
    assert np.all(n(res.j) >= n(res.j_grid))


# ---------------------------------------------------------------------------
# Parity fixture: the n_ens=1 / n_iter=0 degenerate case IS the grid search
# ---------------------------------------------------------------------------


PARITY = bidding.BidConfig(n_ens=1, n_iter=0)


@pytest.mark.parametrize("pue_aware", [True, False])
def test_parity_with_grid_search_bit_for_bit(pue_aware, ref):
    green = np.linspace(0.05, 0.95, 24).astype(np.float32)
    t_amb = np.linspace(-3.0, 24.0, 24).astype(np.float32)
    # 3-weight form: the 3 -> 4 padding on both sides of the comparison
    weights = (tier3.W_FFR, tier3.W_CFE, tier3.W_REV_DEFAULT)
    res = bidding.optimize_bids(green, t_amb, key=3, weights=weights,
                                pue_aware=pue_aware, use_revenue=True,
                                config=PARITY, device=CPU)
    op = tier3.select_operating_points(
        torch.from_numpy(green), torch.from_numpy(t_amb),
        pue_aware=pue_aware, weights=weights, use_revenue=True)
    assert torch.equal(res.mu, op.mu)
    assert torch.equal(res.rho, op.rho)
    assert torch.equal(res.bid, op.rho)
    assert res.history.shape == (0, 24)
    # and the grid search's cells are the reference's
    r_op = ref.tier3.select_operating_points(green, t_amb,
                                           pue_aware=pue_aware,
                                           weights=weights, use_revenue=True)
    np.testing.assert_array_equal(n(res.mu), np.asarray(r_op.mu))


def test_parity_key_independent_with_single_member():
    """With only the nominal member the ensemble carries no randomness,
    so the degenerate selection cannot depend on the key."""
    green = np.linspace(0.1, 0.9, 12).astype(np.float32)
    t_amb = np.full(12, 15.0, np.float32)
    a = bidding.optimize_bids(green, t_amb, key=1, config=PARITY, device=CPU)
    b = bidding.optimize_bids(green, t_amb, key=999, config=PARITY,
                              device=CPU)
    assert torch.equal(a.mu, b.mu)
    assert torch.equal(a.rho, b.rho)
    assert torch.equal(a.j, b.j)


def test_ensemble_member_zero_is_nominal_bitwise():
    green = torch.linspace(0.2, 0.8, 6)
    t_amb = torch.linspace(0.0, 20.0, 6)
    epd = torch.full((6,), 4.0)
    ens = bidding._synth_ensemble(0, green, t_amb, epd,
                                  bidding.BidConfig(n_ens=5))
    assert torch.equal(ens.green[:, 0], green)
    assert torch.equal(ens.t_amb[:, 0], t_amb)
    assert torch.all(ens.price_rel[:, 0] == 1.0)
    assert torch.equal(ens.epd[:, 0], epd)
    # perturbed members actually differ
    assert not torch.equal(ens.green[:, 1], green)


def test_decode_always_feasible():
    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.normal(0.0, 4.0, (256, 3)), dtype=torch.float32)
    mu, rho, bid = map(n, bidding.decode(z))
    assert np.all(mu > bidding.MU_LO) and np.all(mu < bidding.MU_HI)
    assert np.all(rho >= 0.0) and np.all(rho < tier3.RHO_MAX)
    assert np.all(mu - rho > tier3.MIN_RESIDUAL_LOAD)
    assert np.all(bid >= 0.0) and np.all(bid <= rho)


# ---------------------------------------------------------------------------
# The port's own draws: checked by their distribution and their keys
# ---------------------------------------------------------------------------


def test_port_draws_are_standard_normal_and_keyed_by_hour():
    cfg = bidding.BidConfig(n_ens=64)
    g = torch.full((200,), 0.5, dtype=torch.float64)
    ens = bidding._synth_ensemble(5, g, g * 0 + 10.0, g * 0 + 4.0, cfg)
    eps = (ens.t_amb[:, 1:] - 10.0) / cfg.sigma_t_amb
    assert abs(float(eps.mean())) < 0.03
    assert abs(float(eps.std()) - 1.0) < 0.03
    # an hour's draws do not depend on how many hours the call holds
    short = bidding._synth_ensemble(5, g[:7], g[:7] * 0 + 10.0,
                                    g[:7] * 0 + 4.0, cfg)
    assert torch.equal(short.t_amb, ens.t_amb[:7])
    other = bidding._synth_ensemble(6, g, g * 0 + 10.0, g * 0 + 4.0, cfg)
    assert not torch.equal(other.t_amb, ens.t_amb)
    keys = bidding._proposal_keys(5, 200, CPU)
    p0 = bidding._proposals(keys, 0, 16, torch.float64)
    p1 = bidding._proposals(keys, 1, 16, torch.float64)
    assert p0.shape == (200, 16, 3) and not torch.equal(p0, p1)
    assert abs(float(p0.mean())) < 0.03 and abs(float(p0.std()) - 1) < 0.03
    assert torch.equal(bidding._proposals(keys[:7], 1, 16, torch.float64),
                       p1[:7])


def test_optimize_bids_validates_its_overrides():
    green, t_amb = _forecast(0)
    with pytest.raises(ValueError, match="ensemble.green"):
        bidding.optimize_bids(green, t_amb, config=FAST, device=CPU,
                              ensemble=bidding.BidEnsemble(
                                  *[torch.zeros(B, 3)] * 4))
    with pytest.raises(ValueError, match="proposals"):
        bidding.optimize_bids(green, t_amb, config=FAST, device=CPU,
                              proposals=torch.zeros(FAST.n_iter, B, 3, 3))
    if not torch.cuda.is_available():
        from repro_torch.core.engine import EngineConfig
        from repro_torch.grid.scenarios import build_scenario_batch, \
            product_specs
        with pytest.raises(RuntimeError, match="cuda"):
            bidding.optimize_bids(green, t_amb, config=FAST)
        batch = build_scenario_batch(product_specs(countries=("SE",),
                                                   horizon_h=1), device=CPU)
        with pytest.raises(RuntimeError, match="cuda"):
            bidding.bids_for_batch(EngineConfig(), batch, config=FAST)


# ---------------------------------------------------------------------------
# Against the reference: pointwise, one step, a whole run
# ---------------------------------------------------------------------------


def _points(m=256, seed=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    mu = rng.uniform(0.42, 0.88, m).astype(f)
    rho = rng.uniform(0.0, 0.3, m).astype(f)
    bid = (rho * rng.uniform(0.0, 1.0, m)).astype(f)
    green = rng.uniform(0.0, 1.0, m).astype(f)
    t_amb = rng.uniform(-5.0, 30.0, m).astype(f)
    price = np.exp(rng.normal(0.0, 0.25, m)).astype(f)
    epd = rng.uniform(1.0, 48.0, m).astype(f)
    pidx = rng.integers(0, len(markets.PRODUCT_ORDER), m).astype(np.int32)
    cw = np.asarray(wl.CLOCK_W, f)[rng.integers(0, len(wl.CLOCK_W), m)]
    pd = rng.uniform(1.1, 1.5, m).astype(f)
    return mu, rho, bid, green, t_amb, price, epd, pidx, cw, pd


def test_decode_and_encode_match_reference(ref):
    rng = np.random.default_rng(4)
    z = rng.normal(0.0, 3.0, (256, 3)).astype(np.float32)
    want = ref.jax.vmap(ref.bid.decode)(ref.jnp.asarray(z))
    got = bidding.decode(torch.from_numpy(z))
    for a, b in zip(got, want):
        assert_close(n(a), b, **POINT)
    mu, rho, bid = (np.array(x) for x in want)
    assert_close(n(bidding.encode(*map(torch.from_numpy, (mu, rho, bid)))),
                 ref.jax.vmap(ref.bid.encode)(mu, rho, bid), rtol=1e-5,
                 atol=1e-5)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("pue_aware", [True, False])
def test_objectives_match_reference_pointwise(pue_aware, smooth, ref):
    pts = _points()
    mu, rho, bid, green, t_amb, price, epd, pidx, cw, pd = pts
    w = np.asarray([0.5, 0.3, 0.2, 0.2], np.float32)
    kw = dict(pue_aware=pue_aware, use_revenue=True, use_workload=True)
    r_fn = ref.bid.soft_objective if smooth else ref.bid.hard_objective
    p_fn = bidding.soft_objective if smooth else bidding.hard_objective
    want = r_fn(mu, rho, bid, green, t_amb, price, epd, w, pidx, cw, 30.0,
                pue_design=pd, **kw)
    t = [torch.from_numpy(x) for x in pts]
    got = p_fn(*t[:7], [float(x) for x in w], t[7], t[8], 30.0,
               pue_design=t[9], **kw)
    assert_close(n(got), want, **POINT)


def _ref_setup(ref, green, t_amb, seed, pue_aware=True):
    """The reference's own init (ensemble + state) and the arguments its
    ``optimize_bids`` hands the jitted step, built as it builds them."""
    b = len(green)
    jnp, t3, wl_r = ref.jnp, ref.tier3, ref.wl

    def bc(x, dt=jnp.float32):
        return jnp.broadcast_to(jnp.asarray(x, dt).reshape(-1), (b,))

    step_args = (t3._pad_weights((t3.W_FFR, t3.W_CFE, t3.W_REV_DEFAULT)),
                 bc(ref.pue.PUE_DESIGN), bc(0, jnp.int32),
                 bc(wl_r.clock_weight("train")),
                 jnp.asarray(wl_r.DEFAULT_GRID_CKPT_S, jnp.float32))
    flags = dict(bcfg=ref.FAST, pue_aware=pue_aware, use_revenue=True,
                 use_workload=False)
    ens, state = ref.bid._init_jit(
        ref.jax.random.PRNGKey(seed), jnp.asarray(green, jnp.float32),
        bc(t_amb), bc(t3.EVENTS_PER_DAY_DEFAULT), *step_args, **flags)
    return ens, state, step_args, flags


def _port_knobs(step_args, pue_aware=True):
    """The port's per-hour knobs from the reference step's arguments."""
    w, pd, pi, cw, ck = step_args
    return bidding._Knobs(
        weights=[float(x) for x in np.asarray(w)],
        pue_design=torch.from_numpy(np.array(pd)),
        product_idx=torch.from_numpy(np.array(pi, np.int64)),
        clock_w=torch.from_numpy(np.array(cw)), ckpt_cost_s=float(ck),
        pue_aware=pue_aware, use_revenue=True, use_workload=False)


def _ref_proposals(ref, keys):
    """(n_iter, B, cem_pop, 3): the reference step's per-hour split chain
    replayed from the init state's keys."""
    jax, jnp, cfg = ref.jax, ref.jnp, ref.FAST
    def chain(key):
        def body(k, _):
            k2, k1 = jax.random.split(k)
            return k2, jax.random.normal(k1, (cfg.cem_pop, 3), jnp.float32)
        return jax.lax.scan(body, key, None, length=cfg.n_iter)[1]

    return np.asarray(jax.vmap(chain)(keys)).transpose(1, 0, 2, 3)


def test_one_opt_step_matches_reference(ref):
    green, t_amb = _forecast(21)
    ens, state, step_args, flags = _ref_setup(ref, green, t_amb, 21)
    eps = _ref_proposals(ref, state.key)[0]
    st0 = np_tree(state)
    ens_np = np_tree(ens)
    want = np_tree(ref.bid._step_jit(state, ens, *step_args, **flags))
    p_state = convert.bid_state(st0, seed=21, device=CPU)
    p_ens = convert.bid_ensemble(ens_np, device=CPU)
    kn = _port_knobs(step_args)
    got = bidding._step(p_state, p_ens, torch.from_numpy(eps), kn, FAST)
    for k in ("z", "m", "v", "sigma", "best_mu", "best_rho", "best_bid",
              "best_j"):
        assert_close(n(getattr(got, k)), want[k], rtol=1e-5, atol=1e-6,
                     msg=k)
    assert int(got.it) == int(want["it"]) == 1


def test_bid_state_round_trips_the_reference_init(ref):
    green, t_amb = _forecast(2)
    ens, state, _, _ = _ref_setup(ref, green, t_amb, 2)
    st = convert.bid_state(np_tree(state), seed=2, device=CPU)
    for k in bidding.BidState._fields:
        if k == "key":
            continue
        np.testing.assert_array_equal(n(getattr(st, k)),
                                      np.asarray(getattr(state, k)), k)
    assert st.z.dtype == torch.float32 and st.it.dtype == torch.int32
    assert torch.equal(st.key, bidding._proposal_keys(2, B, CPU))
    pe = convert.bid_ensemble(np_tree(ens), device=CPU)
    for k in bidding.BidEnsemble._fields:
        np.testing.assert_array_equal(n(getattr(pe, k)),
                                      np.asarray(getattr(ens, k)), k)
    # the port's init on the reference's ensemble is the reference's init
    _, _, step_args, _ = _ref_setup(ref, green, t_amb, 2)
    init = bidding._init_state(2, pe, _port_knobs(step_args), FAST)
    for k in ("z", "best_mu", "best_rho", "best_bid", "best_j"):
        assert_close(n(getattr(init, k)), np.asarray(getattr(state, k)),
                     rtol=1e-6, msg=k)


@pytest.mark.parametrize("pue_aware", [True, False])
def test_fast_run_on_reference_draws_matches_reference(pue_aware, ref):
    green, t_amb = _forecast(5)
    want = ref.bid.optimize_bids(green, t_amb, key=5, pue_aware=pue_aware,
                                 config=ref.FAST)
    ens, state, _, _ = _ref_setup(ref, green, t_amb, 5,
                                  pue_aware=pue_aware)
    got = bidding.optimize_bids(
        green, t_amb, key=5, pue_aware=pue_aware, config=FAST, device=CPU,
        ensemble=convert.bid_ensemble(np_tree(ens), device=CPU),
        proposals=_ref_proposals(ref, state.key))
    assert_close(n(got.j_grid), want.j_grid, rtol=1e-6)
    assert_close(n(got.j), want.j, rtol=1e-4)
    assert_close(got.history, want.history, rtol=1e-4)
    for k in ("mu", "rho", "bid"):
        assert_close(n(getattr(got, k)), getattr(want, k), rtol=1e-4,
                     atol=1e-5, msg=k)


# ---------------------------------------------------------------------------
# Batch wiring (engine ops override)
# ---------------------------------------------------------------------------


def test_bidding_seeds_match_reference():
    from repro.grid.scenarios import bidding_seeds as r_seeds
    from repro.grid.scenarios import build_scenario_batch as r_build
    from repro.grid.scenarios import product_specs as r_specs
    from repro_torch.grid.scenarios import bidding_seeds
    specs = r_specs(countries=("SE", "DE"), seeds=(0, 5, 2_000_000_000),
                    horizon_h=1, event_seeds=(0, 9, 2_100_000_000))
    pb = convert.scenario_batch(np_tree(r_build(specs)), device=CPU)
    np.testing.assert_array_equal(n(bidding_seeds(pb)),
                                  np.asarray(r_seeds(r_build(specs)),
                                             np.int64))


def test_bids_for_batch_replays_through_engine():
    import repro.core.engine as r_eng
    import repro_torch.core.engine as eng
    from repro_torch.grid.scenarios import build_scenario_batch, \
        product_specs
    specs = product_specs(countries=("SE", "DE", "PL"), seeds=(0,),
                          horizon_h=1, products=("FFR",),
                          reserve_rhos=(0.0, 0.2), event_seeds=(0,))
    batch = build_scenario_batch(specs, device=CPU)
    cfg = port_config(r_eng.EngineConfig(
        n_hosts=2, chips_per_host=2, e_max=24, events_per_day=24.0,
        rho_mode="tier3", price_aware=True))
    ops = bidding.bids_for_batch(cfg, batch, config=FAST, device=CPU)
    assert ops[0].shape == (batch.n, batch.h_max)
    out = eng.engine_rollout(cfg, batch, ops=ops, device=CPU)
    assert np.all(np.isfinite(n(out["net_eur"])))
    # committed band in the settlement is the shaded bid
    mask = n(batch.mask)
    np.testing.assert_allclose(n(out["rho_h"]), n(ops[1]) * mask, atol=1e-7)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_optimize_bids_on_the_card_matches_the_cpu(cuda):
    green, t_amb = _forecast(9)
    cfg = bidding.BidConfig(n_ens=8, n_iter=16)
    a = bidding.optimize_bids(green, t_amb, key=9, config=cfg, device=CPU)
    b = bidding.optimize_bids(green, t_amb, key=9, config=cfg, device=cuda)
    assert b.mu.device.type == "cuda"
    torch.testing.assert_close(b.j_grid.cpu(), a.j_grid, rtol=1e-6,
                               atol=0.0)
    for k in ("mu", "rho", "bid", "j"):
        torch.testing.assert_close(getattr(b, k).cpu(), getattr(a, k),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b.history, a.history, rtol=1e-4)
