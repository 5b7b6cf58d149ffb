"""The port's separate reserve replay against ``repro.core.reserve``.

The cases of ``tests/test_reserve.py`` run on the port: detection
semantics, delivery verdicts, settlement, and the replay against its
per-event oracle.  Parity cases feed the reference's pinned batch
(its frequency synthesis, its hourly mu and ambient) through both
packages' replays and oracles: event counts and trigger seconds exact,
verdict floats at 1e-3.  The card has no JAX: the reference is imported
inside the CPU tests only.
"""
import numpy as np
import pytest
import torch

from test_torch_common import CPU, assert_close, n
import repro_torch.core.plant as plant_lib
import repro_torch.core.reserve as reserve
from repro_torch.grid import markets

FFR = markets.PRODUCT_ORDER.index("FFR")
FCRD = markets.PRODUCT_ORDER.index("FCR-D")
FFR_TRIG = markets.FR_PRODUCTS["FFR"].trigger_hz          # 49.7
FFR_DUR = int(markets.FR_PRODUCTS["FFR"].min_duration_s)  # 30 s
_BOOL_FIELDS = ("t_event_s", "budget_ok", "sustain_ok", "delivered_ok",
                "compliant", "valid")
_FLOAT_FIELDS = ("t_full_ms", "sustain_s", "delivered_mw", "delivered_frac")


def _run(freq, hours=1, mu=0.9, ta=10.0, valid_s=None, product_idx=FFR,
         rho=0.2, mw=10.0, pd=1.2, aware=True):
    freq = np.asarray(freq, np.float32)
    out = reserve.reserve_replay(
        freq, np.full((hours,), mu, np.float32),
        np.full((hours,), ta, np.float32),
        freq.shape[0] if valid_s is None else valid_s,
        product_idx, rho, mw, pd, pue_aware=aware, device=CPU)
    return dict(events=reserve.ReserveEvents(*(n(x) for x in out["events"])),
                **{k: n(v) for k, v in out.items() if k != "events"})


def _flat(T, dips=()):
    f = np.full(T, 50.0, np.float32)
    for (t0, t1, hz) in dips:
        f[t0:t1] = hz
    return f


def _events(**kw):
    return reserve.ReserveEvents(**{k: torch.as_tensor(v)
                                    for k, v in kw.items()})


def _settle(ev, *args):
    return {k: float(v) for k, v in reserve.settle_reserve(ev, *args).items()}


# ---------------------------------------------------------------------------
# detection semantics
# ---------------------------------------------------------------------------


def test_no_event_in_horizon():
    out = _run(_flat(3600))
    assert out["n_events"] == 0 and out["active_s"] == 0
    assert not out["events"].valid.any()
    ev = reserve.ReserveEvents(*(torch.as_tensor(x) for x in out["events"]))
    s = _settle(ev, FFR, 0.2, 10.0, 1.2, 1)
    p = markets.FR_PRODUCTS["FFR"]
    assert s["penalty_eur"] == 0.0
    assert s["capacity_eur"] == pytest.approx(
        0.2 * 10.0 * 1.2 * 1 * p.capacity_price_eur_mw_h, rel=1e-6)
    assert s["net_eur"] == pytest.approx(s["capacity_eur"])


def test_exact_threshold_does_not_trigger():
    """Activation requires frequency strictly below the trigger."""
    f = _flat(3600, [(100, 140, FFR_TRIG)])
    assert _run(f)["n_events"] == 0
    f = _flat(3600, [(100, 140, FFR_TRIG - 1e-3)])
    out = _run(f)
    assert out["n_events"] == 1
    assert out["events"].t_event_s[0] == 100


def test_event_truncated_at_horizon_edge():
    T = 3600
    out = _run(_flat(T, [(T - 10, T, 49.5)]))
    ev = out["events"]
    assert out["n_events"] == 1
    assert ev.sustain_s[0] == pytest.approx(10.0)
    assert not ev.sustain_ok[0] and not ev.compliant[0]
    assert ev.budget_ok[0]
    assert out["active_s"] == 10      # shed gated to the valid horizon


def test_ragged_horizon_gates_detection():
    f = _flat(7200, [(4000, 4100, 49.5)])
    assert _run(f, hours=2, valid_s=3600)["n_events"] == 0
    assert _run(f, hours=2, valid_s=7200)["n_events"] == 1


def test_overlapping_dips_merge_into_held_window():
    f = _flat(3600, [(100, 103, 49.5), (110, 113, 49.5), (160, 163, 49.5)])
    out = _run(f)
    assert out["n_events"] == 2
    np.testing.assert_array_equal(out["events"].t_event_s[:2], [100, 160])
    assert out["active_s"] == 2 * FFR_DUR


def test_long_event_holds_until_recovery():
    out = _run(_flat(3600, [(100, 200, 49.5)]))
    assert out["n_events"] == 1
    assert out["active_s"] == 101


# ---------------------------------------------------------------------------
# delivery verdicts
# ---------------------------------------------------------------------------


def test_delivery_time_matches_governor_model():
    out = _run(_flat(3600, [(100, 103, 49.5)]), mu=0.9, rho=0.2,
               aware=False)
    ev = out["events"]
    t_full = plant_lib.ACTUATE_DELAY_MS + float(
        np.log(0.9 / 0.7)) / plant_lib.GOV_SLEW
    assert ev.t_full_ms[0] == pytest.approx(t_full, rel=1e-4)
    assert 50.0 < ev.t_full_ms[0] < 200.0
    assert ev.budget_ok[0]


def test_blind_underdelivers_at_meter():
    f = _flat(3600, [(100, 103, 49.5)])
    aware = _run(f, mu=0.5, ta=0.0, rho=0.2, aware=True)["events"]
    blind = _run(f, mu=0.5, ta=0.0, rho=0.2, aware=False)["events"]
    assert blind.delivered_frac[0] < aware.delivered_frac[0]
    assert blind.delivered_frac[0] < 1.0 - reserve.DELIVERY_TOL
    assert not blind.delivered_ok[0]
    assert aware.delivered_frac[0] == pytest.approx(1.0, abs=0.01)
    assert aware.delivered_ok[0] and aware.compliant[0]


def test_low_mu_hour_cannot_deliver_full_band():
    ev = _run(_flat(3600, [(100, 103, 49.5)]), mu=0.3, rho=0.2)["events"]
    assert ev.delivered_frac[0] < 0.8
    assert not ev.delivered_ok[0] and not ev.compliant[0]


def test_zero_band_is_trivially_delivered():
    out = _run(_flat(3600, [(100, 103, 49.5)]), rho=0.0)
    ev = out["events"]
    assert out["n_events"] == 1
    assert ev.delivered_frac[0] == pytest.approx(1.0)
    assert ev.compliant[0]
    assert out["shed_it_mwh"] == pytest.approx(0.0)


# ---------------------------------------------------------------------------
# settlement
# ---------------------------------------------------------------------------


def test_settlement_penalty_arithmetic():
    ev = _events(
        t_event_s=np.asarray([100, 2000], np.int32),
        t_full_ms=np.asarray([90.0, 90.0], np.float32),
        sustain_s=np.asarray([30.0, 10.0], np.float32),
        delivered_mw=np.asarray([2.4, 1.2], np.float32),
        delivered_frac=np.asarray([1.0, 0.5], np.float32),
        budget_ok=np.asarray([True, True]),
        sustain_ok=np.asarray([True, False]),
        delivered_ok=np.asarray([True, False]),
        compliant=np.asarray([True, False]),
        valid=np.asarray([True, True]))
    s = _settle(ev, FFR, 0.2, 10.0, 1.2, 24)
    price = markets.FR_PRODUCTS["FFR"].capacity_price_eur_mw_h
    committed = 0.2 * 10.0 * 1.2
    assert s["committed_mw"] == pytest.approx(committed, rel=1e-6)
    assert s["capacity_eur"] == pytest.approx(committed * 24 * price,
                                              rel=1e-6)
    at_risk = price * committed * reserve.PENALTY_WINDOW_H
    assert s["penalty_eur"] == pytest.approx(1.5 * at_risk, rel=1e-5)
    assert s["n_events"] == 2 and s["n_compliant"] == 1


def test_settlement_ignores_invalid_slots():
    z = np.zeros((reserve.E_MAX,), np.float32)
    no = np.zeros((reserve.E_MAX,), bool)
    ev = _events(t_event_s=np.full((reserve.E_MAX,), -1, np.int32),
                 t_full_ms=z, sustain_s=z, delivered_mw=z,
                 delivered_frac=z, budget_ok=no, sustain_ok=no,
                 delivered_ok=no, compliant=no, valid=no)
    s = _settle(ev, FCRD, 0.3, 50.0, 1.2, 24)
    assert s["penalty_eur"] == 0.0


# ---------------------------------------------------------------------------
# the replay against its per-event oracle, and against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pinned():
    """The reference's pinned batch: both products, ragged horizons,
    mixed rho (tests/test_reserve.py::_pinned_batch), as numpy."""
    import repro.core  # noqa: F401  (the reference's grid needs core first)
    from repro.grid import frequency
    nb = 6
    T = 4 * 3600
    seeds = np.arange(10, 10 + nb)
    pidx = np.asarray([FFR, FFR, FFR, FCRD, FCRD, FFR], np.int32)
    freq, _ = frequency.synthesize_frequency_batch(
        seeds, pidx, n_seconds=T, events_per_day=24.0)
    rng = np.random.default_rng(0)
    mu_h = rng.uniform(0.3, 0.9, (nb, 4)).astype(np.float32)
    ta_h = rng.uniform(-5.0, 28.0, (nb, 4)).astype(np.float32)
    valid_s = np.asarray([T, T, 2 * 3600, T, 3 * 3600, T], np.int32)
    rho = np.asarray([0.2, 0.0, 0.3, 0.1, 0.2, 0.25], np.float32)
    mw = np.asarray([10.0, 10.0, 50.0, 1.0, 10.0, 10.0], np.float32)
    pd = np.asarray([1.2, 1.2, 1.1, 1.3, 1.2, 1.2], np.float32)
    return [np.asarray(freq), mu_h, ta_h, valid_s, pidx, rho, mw, pd]


def _check_lane(out, i, ref, rtol=1e-3):
    for field in _BOOL_FIELDS:
        np.testing.assert_array_equal(
            n(getattr(out["events"], field))[i],
            np.asarray(getattr(ref["events"], field)),
            err_msg=f"scenario {i} field {field}")
    assert int(out["n_events"][i]) == int(ref["n_events"])
    assert int(out["active_s"][i]) == int(ref["active_s"])
    for field in _FLOAT_FIELDS:
        assert_close(n(getattr(out["events"], field))[i],
                     np.asarray(getattr(ref["events"], field)), rtol,
                     atol=1e-6, msg=f"scenario {i} field {field}")
    assert_close(float(out["shed_it_mwh"][i]), float(ref["shed_it_mwh"]),
                 1e-4, atol=1e-6)


@pytest.mark.parametrize("aware", [True, False])
def test_scan_matches_reference(pinned, aware):
    """The replay against the port's per-event oracle."""
    out = reserve.reserve_replay_batch(*pinned, pue_aware=aware, device=CPU)
    total = 0
    for i in range(pinned[0].shape[0]):
        ref = reserve.reserve_replay_reference(
            *[a[i] for a in pinned], pue_aware=aware)
        total += ref["n_events"]
        _check_lane(out, i, ref)
    assert total > 0


def test_batch_matches_single_scenario_calls(pinned):
    batched = reserve.reserve_replay_batch(*pinned, device=CPU)
    for i in (0, 3, 5):
        single = reserve.reserve_replay(*[a[i] for a in pinned], device=CPU)
        for field in reserve.ReserveEvents._fields:
            a = n(getattr(batched["events"], field))[i]
            b = n(getattr(single["events"], field))
            if a.dtype == np.float32:
                np.testing.assert_allclose(a, b, atol=1e-4, err_msg=field)
            else:
                np.testing.assert_array_equal(a, b, err_msg=field)
        for k in ("n_events", "active_s", "shed_it_mwh"):
            assert float(batched[k][i]) == pytest.approx(float(single[k]))


@pytest.mark.parametrize("aware", [True, False])
def test_replay_matches_the_references_scan(pinned, aware):
    """The same inputs through the reference's ``reserve_replay_batch``:
    event counts and trigger seconds exact, floats 1e-3."""
    import jax
    import repro.core.reserve as r_reserve
    want = jax.tree.map(np.asarray, r_reserve.reserve_replay_batch(
        *pinned, pue_aware=aware))
    got = reserve.reserve_replay_batch(*pinned, pue_aware=aware, device=CPU)
    for i in range(pinned[0].shape[0]):
        _check_lane(got, i, {"events": reserve.ReserveEvents(
            *(x[i] for x in want["events"])),
            **{k: want[k][i] for k in ("n_events", "active_s",
                                       "shed_it_mwh")}})


def test_oracle_matches_the_references_oracle(pinned):
    import repro.core.reserve as r_reserve
    for i in range(pinned[0].shape[0]):
        args = [a[i] for a in pinned]
        got = reserve.reserve_replay_reference(*args)
        want = r_reserve.reserve_replay_reference(*args)
        assert got["n_events"] == want["n_events"]
        assert got["active_s"] == want["active_s"]
        for field in _BOOL_FIELDS:
            np.testing.assert_array_equal(getattr(got["events"], field),
                                          getattr(want["events"], field))
        for field in _FLOAT_FIELDS:
            assert_close(getattr(got["events"], field),
                         getattr(want["events"], field), 1e-3, atol=1e-6)


def test_replay_default_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs there")
    f = _flat(3600)
    with pytest.raises(RuntimeError, match="cuda"):
        reserve.reserve_replay(f, [0.9], [10.0], 3600, FFR, 0.2, 10.0, 1.2)
    with pytest.raises(RuntimeError, match="cuda"):
        reserve.reserve_replay_batch(f[None], [[0.9]], [[10.0]], [3600],
                                     [FFR], [0.2], [10.0], [1.2])


@pytest.mark.cuda
def test_replay_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    from repro_torch.grid import frequency
    nb, T = 8, 2 * 3600
    pidx = np.asarray([FFR, FCRD] * 4)
    freq, _ = frequency.synthesize_frequency_batch(
        np.arange(nb), pidx, n_seconds=T, events_per_day=48.0, device=CPU)
    rng = np.random.default_rng(1)
    args = [freq, rng.uniform(0.3, 0.9, (nb, 2)).astype(np.float32),
            rng.uniform(-5, 28, (nb, 2)).astype(np.float32),
            np.full(nb, T), pidx, np.full(nb, 0.2, np.float32),
            np.full(nb, 10.0, np.float32), np.full(nb, 1.2, np.float32)]
    a = reserve.reserve_replay_batch(*args, device=CPU)
    b = reserve.reserve_replay_batch(*args, device="cuda")
    assert b["n_events"].is_cuda and int(a["n_events"].sum()) > 0
    for i in range(nb):
        _check_lane(b, i, {"events": reserve.ReserveEvents(
            *(x[i] for x in a["events"])),
            **{k: a[k][i] for k in ("n_events", "active_s",
                                    "shed_it_mwh")}})
