"""The port's online service against ``repro.service``.

Case for case ``tests/test_service.py``, on the port's SiteStore and
server (the CPU runs the tick eagerly; a card replays it as a CUDA graph):

  * churn independence -- admitting/evicting neighbours leaves surviving
    sites' ``EngineState`` BIT-identical to an uninterrupted run,
  * no re-capture -- admit/evict/storms reuse the one prepared tick
    (``step_cache_size() == 1``),
  * in place -- the batched step writes back into the same storage
    (``data_ptr`` unchanged), the port's form of the reference's donation,
  * graceful degradation -- a stale site is quarantined alone (state
    frozen, fleet keeps ticking) and rejoins on a fresh tick; N
    simultaneous FFR triggers each get an under-budget island response
    with no cross-site cap leakage.

Plus per-lane parity with the reference's ``SiteStore`` on the reference's
own demand and plant draws (passed in through ``step(fast=, noise=)``),
and, on a card (marked ``cuda``), the captured tick against the eager one.
"""
from __future__ import annotations

import asyncio
import dataclasses
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from test_torch_common import CPU, ROOT, assert_close, n, port_config
from repro_torch.core.engine import EngineConfig
from repro_torch.core.island import encode_trigger
from repro_torch.grid.scenarios import ScenarioBatch
from repro_torch.obs import trace
from repro_torch.service import (LoadGen, LoadGenConfig, ServiceConfig,
                                 ServiceServer, SiteStore, demo_batch,
                                 encode_tick)

CFG = EngineConfig()


def _batch(n_sites, horizon_h=1):
    return demo_batch(n_sites, horizon_h, device=CPU)


def _rows(batch: ScenarioBatch, sl: slice) -> ScenarioBatch:
    return ScenarioBatch(**{f.name: getattr(batch, f.name)[sl]
                            for f in dataclasses.fields(batch)})


def _store(capacity, n_sites, horizon_h=1, seed=0, device=CPU):
    st = SiteStore(CFG, capacity, horizon_h, seed=seed, device=device)
    slots = st.admit_batch(_batch(n_sites, horizon_h))
    return st, slots


def _assert_lanes_equal(a, b, lanes, msg):
    for la, lb in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        np.testing.assert_array_equal(la[lanes], lb[lanes], err_msg=msg)


def _server(**kw):
    return ServiceServer(ServiceConfig(device=CPU, **kw))


class TestChurnBitIdentity:
    def test_admit_evict_mid_run_leaves_survivors_bit_identical(self):
        below = np.zeros(4, bool)
        below_trig = np.array([True, True, False, False])

        # uninterrupted: 2 sites, 6 ticks (trigger burst at tick 2)
        ref, _ = _store(4, 2)
        for k in range(6):
            ref.step(below_trig if k == 2 else below)
        ref_snap = ref.snapshot()

        # churned: same 2 sites, but a third admitted at tick 2 and
        # evicted at tick 4, same per-lane inputs for the survivors
        churn, _ = _store(4, 2)
        extra = _batch(3)  # 3rd spec lands in slot 2
        for k in range(6):
            if k == 2:
                (s3,) = churn.admit_batch(_rows(extra, slice(2, 3)))
                assert s3 == 2
            if k == 4:
                churn.evict(2)
            churn.step(below_trig if k == 2 else below)
        _assert_lanes_equal(
            ref_snap, churn.snapshot(), slice(0, 2),
            "surviving lanes diverged across admit/evict churn")

    def test_eviction_frees_and_readmission_restarts(self):
        st, slots = _store(4, 2)
        st.step()
        st.evict(slots[0])
        assert st.free_slots == 3
        (s,) = st.admit_batch(_batch(1))
        assert s == slots[0]
        assert int(n(st.state.t)[s]) == 0  # fresh site clock
        with pytest.raises(ValueError, match="already free"):
            st.evict(3)


class TestHotPath:
    def test_no_retrace_across_churn_and_trigger_patterns(self):
        st, slots = _store(4, 2)
        st.clear_step_cache()
        st.step()
        st.step(np.array([True, False, True, False]))
        st.admit_batch(_batch(1))
        st.step(np.ones(4, bool))
        st.evict(slots[1])
        st.step(enabled=np.array([True, False, True, True]))
        assert st.step_cache_size() == 1

    def test_step_writes_state_in_place(self):
        st, _ = _store(4, 2)
        st.step()  # prepare
        ptrs = [x.data_ptr() for x in pytree.tree_leaves(st.state)]
        st.step()
        assert [x.data_ptr() for x in pytree.tree_leaves(st.state)] == ptrs

    def test_admit_validates_capacity_and_horizon(self):
        st, _ = _store(2, 2)
        with pytest.raises(ValueError, match="free slots"):
            st.admit_batch(_batch(1))
        st2 = SiteStore(CFG, 4, 2, device=CPU)
        with pytest.raises(ValueError, match="horizon"):
            st2.admit_batch(_batch(1))


class TestTriggerStorm:
    def test_simultaneous_triggers_under_budget_no_leakage(self):
        server = _server(capacity=8, horizon_h=1)
        slots = server.admit_sites(_batch(8))
        server.step_once()  # prepare tick
        n_spans0 = len(trace.get_tracer().spans("serve.ffr_response"))

        hit = slots[:4]
        for s in hit:
            server.ingest_trigger(s, 49.5)
        spans = trace.get_tracer().spans("serve.ffr_response")[n_spans0:]
        assert len(spans) == len(hit)
        for rec in spans:
            assert rec["wall_s"] * 1e3 < 700.0  # FFR activation budget
        assert sorted(r["attrs"]["site"] for r in spans) == sorted(hit)

        # island register file: triggered rows shed, neighbours untouched
        np.testing.assert_array_equal(server.caps[hit],
                                      server.shed_caps[hit])
        rest = slots[4:]
        np.testing.assert_array_equal(server.caps[rest],
                                      server.armed_caps[rest])

        out = server.step_once()
        assert out["n_triggered"] == len(hit)
        assert out["n_shedding"] == len(hit)
        assert out["n_resolved"] == len(hit)

    def test_shed_release_restores_armed_caps(self):
        server = _server(capacity=2, horizon_h=1)
        (s0, s1) = server.admit_sites(_batch(2))
        server.step_once()
        server.ingest_trigger(s0, 49.5)
        min_dur = int(server.store.site_tables([s0])["min_dur_s"][0])
        st = server.step_once()
        assert st["n_shedding"] == 1
        for _ in range(min_dur + 2):  # ride out the minimum duration
            st = server.step_once()
        assert st["n_shedding"] == 0
        np.testing.assert_array_equal(server.caps[s0],
                                      server.armed_caps[s0])


class TestGracefulDegradation:
    def test_stale_site_quarantined_alone_then_recovers(self):
        server = _server(capacity=4, horizon_h=1, late_after_s=0.05)
        slots = server.admit_sites(_batch(3))
        server.feed_frequency(np.full(3, 50.0, np.float32), slots)
        server.step_once()

        time.sleep(0.06)  # everyone's feed is now stale...
        server.feed_frequency(np.full(2, 50.0, np.float32), slots[:2])
        t_before = n(server.store.state.t).copy()
        out = server.step_once()  # ...except the two just refreshed
        assert out["n_quarantined"] == 1
        assert out["n_run"] == 2  # no global stall
        t_after = n(server.store.state.t)
        assert t_after[slots[2]] == t_before[slots[2]]  # lane frozen
        assert all(t_after[s] == t_before[s] + 1 for s in slots[:2])

        server.feed_frequency(np.full(3, 50.0, np.float32), slots)
        out = server.step_once()  # fresh tick -> rejoin
        assert out["n_quarantined"] == 0
        assert out["n_run"] == 3
        assert trace.metrics.counters.get("service.recovered", 0) >= 1

    def test_quarantined_trigger_resolves_after_recovery(self):
        server = _server(capacity=2, horizon_h=1, late_after_s=0.05)
        (s0, s1) = server.admit_sites(_batch(2))
        server.feed_frequency(np.full(2, 50.0, np.float32), [s0, s1])
        server.step_once()
        time.sleep(0.06)
        server.ingest_tick(s1, freq_hz=50.0)
        server.ingest_trigger(s0, 49.5)  # island write happens regardless
        np.testing.assert_array_equal(server.caps[s0], server.shed_caps[s0])
        out = server.step_once()
        assert out["n_quarantined"] == 1
        assert out["n_resolved"] == 0  # physics deferred, not dropped
        server.ingest_tick(s0, freq_hz=50.0)
        out = server.step_once()
        assert out["n_resolved"] == 1


class TestIngestion:
    def test_datagram_wire_formats(self):
        server = _server(capacity=4, horizon_h=1)
        slots = server.admit_sites(_batch(2))
        server.ingest_datagram(encode_tick(slots[0], 49.95, 87.5, 120.0))
        assert server.freq_hz[slots[0]] == np.float32(49.95)
        assert server.price[slots[0]] == np.float32(87.5)
        assert server.ci[slots[0]] == np.float32(120.0)
        server.ingest_datagram(encode_trigger(slots[1], 49.4))
        np.testing.assert_array_equal(server.caps[slots[1]],
                                      server.shed_caps[slots[1]])
        # junk and out-of-range slots are ignored, not fatal
        server.ingest_datagram(b"nonsense")
        server.ingest_datagram(encode_trigger(99, 49.4))

    def test_udp_ingestion_through_serve_loop(self):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        server = _server(capacity=4, horizon_h=1, port=port)
        slots = server.admit_sites(_batch(2))
        server.step_once()  # prepare outside the served ticks

        async def drive():
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                def on_tick(srv, k):
                    if k == 0:
                        sock.sendto(encode_trigger(slots[0], 49.5),
                                    ("127.0.0.1", port))
                        sock.sendto(encode_tick(slots[1], 50.0, 42.0, 0.0),
                                    ("127.0.0.1", port))
                    return asyncio.sleep(0.05)  # let the datagrams land
                return await server.serve(n_ticks=3, on_tick=on_tick)
            finally:
                sock.close()
                server.close()

        asyncio.run(drive())
        np.testing.assert_array_equal(server.caps[slots[0]],
                                      server.shed_caps[slots[0]])
        assert server.price[slots[1]] == np.float32(42.0)


class TestLoadGen:
    def test_drive_reports_latency_and_survives_stale_sites(self):
        server = _server(capacity=8, horizon_h=1, late_after_s=0.02)
        slots = server.admit_sites(_batch(8))
        gen = LoadGen(LoadGenConfig(n_ticks=30, warmup_ticks=1,
                                    trigger_rate_per_site_day=20000.0,
                                    storm_every=10, storm_sites=4, seed=1))
        stats = asyncio.run(
            gen.drive(server, slots, stale_slots=slots[-1:]))
        assert stats["n_triggers"] > 0
        assert stats["n_resolved"] > 0
        assert stats["n_storms"] == 2
        assert 0.0 < stats["p50_trigger_to_target_ms"] <= \
            stats["p99_trigger_to_target_ms"]
        assert stats["ticks_per_s"] > 0

    def test_metrics_summary_has_p99(self):
        trace.metrics.observe("test.p99_series", 1.0)
        s = trace.metrics.summary("test.p99_series")
        assert "p99" in s and s["p99"] == 1.0


# ---------------------------------------------------------------------------
# Against the reference's SiteStore, lane by lane
# ---------------------------------------------------------------------------


def _ref_draws(jax, load_keys, t, engine_keys):
    """The demand white noise and plant noise the reference tick is about
    to draw for every lane: ``fold_in(fast_key, t)`` and the first half
    of the next split of the engine key."""
    H = CFG.n_hosts
    fast = jax.vmap(lambda k, s: jax.random.normal(
        jax.random.fold_in(k, s), (1, H))[0])(load_keys, t)
    noise = jax.vmap(lambda k: jax.random.normal(
        jax.random.split(k)[1], (H, CFG.chips_per_host)))(engine_keys)
    return fast, noise


def test_lanes_match_reference_site_store():
    import jax
    import repro.core.engine as r_eng
    import repro.service as r_service
    from repro.service import demo_batch as r_demo
    r_cfg = r_eng.EngineConfig()
    assert port_config(r_cfg) == CFG
    ref = r_service.SiteStore(r_cfg, 4, 1)
    ref.admit_batch(r_demo(3, 1))
    st, _ = _store(4, 3)
    np.testing.assert_array_equal(n(st.state.params.mu_h)[:3],
                                  np.asarray(ref.state.params.mu_h)[:3])
    assert_close(n(st.state.params.rho_it_h)[:3],
                 np.asarray(ref.state.params.rho_it_h)[:3], rtol=1e-6)
    # the reference's own slow-wave and jitter phases (draws as well)
    for name in ("phases", "jitter_ph"):
        getattr(st.state.load, name).copy_(torch.from_numpy(
            np.array(getattr(ref.state.load, name))))
    quiet = np.zeros(4, bool)
    burst = np.array([True, True, False, False])
    for k in range(30):
        below = burst if 5 <= k < 9 else quiet
        enabled = np.array([True, True, k not in (12, 13), True])
        s = ref.state
        fast, noise = _ref_draws(jax, s.load.fast_key, s.t, s.engine.key)
        want = ref.step(below, enabled)
        want = {f: np.asarray(getattr(want, f)) for f in want._fields}
        got = st.step(below, enabled, fast=np.asarray(fast),
                      noise=np.asarray(noise))
        got = {f: n(getattr(got, f)) for f in got._fields}
        for f in ("trig", "shed"):
            np.testing.assert_array_equal(got[f], want[f], f"{f} @ {k}")
        for f in ("it_mw", "load"):
            assert_close(got[f], want[f], rtol=1e-3, msg=f"{f} @ {k}")
        assert_close(got["tracking_err"], want["tracking_err"], rtol=2e-2,
                     atol=1e-6, msg=f"tracking_err @ {k}")
    assert n(st.out.shed).any() or any(
        np.asarray(ref.state.engine.in_event))
    np.testing.assert_array_equal(n(st.state.t), np.asarray(ref.state.t))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        SiteStore(CFG, 4, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        ServiceServer(ServiceConfig(capacity=4, horizon_h=1))
    with pytest.raises(RuntimeError, match="cuda"):
        demo_batch(2, 1)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.service.server", "--sites", "2",
         "--ticks", "2"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode != 0 and "cuda" in res.stderr


def test_cli_serves_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.service.server", "--sites", "4",
         "--ticks", "5", "--trigger-rate", "20000", "--device", "cpu",
         "--horizon-h", "1"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr
    assert "served 5 ticks x 4 sites on cpu" in res.stdout


# ---------------------------------------------------------------------------
# On the card: the captured tick
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _eager_tick(st: SiteStore, below, enabled):
    """The function the graph captured, run eagerly on the same buffers."""
    st._inputs[0].copy_(torch.from_numpy(below))
    st._inputs[1].copy_(torch.from_numpy(enabled))
    st._use_fast.fill_(False)
    st._use_noise.fill_(False)
    st._tick()


@pytest.mark.cuda
def test_captured_tick_equals_eager_tick(cuda):
    a, _ = _store(8, 6, device=cuda)
    b, _ = _store(8, 6, device=cuda)
    rng = np.random.default_rng(0)
    for k in range(10):
        below = rng.random(8) < 0.3
        enabled = rng.random(8) < 0.9
        got = a.step(below, enabled)
        _eager_tick(b, below, enabled)
        for x, y in zip(got, b.out):
            assert torch.equal(x, y), k
    assert a.step_cache_size() == 1
    _assert_lanes_equal(a.snapshot(), b.snapshot(), slice(None),
                        "captured and eager ticks diverged")


@pytest.mark.cuda
def test_step_cache_size_is_one_after_churn_on_the_card(cuda):
    st, slots = _store(8, 4, device=cuda)
    before = torch.cuda.memory_allocated()
    st.step()
    st.step(np.ones(8, bool))
    st.admit_batch(_batch(2))
    st.evict(slots[0])
    st.step(enabled=np.array([True, False] * 4))
    assert st.step_cache_size() == 1
    steady = torch.cuda.memory_allocated()
    for _ in range(5):
        st.step()
    assert torch.cuda.memory_allocated() == steady >= before
