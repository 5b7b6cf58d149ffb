"""The engine's mesh paths: ``engine_rollout(mesh=...)`` split over the
lanes of a ``ScenarioMesh`` and ``engine_sweep(mesh=...)`` over lanes and
over two gloo processes (``process_slice``, raw aggregates merged through
``summary_merge``), against the reference's unsharded rollout and sweep.

The seconds tier is held against the reference on its own inputs
(``ref_inputs``) with the operating points pinned through ``ops=``, at
the reference's tolerances (``tests/test_engine_sharded.py``): rtol 1e-3
on energy, money and mu/rho, 2e-2 on the RLS metrics, exact on event
counts and trigger seconds.  A sweep draws the port's own inputs, so its
seconds tier is held against the port's monolithic rollout, which
``test_torch_engine.py`` holds against the reference; its hourly tiers
are held against the reference's sweep directly (1e-4 / 1e-5).  N = 6
scenarios on 4 lanes pads the batch to 8.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_common import (CPU, assert_close, n, port_config, port_specs,
                               ref_inputs, run_ranks)
from test_torch_engine import REF_CFG, _check_summary, _specs
import repro.core.engine as r_eng
from repro.grid.scenarios import build_scenario_batch as r_build
import repro_torch.core.engine as eng
from repro_torch.grid.scenarios import build_scenario_batch
from repro_torch.launch.mesh import ScenarioMesh

CFG = port_config(REF_CFG)
HOURLY = dataclasses.replace(REF_CFG, with_seconds=False)
TEL = dataclasses.replace(REF_CFG, telemetry=True)
LANES4 = ScenarioMesh((CPU,) * 4)
LANES2 = ScenarioMesh((CPU, CPU))
RLS_KEYS = ("ar4_mae_norm", "tracking_err_mean")
TEL_RLS = ("rls_rms", "track_rms", "track_hist")


@pytest.fixture(scope="module")
def world():
    """The reference's unsharded rollout on its own draws; the port's
    monolithic rollout (its own draws, telemetry on) and its finalized
    summary, the single-process stand-in of every sweep below."""
    specs = _specs()
    rb = r_build(specs)
    pb = build_scenario_batch(port_specs(specs), device=CPU)
    freq, loads, noise = ref_inputs(REF_CFG, rb)
    ref = r_eng.engine_rollout(REF_CFG, rb, freq=freq, loads=loads)
    ops = (np.asarray(ref["mu_h"]), np.asarray(ref["rho_h"]))
    mono = eng.engine_rollout(port_config(TEL), pb, device=CPU)
    return dict(specs=specs, rb=rb, pb=pb, ref=ref,
                kw=dict(freq=freq, loads=loads, noise=noise, ops=ops),
                mono=eng.sweep_finalize(eng.chunk_summary(
                    port_config(TEL), mono, pb)))


def test_pad_scenario_axis_replicates_last_row(world):
    pb = world["pb"]
    padded, n_ = eng.pad_scenario_axis(pb, 4)
    assert n_ == 6 and padded.n == 8
    assert torch.equal(padded.ci[6:], pb.ci[-1:].repeat(2, 1))
    assert torch.equal(padded.seed[6:], pb.seed[-1:].repeat(2))
    same, n2 = eng.pad_scenario_axis(pb, 3)
    assert n2 == 6 and same is pb
    out = eng.unpad_scenario_axis(padded, n_)
    assert torch.equal(out.ci, pb.ci)
    (b, none), n3 = eng.pad_scenario_axis((pb, None), 4)
    assert n3 == 6 and none is None and b.n == 8


def test_mesh_requires_scenario_axis(world):
    mesh = ScenarioMesh((CPU,), axis_names=("data",))
    with pytest.raises(ValueError, match="scenario"):
        eng.engine_rollout(CFG, world["pb"], mesh=mesh, device=CPU)
    with pytest.raises(ValueError, match="scenario"):
        eng.engine_sweep(CFG, port_specs(world["specs"]), chunk_size=4,
                         mesh=mesh, device=CPU)


def test_sharded_seconds_matches_unsharded_reference(world):
    """Four lanes, N = 6 padded to 8, on the reference's inputs and
    operating points: the reference's unsharded numbers, and no leaf with
    a lane of padding left in it."""
    out = eng.engine_rollout(CFG, world["pb"], mesh=LANES4, device=CPU,
                             **world["kw"])
    ref = world["ref"]
    assert set(out) == set(ref)
    _check_summary(out, ref)
    for k in ("mu_h", "rho_h", "mean_mu", "mean_rho"):
        assert_close(n(out[k]), ref[k], rtol=1e-3, msg=k)
    for leaf in torch.utils._pytree.tree_leaves(out):
        assert leaf.shape[0] == 6


@pytest.mark.parametrize("mesh", [LANES2, LANES4], ids=["2", "4"])
def test_sharded_hourly_matches_unsharded_reference(world, mesh):
    ref = r_eng.engine_rollout(HOURLY, world["rb"])
    out = eng.engine_rollout(port_config(HOURLY), world["pb"], mesh=mesh,
                             device=CPU)
    assert "events" not in out and set(out) == set(ref)
    for k in ref:
        assert_close(n(out[k]), ref[k], rtol=1e-4, atol=1e-5, msg=k)
    ops = (n(out["mu_h"]), n(out["rho_h"]))
    pinned = eng.engine_rollout(port_config(HOURLY), world["pb"], ops=ops,
                                mesh=mesh, device=CPU)
    for k in ref:
        assert torch.equal(pinned[k], out[k]), k


def _check_finalized(got, want, rls=2e-2, energy=1e-3):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "telemetry":
            for tk, tv in v.items():
                rt = rls if tk in TEL_RLS else energy
                np.testing.assert_allclose(got[k][tk], tv, rtol=rt,
                                           atol=1e-2, err_msg=tk)
        elif k in ("n_scenarios", "n_events", "n_compliant", "active_s"):
            assert got[k] == v, k
        else:
            rt = rls if k in RLS_KEYS else energy
            np.testing.assert_allclose(got[k], v, rtol=rt, atol=1e-4,
                                       err_msg=k)


def test_sharded_sweep_matches_single_device(world):
    """Two lanes, chunks of 3, each padded to 4 lanes with its lane
    mask: the monolithic numbers; the padding stays out of the sums."""
    got = eng.engine_sweep(port_config(TEL), port_specs(world["specs"]),
                           chunk_size=3, mesh=LANES2, device=CPU)
    assert got["n_scenarios"] == 6.0 and got["seconds"] == 6 * 3600.0
    _check_finalized(got, world["mono"])


def test_sweep_raw_aggregate_round_trips(world):
    """finalize=False returns CPU tensors; any split of them merged
    through summary_merge finalizes to the sweep's numbers, and the
    hourly tiers equal the reference's sweep."""
    cfg = port_config(HOURLY)
    specs = port_specs(world["specs"])
    whole = eng.engine_sweep(cfg, specs, chunk_size=4, mesh=LANES4,
                             device=CPU)
    raw = eng.engine_sweep(cfg, specs, chunk_size=4, mesh=LANES4,
                           finalize=False, device=CPU)
    assert all(v.device.type == "cpu" for v in raw.values())
    assert float(raw["n_scenarios"]) == 6.0
    ident = eng.summary_merge(eng.summary_init(cfg, device=CPU), raw)
    assert eng.sweep_finalize(ident) == whole
    ref = r_eng.engine_sweep(HOURLY, world["specs"], chunk_size=4)
    for k, v in ref.items():
        assert whole[k] == pytest.approx(v, rel=1e-4, abs=1e-5), k


def test_pad_chunk_lane_mask(world):
    pb = world["pb"]
    padded, lane = eng._pad_chunk(pb, 8)
    assert padded.n == 8 and lane.tolist() == [1.0] * 6 + [0.0] * 2
    same, lane = eng._pad_chunk(pb, 6)
    assert same is pb and lane.tolist() == [1.0] * 6
    with pytest.raises(ValueError, match="exceeds lane count"):
        eng._pad_chunk(pb, 4)


def test_two_process_sweep_merges_to_the_single_process(world, tmp_path):
    """Two gloo ranks under the REPRO_* contract, each sweeping only its
    process_slice (chunks of 2: a rank's last chunk of 1 is padded):
    each rank's aggregate counts its slice, the slices cover the specs,
    and the merged aggregates equal the single-process numbers (the
    seconds tier with telemetry, the hourly tiers against the
    reference's sweep)."""
    specs = port_specs(world["specs"])
    job = tmp_path / "job.json"
    job.write_text(json.dumps(dict(
        specs=[dataclasses.asdict(s) for s in specs], chunk=2,
        cfgs={"seconds": dataclasses.asdict(port_config(TEL)),
              "hourly": dataclasses.asdict(port_config(HOURLY))})))
    run_ranks(["tests/test_torch_common.py", "sweep", str(job),
               str(tmp_path)], timeout=240)
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    assert [tuple(r["slice"]) for r in recs] == [(0, 3), (3, 6)]
    merged = {}
    for name in ("seconds", "hourly"):
        aggs = [{k: torch.tensor(v, dtype=torch.float32)
                 for k, v in r[name].items()} for r in recs]
        for r, a in zip(recs, aggs):
            lo, hi = r["slice"]
            assert float(a["n_scenarios"]) == hi - lo
        merged[name] = eng.sweep_finalize(eng.summary_merge(*aggs))
    assert all(r["backend"] == "gloo" for r in recs)
    _check_finalized(merged["seconds"], world["mono"])
    ref = r_eng.engine_sweep(HOURLY, world["specs"], chunk_size=4)
    for k, v in ref.items():
        assert merged["hourly"][k] == pytest.approx(v, rel=1e-4,
                                                    abs=1e-5), k
