"""Shared helpers of the port's parity tests, and the port's package-level
checks: import hygiene, copied constants, the CUDA default.

The helpers carry state between the two packages as numpy arrays: the
JAX reference's outputs and draws go through numpy into the port.  JAX
and the reference are imported inside the helpers that use them, so the
card's machine, which has no JAX, can import this module for the card
tests.
"""
import ast
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import repro_torch

# six xdist workers share eight cores
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
CPU = "cpu"


# ---------------------------------------------------------------------------
# jax -> numpy -> port
# ---------------------------------------------------------------------------

def np_tree(x):
    """A reference pytree (NamedTuple, dataclass, dict, array) as the
    same structure of numpy arrays; NamedTuples become dicts."""
    if hasattr(x, "_asdict"):
        return {k: np_tree(v) for k, v in x._asdict().items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: np_tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: np_tree(v) for k, v in x.items()}
    return np.asarray(x)


def t(x, dtype=torch.float32):
    """numpy / jax array -> CPU tensor (copied, writable)."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def n(x):
    """Port tensor (or tree of them) -> numpy."""
    if hasattr(x, "_asdict"):
        return {k: n(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: n(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def port_config(ref_cfg, **over):
    """The port's EngineConfig with the reference config's field values."""
    import repro_torch.core.engine as eng
    names = {f.name for f in dataclasses.fields(eng.EngineConfig)}
    kw = {k: getattr(ref_cfg, k) for k in names}
    kw.update(over)
    return eng.EngineConfig(**kw)


def port_specs(ref_specs):
    from repro_torch.grid.scenarios import ScenarioSpec
    return [ScenarioSpec(**dataclasses.asdict(s)) for s in ref_specs]


def ref_plant_noise(batch, n_hosts, chips_per_host):
    """(N, T, H, C) plant normals the reference tick draws: its per-tick
    ``split`` chain replayed from ``engine.scenario_keys``."""
    import jax
    import repro.core.engine as ref_eng
    T = int(batch.h_max) * 3600
    _, scan_keys = ref_eng.scenario_keys(batch)

    def one(key):
        def body(k, _):
            k, k1 = jax.random.split(k)
            return k, jax.random.normal(k1, (n_hosts, chips_per_host))
        return jax.lax.scan(body, key, None, length=T)[1]

    return np.asarray(jax.jit(jax.vmap(one))(scan_keys))


def ref_inputs(cfg, batch):
    """The reference's own draws for a batch: freq (N, T), loads (N, T, H)
    and plant noise (N, T, H, C), as numpy."""
    import repro.core.engine as ref_eng
    from repro.grid import frequency
    from repro.grid.scenarios import frequency_seeds
    T = int(batch.h_max) * 3600
    freq, _ = frequency.synthesize_frequency_batch(
        frequency_seeds(batch), batch.product_idx, n_seconds=T,
        events_per_day=cfg.events_per_day, max_events=cfg.max_freq_events)
    loads = ref_eng.base_loads(cfg, batch)
    noise = ref_plant_noise(batch, cfg.n_hosts, cfg.chips_per_host)
    return np.asarray(freq), np.asarray(loads), noise


def assert_close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# Ranks: worker processes under the REPRO_* environment, on gloo
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A localhost port that was free a moment ago (bind port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_procs(argvs, envs, timeout=180):
    """Run ``python *argv`` once per (argv, env), all at once, from the
    repo root with ``src`` and ``tests`` on the path; return each
    process's stdout.  A process that exits nonzero fails the test; all
    are killed once ``timeout`` seconds have passed."""
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    procs = []
    try:
        for argv, env in zip(argvs, envs):
            procs.append(subprocess.Popen(
                [sys.executable, *argv], cwd=ROOT, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                env=dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="2",
                         **env)))
        deadline = time.monotonic() + timeout
        outs = []
        for i, p in enumerate(procs):
            out, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            assert p.returncode == 0, f"process {i}: {err[-4000:]}"
            outs.append(out)
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def run_ranks(argv, n=2, timeout=180):
    """``python *argv`` as ``n`` ranks under the REPRO_* contract on a
    free localhost port (:func:`run_procs`)."""
    port = free_port()
    envs = [dict(REPRO_COORD_ADDR=f"127.0.0.1:{port}",
                 REPRO_NUM_PROCESSES=str(n), REPRO_PROCESS_ID=str(r))
            for r in range(n)]
    return run_procs([argv] * n, envs, timeout)


def flat_arrays(tree, prefix):
    """{"prefix/a/b": numpy} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(flat_arrays(v, key) if isinstance(v, dict)
                   else {key: n(v) if isinstance(v, torch.Tensor)
                         else np.asarray(v)})
    return out


def nested_arrays(flat, prefix):
    """The nested dict :func:`flat_arrays` flattened under ``prefix``."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = np.asarray(v)
    return out


# the compressed step's cut: reduced qwen2-1.5b (2 layers, d 64), float32
# compute, a global batch of 4 x 16 tokens, two steps past warm-up
COMPRESSED_ARCH = "qwen2-1.5b"
COMPRESSED_STEPS = (150, 151)


def port_compressed_run(inputs, *, device=CPU):
    """The port's compressed step on this rank's share of ``inputs``'
    batch (``tokens``, and ``params``/``mu``/``nu`` flattened, see
    :func:`flat_arrays`) for COMPRESSED_STEPS, on ``make_local_mesh``
    (the REPRO_* world, or a world of one).  Returns the losses, the
    norms of the all-reduced gradients, the rank's residual and the
    parameters after the steps, and each leaf's shared scale per step."""
    import torch.distributed as dist
    import repro_torch.train.step as st
    from repro_torch import convert
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_local_mesh
    cfg = get_arch(COMPRESSED_ARCH).reduced()
    tokens = np.asarray(inputs["tokens"])
    shape = ShapeConfig("compressed", tokens.shape[1], tokens.shape[0],
                        "train")
    mesh = make_local_mesh(device)
    b = st.build_step_bundle(cfg, shape, device=device, mesh=mesh,
                             compressed=True,
                             model_kw=dict(compute_dtype=torch.float32))
    lo, hi = st.batch_share(b.rules, shape.global_batch,
                            mesh.get_coordinate())
    params = convert.model_params(nested_arrays(inputs, "params"), device)
    opt = convert.adamw_state({"step": inputs["step"],
                               "mu": nested_arrays(inputs, "mu"),
                               "nu": nested_arrays(inputs, "nu")}, device)
    res = st.init_residual(b.model, b.rules)
    batch = {"tokens": torch.as_tensor(tokens[lo:hi], device=device)}
    scales, orig = [], st.requantize_sum

    def recording(q, s, group=None):
        sh = s.detach().clone()
        dist.all_reduce(sh, op=dist.ReduceOp.MAX, group=group)
        scales.append(float(sh))
        return orig(q, s, group)

    st.requantize_sum = recording
    try:
        metrics = []
        for step in COMPRESSED_STEPS:
            params, opt, res, m = b.step_fn(params, opt, res, batch, step)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
    finally:
        st.requantize_sum = orig
    loss, grad_norm = np.asarray(metrics).T
    return {"loss": loss, "grad_norm": grad_norm,
            "rows": np.asarray([lo, hi]),
            "scales": np.asarray(scales).reshape(len(COMPRESSED_STEPS), -1),
            **flat_arrays(params, "params"),
            **flat_arrays(tree_map(lambda r: r[0], res), "res")}


def ref_compressed_run(inputs):
    """The reference's compressed step (``build_step_bundle(...,
    compressed=True)``) on a (devices, 1) mesh over every JAX device, on
    the same inputs as :func:`port_compressed_run`; the residual keeps its
    leading device axis."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.optim import AdamWState
    from repro.train.step import build_step_bundle, init_residual
    cfg = get_arch(COMPRESSED_ARCH).reduced()
    tokens = np.asarray(inputs["tokens"])
    shape = ShapeConfig("compressed", tokens.shape[1], tokens.shape[0],
                        "train")
    mesh = jax.make_mesh((len(jax.devices()), 1), ("data", "model"))
    b = build_step_bundle(cfg, shape, mesh, compressed=True,
                          model_kw=dict(compute_dtype=jnp.float32))
    tree = lambda k: jax.tree.map(jnp.asarray, nested_arrays(inputs, k))
    params = tree("params")
    opt = AdamWState(step=jnp.int32(inputs["step"]), mu=tree("mu"),
                     nu=tree("nu"))
    res = init_residual(b.model, b.rules)
    f = b.jitted()
    metrics = []
    with mesh:
        for step in COMPRESSED_STEPS:
            params, opt, res, m = f(params, opt, res,
                                    {"tokens": jnp.asarray(tokens)},
                                    jnp.int32(step))
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
    loss, grad_norm = np.asarray(metrics).T
    return {"loss": loss, "grad_norm": grad_norm,
            **flat_arrays(jax.tree.map(np.asarray, params), "params"),
            **flat_arrays(jax.tree.map(np.asarray, res), "res")}


def _rank_path(out_dir, suffix):
    rank = os.environ["REPRO_PROCESS_ID"]
    return pathlib.Path(out_dir) / f"rank{rank}{suffix}"


def _worker_ensure(out_dir):
    """Two-rank check of the env contract: the group, the backend, the
    slice and the scenario mesh this rank gets, and one all-reduce."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    assert mesh_lib.ensure_distributed("cpu")
    assert mesh_lib.ensure_distributed("cpu")       # a second call is a no-op
    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    mesh = mesh_lib.resolve_mesh("auto", device="cpu")
    rec = dict(rank=dist.get_rank(), world=dist.get_world_size(),
               backend=dist.get_backend(), slice=mesh_lib.process_slice(7),
               devices=[str(d) for d in mesh.devices], sum=float(x),
               local_mesh=list(mesh_lib.make_local_mesh("cpu").shape))
    dist.destroy_process_group()
    _rank_path(out_dir, ".json").write_text(json.dumps(rec))


def _worker_sweep(job_path, out_dir):
    """This rank's raw aggregates of ``engine_sweep(mesh="auto",
    finalize=False)`` for each config of the job file."""
    import torch.distributed as dist
    import repro_torch.core.engine as eng
    from repro_torch.grid.scenarios import ScenarioSpec
    from repro_torch.launch import mesh as mesh_lib
    job = json.loads(pathlib.Path(job_path).read_text())
    specs = [ScenarioSpec(**s) for s in job["specs"]]
    rec = {}
    for name, kw in job["cfgs"].items():
        agg = eng.engine_sweep(eng.EngineConfig(**kw), specs,
                               chunk_size=job["chunk"], mesh="auto",
                               finalize=False, device="cpu")
        rec[name] = {k: n(v).tolist() for k, v in agg.items()}
    rec["slice"] = mesh_lib.process_slice(len(specs))
    rec["backend"] = dist.get_backend()
    dist.destroy_process_group()
    _rank_path(out_dir, ".json").write_text(json.dumps(rec))


def _worker_data_parallel(in_path, out_dir):
    """On this rank: the compressed step (:func:`port_compressed_run`),
    the plain data-parallel step and a 3-step data-parallel ``Trainer``
    on this rank's batch share, and ``compressed_psum`` on rank-seeded
    payloads."""
    import torch.distributed as dist
    import repro_torch.train.step as st
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import compressed_psum
    from repro_torch.train.trainer import Trainer, TrainerConfig
    inputs = dict(np.load(in_path))
    out = {f"compressed/{k}": v
           for k, v in port_compressed_run(inputs).items()}
    mesh = make_local_mesh(CPU)
    cfg = get_arch(COMPRESSED_ARCH).reduced()
    tokens = inputs["tokens"]
    shape = ShapeConfig("dp", tokens.shape[1], tokens.shape[0], "train")
    for name, m in (("dp", mesh), ("single", None)):
        b = st.build_step_bundle(cfg, shape, device=CPU, mesh=m,
                                 model_kw=dict(compute_dtype=torch.float32))
        lo, hi = ((0, shape.global_batch) if m is None else st.batch_share(
            b.rules, shape.global_batch, mesh.get_coordinate()))
        params = convert.model_params(nested_arrays(inputs, "params"), CPU)
        opt = convert.adamw_state({"step": inputs["step"],
                                   "mu": nested_arrays(inputs, "mu"),
                                   "nu": nested_arrays(inputs, "nu")}, CPU)
        params, opt, met = b.step_fn(
            params, opt, {"tokens": torch.as_tensor(tokens[lo:hi])}, 150)
        out.update(flat_arrays(params, f"{name}/params"))
        out[f"{name}/loss"] = np.float32(met["loss"])
        t = Trainer(cfg, ShapeConfig("dp", 16, 4, "train"), m,
                    TrainerConfig(steps=3, log_every=0), device=CPU)
        out[f"{name}/trainer_loss"] = np.asarray(
            [h["loss"] for h in t.train()["history"]])
    rng = np.random.default_rng(dist.get_rank())
    q = {f"leaf{i}": torch.as_tensor(rng.integers(-127, 128, shape),
                                     dtype=torch.int8)
         for i, shape in enumerate(((5, 3), (7,), ()))}
    s = {k: torch.tensor(float(rng.uniform(0.01, 1.0)), dtype=torch.float32)
         for k in q}
    got = compressed_psum(q, s)
    for k in q:
        out[f"psum/q/{k}"], out[f"psum/s/{k}"] = n(q[k]), n(s[k])
        out[f"psum/out/{k}"] = n(got[k])
    dist.destroy_process_group()
    np.savez(_rank_path(out_dir, ".npz"), **out)


def _worker_ref_compressed(in_path, out_path):
    np.savez(out_path, **ref_compressed_run(dict(np.load(in_path))))


# ---------------------------------------------------------------------------
# The port's package-level checks
# ---------------------------------------------------------------------------

def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for sub in ("optim/bidding.py", "service/state.py", "service/server.py",
                "service/loadgen.py", "core/twin.py", "core/reserve.py",
                "core/dispatch.py", "core/island.py", "obs/report.py",
                "experiments.py", "train/trainer.py", "train/step.py",
                "ckpt/manager.py", "data/tokens.py", "optim/adamw.py",
                "workload/actuator.py", "launch/train.py",
                "launch/mesh.py", "sharding/rules.py", "models/moe.py",
                "models/encdec.py", "models/api.py", "models/layers.py"):
        assert PORT / sub in files, sub
    return files


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("forbidden", ["jax", "repro"])
def test_port_sources_import_neither_jax_nor_repro(forbidden):
    bad = [(p.relative_to(ROOT), m) for p in _port_sources()
           for m in _imported_modules(p)
           if m == forbidden or m.startswith(forbidden + ".")]
    assert not bad, bad


def test_importing_the_engine_loads_neither_jax_nor_repro():
    code = ("import sys; import repro_torch.core.engine, "
            "repro_torch.core.pid, repro_torch.optim.bidding, "
            "repro_torch.service.server, repro_torch.service.loadgen, "
            "repro_torch.core.twin, repro_torch.core.reserve, "
            "repro_torch.core.dispatch, repro_torch.obs.report, "
            "repro_torch.experiments, repro_torch.core, repro_torch.grid, "
            "repro_torch.obs, repro_torch.workload, "
            "repro_torch.train.trainer, repro_torch.launch.train, "
            "repro_torch.ckpt, repro_torch.data, repro_torch.optim, "
            "repro_torch.launch.mesh, repro_torch.sharding, "
            "repro_torch.train.step, repro_torch.models.moe, "
            "repro_torch.models.encdec, repro_torch.models.api; "
            "import repro_torch.core as c, repro_torch.grid as g; "
            "[getattr(m, k) for m in (c, g) for k in m.__all__]; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _constant_pairs():
    import repro.core.ar4 as r_ar4
    import repro.core.pid as r_pid
    import repro.core.plant as r_plant
    import repro.core.pue as r_pue
    import repro.core.tier3 as r_tier3
    import repro.grid.frequency as r_freq
    import repro.grid.markets as r_markets
    import repro.grid.signals as r_signals
    import repro.obs.telemetry as r_tel
    import repro.workload.model as r_wl
    import repro.core.dispatch as r_dispatch
    import repro.core.reserve as r_reserve
    import repro.core.twin as r_twin
    import repro.obs.report as r_report
    import repro_torch.core.dispatch as p_dispatch
    import repro_torch.core.reserve as p_reserve
    import repro_torch.core.twin as p_twin
    import repro_torch.obs.report as p_report
    import repro_torch.core.ar4 as p_ar4
    import repro_torch.core.pid as p_pid
    import repro_torch.core.plant as p_plant
    import repro_torch.core.pue as p_pue
    import repro_torch.core.tier3 as p_tier3
    import repro_torch.grid.frequency as p_freq
    import repro_torch.grid.markets as p_markets
    import repro_torch.grid.signals as p_signals
    import repro_torch.obs.telemetry as p_tel
    import repro_torch.workload.model as p_wl
    import repro.models.transformer as r_tr
    import repro.models.moe as r_moe
    import repro_torch.models.moe as p_moe
    import repro.data.m100 as r_m100
    import repro_torch.models.transformer as p_tr
    import repro_torch.data.m100 as p_m100
    names = {
        (r_tr, p_tr): "AUX_LOSS_WEIGHT Z_LOSS_WEIGHT",
        (r_moe, p_moe): "CAPACITY_FACTOR GROUP_SIZE",
        (r_m100, p_m100): "M100_NODE_POWER_W",
        (r_plant, p_plant): (
            "P_IDLE ALPHA BETA GAMMA TDP CAP_MIN CAP_MAX F_MAX F_MIN F_VMIN "
            "F_NOMINAL GOV_SLEW ACTUATE_DELAY_MS TAU_THERMAL T_AMBIENT_INT "
            "R_TH T_FALLBACK CAP_FALLBACK CONTROL_HZ WORKLOADS _ARCHETYPES "
            "_R0 "
            "BURSTY_PERIOD_S BURSTY_DUTY BURSTY_LOW BURSTY_EDGE_JITTER_S "
            "SLOW_FREQS_HZ BURSTY_JITTER_FREQ_HZ"),
        (r_pue, p_pue): (
            "PUE_DESIGN T_FREECOOL_HI T_FREECOOL_LO PUMP_FLOOR AIR_FLOOR "
            "T_REF CHILLER_SHARE PUMP_SHARE AIR_SHARE MISC_SHARE"),
        (r_pid, p_pid): (
            "KP KI KD DT_S WINDUP_CLAMP U_MIN U_MAX T_PREDICT_LIMIT "
            "FALLBACK_CAP THERMAL_TAU"),
        (r_ar4, p_ar4): "ORDER FORGET WINDOW_S TICK_HZ",
        (r_tier3, p_tier3): (
            "MU_GRID RHO_GRID W_FFR W_CFE W_REV_DEFAULT MIN_RESIDUAL_LOAD "
            "RHO_MAX DELIVERY_TOL PENALTY_WINDOW_H EVENTS_PER_DAY_DEFAULT"),
        (r_markets, p_markets): (
            "NOMINAL_HZ FR_PRODUCTS PRODUCT_ORDER TRIGGER_HZ BUDGET_MS "
            "MIN_DURATION_S CAPACITY_PRICE_EUR_MW_H"),
        (r_signals, p_signals): "COUNTRIES COUNTRY_ORDER",
        (r_freq, p_freq): (
            "MAX_EVENTS DEFAULT_ROCOF_HZ_S DEFAULT_EVENTS_PER_DAY "
            "RECOVERY_RANGE_S"),
        (r_wl, p_wl): (
            "MIX_ORDER CLOCK_W TOKENS_PER_MW_S STEP_PERIOD_S_DEFAULT "
            "STEP_COMPUTE_FRAC DEFAULT_GRID_CKPT_S P_FLOOR_FRAC P_IDLE_FRAC "
            "F_AT_TDP"),
        (r_dispatch, p_dispatch): (
            "SIGMA_PCT BETA_CUTOFF HIGH_SIGMA_CAP ELASTIC_FRACTION "
            "SHORT_JOB_H LOOKAHEAD_H"),
        (r_reserve, p_reserve): "E_MAX DELIVERY_TOL PENALTY_WINDOW_H",
        (r_twin, p_twin): "LOAD_BLOCK_S",
        (r_report, p_report): "BAR_W",
        (r_tel, p_tel): (
            "TRACK_ERR_EDGES N_TRACK_BUCKETS RESP_FRAC_EDGES N_RESP_BUCKETS "
            "CAP_SAT_TOL_W HOUR_S"),
    }
    for (ref, port), ns in names.items():
        for name in ns.split():
            yield ref, port, name


def test_copied_constants_equal_the_reference():
    checked = 0
    for ref, port, name in _constant_pairs():
        a, b = getattr(ref, name), getattr(port, name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
            assert a.dtype == b.dtype, name
        elif name == "FR_PRODUCTS":
            assert {k: dataclasses.asdict(v) for k, v in a.items()} == {
                k: dataclasses.asdict(v) for k, v in b.items()}
        else:
            assert a == b, (ref.__name__, name, a, b)
        checked += 1
    assert checked > 60
    # the derived nadir window of the frequency synthesiser
    import repro.grid.frequency as r_freq
    import repro_torch.grid.frequency as p_freq
    np.testing.assert_array_equal(np.asarray(r_freq._NADIR_LO, np.float32),
                                  p_freq._NADIR_LO)
    np.testing.assert_array_equal(np.asarray(r_freq._NADIR_HI, np.float32),
                                  p_freq._NADIR_HI)


@pytest.mark.parametrize("pkg", ["core", "grid", "obs", "workload"])
def test_packages_export_the_references_names(pkg):
    """Each port package resolves every name of the reference package's
    ``__all__``, less the training stack's (ROADMAP A14)."""
    import importlib
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    a14 = {"PowerActuator", "RUN_FULL", "StepDecision", "duty_run_quota",
           "CkptCostModel", "checkpoint_bytes", "grid_event_cost_s",
           "manifest_bytes", "tree_bytes"}
    missing = [k for k in ref.__all__ if k not in a14
               and not hasattr(port, k)]
    assert not missing, missing
    assert set(ref.__all__) - a14 <= set(port.__all__)


@pytest.mark.parametrize("module", ["moe", "encdec", "layers", "api"])
def test_model_modules_export_the_references_names(module):
    """Every public name that ``repro.models.<module>`` defines (or takes
    in, as encdec's Z_LOSS_WEIGHT) resolves in ``repro_torch.models.
    <module>``; ROADMAP C lists no exception."""
    import importlib
    import inspect
    ref = importlib.import_module(f"repro.models.{module}")
    port = importlib.import_module(f"repro_torch.models.{module}")
    names = [k for k, v in vars(ref).items() if not k.startswith("_")
             and not inspect.ismodule(v)
             and getattr(v, "__module__", ref.__name__) == ref.__name__]
    assert names
    missing = [k for k in names if not hasattr(port, k)]
    assert not missing, missing


# reference parameters the port does not take, by design (ROADMAP C7):
# the Pallas kernels' tiling and interpret switches, the shard_map axis
# (the port's collectives take a process group), the reference's HLO text
# (the port's dry run records collectives), StepBundle's jit surface, an
# argument the reference's own body never reads, and the telemetry
# accumulator's tick values (the port passes the tick's tensors); any
# threefry ``*key`` (the port takes seeds and explicit draws)
BY_DESIGN = {
    ("repro.kernels.flash_attention", "flash_attention"):
        {"block_q", "block_k", "interpret"},
    ("repro.kernels.ops", "flash_attention"):
        {"block_q", "block_k", "interpret"},
    ("repro.kernels.ops", "ssd_scan"): {"block_heads", "interpret"},
    ("repro.kernels.ssd_scan", "ssd_scan"): {"block_heads", "interpret"},
    ("repro.kernels.ops", "pid_update"): {"interpret"},
    ("repro.kernels.pid_update", "pid_update"): {"interpret"},
    ("repro.optim.compress", "compressed_psum"): {"axis_name"},
    ("repro.launch.dryrun", "collective_bytes"): {"hlo_text"},
    ("repro.train.step", "StepBundle"):
        {"in_shardings", "out_shardings", "abstract_args", "donate_argnums"},
    ("repro.train.step", "StepBundle.__init__"):
        {"in_shardings", "out_shardings", "abstract_args", "donate_argnums"},
    ("repro.models.layers", "gated_mlp"): {"tp_axis"},
    ("repro.obs.telemetry", "accum_update"): {"acc", "state", "m"},
}


def _shared_callables():
    """(reference module, name, reference callable, port callable) of
    every public function, class and method that both packages define:
    every module of ``repro`` (``repro.launch``'s by hand: it has no
    ``__init__.py``) against ``repro_torch``'s of the same path."""
    import importlib
    import inspect
    import pkgutil
    import repro
    mods = [repro.__name__] + [m.name for m in pkgutil.walk_packages(
        repro.__path__, repro.__name__ + ".")]
    mods += [f"repro.launch.{m}" for m in ("dryrun", "mesh", "serve",
                                            "train")]
    for rn in sorted(set(mods)):
        try:
            port = importlib.import_module("repro_torch" + rn[len("repro"):])
        except ModuleNotFoundError:      # kernels/ref, pallas_compat
            continue
        ref = importlib.import_module(rn)
        for k, v in vars(ref).items():
            if k.startswith("_") or not callable(v) or \
                    getattr(v, "__module__", None) != rn:
                continue
            pv = getattr(port, k, None)
            if pv is None:
                continue
            yield rn, k, v, pv
            if inspect.isclass(v):
                for mk, mv in vars(v).items():
                    pmv = getattr(pv, mk, None)
                    if (mk == "__init__" or not mk.startswith("_")) and \
                            callable(mv) and callable(pmv):
                        yield rn, f"{k}.{mk}", mv, pmv


def test_port_takes_every_reference_parameter():
    """Each shared public callable takes every parameter name the
    reference's takes (the port may take more: ``device=``, explicit
    draws), less the differences by design (BY_DESIGN)."""
    import inspect
    missing, walked = {}, 0
    for rn, name, ref, port in _shared_callables():
        try:
            want = inspect.signature(ref).parameters
            got = inspect.signature(port).parameters
        except (TypeError, ValueError):
            continue
        walked += 1
        lack = {p for p in want if p not in got and not p.endswith("key")}
        lack -= BY_DESIGN.get((rn, name), set())
        if lack:
            missing[f"{rn}.{name}"] = sorted(lack)
    assert walked > 300
    assert not missing, missing


# the port's parameters that stand where the reference takes a threefry
# ``*key`` (ROADMAP C7): its seeds and explicit draws, in the key's place,
# so a reference call that passes a key by position has no counterpart
KEY_STANDINS = {
    ("repro.core.engine", "EngineState"): {"seed"},   # its per-lane seeds
    ("repro.data.tokens", "synthetic_batch"): {"seed", "step"},
    ("repro.grid.frequency", "sample_events"): {"seeds"},
    ("repro.grid.frequency", "baseline_wander"): {"seeds"},
}


def test_port_keeps_the_references_positional_order():
    """Each shared public callable's positional parameters begin with the
    reference's, in its order (less any ``*key``, the BY_DESIGN names the
    port does not take and the KEY_STANDINS the port takes in a key's
    place): a call that passes the reference's arguments by position
    means the same on the port.  The port adds parameters only after
    them or keyword-only."""
    import inspect
    pos = (inspect.Parameter.POSITIONAL_ONLY,
           inspect.Parameter.POSITIONAL_OR_KEYWORD)
    wrong, walked = {}, 0
    for rn, name, ref, port in _shared_callables():
        try:
            want = inspect.signature(ref).parameters
            got = inspect.signature(port).parameters
        except (TypeError, ValueError):
            continue
        walked += 1
        absent = BY_DESIGN.get((rn, name), set())
        standins = KEY_STANDINS.get((rn, name), set())
        r = [p for p, v in want.items() if v.kind in pos
             and not p.endswith("key") and p not in absent]
        p_ = [p for p, v in got.items() if v.kind in pos
              and not p.endswith("key") and p not in standins]
        if p_[:len(r)] != r:
            wrong[f"{rn}.{name}"] = (r, p_)
    assert walked > 300
    assert not wrong, wrong


def test_point_objective_scales_revenue_by_price_rel():
    """``point_objective(price_rel=)`` against the reference's values."""
    import jax.numpy as jnp
    import repro.core.tier3 as r_tier3
    import repro_torch.core.tier3 as p_tier3
    rng = np.random.default_rng(4)
    mu = rng.uniform(0.3, 1.0, (5, 3)).astype(np.float32)
    rho = rng.uniform(0.0, 0.4, (5, 3)).astype(np.float32)
    green = rng.uniform(0.0, 1.0, (5, 1)).astype(np.float32)
    t_amb = rng.uniform(5.0, 30.0, (5, 1)).astype(np.float32)
    price = rng.lognormal(0.0, 0.3, (5, 3)).astype(np.float32)
    w = np.asarray([1.0, 0.5, 0.8, 0.2], np.float32)
    kw = dict(pue_aware=True, use_revenue=True, use_workload=True)
    args = (1, 12.0, 1.0, 30.0)
    for pr in (None, price):
        want = r_tier3.point_objective(
            *(jnp.asarray(a) for a in (mu, rho, green, t_amb, w)), *args,
            **kw, price_rel=None if pr is None else jnp.asarray(pr))
        got = p_tier3.point_objective(
            *(t(a) for a in (mu, rho, green, t_amb, w)), *args, **kw,
            price_rel=None if pr is None else t(pr))
        assert_close(n(got), want, rtol=1e-3)
    plain = p_tier3.point_objective(*(t(a) for a in (mu, rho, green, t_amb,
                                                     w)), *args, **kw)
    assert not np.allclose(n(got), n(plain))


def test_pid_gains_come_from_the_constants():
    import repro_torch.core.pid as p_pid
    import repro_torch.core.plant as p_plant
    g = p_pid.GAINS
    assert (g.kp, g.ki, g.kd) == (p_pid.KP, p_pid.KI, p_pid.KD)
    assert (g.windup, g.u_min, g.u_max) == (
        p_pid.WINDUP_CLAMP, p_pid.U_MIN, p_pid.U_MAX)
    assert (g.t_amb_int, g.r_th, g.thermal_tau) == (
        p_plant.T_AMBIENT_INT, p_plant.R_TH, p_pid.THERMAL_TAU)
    assert (g.t_limit, g.fallback_cap) == (
        p_pid.T_PREDICT_LIMIT, p_pid.FALLBACK_CAP)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_default_device_is_cuda_and_raises_without_a_card(device):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs there")
    import repro_torch.core.engine as eng
    from repro_torch.grid.scenarios import build_scenario_batch, \
        product_specs
    batch = build_scenario_batch(product_specs(countries=("SE",),
                                               horizon_h=1), device=CPU)
    kw = {} if device is None else {"device": device}
    with pytest.raises(RuntimeError, match="cuda"):
        eng.engine_rollout(eng.EngineConfig(), batch, **kw)
    with pytest.raises(RuntimeError, match="cuda"):
        build_scenario_batch(product_specs(countries=("SE",), horizon_h=1),
                             **kw)
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.resolve_device(device)


def test_convert_round_trips_reference_state():
    """convert.py turns the reference's state, as numpy dicts, into the
    port's tensors."""
    import jax
    import jax.numpy as jnp
    import repro.core.ar4 as r_ar4
    import repro.core.engine as ref_eng
    import repro.core.pid as r_pid
    import repro.core.plant as r_plant
    import repro.grid.frequency as r_freq
    from repro.grid.scenarios import build_scenario_batch, product_specs
    from repro_torch import convert
    batch = build_scenario_batch(product_specs(countries=("SE", "DE"),
                                               horizon_h=3))
    pb = convert.scenario_batch(np_tree(batch), device=CPU)
    for f in dataclasses.fields(batch):
        np.testing.assert_array_equal(n(getattr(pb, f.name)),
                                      np.asarray(getattr(batch, f.name)))
    assert pb.n == batch.n and pb.h_max == batch.h_max
    pid_s = convert.pid_state(np_tree(r_pid.init_pid(5, 250.0)), CPU)
    assert n(pid_s.u).tolist() == [250.0] * 5
    pl = convert.plant_state(np_tree(r_plant.init_plant(5)), CPU)
    assert n(pl.temp).tolist() == [r_plant.T_AMBIENT_INT] * 5
    rls = convert.rls_state(np_tree(r_ar4.init_rls(3)), CPU)
    np.testing.assert_array_equal(n(rls.P), np.asarray(r_ar4.init_rls(3).P))
    ev = r_freq.sample_events(jax.random.PRNGKey(0), 86_400, 0, 8.0, 16)
    pev = convert.event_batch(np_tree(ev), CPU)
    assert pev.t0_s.dtype == torch.int32 and pev.valid.dtype == torch.bool
    np.testing.assert_array_equal(n(pev.nadir_hz), np.asarray(ev.nadir_hz))
    ref_state = ref_eng.engine_init(ref_eng.EngineConfig(n_hosts=2),
                                    jax.random.PRNGKey(0))
    st = convert.engine_state(
        jax.tree.map(lambda x: np.asarray(x)[None], np_tree(ref_state)),
        seed=np.array([7]), device=CPU)
    assert tuple(st.chip_power.shape) == (1, 2, 2)
    assert tuple(st.rls.P.shape) == (1, 2, 4, 4)
    assert int(st.seed[0]) == 7 and float(st.acc.n_s[0]) == 0.0
    assert jnp.asarray(ref_state.last_load).item() == pytest.approx(
        float(st.last_load[0]))


if __name__ == "__main__":
    # worker entry points of the multi-process tests:
    #   python tests/test_torch_common.py <worker> <args...>
    {"ensure": _worker_ensure, "sweep": _worker_sweep,
     "data_parallel": _worker_data_parallel,
     "ref_compressed": _worker_ref_compressed}[sys.argv[1]](*sys.argv[2:])
