"""The tensor-parallel decode step (``lm_decode_step`` and
``encdec_decode_step`` on each rank's ``model`` shards, the cache laid
out by ``cache_pspecs``: ``StepBundle.init_cache``) on gloo worlds on the
CPU, in float32.

Each case's reduced config runs under an ``fsdp_tp`` plan on a (data,
model) mesh: a prompt of PROMPT tokens is teacher-forced through the
decode step, then GEN more tokens are decoded, each the replicated
port's greedy pick, so every run sees the same token ids.  At every step
the logits on every rank meet

- the replicated port on the same rows, in the same process, and
- the reference's unsharded ``Model.decode_step`` on the same parameters
  and tokens (the whole batch, in the test process),

at ``tests/test_torch_models.py``'s f32 tolerance, and the next-token
ids (``make_decode_step``'s argmax over the gathered columns) equal the
replicated port's.  After the last step each rank's cache leaves have
the shapes of their shard under the reference's ``cache_pspecs`` and
equal that chunk of the replicated cache.  With the recorder of
``tests/test_torch_tp.py``, every weight the rules split over ``model``
enters the decode's products at its local width, and each rank's matmul
FLOPs are the replicated step's on its rows divided by ``model``, plus
the products that stay whole (:func:`unsplit_decode_flops`), within 5 %.
The MoE picks are pinned to the replicated run's (``route(topi=)``) and
asserted equal to the rank's own.

The cases: the cache split by kv heads (qwen2-1.5b with 2 kv heads), by
positions (yi-9b: its one kv head, under ``decode_seq_constraint``),
GQA groups of 4 that straddle two ranks (12 query heads on 3 kv heads)
over a cache split by positions and over a whole one
(``decode_kv_shard="replicated"``), the sliding-window ring split by
positions (mixtral-8x22b: window 8, ``tp`` experts, 14 tokens), the SSM
(mamba2-1.3b: the conv state's channel blocks are not the ranks' heads'
x channels), the hybrid (zamba2-2.7b), MoE ``ep`` (olmoe-1b-7b), the VLM
(phi-3-vision-4.2b), the enc-dec family (whisper-medium, self and cross
K/V split by heads), a padded vocabulary (yi-9b, 200 of 256 columns),
and the heads and SSM cases again on (2, 2).

Ranks are processes of ``tests/test_torch_decode_tp.py worker`` under
the REPRO_* contract (``test_torch_common.run_procs``), one world per
mesh shape, all at once; the reference runs in the test process."""
import dataclasses
import functools
import json
import math
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from test_torch_common import CPU, flat_arrays, free_port, nested_arrays, \
    run_procs
from test_torch_tp import _flat_leaves, _model_shard_shape, _splits, \
    product_flops, product_recorder

# name -> (arch, ArchConfig overrides, ShardingPlan overrides, mesh)
CASES = {
    "heads": ("qwen2-1.5b", dict(n_kv_heads=2), {}, (1, 2)),
    "seq": ("yi-9b", {}, dict(decode_seq_constraint=True), (1, 2)),
    "straddle": ("qwen2-1.5b", dict(n_heads=12, n_kv_heads=3), {}, (1, 2)),
    "straddle_whole": ("qwen2-1.5b", dict(n_heads=12, n_kv_heads=3),
                       dict(decode_kv_shard="replicated"), (1, 2)),
    "ring": ("mixtral-8x22b", {}, {}, (1, 2)),
    "ssm": ("mamba2-1.3b", {}, {}, (1, 2)),
    "hybrid": ("zamba2-2.7b", {}, {}, (1, 2)),
    "moe_ep": ("olmoe-1b-7b", {}, {}, (1, 2)),
    "vlm": ("phi-3-vision-4.2b", {}, {}, (1, 2)),
    "encdec": ("whisper-medium", {}, {}, (1, 2)),
    "vocab": ("yi-9b", dict(vocab_size=200), {}, (1, 2)),
    "heads_2x2": ("qwen2-1.5b", dict(n_kv_heads=2), {}, (2, 2)),
    "ssm_2x2": ("mamba2-1.3b", {}, {}, (2, 2)),
}
BATCH, SEQ = 4, 16            # rows; the cache's positions (a ring of 8
PROMPT, GEN = 6, 8            # under a window of 8)
LOGITS_F32 = dict(atol=1e-4, rtol=1e-4)    # tests/test_torch_models.py
CACHE_F32 = dict(atol=1e-5, rtol=1e-5)
FLOP_BAND = 0.05


def _tag(shape):
    return "x".join(map(str, shape))


def _cfg(pkg_get_arch, plan_cls, case):
    arch, over, plan, _ = CASES[case]
    cfg = pkg_get_arch(arch).reduced()
    return dataclasses.replace(cfg, **over, plan=plan_cls(
        mode="fsdp_tp", moe_mode=cfg.plan.moe_mode, **plan))


def port_cfg(case):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShardingPlan
    return _cfg(get_arch, ShardingPlan, case)


def ref_cfg(case):
    from repro.configs import get_arch
    from repro.configs.base import ShardingPlan
    return _cfg(get_arch, ShardingPlan, case)


# ---------------------------------------------------------------------------
# The ranks' side
# ---------------------------------------------------------------------------


class Picks:
    """``moe.route`` recording each call's own top-k picks and, where
    pinned, returning the pinned ones' gates instead (``topi=``)."""

    def __init__(self):
        import repro_torch.models.moe as moe
        self.moe, self.route = moe, moe.route
        self.own, self.pinned = [], None

    def __enter__(self):
        def route(router, x, top_k, topi=None):
            out = self.route(router, x, top_k)
            self.own.append(out[2].clone())
            if self.pinned is not None:
                return self.route(router, x, top_k,
                                  self.pinned[len(self.own) - 1])
            return out
        self.moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def _model_chunk(full, mesh, placements):
    """The chunk of ``full`` (a leaf of this rank's rows) that this rank's
    ``model`` coordinate holds under ``placements``."""
    from torch.distributed.tensor import Shard
    i = mesh.mesh_dim_names.index("model")
    p = placements[i]
    if not isinstance(p, Shard):
        return full
    n = full.shape[p.dim] // mesh.size(i)
    return full.narrow(p.dim, mesh.get_coordinate()[i] * n, n)


def _case_on_rank(case, mesh, inputs):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import convert
    from repro_torch._tree import tree_map
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import encdec
    from repro_torch.sharding import fsdp
    from repro_torch.train.step import batch_share, build_step_bundle
    cfg = port_cfg(case)
    b = build_step_bundle(cfg, ShapeConfig("decode_tp", SEQ, BATCH,
                                           "decode"),
                          mesh, device=CPU,
                          model_kw=dict(compute_dtype=torch.float32))
    model = b.model
    whole = convert.model_params(nested_arrays(inputs, "params"), CPU)
    params = tree_map(lambda t, pl: fsdp.place(t, mesh, pl), whole,
                      b.param_placements)
    lo, hi = batch_share(b.rules, BATCH, mesh.get_coordinate())
    cache, rcache = b.init_cache(), model.init_cache(hi - lo, SEQ)
    if cfg.family == "encdec":
        frames = torch.as_tensor(inputs["frames"][lo:hi])
        for p, c in ((params, cache), (whole, rcache)):
            enc = encdec.encode(cfg, p, frames, dtype=torch.float32)
            c["xk"], c["xv"] = encdec.precompute_cross_kv(cfg, p, enc)
    seen = []
    decode = model.decode_step

    def recorded(p, c, t):
        out = decode(p, c, t)
        seen.append(out[0])
        return out
    model.decode_step = recorded                  # step_fn's logits
    prompt = torch.as_tensor(inputs["prompt"][lo:hi])
    tokens, logits, rep_logits, ids_equal = [], [], [], []
    picks_equal = True
    tok = prompt[:, 0]
    for t in range(PROMPT + GEN):
        last = t == PROMPT + GEN - 1
        rec, rep_rec = [], []
        with Picks() as rp, product_recorder(rep_rec), \
                FlopCounterMode(display=False) as rep_fc:
            rl, rcache = decode(whole, rcache, tok)
        with Picks() as pk, product_recorder(rec), \
                FlopCounterMode(display=False) as fc:
            pk.pinned = rp.own
            ids, cache = b.step_fn(params, cache, tok)
        picks_equal &= len(pk.own) == len(rp.own) and all(
            torch.equal(x, y) for x, y in zip(pk.own, rp.own))
        tokens.append(tok.numpy())
        logits.append(seen.pop().numpy())
        rep_logits.append(rl.numpy())
        ids_equal.append(bool(torch.equal(ids.long(),
                                          torch.argmax(rl, -1))))
        tok = torch.argmax(rl, -1).to(torch.int32) if t + 1 >= PROMPT \
            else prompt[:, t + 1]
    out = {"rows": np.asarray([lo, hi]), "tokens": np.stack(tokens, 1),
           "logits": np.stack(logits), "rep_logits": np.stack(rep_logits),
           "ids_equal": np.asarray(ids_equal),
           "picks_equal": np.asarray(picks_equal),
           "cur": np.asarray([cache["cur"], rcache["cur"]]),
           "flops": np.asarray([fc.get_total_flops(),
                                rep_fc.get_total_flops()], np.float64),
           "products": np.asarray(json.dumps([rec, rep_rec])),
           "local": np.asarray(json.dumps({
               "/".join(k.split("/")[1:]): _model_shard_shape(x)
               for k, x in _flat_leaves(params).items() if _splits(x)}))}
    for k, x in cache.items():
        if k == "cur":
            continue
        out[f"cache/{k}"] = x.numpy()
        out[f"rep_chunk/{k}"] = _model_chunk(
            rcache[k], mesh, b.cache_placements[k]).numpy()
    return out


def _worker(job_dir, out_dir, tag):
    """One rank of the world of the mesh ``tag``: every case on it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.mesh import ensure_distributed
    torch.set_num_threads(1)
    assert ensure_distributed(CPU)
    shape = tuple(int(x) for x in tag.split("x"))
    rank = dist.get_rank()
    mesh = DeviceMesh(CPU, torch.arange(dist.get_world_size())
                      .reshape(shape), mesh_dim_names=("data", "model"))
    out = {}
    for case in [c for c, v in CASES.items() if v[3] == shape]:
        inputs = dict(np.load(pathlib.Path(job_dir) / f"{case}.npz"))
        with torch.no_grad():
            rec = _case_on_rank(case, mesh, inputs)
        out.update({f"{case}/{k}": v for k, v in rec.items()})
        dist.barrier()
    dist.destroy_process_group()
    np.savez(pathlib.Path(out_dir) / f"{tag}_rank{rank}.npz", **out)


# ---------------------------------------------------------------------------
# The test process: inputs, the reference, the worlds
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _inputs(case):
    from test_torch_models import _batch_np, _params_np
    rc = ref_cfg(case)
    rng = np.random.default_rng(23)
    out = {**flat_arrays(_params_np(rc), "params"),
           "prompt": rng.integers(0, rc.vocab_size, (BATCH, PROMPT),
                                  dtype=np.int32)}
    if rc.family == "encdec":
        out["frames"] = _batch_np(rc, b=BATCH, seed=5)["frames"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode_tp")
    for case in CASES:
        np.savez(d / f"{case}.npz", **_inputs(case))
    meshes = sorted({v[3] for v in CASES.values()})
    argvs, envs = [], []
    for shape in meshes:
        n, port = math.prod(shape), free_port()
        for r in range(n):
            argvs.append(["tests/test_torch_decode_tp.py", "worker", str(d),
                          str(d), _tag(shape)])
            envs.append(dict(REPRO_COORD_ADDR=f"127.0.0.1:{port}",
                             REPRO_NUM_PROCESSES=str(n),
                             REPRO_PROCESS_ID=str(r)))
    run_procs(argvs, envs, timeout=240)
    return {_tag(s): [dict(np.load(d / f"{_tag(s)}_rank{r}.npz"))
                      for r in range(math.prod(s))] for s in meshes}


def _recs(runs, case):
    return [{k[len(case) + 1:]: v for k, v in rec.items()
             if k.startswith(case + "/")}
            for rec in runs[_tag(CASES[case][3])]]


def _whole_tokens(recs):
    """The (BATCH, steps) token ids every rank fed, from each rank's
    rows."""
    tokens = np.full((BATCH, PROMPT + GEN), -1, np.int32)
    for rec in recs:
        lo, hi = rec["rows"]
        tokens[lo:hi] = rec["tokens"]
    assert (tokens >= 0).all()
    return tokens


def ref_decode_logits(case, tokens):
    """The reference's unsharded ``Model.decode_step`` logits (steps,
    BATCH, V) of ``tokens``, in float32 (the step jitted)."""
    import jax
    import jax.numpy as jnp
    import repro.models.encdec as r_ed
    from repro.models import build_model
    inputs = _inputs(case)
    rc = ref_cfg(case)
    rm = build_model(rc, compute_dtype=jnp.float32)
    rp = nested_arrays(inputs, "params")
    cache = rm.init_cache(BATCH, SEQ)
    if rc.family == "encdec":
        enc = r_ed.encode(rc, rp, jnp.asarray(inputs["frames"]),
                          dtype=jnp.float32)
        cache["xk"], cache["xv"] = r_ed.precompute_cross_kv(rc, rp, enc)
    step = jax.jit(rm.decode_step)
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = step(rp, cache, jnp.asarray(tokens[:, t]))
        out.append(np.asarray(logits))
    return np.stack(out)


def cache_shard_shapes(case, shape):
    """Each cache leaf's shard shape under the reference's
    ``cache_pspecs`` on a (data, model) mesh of ``shape``."""
    from jax.sharding import AbstractMesh
    from repro.models import build_model
    from repro.sharding.rules import MeshRules
    from repro.train.step import cache_pspecs
    rc = ref_cfg(case)
    mesh = AbstractMesh(shape, ("data", "model"))
    specs = build_model(rc).cache_specs(BATCH, SEQ)
    specs.pop("cur", None)
    pspecs = cache_pspecs(rc, MeshRules(rc.plan, mesh), specs, BATCH)
    sizes = dict(zip(("data", "model"), shape))
    out = {}
    for k, s in specs.items():
        dims = list(s.shape)
        for d, e in enumerate(pspecs[k]):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    dims[d] //= sizes[a]
        out[k] = tuple(dims)
    return out


# ---------------------------------------------------------------------------
# What each rank computes
# ---------------------------------------------------------------------------


def unsplit_decode_flops(cfg, rows, m) -> float:
    """The matmul FLOPs of one decode step on ``rows`` rows that a rank of
    a ``model`` of ``m`` computes beyond its 1/m share of the replicated
    step's: the products that stay whole on every rank, each counted at
    (1 - 1/m) of its 2 M K N --

    - the SSM's ``w_bc`` product: B and C, which every head reads;
    - the MoE router (every token on every rank) and, under
      ``moe_mode="tp"``, the combine of every expert's output by its gate;
    - the k and v products where the rules keep ``kv_feat`` whole (it does
      not divide over ``model``).

    The K/V of the token that the cache's positions' owner writes, and the
    queries that attend over every rank's positions, are this rank's
    columns, gathered: activations, not products."""
    d, keep = cfg.d_model, 1.0 - 1.0 / m
    extra = 0.0
    if cfg.family in ("ssm", "hybrid"):
        extra += keep * cfg.num_layers * 2 * rows * d * 2 * cfg.ssm_state
    if cfg.is_moe:
        e = cfg.n_experts
        extra += keep * cfg.num_layers * 2 * rows * d * e
        if cfg.plan.moe_mode == "tp":
            extra += keep * cfg.num_layers * 2 * e * rows * d
    kf = cfg.n_kv_heads * cfg.resolved_head_dim
    if cfg.n_heads and kf % m:
        n_attn = cfg.num_layers // cfg.hybrid_period \
            if cfg.family == "hybrid" else cfg.num_layers
        n_attn *= 2 if cfg.family == "encdec" else 1
        extra += keep * n_attn * 2 * 2 * rows * d * kf
    return extra


# leaves that enter no product of the decode step at their local width:
# an untied table is looked up, the convolutions' leaves are gathered for
# the rank's channel block, the cross K/V's are the prefill's
NOT_PRODUCTS = ("embed", "conv_x", "dt_bias", "A_log", "D", "gate_norm",
                "b1", "bq", "bk", "bv", "x_wk", "x_wv")


def _operands(products):
    """The operand shapes of the products, each also transposed in its
    last two dims, and a ``bmm``'s of one batch also as the 2-D operand
    (an expert einsum's (D, E x F), for one)."""
    shapes = set()
    for _, a, b in products:
        for x in (a, b):
            x = tuple(x)
            if len(x) == 3 and x[0] == 1:
                x = x[1:]
            shapes |= {x, x[:-2] + (x[-1], x[-2])}
    return shapes


def _checked_leaves(cfg, local):
    """(name, whole shape or None, local shape) of each leaf the rules
    split over ``model`` that enters a decode product at its shard's
    width.  A whole shape equal to a legitimate operand's (a leaf the
    rules keep whole, or a shard) is None: only the shard is checked."""
    from repro_torch._tree import leaves_with_paths
    from repro_torch.models import build_model
    specs = {"/".join(p): s for p, s in leaves_with_paths(
        build_model(cfg, device="meta").specs())}
    whole_2d = {tuple(s.shape[-2:]) for k, s in specs.items()
                if k not in local and len(s.shape) >= 2}
    whole_2d |= {tuple(v[-2:]) for v in local.values() if len(v) >= 2}
    whole_2d |= {(v[-2], v[-3] * v[-1]) for k, v in local.items()
                 if k.split("/")[-1] in ("moe_wi", "moe_wg")}
    whole_2d |= {w[::-1] for w in whole_2d}
    out = []
    for name, shape in local.items():
        leaf = name.split("/")[-1]
        if leaf in NOT_PRODUCTS and not (leaf == "embed"
                                         and cfg.tie_embeddings):
            continue
        if leaf in ("moe_wi", "moe_wg"):
            # the einsum bd,edf->ebf: one (D, E x F) product
            e, d_, f = specs[name].shape[-3:]
            whole = (d_, e * f)
            out.append((name, None if whole in whole_2d else whole,
                        (shape[-2], shape[-3] * shape[-1])))
            continue
        n = 3 if leaf == "moe_wo" else 2
        whole = tuple(specs[name].shape[-n:])
        out.append((name, None if whole in whole_2d else whole,
                    tuple(shape[-n:])))
    return out


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_tp_decode_logits_and_ids_equal_the_replicated_port(runs, case):
    for r, rec in enumerate(_recs(runs, case)):
        assert rec["logits"].shape == rec["rep_logits"].shape
        for t in range(PROMPT + GEN):
            np.testing.assert_allclose(rec["logits"][t], rec["rep_logits"][t],
                                       **LOGITS_F32,
                                       err_msg=f"rank {r}, step {t}")
        assert rec["ids_equal"].all(), f"rank {r}: next tokens differ"
        assert rec["picks_equal"], f"rank {r}: MoE picks differ"
        assert rec["cur"].tolist() == [PROMPT + GEN] * 2


@pytest.mark.parametrize("case", list(CASES))
def test_tp_decode_logits_equal_the_reference(runs, case):
    recs = _recs(runs, case)
    want = ref_decode_logits(case, _whole_tokens(recs))
    for r, rec in enumerate(recs):
        lo, hi = rec["rows"]
        for t in range(PROMPT + GEN):
            np.testing.assert_allclose(rec["logits"][t], want[t, lo:hi],
                                       **LOGITS_F32,
                                       err_msg=f"rank {r}, step {t}")


@pytest.mark.parametrize("case", list(CASES))
def test_tp_decode_cache_is_the_cache_pspecs_chunk(runs, case):
    shapes = cache_shard_shapes(case, CASES[case][3])
    for r, rec in enumerate(_recs(runs, case)):
        keys = sorted(k[len("cache/"):] for k in rec
                      if k.startswith("cache/"))
        assert keys == sorted(shapes), (keys, sorted(shapes))
        for k in keys:
            got, want = rec[f"cache/{k}"], rec[f"rep_chunk/{k}"]
            assert got.shape == shapes[k], (r, k, got.shape, shapes[k])
            if k == "pos_buf":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, **CACHE_F32,
                                           err_msg=f"rank {r}: {k}")
        if CASES[case][2].get("decode_kv_shard") != "replicated":
            # some leaf is split over ``model``: smaller than its rows'
            rows = cache_shard_shapes(case, (CASES[case][3][0], 1))
            assert any(shapes[k] != rows[k] for k in keys), case


@pytest.mark.parametrize("case", list(CASES))
def test_tp_decode_split_weights_enter_products_at_local_width(runs, case):
    cfg = port_cfg(case)
    for r, rec in enumerate(_recs(runs, case)):
        local = json.loads(str(rec["local"]))
        tp_rec, _ = json.loads(str(rec["products"]))
        ops = _operands(tp_rec)
        checked = _checked_leaves(cfg, local)
        assert checked, case
        for name, whole, loc in checked:
            assert loc in ops, f"rank {r}: {name} {loc} not in a product"
            assert whole is None or whole not in ops, \
                f"rank {r}: {name} {whole} whole"


@pytest.mark.parametrize("case", list(CASES))
def test_tp_decode_rank_flops_split_over_model(runs, case):
    """Each rank's matmul FLOPs of the last step (the recorder's and
    FlopCounterMode's) are its replicated step's on the same rows divided
    by ``model``, plus the products that stay whole
    (:func:`unsplit_decode_flops`), within 5 %."""
    cfg = port_cfg(case)
    m = CASES[case][3][1]
    for r, rec in enumerate(_recs(runs, case)):
        got, rep = rec["flops"]
        tp_rec, rep_rec = json.loads(str(rec["products"]))
        assert product_flops(tp_rec) == got and \
            product_flops(rep_rec) == rep
        rows = int(rec["rows"][1] - rec["rows"][0])
        want = rep / m + unsplit_decode_flops(cfg, rows, m)
        assert abs(got - want) <= FLOP_BAND * want, \
            f"rank {r}: {got:.4g} FLOPs, want {want:.4g} ({rep:.4g} whole)"
        assert got < rep


if __name__ == "__main__":
    # rank entry point of the module fixture:
    #   python tests/test_torch_decode_tp.py worker <job_dir> <out_dir> <mesh>
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    {"worker": _worker}[sys.argv[1]](*sys.argv[2:])
