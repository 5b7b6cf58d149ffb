"""Tensor-parallel products over ``model`` (``repro_torch.sharding.tp``) on
gloo worlds on the CPU, in float32:

- each case's loss, metrics and every gradient on a (data 1, model m)
  mesh against the replicated port (one process, the same rows) and the
  reference's ``jax.value_and_grad`` of ``Model.loss``, at
  ``tests/test_torch_train.py``'s f32 tolerances: the attention's four
  cases -- (a) ``q_feat`` and ``kv_feat`` split on whole heads, (b)
  ``kv_feat`` split inside a head (one kv head of 16 features on a
  ``model`` of 2: each rank takes ``wk``/``wv`` whole and computes the kv
  head its query heads read), (c) ``kv_feat`` replicated (6 features on
  a ``model`` of 4), (d) ``q_feat`` replicated (the attention unsplit,
  the MLP and the vocabulary split), and query heads whose GQA groups
  straddle two ranks --, the SSD's packed ``w_zx`` and
  its gated norm over the whole inner width, the hybrid's shared block,
  ``gelu_mlp``'s ``b2`` added once after the sum (whisper), MoE ``ep``
  and ``tp`` (the same expert picks as the replicated run, asserted),
  the VLM, and a padded vocabulary (200 of 256 columns, untied); and
  ``Model.forward``'s logits (the ranks' vocabulary columns gathered)
  against the replicated forward;
- on (1, 2) and (2, 2) meshes, a recorder of every ``aten.mm``/``bmm``
  operand: each weight the rules split over ``model`` enters its
  product at its local width and never whole, and each rank's matmul
  FLOPs (``FlopCounterMode``, forward and backward) are within 5 % of
  the replicated step's on its rows divided by ``model``, plus the
  listed products that stay unsplit (:func:`unsplit_flops`);
- ``tp.row``'s float32 part of a bfloat16 row product on the card, and
  its gradients, against ``a @ w`` (and ``a @ w`` itself on the CPU).

Ranks are processes of ``tests/test_torch_tp.py worker`` under the
REPRO_* contract (``test_torch_common.run_procs``); the reference runs in
the test process."""
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

# name -> (arch, ArchConfig overrides, (data, model) mesh); d_ff 80 (not
# the reduced 128) where a case's products are recorded, so that no whole
# FFN leaf has the shape of another leaf's shard or of a rank's tokens
FF = dict(d_ff=80)
CASES = {
    "attn_a": ("qwen2-1.5b", dict(n_kv_heads=2), (1, 2)),
    "attn_b": ("qwen2-1.5b", FF, (1, 2)),
    "attn_c": ("qwen2-1.5b", dict(head_dim=6), (1, 4)),
    "attn_d": ("qwen2-1.5b", dict(n_heads=3, head_dim=6), (1, 4)),
    # 12 query heads in groups of 4 on a model of 2: a rank's 6 query
    # heads read kv heads 0 and 1 in groups of 4 and 2 (Heads.kv_idx)
    "attn_e": ("qwen2-1.5b", dict(n_heads=12, n_kv_heads=3), (1, 2)),
    "ssm": ("mamba2-1.3b", {}, (1, 2)),
    "hybrid": ("zamba2-2.7b", FF, (1, 2)),
    "gelu": ("whisper-medium", FF, (1, 2)),
    "moe_ep": ("olmoe-1b-7b", FF, (1, 2)),
    "moe_tp": ("mixtral-8x22b", FF, (1, 2)),
    "vlm": ("phi-3-vision-4.2b", FF, (1, 2)),
    "vocab": ("yi-9b", dict(vocab_size=200), (1, 2)),
}
# the FLOP and operand-width cases, on both meshes
FLOP_CASES = ("attn_b", "ssm", "hybrid", "gelu", "moe_ep", "moe_tp", "vlm")
FLOP_MESHES = ((1, 2), (2, 2))
BATCH, SEQ = 6, 24           # rows x positions: no product dim equals D
LOSS_F32 = dict(rtol=1e-5, atol=0.0)       # tests/test_torch_train.py
GRAD_F32 = dict(rtol=1e-4, atol=1e-6)
LOGITS_F32 = dict(atol=1e-4, rtol=1e-4)    # tests/test_torch_models.py
FLOP_BAND = 0.05


def _tag(shape):
    return "x".join(map(str, shape))


def port_cfg(case):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShardingPlan
    arch, over, _ = CASES[case]
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, **over, plan=ShardingPlan(
        mode="fsdp_tp", moe_mode=cfg.plan.moe_mode, remat="dots"))


def ref_cfg(case):
    from repro.configs import get_arch
    from repro.configs.base import ShardingPlan
    arch, over, _ = CASES[case]
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, **over, plan=ShardingPlan(
        mode="fsdp_tp", moe_mode=cfg.plan.moe_mode, remat="dots"))


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


def product_recorder(out: list):
    """A dispatch mode that appends (op, operand shapes, output shape) of
    every ``aten.mm``/``bmm`` (an einsum's products among them)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    ops = {torch.ops.aten.mm.default: "mm", torch.ops.aten.bmm.default: "bmm"}

    class Rec(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            if func in ops:
                out.append((ops[func], tuple(args[0].shape),
                            tuple(args[1].shape)))
            return res
    return Rec()


def product_flops(rec) -> int:
    """2 x M x K x N (x batch) over the recorded products."""
    total = 0
    for _, a, b in rec:
        total += 2 * math.prod(a) * b[-1]
    return total


# ---------------------------------------------------------------------------
# The ranks' side
# ---------------------------------------------------------------------------


def _run(model, params, batch, partial):
    """(loss, metrics, grads, products, flops, picks) of one
    loss-and-gradient on ``params``, every MoE pick recorded."""
    from torch.utils.flop_counter import FlopCounterMode
    import repro_torch.models.moe as moe
    from repro_torch.train.step import loss_and_grads
    rec, picks = [], []
    route = moe.route

    def recorded(*a, **k):
        out = route(*a, **k)
        picks.append(out[2].detach().clone())
        return out
    moe.route = recorded
    try:
        with FlopCounterMode(display=False) as fc, product_recorder(rec):
            loss, metrics, grads = loss_and_grads(model, params, batch,
                                                  partial)
    finally:
        moe.route = route
    return loss, metrics, grads, rec, fc.get_total_flops(), picks


def _case_on_rank(case, mesh, inputs, rank):
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch._tree import tree_map, unflatten_like
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.sharding import fsdp
    from repro_torch.train.step import batch_rows, build_step_bundle
    cfg = port_cfg(case)
    b = build_step_bundle(cfg, ShapeConfig("tp", SEQ, BATCH, "train"),
                          device=CPU, mesh=mesh,
                          model_kw=dict(compute_dtype=torch.float32))
    whole = convert.model_params(nested_arrays(inputs, "params"), CPU)
    params = tree_map(lambda t, pl: fsdp.place(t, mesh, pl), whole,
                      b.param_placements)
    lo, hi = batch_rows(b.rules, BATCH, mesh.get_coordinate())
    batch = {k: torch.as_tensor(inputs[k][lo:hi])
             for k in ("tokens", "embeds", "frames") if k in inputs}
    loss, metrics, grads, rec, flops, picks = _run(
        b.model, params, batch, (mesh, b.batch_axes))
    rep = _run(b.model, whole, batch, None)
    logits = [b.model.forward(w, batch).float().numpy()
              for w in (params, whole)]
    out = {"loss": np.asarray([float(loss), float(rep[0])]),
           "logits": np.stack(logits),
           "flops": np.asarray([flops, rep[4]], np.float64),
           "products": np.asarray(json.dumps([rec, rep[3]])),
           "picks_equal": np.asarray(all(torch.equal(p, q) for p, q in
                                         zip(picks, rep[5]))
                                     and len(picks) == len(rep[5])),
           "local": np.asarray(json.dumps({
               "/".join(k.split("/")[1:]): _model_shard_shape(x)
               for k, x in _flat_leaves(params).items()
               if _splits(x)})),
           **{f"metric/{k}": np.asarray([float(v), float(rep[1][k])])
              for k, v in metrics.items()}}
    flat = fsdp.full_leaves(grads, keep=rank == 0)
    if rank == 0:
        out.update(flat_arrays(unflatten_like(grads, flat), "grad"))
        out.update(flat_arrays(rep[2], "rep_grad"))
    dist.barrier()
    return out


def _flat_leaves(tree, prefix="p"):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _splits(x):
    from repro_torch.sharding import tp
    return tp.splits(x)


def _model_shard_shape(x) -> list:
    """The shape of a split leaf as a tensor-parallel region uses it: the
    whole shape with its ``model``-split dim divided by the axis."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    i = mesh.mesh_dim_names.index("model")
    shape = list(x.shape)
    p = x.placements[i]
    assert isinstance(p, Shard)
    shape[p.dim] //= mesh.size(i)
    return shape


def _worker(job_dir, out_dir, tag):
    """One rank of the world of the mesh ``tag``: every case whose mesh it
    is, and on the FLOP meshes the FLOP cases."""
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
    for case in cases_on(shape):
        inputs = dict(np.load(pathlib.Path(job_dir) / f"{case}.npz"))
        rec = _case_on_rank(case, mesh, inputs, rank)
        out.update({f"{case}/{k}": v for k, v in rec.items()})
    dist.destroy_process_group()
    np.savez(pathlib.Path(out_dir) / f"{tag}_rank{rank}.npz", **out)


def cases_on(shape):
    return [c for c, (_, _, m) in CASES.items()
            if m == shape or (shape in FLOP_MESHES and c in FLOP_CASES)]


# ---------------------------------------------------------------------------
# The test process: inputs, the reference, the worlds
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _inputs(case):
    from test_torch_models import _batch_np, _params_np
    rc = ref_cfg(case)
    return {**flat_arrays(_params_np(rc), "params"),
            **_batch_np(rc, b=BATCH, s=SEQ, seed=9)}


@functools.lru_cache(maxsize=None)
def ref_loss_grads(case):
    """The reference's loss, metrics and ``jax.grad`` on the whole batch,
    as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model
    inputs = _inputs(case)
    rm = build_model(ref_cfg(case), compute_dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, nested_arrays(inputs, "params"))
    batch = {k: jnp.asarray(inputs[k]) for k in ("tokens", "embeds",
                                                 "frames") if k in inputs}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        rm.loss, has_aux=True))(params, batch)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            flat_arrays(jax.tree.map(np.asarray, grads), "grad"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    for case in CASES:
        np.savez(d / f"{case}.npz", **_inputs(case))
    meshes = sorted({m for _, _, m in CASES.values()} | set(FLOP_MESHES))
    argvs, envs = [], []
    for shape in meshes:
        n, port = math.prod(shape), free_port()
        for r in range(n):
            argvs.append(["tests/test_torch_tp.py", "worker", str(d), str(d),
                          _tag(shape)])
            envs.append(dict(REPRO_COORD_ADDR=f"127.0.0.1:{port}",
                             REPRO_NUM_PROCESSES=str(n),
                             REPRO_PROCESS_ID=str(r)))
    run_procs(argvs, envs, timeout=280)
    return {_tag(s): [dict(np.load(d / f"{_tag(s)}_rank{r}.npz"))
                      for r in range(math.prod(s))] for s in meshes}


# ---------------------------------------------------------------------------
# What each rank computes
# ---------------------------------------------------------------------------


def kv_heads_per_rank(cfg, m):
    """The kv heads a rank of a ``model`` of ``m`` computes (the most over
    the ranks), or None where the attention runs unsplit."""
    if (cfg.n_heads * cfg.resolved_head_dim) % m or cfg.n_heads % m:
        return None
    hq, rep = cfg.n_heads // m, cfg.n_heads // cfg.n_kv_heads
    return max((r * hq + hq - 1) // rep - (r * hq) // rep + 1
               for r in range(m))


def unsplit_flops(cfg, rows, m) -> float:
    """The forward-and-backward matmul FLOPs on ``rows`` rows that a rank
    of a ``model`` of ``m`` computes beyond its 1/m share of the
    replicated step's: the products that stay whole on every rank, each
    counted at (1 - 1/m) of its FLOPs --

    - kv heads that several ranks compute (attention cases (b), (c)):
      each rank's k and v products at its kv width, less their 1/m share;
    - the MoE router (float32, every token on every rank) and, under
      ``moe_mode="tp"``, the dispatch and combine products (each rank
      dispatches every token to every expert, at its hidden width);
    - the SSM's ``w_bc`` product and the scan's C.B^T scores, which every
      head shares;
    - ``frontend_proj`` (the VLM's patches, whisper's frames), which the
      rules keep whole over ``model``.

    A product counts 2 M K N forward and as much again for each operand
    that takes a gradient; under remat ``"dots"`` a batched product
    (``bmm``) runs its forward again in the backward."""
    d, s = cfg.d_model, SEQ
    t = rows * s
    keep = 1.0 - 1.0 / m
    again = 2 if cfg.plan.remat != "none" else 0
    extra = 0.0

    def attn_kv(tokens, src_tokens=None):
        hd = cfg.resolved_head_dim
        nkv = kv_heads_per_rank(cfg, m)
        if nkv is None:
            return 0.0
        src = tokens if src_tokens is None else src_tokens
        return 2 * 6 * src * d * hd * (nkv - cfg.n_kv_heads / m)

    if cfg.family in ("dense", "moe", "vlm"):
        tt = rows * (s + (cfg.frontend_tokens if cfg.frontend != "none"
                          else 0))
        extra += cfg.num_layers * attn_kv(tt)
        if cfg.frontend != "none":
            extra += keep * 4 * rows * cfg.frontend_tokens * d * d
        if cfg.is_moe:
            e, k = cfg.n_experts, cfg.top_k
            extra += keep * cfg.num_layers * 6 * tt * d * e
            if cfg.plan.moe_mode == "tp":
                import repro_torch.models.moe as moe
                cap = moe._capacity(tt, e, k)
                # dispatch (the tokens' gradient; run again under remat)
                # and combine (both operands; the block's last product,
                # which the recompute, stopping once it has the saved
                # tensors, does not reach)
                extra += keep * cfg.num_layers * (10 + again) * tt \
                    * e * cap * d
    if cfg.family in ("ssm", "hybrid"):
        ds, q = cfg.ssm_state, cfg.ssm_chunk
        per = 6 * t * d * 2 * ds + (6 + again) * rows * (s // q) * q * q \
            * ds
        extra += keep * cfg.num_layers * per
        if cfg.family == "hybrid":
            extra += (cfg.num_layers // cfg.hybrid_period) * attn_kv(t)
    if cfg.family == "encdec":
        extra += keep * 4 * rows * cfg.encoder_seq * d * d
    return extra


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


def _recs(runs, case, shape=None):
    return runs[_tag(shape or CASES[case][2])]


@pytest.mark.parametrize("case", list(CASES))
def test_tp_loss_and_grads_equal_the_replicated_port(runs, case):
    recs = _recs(runs, case)
    for r, rec in enumerate(recs):
        got, want = rec[f"{case}/loss"]
        np.testing.assert_allclose(got, want, **LOSS_F32,
                                   err_msg=f"rank {r}")
        for k in [k for k in rec if k.startswith(f"{case}/metric/")]:
            np.testing.assert_allclose(*rec[k], **LOSS_F32,
                                       err_msg=f"rank {r}: {k}")
        assert rec[f"{case}/picks_equal"], f"rank {r}: MoE picks differ"
        got, want = rec[f"{case}/logits"]
        np.testing.assert_allclose(got, want, **LOGITS_F32,
                                   err_msg=f"rank {r}: forward logits")
    rec = recs[0]
    keys = [k for k in rec if k.startswith(f"{case}/grad/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(
            rec[k], rec[k.replace("/grad/", "/rep_grad/")], **GRAD_F32,
            err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_loss_and_grads_equal_the_reference(runs, case):
    loss, metrics, grads = ref_loss_grads(case)
    for r, rec in enumerate(_recs(runs, case)):
        np.testing.assert_allclose(rec[f"{case}/loss"][0], loss,
                                   **LOSS_F32, err_msg=f"rank {r}")
        for k, v in metrics.items():
            np.testing.assert_allclose(rec[f"{case}/metric/{k}"][0], v,
                                       **LOSS_F32, err_msg=f"rank {r}: {k}")
    rec = _recs(runs, case)[0]
    for k, v in grads.items():
        np.testing.assert_allclose(rec[f"{case}/{k}"], v, **GRAD_F32,
                                   err_msg=k)


def _operands(rec, case):
    """The operand shapes of the rank's products, each also transposed in
    its last two dims (a backward's operands): ``mm``'s 2-D ones and
    ``bmm``'s 3-D ones."""
    tp_rec, _ = json.loads(str(rec[f"{case}/products"]))
    shapes = set()
    for _, a, b in tp_rec:
        for x in (a, b):
            shapes.add(tuple(x))
            shapes.add(tuple(x[:-2]) + (x[-1], x[-2]))
    return shapes


# leaves that enter no product at their local shard's width: the table of
# an untied vocabulary is looked up, the convolutions are shifted adds;
# w_zx (its z and x columns of this rank's heads) and the kv projections
# of cases (b) and (c) (whole heads) have their own checks
NOT_PRODUCTS = ("embed", "conv_x", "dt_bias", "A_log", "D", "gate_norm",
                "b1", "bq", "bk", "bv", "x_bq", "x_bk", "x_bv")


def _checked_leaves(cfg, m, local):
    """(name, whole 2-D shape, local 2-D shape) of each leaf the rules
    split over ``model`` that enters a product at its shard's width."""
    from repro_torch.models import build_model
    from repro_torch._tree import leaves_with_paths
    specs = {"/".join(p): s for p, s in leaves_with_paths(
        build_model(cfg, device="meta").specs())}
    nkv = kv_heads_per_rank(cfg, m)
    # the 2-D shapes that legitimately enter products: the leaves the
    # rules keep whole over ``model`` and the split leaves' shards.  A
    # split leaf's whole shape that equals one of them (a 64 x 64 wq and
    # frontend_proj) may show in a product without its leaf, so only its
    # shard's presence is checked
    whole_2d = {tuple(s.shape[-2:]) for k, s in specs.items()
                if k not in local and len(s.shape) >= 2}
    whole_2d |= {tuple(v[-2:]) for v in local.values() if len(v) >= 2}
    whole_2d |= {w[::-1] for w in whole_2d}
    out = []
    for name, shape in local.items():
        leaf = name.split("/")[-1]
        whole = specs[name].shape
        if leaf in NOT_PRODUCTS and not (leaf == "embed"
                                         and cfg.tie_embeddings):
            continue
        if leaf in ("wk", "wv", "x_wk", "x_wv") and (
                nkv is None or nkv * m != cfg.n_kv_heads):
            continue                      # cases (b), (c): whole heads
        whole = tuple(whole[-3:] if leaf.startswith("moe_")
                      else whole[-2:])
        out.append((name, None if whole in whole_2d else whole,
                    tuple(shape[-3:] if leaf.startswith("moe_")
                          else shape[-2:])))
    return out


@pytest.mark.parametrize("shape", FLOP_MESHES, ids=_tag)
@pytest.mark.parametrize("case", FLOP_CASES)
def test_split_weights_enter_products_at_local_width(runs, case, shape):
    cfg = port_cfg(case)
    m = shape[1]
    for r, rec in enumerate(runs[_tag(shape)]):
        local = json.loads(str(rec[f"{case}/local"]))
        ops = _operands(rec, case)
        checked = _checked_leaves(cfg, m, local)
        assert checked, case
        for name, whole, loc in checked:
            assert loc in ops, f"rank {r}: {name} {loc} not in a product"
            assert whole is None or whole not in ops, \
                f"rank {r}: {name} {whole} whole"
        if cfg.family in ("ssm", "hybrid"):
            # w_zx: the z and x columns of this rank's heads, packed
            zx = (cfg.d_model, 2 * cfg.ssm_d_inner // m)
            assert zx in ops and (cfg.d_model, 2 * cfg.ssm_d_inner) \
                not in ops
        nkv = kv_heads_per_rank(cfg, m)
        if cfg.n_heads and nkv is not None:
            hd = cfg.resolved_head_dim
            assert (cfg.d_model, nkv * hd) in ops


@pytest.mark.parametrize("shape", FLOP_MESHES, ids=_tag)
@pytest.mark.parametrize("case", FLOP_CASES)
def test_rank_flops_split_over_model(runs, case, shape):
    """Each rank's matmul FLOPs (the recorder's and FlopCounterMode's) are
    its replicated step's on the same rows divided by ``model``, plus the
    products that stay whole (:func:`unsplit_flops`), within 5 %."""
    cfg = port_cfg(case)
    m = shape[1]
    rows = BATCH // shape[0]
    for r, rec in enumerate(runs[_tag(shape)]):
        got, rep = rec[f"{case}/flops"]
        tp_rec, rep_rec = json.loads(str(rec[f"{case}/products"]))
        assert product_flops(tp_rec) == got and \
            product_flops(rep_rec) == rep
        want = rep / m + unsplit_flops(cfg, rows, m)
        assert abs(got - want) <= FLOP_BAND * want, \
            f"rank {r}: {got:.4g} FLOPs, want {want:.4g} ({rep:.4g} whole)"
        assert got < rep


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_row_part_and_its_gradients_against_the_product(device):
    """``tp.row``, a rank's part of a row-parallel product, against
    ``a @ w`` on the same bfloat16 operands: on the card the float32 part
    (``mm(out_dtype=float32)``) and its gradients in the operands' dtype,
    as autograd gives them for ``a @ w`` at the bfloat16 cotangent; on
    the CPU ``a @ w`` itself."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    from repro_torch.sharding import tp
    g = torch.Generator().manual_seed(11)
    a, w = (torch.randn(*sh, generator=g).to(device=device,
                                              dtype=torch.bfloat16)
            for sh in ((2, 24, 256), (256, 48)))
    gr = torch.randn(2, 24, 48, generator=g).to(device)
    a1, w1 = a.clone().requires_grad_(True), w.clone().requires_grad_(True)
    a2, w2 = a.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ax = tp.Axis(None, 2, 0)                 # the part needs no group
    got = tp.row(a1, w1, ax)
    want = a2 @ w2
    if device == "cpu":
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    else:
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, a.float() @ w.float(), rtol=1e-5,
                                   atol=1e-4)
    ga = torch.autograd.grad(got, (a1, w1), gr.to(got.dtype))
    gw = torch.autograd.grad(want, (a2, w2), gr.to(want.dtype))
    for x, y in zip(ga, gw):
        assert x.dtype == torch.bfloat16
        torch.testing.assert_close(x, y)


if __name__ == "__main__":
    # rank entry point of the module fixture:
    #   python tests/test_torch_tp.py worker <job_dir> <out_dir> <mesh>
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    {"worker": _worker}[sys.argv[1]](*sys.argv[2:])
