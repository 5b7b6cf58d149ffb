"""Decoder-only LM, the dense, MoE, SSM, hybrid and VLM families: the port
of ``repro.models.transformer``.

Parameters are stacked over layers, as the reference stores them (the
hybrid family over (n_chunks, period) with one ``shared`` attention+MLP
block), and the trunk is a Python loop over the layer axis.  The prefill
runs the port's kernels through ``kernels.ops``: ``flash_attention`` for
full-sequence attention and, in ``models/ssd.py``, ``ssd_scan`` for every
Mamba-2 layer -- the hand-written CUDA kernels on the card, their plain
versions on the CPU.  Decoding keeps the cache (K/V, or the SSM and conv
state) in a dict of tensors that ``lm_decode_step`` updates in place, and
the decode position ``cache["cur"]`` is a Python int, so no index waits
on the device.

The MoE family (olmoe-1b-7b, mixtral-8x22b) replaces the dense FFN by
``models/moe.py``'s capacity-dispatch layer, whose router aux loss the
trunk sums over the layers; its decode step runs every expert
(``moe_ffn_decode``).  The VLM family (phi-3-vision-4.2b) prepends its
``frontend_tokens`` image embeddings, projected by ``frontend_proj``, to
the token embeddings: positions run over both, and the loss skips the
frontend positions.  The enc-dec family (whisper-medium) is
``models/encdec.py``.

Training: ``lm_loss`` is the reference's next-token cross-entropy with
its z-loss and ``AUX_LOSS_WEIGHT`` times the aux loss, in float32;
``lm_forward`` returns the logits and the aux loss (a float32 0 for
every family but MoE).  ``lm_trunk`` honours ``cfg.plan.remat`` with
``torch.utils.checkpoint`` per layer, as the reference's
``jax.checkpoint`` policies do: ``"none"`` saves every activation,
``"full"`` recomputes the whole layer in the backward, and ``"dots"``
saves the outputs of the matrix products that have no batch dimension
(the projections, the dense MLP and the MoE router: ``aten.mm``) and
recomputes the rest -- attention, and the MoE's dispatch, expert and
combine products, which are batched (``aten.bmm``), as the reference's
``dots_with_no_batch_dims_saveable`` recomputes them.  So with
``"dots"`` or ``"full"`` the attention forward runs twice per training
step.  Remat moves memory, never the numbers.

Sharded parameters (DTensors placed by the sharding rules,
``sharding/fsdp.py``) are gathered where they are used: a layer's
leaves inside each block -- so under ``"dots"`` or ``"full"`` the
backward gathers them again, as FSDP reshards after the forward, while
``"none"`` keeps every layer's gathered leaves until the backward --,
the hybrid's shared block once per forward, the embeddings,
``frontend_proj``, ``final_norm`` and the head where they are applied.
Where the rules split a block's leaves over ``model`` (``fsdp_tp`` on a
mesh whose ``model`` axis is wider than 1), the block gathers them over
the other mesh dims only and computes on this rank's shards
(``sharding/tp.py``): the attention on its heads (``attn_weights``: the
four cases of how ``q_feat`` and ``kv_feat`` split), the MLP on its
hidden columns, the Mamba-2 block on its heads (``ssd.ssd_weights``),
the MoE on its experts or hidden columns (``moe.moe_weights``), the
embedding and the head on its rows of the vocabulary, and the loss's
logsumexp over the ranks' columns.  Under ``"dots"`` each block is
checkpointed alone and the sums over ``model`` run outside them, so the
backward's recompute repeats no forward sum; ``"full"`` recomputes the
whole layer, its sums too.  The decode step computes on the same shards,
against a cache laid out by ``train.step.cache_pspecs`` (K/V over
``model`` by kv heads or by positions, the SSM state by heads, the conv
state by channels; :func:`lm_decode_step`).
``shard`` is called where the reference calls it, with its specs.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
from torch.utils import checkpoint as ckpt_lib

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.layers import ParamSpec, TensorSpec, apply_rope, \
    gated_mlp, rmsnorm, shard
from repro_torch.sharding import fsdp, tp

PORTED = ("dense", "moe", "ssm", "hybrid", "vlm")  # the decoder-only ones
AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4
REMAT_POLICIES = ("none", "dots", "full")


def check_family(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a family this module does not build: the
    enc-dec family is ``models/encdec.py``'s."""
    if cfg.family not in PORTED:
        raise ValueError(
            f"{cfg.name}: the {cfg.family!r} family is not a decoder-only "
            f"LM; this module builds the {', '.join(PORTED)} families")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def attn_specs(cfg: ArchConfig, lead: tuple, dtype) -> dict:
    d = cfg.d_model
    h = cfg.resolved_head_dim
    qf, kf = cfg.n_heads * h, cfg.n_kv_heads * h
    lax_ = tuple("layers" for _ in lead)
    sp = {
        "wq": ParamSpec(lead + (d, qf), lax_ + ("embed", "q_feat"), dtype),
        "wk": ParamSpec(lead + (d, kf), lax_ + ("embed", "kv_feat"), dtype),
        "wv": ParamSpec(lead + (d, kf), lax_ + ("embed", "kv_feat"), dtype),
        "wo": ParamSpec(lead + (qf, d), lax_ + ("q_feat", "embed"), dtype),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec(lead + (qf,), lax_ + ("q_feat",), dtype, "zeros")
        sp["bk"] = ParamSpec(lead + (kf,), lax_ + ("kv_feat",), dtype,
                             "zeros")
        sp["bv"] = ParamSpec(lead + (kf,), lax_ + ("kv_feat",), dtype,
                             "zeros")
    return sp


def dense_ffn_specs(cfg: ArchConfig, lead: tuple, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    lax_ = tuple("layers" for _ in lead)
    return {
        "wi": ParamSpec(lead + (d, f), lax_ + ("embed", "mlp"), dtype),
        "wg": ParamSpec(lead + (d, f), lax_ + ("embed", "mlp"), dtype),
        "wo_mlp": ParamSpec(lead + (f, d), lax_ + ("mlp", "embed"), dtype),
    }


def lm_specs(cfg: ArchConfig, dtype=torch.float32) -> dict:
    check_family(cfg)
    d = cfg.d_model
    specs: dict = {
        "embed": ParamSpec((cfg.padded_vocab, d), ("vocab", "embed"), dtype),
        "final_norm": ParamSpec((d,), (None,), dtype, "ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, cfg.padded_vocab),
                                     ("embed", "vocab"), dtype)
    if cfg.frontend != "none":
        # stub adapter: precomputed patch/frame embeddings -> model space
        specs["frontend_proj"] = ParamSpec((d, d), ("embed", None), dtype)
    L = (cfg.num_layers,)
    if cfg.family == "ssm":
        specs["layers"] = {
            "ln1": ParamSpec(L + (d,), ("layers", None), dtype, "ones"),
            **ssd_lib.ssd_specs(cfg, cfg.num_layers, dtype),
        }
        return specs
    if cfg.family == "hybrid":
        lead = (cfg.num_layers // cfg.hybrid_period, cfg.hybrid_period)
        specs["layers"] = {
            "ln1": ParamSpec(lead + (d,), ("layers", "layers", None), dtype,
                             "ones"),
            **{k: ParamSpec(lead + s.shape[1:], ("layers",) + s.axes,
                            s.dtype, s.init)
               for k, s in ssd_lib.ssd_specs(cfg, cfg.hybrid_period,
                                             dtype).items()},
        }
        # one attention+MLP block, shared by every chunk
        specs["shared"] = {
            "ln1": ParamSpec((d,), (None,), dtype, "ones"),
            "ln2": ParamSpec((d,), (None,), dtype, "ones"),
            **attn_specs(cfg, (), dtype),
            **dense_ffn_specs(cfg, (), dtype),
        }
        return specs
    specs["layers"] = {
        "ln1": ParamSpec(L + (d,), ("layers", None), dtype, "ones"),
        "ln2": ParamSpec(L + (d,), ("layers", None), dtype, "ones"),
        **attn_specs(cfg, L, dtype),
        **(moe_lib.moe_specs(cfg, cfg.num_layers, dtype) if cfg.is_moe
           else dense_ffn_specs(cfg, L, dtype)),
    }
    return specs


# ---------------------------------------------------------------------------
# A layer's leaves as its blocks use them (tensor parallelism)
# ---------------------------------------------------------------------------


class Heads(NamedTuple):
    """The attention heads a block computes: ``q`` query heads and the
    ``kv`` kv heads they read; ``kv_idx`` (one kv head per query head)
    where this rank's query heads do not read its kv heads in GQA groups
    of one size."""

    q: int
    kv: int
    kv_idx: Optional[tuple] = None


def attn_weights(cfg, lp, dtype, prefix: str = "") -> dict:
    """The attention leaves ``prefix + (wq, wk, wv, wo[, bq, bk, bv])`` of
    ``lp`` in ``dtype`` as :func:`attn_block` takes them, under the keys
    without the prefix, with ``"tp"`` (the axis or None) and ``"heads"``.

    Split over ``model`` (``wq`` split by the rules into whole query
    heads: not so under case (d), where ``q_feat`` is replicated, or where
    the query heads do not divide over ``model``, and the block then runs
    unsplit on whole leaves), a rank computes ``n_heads / m``
    query heads (its ``wq``/``bq`` columns and ``wo`` rows) and the kv
    heads they read, kv heads ``lo`` to ``hi``:
    (a) where ``n_kv_heads`` divides over ``model`` its ``wk``/``wv``
    shards are those heads; (b) where ``kv_feat`` divides but the heads
    do not (a shard would hold part of a head), and (c) where the rules
    replicate ``kv_feat``, it takes ``wk``/``wv`` whole (``tp.whole``,
    their gradient summed over ``model``) and cuts the columns of heads
    ``lo:hi``, so a kv head that several ranks read is computed on each
    of them."""
    names = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv")
                                        if cfg.qkv_bias else ())
    ax = tp.axis_of(lp[prefix + "wq"])
    if ax is None or cfg.n_heads % ax.size:
        out = {k: fsdp.gather(lp[prefix + k], dtype) for k in names}
        return {**out, "tp": None,
                "heads": Heads(cfg.n_heads, cfg.n_kv_heads)}
    hd = cfg.resolved_head_dim
    lo, heads = rank_heads(cfg, ax.size, ax.rank)
    kv_local = tp.splits(lp[prefix + "wk"]) and \
        cfg.n_kv_heads % ax.size == 0                       # case (a)
    out = {}
    for k in names:
        leaf = lp[prefix + k]
        if k in ("wk", "wv", "bk", "bv") and not kv_local:  # (b), (c)
            out[k] = tp.whole(leaf, dtype, ax).narrow(-1, lo * hd,
                                                      heads.kv * hd)
        else:
            out[k] = tp.local(leaf, dtype)
    return {**out, "tp": ax, "heads": heads}


def rank_heads(cfg, m: int, rank: int) -> tuple:
    """(the first kv head, ``Heads``) that rank ``rank`` of a ``model``
    axis of ``m`` computes: its ``n_heads / m`` query heads and the kv
    heads ``lo`` to ``hi`` they read (GQA), with ``kv_idx`` where its
    query heads do not read them in groups of one size."""
    hq = cfg.n_heads // m
    rep = cfg.n_heads // cfg.n_kv_heads
    first = rank * hq
    lo, hi = first // rep, (first + hq - 1) // rep + 1
    kv_of = tuple((first + j) // rep - lo for j in range(hq))
    nkv = hi - lo
    whole_groups = hq % nkv == 0 and all(
        kv == j // (hq // nkv) for j, kv in enumerate(kv_of))
    return lo, Heads(hq, nkv, None if whole_groups else kv_of)


def mlp_weights(lp, dtype, names=("wi", "wg", "wo_mlp")) -> dict:
    """The MLP leaves ``names`` of ``lp`` in ``dtype``, each rank's
    hidden columns (rows of the output product) where the MLP splits over
    ``model``, with ``"tp"``."""
    ax = tp.axis_of(lp[names[0]])
    get = tp.local if ax is not None else fsdp.gather
    return {**{k: get(lp[k], dtype) for k in names}, "tp": ax}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _qkv(cfg, lp, x):
    h = cfg.resolved_head_dim
    heads = lp.get("heads") or Heads(cfg.n_heads, cfg.n_kv_heads)
    q, k, v = x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    lead = x.shape[:-1]
    q = q.reshape(lead + (heads.q, h))
    k = k.reshape(lead + (heads.kv, h))
    v = v.reshape(lead + (heads.kv, h))
    if heads.kv_idx is not None:
        idx = torch.tensor(heads.kv_idx, device=x.device)
        k, v = k.index_select(-2, idx), v.index_select(-2, idx)
    return q, k, v


def attn_block(cfg, lp, x, positions, *, window: int):
    """Full-sequence causal attention (prefill). Returns (out, k, v).
    With leaves split over ``model`` (``attn_weights``), the heads are
    this rank's and ``out`` is its part of the output product: the caller
    sums it over the axis (``tp.g``)."""
    q, k, v = _qkv(cfg, lp, tp.f(x, lp.get("tp")))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", None, "heads", None)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    b, s = x.shape[:2]
    out = out.reshape(b, s, q.shape[2] * cfg.resolved_head_dim)
    return tp.row(out, lp["wo"], lp.get("tp")), k, v


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def mlp_block(cfg, lp, x):
    """The FFN: (out, aux) -- the MoE layer and its router aux loss, or
    the dense SwiGLU and a float32 0.  Split over ``model`` (``lp["tp"]``)
    ``out`` is this rank's part, which the caller sums (``tp.g``)."""
    if cfg.is_moe:
        return moe_lib.moe_ffn(cfg, lp, x)
    return gated_mlp(x, lp["wi"], lp["wg"], lp["wo_mlp"], lp.get("tp")), \
        _zero(x)


def _cast(tree: dict, dtype) -> dict:
    """A (nested) dict of parameters, each gathered whole
    (``fsdp.gather``: the identity on a plain tensor) and cast to
    ``dtype``."""
    return {k: _cast(p, dtype) if isinstance(p, dict)
            else fsdp.gather(p, dtype) for k, p in tree.items()}


def _attn_part(cfg, x, lp, positions):
    """A layer's attention on its leaves ``lp``: (out, axis), ``out`` this
    rank's part where it splits over the ``model`` axis, else None."""
    h = rmsnorm(x, fsdp.gather(lp["ln1"], x.dtype), cfg.norm_eps)
    w = attn_weights(cfg, lp, x.dtype)
    a, _, _ = attn_block(cfg, w, h, positions, window=cfg.sliding_window)
    return a, w["tp"]


def _ffn_part(cfg, x, lp):
    """A layer's FFN on its leaves ``lp``: (out, aux, axis), ``out`` this
    rank's part where it splits over the ``model`` axis, else None."""
    h = rmsnorm(x, fsdp.gather(lp["ln2"], x.dtype), cfg.norm_eps)
    w = moe_lib.moe_weights(lp, x.dtype) if cfg.is_moe \
        else mlp_weights(lp, x.dtype)
    return (*mlp_block(cfg, w, h), w["tp"])


def _ssd_part(cfg, x, lp):
    """A Mamba-2 layer on its leaves ``lp``: (out, axis), ``out`` this
    rank's part where it splits over the ``model`` axis, else None."""
    h = rmsnorm(x, fsdp.gather(lp["ln1"], x.dtype), cfg.norm_eps)
    w = ssd_lib.ssd_weights(cfg, lp, x.dtype)
    return ssd_lib.ssd_block(cfg, w, h, cfg.norm_eps), w["tp"]


def _layer(cfg, x, lp, positions, seg=None):
    """One layer: (x, aux).  Each block gathers its leaves inside itself
    (mixed precision: params stored f32, computed in x.dtype) and, split
    over ``model``, returns its partial output and the axis, over which
    ``tp.g`` sums it outside the block: ``seg`` (the remat of ``"dots"``
    under tensor parallelism) wraps each block, so the recompute in the
    backward re-runs no ``g``."""
    seg = seg or (lambda fn: fn)
    if cfg.family in ("ssm", "hybrid"):  # hybrid inner layers are Mamba-2
        m, ax = seg(functools.partial(_ssd_part, cfg))(x, lp)
        return x + tp.g(m, ax, x.dtype), _zero(x)
    a, ax = seg(functools.partial(_attn_part, cfg))(x, lp, positions)
    x = x + tp.g(a, ax, x.dtype)
    m, aux, ax = seg(functools.partial(_ffn_part, cfg))(x, lp)
    return x + tp.g(m, ax, x.dtype), aux


def shared_weights(cfg, sp, dtype) -> dict:
    """The hybrid family's shared block's leaves as
    :func:`shared_block` applies them: gathered (each rank's ``model``
    shards where they split) once per forward, as every chunk applies
    the same block."""
    return {"ln1": fsdp.gather(sp["ln1"], dtype),
            "ln2": fsdp.gather(sp["ln2"], dtype),
            "attn": attn_weights(cfg, sp, dtype),
            "mlp": mlp_weights(sp, dtype)}


def _shared_apply(cfg, w, x, positions, window):
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    a, _, _ = attn_block(cfg, w["attn"], h, positions, window=window)
    x = x + tp.g(a, w["attn"]["tp"], x.dtype)
    m, _ = mlp_block(cfg, w["mlp"], rmsnorm(x, w["ln2"], cfg.norm_eps))
    return x + tp.g(m, w["mlp"]["tp"], x.dtype)


def shared_block(cfg, sp, x, positions, window):
    """The hybrid family's shared attention+MLP block."""
    return _shared_apply(cfg, shared_weights(cfg, sp, x.dtype), x,
                         positions, window)


def _layer_params(params, *idx) -> dict:
    """One layer's parameters: index ``(i,)``, or ``(chunk, j)`` of the
    hybrid family's (n_chunks, period) stack."""
    return {k: fsdp.layer_slice(p, *idx)
            for k, p in params["layers"].items()}


# ---------------------------------------------------------------------------
# Forward (prefill trunk)
# ---------------------------------------------------------------------------


def _lookup(emb, tokens, dtype):
    """Rows ``tokens`` of the embedding table ``emb`` in ``dtype``: with
    rows split over ``model``, each rank's rows looked up and summed
    (``tp.vocab_lookup``); else gathered, then looked up -- the values of
    casting the table first, without a cast copy of the whole
    vocabulary."""
    ax = tp.model_axis(emb) if tp.splits(emb, 0) else None
    if ax is not None:
        return tp.vocab_lookup(tp.local(emb, dtype), tokens, ax)
    if fsdp.is_plain(emb):
        return emb[tokens].to(dtype)
    return fsdp.gather(emb, dtype)[tokens]


def embed_tokens(cfg, params, tokens, extra_embeds, dtype):
    """The token embeddings, and for a frontend (the VLM's image patches)
    ``frontend_proj`` of ``extra_embeds`` (B, frontend_tokens, D) in
    front of them."""
    x = _lookup(params["embed"], tokens, dtype)
    if cfg.frontend == "none":
        return x
    if extra_embeds is None:
        raise ValueError(f"{cfg.name} takes its {cfg.frontend_tokens} "
                         "frontend embeddings with the tokens")
    fe = extra_embeds.to(dtype) @ fsdp.gather(params["frontend_proj"],
                                              dtype)
    return torch.cat([fe, x], dim=1)


# the weight products "dots" saves: aten.mm, and its float32-output form
# (a tensor-parallel row product's part, ``tp.row``)
_WEIGHT_PRODUCTS = tuple(op for op in (torch.ops.aten.mm.default,
                                       getattr(torch.ops.aten.mm, "dtype",
                                               None)) if op is not None)


def _dots_policy(ctx, func, *args, **kwargs):
    """Save what the reference's ``dots_with_no_batch_dims_saveable``
    saves: products without a batch dimension (``aten.mm``, which every
    2-D weight product becomes), and recompute everything else."""
    if func in _WEIGHT_PRODUCTS:
        return ckpt_lib.CheckpointPolicy.MUST_SAVE
    return ckpt_lib.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` under the activation-checkpoint policy (see the module
    docstring); the identity where no gradient is recorded."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r} is not one of "
                         f"{REMAT_POLICIES}")
    if policy == "none":
        return fn
    context_fn = (functools.partial(
        ckpt_lib.create_selective_checkpoint_contexts, _dots_policy)
        if policy == "dots" else ckpt_lib.noop_context_fn)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt_lib.checkpoint(fn, *args, use_reentrant=False,
                                   context_fn=context_fn)
    return wrapped


def _layer_fn(cfg, layers: dict):
    """The layer under ``cfg.plan.remat``: the whole layer checkpointed,
    or under ``"dots"`` with leaves split over ``model``, each block
    (``_layer``'s ``seg``), so the ``g`` sums are saved, not re-run."""
    if cfg.plan.remat == "dots" and tp.active(layers):
        return functools.partial(
            _layer, cfg, seg=lambda fn: _remat(fn, "dots"))
    return _remat(functools.partial(_layer, cfg), cfg.plan.remat)


def lm_trunk(cfg: ArchConfig, params, x, positions, *,
             unroll: bool = False):
    """Embeddings -> final norm. x: (B,S,D).  Returns (x, the aux loss
    summed over the layers).  Each layer (each Mamba-2 layer of the
    hybrid family, as in the reference) runs under ``cfg.plan.remat``.
    ``unroll`` (the reference's layer-scan unroll) is accepted and has
    no effect: the layer loop runs eagerly, as unrolled."""
    layer = _layer_fn(cfg, params["layers"])
    # one unbind per stacked leaf: its backward stacks the layers'
    # gradients once, where indexing layer by layer would add a
    # zero-filled copy of the whole stack per layer
    stacks = {k: fsdp.unstack(p) for k, p in params["layers"].items()}
    aux = _zero(x)
    if cfg.family == "hybrid":
        # gathered once: every chunk applies the same block
        shared = shared_weights(cfg, params["shared"], x.dtype)
        for c in range(cfg.num_layers // cfg.hybrid_period):
            x = _shared_apply(cfg, shared, x, positions, cfg.sliding_window)
            chunk = {k: fsdp.unstack(v[c]) for k, v in stacks.items()}
            for j in range(cfg.hybrid_period):
                x, a = layer(x, {k: v[j] for k, v in chunk.items()},
                             positions)
                aux = aux + a
    else:
        for i in range(cfg.num_layers):
            x, a = layer(x, {k: v[i] for k, v in stacks.items()}, positions)
            aux = aux + a
    return rmsnorm(x, fsdp.gather(params["final_norm"]), cfg.norm_eps), aux


def vocab_logits(cfg, table, x, *, tied: bool):
    """(logits, axis): ``x`` against the (un)embedding leaf ``table`` --
    (V, D) when ``tied``, else (D, V) -- with the padded columns at
    -1e30.  With the vocabulary split over ``model``, the logits are this
    rank's columns (masked by their global index) and the axis is
    returned; else all of them, and None."""
    dtype = x.dtype
    ax = tp.model_axis(table) if tp.splits(table, 0 if tied else 1) \
        else None
    w = tp.local(table, dtype) if ax is not None \
        else fsdp.gather(table, dtype)
    logits = tp.f(x, ax) @ (w.T if tied else w)
    logits = shard(logits, "batch", None, "vocab")
    n = logits.shape[-1]
    lo = ax.rank * n if ax is not None else 0
    if lo + n > cfg.vocab_size:
        logits[..., max(cfg.vocab_size - lo, 0):] = -1e30  # fresh: in place
    return logits, ax


def _table(cfg, params):
    return (params["embed"], True) if cfg.tie_embeddings \
        else (params["unembed"], False)


def lm_logits(cfg, params, x):
    """(B, S, V) logits of ``x``: with the vocabulary split over
    ``model``, each rank's columns, gathered."""
    table, tied = _table(cfg, params)
    logits, ax = vocab_logits(cfg, table, x, tied=tied)
    return tp.gather_last(logits, ax)


def _hidden(cfg, params, tokens, extra_embeds, dtype):
    x = embed_tokens(cfg, params, tokens, extra_embeds, dtype)
    x = shard(x, "batch", None, None)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    return lm_trunk(cfg, params, x, positions)


def lm_forward(cfg, params, tokens, extra_embeds=None, *,
               dtype=torch.bfloat16, unroll=False, last_only=False):
    """Returns (logits (B, S, V) -- (B, 1, V) with ``last_only`` --, aux
    loss): the MoE router's summed over the layers, a float32 0 for the
    other families.  The VLM's S counts its frontend positions.
    ``unroll`` is accepted and has no effect (:func:`lm_trunk`)."""
    x, aux = _hidden(cfg, params, tokens, extra_embeds, dtype)
    if last_only:
        # serving prefill wants only the next-token distribution: slice
        # BEFORE the unembed so the (B, S, V) logits never materialise.
        x = x[:, -1:, :]
    return lm_logits(cfg, params, x), aux


def next_token_ce(logits, targets, ax):
    """(ce, logz) of float32 ``logits`` (B, S, V or this rank's columns
    of V over ``ax``) against ``targets`` (B, S): the mean of logz less
    the target's logit, and logz."""
    logz = tp.vocab_logsumexp(logits, ax)
    tgt = tp.vocab_pick(logits, targets, ax)
    return torch.mean(logz - tgt), logz


def lm_loss(cfg, params, batch, *, dtype=torch.bfloat16, unroll=False):
    """Next-token CE (+ z-loss + aux), in float32.  batch: tokens (B, S)
    and, for the VLM, embeds (B, frontend_tokens, D), whose positions
    the loss skips.  Returns (loss, {"ce", "zloss", "aux"}), each a 0-d
    tensor.  With the vocabulary split over ``model`` the logsumexp and
    the target's logit are taken over the ranks' columns
    (``tp.vocab_logsumexp``, ``tp.vocab_pick``), and no rank holds all
    the logits.  ``unroll`` is accepted and has no effect."""
    tokens = batch["tokens"]
    x, aux = _hidden(cfg, params, tokens, batch.get("embeds"), dtype)
    table, tied = _table(cfg, params)
    logits, ax = vocab_logits(cfg, table, x, tied=tied)
    n_front = cfg.frontend_tokens if cfg.frontend != "none" else 0
    logits = logits[:, n_front:, :]
    # shift: predict tokens[:, 1:]
    ce, logz = next_token_ce(logits[:, :-1].float(), tokens[:, 1:].long(),
                             ax)
    zloss = torch.mean(logz ** 2)
    loss = ce + Z_LOSS_WEIGHT * zloss + AUX_LOSS_WEIGHT * aux
    return loss, {"ce": ce, "zloss": zloss, "aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.sliding_window and seq_len > cfg.sliding_window:
        return cfg.sliding_window  # ring buffer
    return seq_len


def init_cache_specs(cfg: ArchConfig, batch: int, seq_len: int, dtype):
    """Tensor shapes of the decode cache at total context ``seq_len``: the
    KV cache, the SSM and conv state, or both (hybrid: K/V per chunk).
    The decode position ``cur`` is a Python int beside them, not a
    tensor."""
    check_family(cfg)
    if cfg.family == "ssm":
        return ssd_lib.ssd_decode_state_specs(cfg, cfg.num_layers, batch,
                                              dtype)
    h = cfg.resolved_head_dim
    sc = cache_len_for(cfg, seq_len)
    specs = {}
    n_kv = cfg.num_layers
    if cfg.family == "hybrid":
        specs.update(ssd_lib.ssd_decode_state_specs(cfg, cfg.num_layers,
                                                    batch, dtype))
        n_kv = cfg.num_layers // cfg.hybrid_period
    kv = TensorSpec((n_kv, batch, sc, cfg.n_kv_heads, h), dtype)
    specs.update(k=kv, v=kv, pos_buf=TensorSpec((sc,), torch.int32))
    return specs


def cache_of(specs: dict, device) -> dict:
    """A decode cache of TensorSpecs: zero tensors, ``pos_buf`` all -1
    (the empty sentinel), ``cur`` 0."""
    cache = {k: torch.full(s.shape, -1, dtype=s.dtype, device=device)
             if not s.dtype.is_floating_point
             else torch.zeros(s.shape, dtype=s.dtype, device=device)
             for k, s in specs.items()}
    cache["cur"] = 0
    return cache


def init_cache(cfg, batch, seq_len, dtype, device):
    """Zero K/V, ``pos_buf`` all -1 (the empty sentinel), ``cur`` 0."""
    return cache_of(init_cache_specs(cfg, batch, seq_len, dtype), device)


def decode_attn_weights(cfg, lp, dtype, prefix: str = "") -> dict:
    """The attention leaves ``prefix + (wq, wk, wv, wo[, bq, bk, bv])`` of
    ``lp`` in ``dtype`` as the decode step takes them, under the keys
    without the prefix: the query side (``wq``, ``bq``, ``wo``) as
    :func:`attn_weights` splits it -- this rank's query heads where they
    split over ``model``, ``"tp"`` the axis (else whole, None) -- and the
    kv side as the rules place it over ``model`` (``tp.local``): this
    rank's ``kv_feat`` columns where they split, ``"kv_tp"`` their axis,
    else whole.  No leaf is gathered over ``model``: where a rank needs
    every kv head, it gathers the token's K/V (:func:`_decode_kv`)."""
    ax = tp.axis_of(lp[prefix + "wq"])
    if ax is not None and cfg.n_heads % ax.size:
        ax = None
    bias = cfg.qkv_bias
    get = tp.local if ax is not None else fsdp.gather
    out = {k: get(lp[prefix + k], dtype)
           for k in ("wq", "wo") + (("bq",) if bias else ())}
    out.update({k: tp.local(lp[prefix + k], dtype)
                for k in ("wk", "wv") + (("bk", "bv") if bias else ())})
    return {**out, "tp": ax, "kv_tp": tp.axis_of(lp[prefix + "wk"])}


def _decode_q(cfg, w, x):
    """The token's queries (B, heads, hd): this rank's query heads where
    ``w["tp"]`` splits them."""
    q = x @ w["wq"]
    if cfg.qkv_bias:
        q = q + w["bq"]
    return q.reshape(x.shape[0], -1, cfg.resolved_head_dim)


def _decode_kv(cfg, w, x, split):
    """The token's k and v (B, heads, hd): this rank's kv heads where the
    cache splits over ``model`` by heads, else every kv head -- this
    rank's ``kv_feat`` columns gathered over ``model`` where they split
    (``tp.gather_last`` of (B, Hkv * hd) activations)."""
    k, v = x @ w["wk"], x @ w["wv"]
    if cfg.qkv_bias:
        k, v = k + w["bk"], v + w["bv"]
    if split != "heads":
        k, v = tp.gather_last(k, w["kv_tp"]), tp.gather_last(v, w["kv_tp"])
    b, h = x.shape[0], cfg.resolved_head_dim
    return k.reshape(b, -1, h), v.reshape(b, -1, h)


def cache_split(cfg, ax, cache, n_pos: int):
    """How ``cache_pspecs`` lays a K/V cache of ``n_pos`` positions over
    the ``model`` axis ``ax`` (``tp.kv_split``): ``"heads"``, ``"seq"``
    or None (whole, as without an axis); raises ``ValueError`` where the
    rank's ``cache`` (B, S, Hkv, hd) is not that shard."""
    m = ax.size if ax is not None else 1
    split = tp.kv_split(cfg.plan.decode_kv_shard, m, cfg.n_kv_heads,
                        n_pos) if ax is not None else None
    want = (n_pos // m if split == "seq" else n_pos,
            cfg.n_kv_heads // m if split == "heads" else cfg.n_kv_heads)
    if tuple(cache.shape[1:3]) != want:
        raise ValueError(
            f"a K/V cache of {tuple(cache.shape)} for positions x kv heads "
            f"{want} (split {split!r} over a model axis of {m}): make it "
            "with StepBundle.init_cache")
    return split


def _write_slot(cache, new, slot: int, split, ax):
    """``cache[:, slot] = new`` for the token's K or V: where the cache
    splits by positions, only on the rank that holds ``slot``."""
    if split == "seq":
        slot -= ax.rank * cache.shape[1]
        if not 0 <= slot < cache.shape[1]:
            return
    cache[:, slot] = new


def _attend(q, k, v, valid, dtype, ax=None, constraint: bool = False):
    """q (B, Hq, hd) against the cache k, v (B, S, Hkv, hd), each group of
    Hq / Hkv query heads reading one kv head (GQA, no repeated K/V):
    float32 scores over the ``valid`` positions (all, where None), the
    probabilities in ``dtype``; (B, Hq, hd).  With ``ax`` the cache is
    this rank's positions of every head, and the softmax runs over the
    ranks' positions together (flash-decoding's combine): the scores' row
    max over ``ax`` (an all-reduce MAX), then each rank's exponentials
    against it and their sum and product with V, summed over ``ax`` (one
    all-reduce SUM) and divided."""
    b, hq, h = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, h)
    scores = torch.einsum("bgrd,bkgd->bgrk", qg.float(),
                          k.float()) / math.sqrt(h)
    if constraint:
        scores = shard(scores, "data", None, None, "model")
    if valid is not None:
        scores = torch.where(valid, scores, -1e30)
    if ax is None:
        probs = torch.softmax(scores, dim=-1).to(dtype)
        return torch.einsum("bgrk,bkgd->bgrd", probs, v).reshape(b, hq, h)
    p = torch.exp(scores - tp.all_max(scores.amax(dim=-1), ax)[..., None])
    part = torch.einsum("bgrk,bkgd->bgrd", p.to(dtype), v)
    sums = tp.g(torch.cat([part.float(), p.sum(dim=-1, keepdim=True)], -1),
                ax)
    return (sums[..., :h] / sums[..., h:]).to(dtype).reshape(b, hq, h)


def decode_out(cfg, w, q, k_cache, v_cache, valid, split, ax, dtype,
               constraint: bool = False):
    """The attention of the token's queries ``q`` (:func:`_decode_q`)
    against the cache laid out by ``split`` over ``ax``
    (:func:`cache_split`), then its output product: this rank's part
    where ``w["tp"]`` splits the query heads, which the caller sums over
    it (``tp.g``).  By heads, a rank's query heads read its kv heads; by
    positions, every query head (gathered over ``model``) attends over
    the rank's positions (:func:`_attend`'s combine) and the rank keeps
    its heads of the output; a whole cache is read at the kv heads the
    rank's query heads read (``rank_heads``)."""
    b, _, h = q.shape
    qax = w["tp"]
    if split == "seq":
        q = tp.gather_last(q.reshape(b, -1), qax).reshape(b, -1, h)
        out = _attend(q, k_cache, v_cache, valid, dtype, ax, constraint)
        if qax is not None:
            hq = cfg.n_heads // qax.size
            out = out[:, qax.rank * hq:(qax.rank + 1) * hq]
    else:
        if split is None and qax is not None:
            lo, heads = rank_heads(cfg, qax.size, qax.rank)
            k_cache = k_cache[:, :, lo:lo + heads.kv]
            v_cache = v_cache[:, :, lo:lo + heads.kv]
            if heads.kv_idx is not None:
                idx = torch.tensor(heads.kv_idx, device=q.device)
                k_cache = k_cache.index_select(2, idx)
                v_cache = v_cache.index_select(2, idx)
        out = _attend(q, k_cache, v_cache, valid, dtype, None, constraint)
    return tp.row(out.reshape(b, -1), w["wo"], qax)


def _decode_attn(cfg, w, x, k_cache, v_cache, pos_buf, cur: int, dtype,
                 ax, rope: bool = True):
    """x: (B, D), ``w`` from :func:`decode_attn_weights`.  Writes this
    step's k/v (rotated by RoPE at ``cur`` with ``rope``, as q is) into
    the layer's cache slices in place (laid out by ``cache_pspecs`` over
    ``ax``, :func:`cache_split`); returns this rank's part of the
    attention output (B, D) and the axis it is split over
    (:func:`decode_out`)."""
    sc = pos_buf.shape[0]
    split = cache_split(cfg, ax, k_cache, sc)
    q = _decode_q(cfg, w, x)
    k, v = _decode_kv(cfg, w, x, split)
    if rope:
        pos = torch.full((x.shape[0], 1), cur, dtype=torch.int32,
                         device=x.device)
        q = apply_rope(q[:, None], pos, cfg.rope_theta)[:, 0]
        k = apply_rope(k[:, None], pos, cfg.rope_theta)[:, 0]
    _write_slot(k_cache, k, cur % sc, split, ax)
    _write_slot(v_cache, v, cur % sc, split, ax)
    if cfg.plan.decode_seq_constraint:
        # the reference keeps the cache sequence-sharded here
        k_cache = shard(k_cache, "data", "model", None, None)
        v_cache = shard(v_cache, "data", "model", None, None)

    ages = cur - pos_buf       # pos_buf already holds this step's position
    valid = (pos_buf >= 0) & (ages >= 0)
    if cfg.sliding_window:
        valid &= ages < cfg.sliding_window
    if split == "seq":
        n = k_cache.shape[1]
        valid = valid[ax.rank * n:(ax.rank + 1) * n]
    return decode_out(cfg, w, q, k_cache, v_cache, valid, split, ax, dtype,
                      cfg.plan.decode_seq_constraint), w["tp"]


def lm_decode_step(cfg: ArchConfig, params, cache, tokens, *,
                   dtype=torch.bfloat16, unroll=False):
    """One decode step. tokens: (B,) int. Returns (logits (B,V), cache).

    The cache is updated in place (K/V slots and ``pos_buf`` where the
    family has them, the SSM and conv state) and returned;
    ``cache["cur"]`` advances by one.  On a mesh whose ``model`` axis
    splits the layers (``fsdp_tp``), the cache is this rank's
    ``cache_pspecs`` shard (``StepBundle.init_cache``) and each product
    runs on this rank's shards: the attention (:func:`_decode_attn`), the
    MLP, the Mamba-2 block (``ssd.ssd_block_decode``), the MoE layer, the
    embedding and the logits, gathered over the ranks' columns.
    ``unroll`` is accepted and has no effect: the layer loop runs
    eagerly.
    """
    cur = cache["cur"]
    ax = tp.tree_axis(params)
    x = _lookup(params["embed"], tokens, dtype)               # (B,D)
    pos_buf = cache.get("pos_buf")
    if pos_buf is not None:
        pos_buf[cur % pos_buf.shape[0]] = cur             # ring buffer slot
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = _ssd_decode(cfg, params, cache["ssm"][i], cache["conv"][i],
                            x, dtype, ax, i)
    elif cfg.family == "hybrid":
        n_chunks, period = cfg.num_layers // cfg.hybrid_period, \
            cfg.hybrid_period
        # (num_layers, ...) state seen as (n_chunks, period, ...): views
        ssm = cache["ssm"].view((n_chunks, period) + cache["ssm"].shape[1:])
        conv = cache["conv"].view((n_chunks, period)
                                  + cache["conv"].shape[1:])
        # gathered once: every chunk applies the same block
        sp = params["shared"]
        shared = {"ln1": fsdp.gather(sp["ln1"], dtype),
                  "ln2": fsdp.gather(sp["ln2"], dtype),
                  "attn": decode_attn_weights(cfg, sp, dtype),
                  "mlp": mlp_weights(sp, dtype)}
        for c in range(n_chunks):
            x = _shared_decode(cfg, shared, x, cache["k"][c], cache["v"][c],
                               pos_buf, cur, dtype, ax)
            for j in range(period):
                x = _ssd_decode(cfg, params, ssm[c, j], conv[c, j], x,
                                dtype, ax, c, j)
    else:
        for i in range(cfg.num_layers):
            lp = _layer_params(params, i)
            h = rmsnorm(x, fsdp.gather(lp["ln1"], dtype), cfg.norm_eps)
            a, qax = _decode_attn(cfg, decode_attn_weights(cfg, lp, dtype),
                                  h, cache["k"][i], cache["v"][i], pos_buf,
                                  cur, dtype, ax)
            x = x + tp.g(a, qax, dtype)
            h2 = rmsnorm(x, fsdp.gather(lp["ln2"], dtype), cfg.norm_eps)
            if cfg.is_moe:
                w = moe_lib.moe_weights(lp, dtype)
                m = moe_lib.moe_ffn_decode(cfg, w, h2)
            else:
                w = mlp_weights(lp, dtype)
                m = gated_mlp(h2, w["wi"], w["wg"], w["wo_mlp"], w["tp"])
            x = x + tp.g(m, w["tp"], dtype)
    x = rmsnorm(x, fsdp.gather(params["final_norm"]), cfg.norm_eps)
    logits = lm_logits(cfg, params, x[:, None, :])[:, 0]
    cache["cur"] = cur + 1
    return logits, cache


def _ssd_decode(cfg, params, ssm, conv, x, dtype, ax, *idx):
    """One Mamba-2 layer's decode step; its ``ssm``/``conv`` state views
    (this rank's shards on a ``model`` axis ``ax``) are updated in
    place."""
    lp = _layer_params(params, *idx)
    h = rmsnorm(x, fsdp.gather(lp["ln1"], dtype), cfg.norm_eps)
    w = ssd_lib.ssd_decode_weights(cfg, lp, dtype)
    out, _ = ssd_lib.ssd_block_decode(cfg, w, h, {"ssm": ssm, "conv": conv},
                                      cfg.norm_eps, ax)
    return x + tp.g(out, w["tp"], dtype)


def _shared_decode(cfg, w, x, k_cache, v_cache, pos_buf, cur: int, dtype,
                   ax):
    """The hybrid family's shared block for one token on its leaves ``w``;
    writes this step's K/V into the chunk's cache slices in place."""
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    a, qax = _decode_attn(cfg, w["attn"], h, k_cache, v_cache, pos_buf, cur,
                          dtype, ax)
    x = x + tp.g(a, qax, dtype)
    m, _ = mlp_block(cfg, w["mlp"], rmsnorm(x, w["ln2"], cfg.norm_eps))
    return x + tp.g(m, w["mlp"]["tp"], dtype)
