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
leaves by ``_cast`` inside the layer -- so under ``"dots"`` or
``"full"`` the backward gathers them again, as FSDP reshards after the
forward, while ``"none"`` keeps every layer's gathered leaves until the
backward --, the hybrid's shared block once per forward, the embeddings,
``frontend_proj``, ``final_norm`` and the head where they are applied.
``shard`` is called where the reference calls it, with its specs.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils import checkpoint as ckpt_lib

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.layers import ParamSpec, TensorSpec, apply_rope, \
    gated_mlp, rmsnorm, shard
from repro_torch.sharding import fsdp

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
# Blocks
# ---------------------------------------------------------------------------


def _qkv(cfg, lp, x):
    h = cfg.resolved_head_dim
    q, k, v = x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    lead = x.shape[:-1]
    return (q.reshape(lead + (cfg.n_heads, h)),
            k.reshape(lead + (cfg.n_kv_heads, h)),
            v.reshape(lead + (cfg.n_kv_heads, h)))


def attn_block(cfg, lp, x, positions, *, window: int):
    """Full-sequence causal attention (prefill). Returns (out, k, v)."""
    q, k, v = _qkv(cfg, lp, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", None, "heads", None)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    b, s = x.shape[:2]
    out = out.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim)
    return out @ lp["wo"], k, v


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def mlp_block(cfg, lp, x):
    """The FFN: (out, aux) -- the MoE layer and its router aux loss, or
    the dense SwiGLU and a float32 0."""
    if cfg.is_moe:
        return moe_lib.moe_ffn(cfg, lp, x)
    return gated_mlp(x, lp["wi"], lp["wg"], lp["wo_mlp"]), _zero(x)


def _cast(tree: dict, dtype) -> dict:
    """A (nested) dict of parameters, each gathered whole
    (``fsdp.gather``: the identity on a plain tensor) and cast to
    ``dtype``."""
    return {k: _cast(p, dtype) if isinstance(p, dict)
            else fsdp.gather(p, dtype) for k, p in tree.items()}


def _layer(cfg, x, lp, positions):
    """One layer: (x, aux)."""
    # mixed precision: params stored f32, computed in x.dtype (bf16)
    lp = _cast(lp, x.dtype)
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if cfg.family in ("ssm", "hybrid"):  # hybrid inner layers are Mamba-2
        return x + ssd_lib.ssd_block(cfg, lp, h, cfg.norm_eps), _zero(x)
    a, _, _ = attn_block(cfg, lp, h, positions, window=cfg.sliding_window)
    x = x + a
    m, aux = mlp_block(cfg, lp, rmsnorm(x, lp["ln2"], cfg.norm_eps))
    return x + m, aux


def shared_block(cfg, sp, x, positions, window):
    """The hybrid family's shared attention+MLP block."""
    sp = _cast(sp, x.dtype)
    h = rmsnorm(x, sp["ln1"], cfg.norm_eps)
    a, _, _ = attn_block(cfg, sp, h, positions, window=window)
    x = x + a
    return x + gated_mlp(rmsnorm(x, sp["ln2"], cfg.norm_eps), sp["wi"],
                         sp["wg"], sp["wo_mlp"])


def _layer_params(params, *idx) -> dict:
    """One layer's parameters: index ``(i,)``, or ``(chunk, j)`` of the
    hybrid family's (n_chunks, period) stack."""
    return {k: fsdp.layer_slice(p, *idx)
            for k, p in params["layers"].items()}


# ---------------------------------------------------------------------------
# Forward (prefill trunk)
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens, dtype):
    """Gather, then cast: the same values as casting the table first,
    without a cast copy of the whole vocabulary (a sharded table is
    gathered whole, in ``dtype``)."""
    emb = params["embed"]
    if fsdp.is_plain(emb):
        return emb[tokens].to(dtype)
    return fsdp.gather(emb, dtype)[tokens]


def embed_inputs(cfg, params, tokens, extra_embeds, dtype):
    """The token embeddings, and for a frontend (the VLM's image patches)
    ``frontend_proj`` of ``extra_embeds`` (B, frontend_tokens, D) in
    front of them."""
    x = embed_tokens(params, tokens, dtype)
    if cfg.frontend == "none":
        return x
    if extra_embeds is None:
        raise ValueError(f"{cfg.name} takes its {cfg.frontend_tokens} "
                         "frontend embeddings with the tokens")
    fe = extra_embeds.to(dtype) @ fsdp.gather(params["frontend_proj"],
                                              dtype)
    return torch.cat([fe, x], dim=1)


def _dots_policy(ctx, func, *args, **kwargs):
    """Save what the reference's ``dots_with_no_batch_dims_saveable``
    saves: products without a batch dimension (``aten.mm``, which every
    2-D weight product becomes), and recompute everything else."""
    if func is torch.ops.aten.mm.default:
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


def lm_trunk(cfg: ArchConfig, params, x, positions):
    """Embeddings -> final norm. x: (B,S,D).  Returns (x, the aux loss
    summed over the layers).  Each layer (each Mamba-2 layer of the
    hybrid family, as in the reference) runs under ``cfg.plan.remat``."""
    layer = _remat(functools.partial(_layer, cfg), cfg.plan.remat)
    # one unbind per stacked leaf: its backward stacks the layers'
    # gradients once, where indexing layer by layer would add a
    # zero-filled copy of the whole stack per layer
    stacks = {k: fsdp.unstack(p) for k, p in params["layers"].items()}
    aux = _zero(x)
    if cfg.family == "hybrid":
        # gathered once: every chunk applies the same block
        shared = fsdp.gather_tree(params["shared"], x.dtype)
        for c in range(cfg.num_layers // cfg.hybrid_period):
            x = shared_block(cfg, shared, x, positions, cfg.sliding_window)
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


def lm_logits(cfg, params, x):
    dtype = x.dtype
    if cfg.tie_embeddings:
        logits = x @ fsdp.gather(params["embed"], dtype).T
    else:
        logits = x @ fsdp.gather(params["unembed"], dtype)
    logits = shard(logits, "batch", None, "vocab")
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30  # fresh tensor: in place
    return logits


def lm_forward(cfg, params, tokens, extra_embeds=None, *,
               dtype=torch.bfloat16, last_only=False):
    """Returns (logits (B, S, V) -- (B, 1, V) with ``last_only`` --, aux
    loss): the MoE router's summed over the layers, a float32 0 for the
    other families.  The VLM's S counts its frontend positions."""
    x = embed_inputs(cfg, params, tokens, extra_embeds, dtype)
    x = shard(x, "batch", None, None)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x, aux = lm_trunk(cfg, params, x, positions)
    if last_only:
        # serving prefill wants only the next-token distribution: slice
        # BEFORE the unembed so the (B, S, V) logits never materialise.
        x = x[:, -1:, :]
    return lm_logits(cfg, params, x), aux


def lm_loss(cfg, params, batch, *, dtype=torch.bfloat16):
    """Next-token CE (+ z-loss + aux), in float32.  batch: tokens (B, S)
    and, for the VLM, embeds (B, frontend_tokens, D), whose positions
    the loss skips.  Returns (loss, {"ce", "zloss", "aux"}), each a 0-d
    tensor."""
    tokens = batch["tokens"]
    logits, aux = lm_forward(cfg, params, tokens, batch.get("embeds"),
                             dtype=dtype)
    n_front = cfg.frontend_tokens if cfg.frontend != "none" else 0
    logits = logits[:, n_front:, :]
    # shift: predict tokens[:, 1:]
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = torch.mean(logz - tgt)
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


def _decode_attn(cfg, lp, x, k_cache, v_cache, pos_buf, cur: int, dtype):
    """x: (B,D). Writes this step's k/v into the layer's cache slices in
    place; returns (attn_out (B,D), k_cache, v_cache)."""
    h = cfg.resolved_head_dim
    b = x.shape[0]
    q, k, v = _qkv(cfg, lp, x[:, None, :])                # (B,1,H*,h)
    pos = torch.full((b, 1), cur, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)[:, 0]
    k = apply_rope(k, pos, cfg.rope_theta)[:, 0]

    sc = k_cache.shape[1]
    k_cache[:, cur % sc] = k
    v_cache[:, cur % sc] = v[:, 0]
    if cfg.plan.decode_seq_constraint:
        # the reference keeps the cache sequence-sharded here
        k_cache = shard(k_cache, "data", "model", None, None)
        v_cache = shard(v_cache, "data", "model", None, None)

    ages = cur - pos_buf       # pos_buf already holds this step's position
    valid = (pos_buf >= 0) & (ages >= 0)
    if cfg.sliding_window:
        valid &= ages < cfg.sliding_window

    # grouped GQA against the (B, S, Hkv, h) cache, no repeated K/V
    rep = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, rep, h)
    scores = torch.einsum("bgrd,bkgd->bgrk", qg.float(),
                          k_cache.float()) / math.sqrt(h)
    if cfg.plan.decode_seq_constraint:
        scores = shard(scores, "data", None, None, "model")
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bgrk,bkgd->bgrd", probs, v_cache)
    out = out.reshape(b, cfg.n_heads * h)
    return out @ lp["wo"], k_cache, v_cache


def lm_decode_step(cfg: ArchConfig, params, cache, tokens, *,
                   dtype=torch.bfloat16):
    """One decode step. tokens: (B,) int. Returns (logits (B,V), cache).

    The cache is updated in place (K/V slots and ``pos_buf`` where the
    family has them, the SSM and conv state) and returned;
    ``cache["cur"]`` advances by one.
    """
    cur = cache["cur"]
    x = embed_tokens(params, tokens, dtype)               # (B,D)
    pos_buf = cache.get("pos_buf")
    if pos_buf is not None:
        pos_buf[cur % pos_buf.shape[0]] = cur             # ring buffer slot
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = _ssd_decode(cfg, params, cache["ssm"][i], cache["conv"][i],
                            x, dtype, i)
    elif cfg.family == "hybrid":
        n_chunks, period = cfg.num_layers // cfg.hybrid_period, \
            cfg.hybrid_period
        # (num_layers, ...) state seen as (n_chunks, period, ...): views
        ssm = cache["ssm"].view((n_chunks, period) + cache["ssm"].shape[1:])
        conv = cache["conv"].view((n_chunks, period)
                                  + cache["conv"].shape[1:])
        for c in range(n_chunks):
            x = _shared_decode(cfg, params["shared"], x, cache["k"][c],
                               cache["v"][c], pos_buf, cur, dtype)
            for j in range(period):
                x = _ssd_decode(cfg, params, ssm[c, j], conv[c, j], x,
                                dtype, c, j)
    else:
        for i in range(cfg.num_layers):
            lp = _cast(_layer_params(params, i), dtype)
            h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
            a, _, _ = _decode_attn(cfg, lp, h, cache["k"][i], cache["v"][i],
                                   pos_buf, cur, dtype)
            x = x + a
            h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
            x = x + (moe_lib.moe_ffn_decode(cfg, lp, h2) if cfg.is_moe
                     else gated_mlp(h2, lp["wi"], lp["wg"], lp["wo_mlp"]))
    x = rmsnorm(x, fsdp.gather(params["final_norm"]), cfg.norm_eps)
    logits = lm_logits(cfg, params, x[:, None, :])[:, 0]
    cache["cur"] = cur + 1
    return logits, cache


def _ssd_decode(cfg, params, ssm, conv, x, dtype, *idx):
    """One Mamba-2 layer's decode step; its ``ssm``/``conv`` state views
    are updated in place."""
    lp = _cast(_layer_params(params, *idx), dtype)
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    out, _ = ssd_lib.ssd_block_decode(cfg, lp, h, {"ssm": ssm, "conv": conv},
                                      cfg.norm_eps)
    return x + out


def _shared_decode(cfg, sp, x, k_cache, v_cache, pos_buf, cur: int, dtype):
    """The hybrid family's shared block for one token; writes this step's
    K/V into the chunk's cache slices in place."""
    sp = _cast(sp, dtype)
    h = rmsnorm(x, sp["ln1"], cfg.norm_eps)
    a, _, _ = _decode_attn(cfg, sp, h, k_cache, v_cache, pos_buf, cur, dtype)
    x = x + a
    return x + gated_mlp(rmsnorm(x, sp["ln2"], cfg.norm_eps), sp["wi"],
                         sp["wg"], sp["wo_mlp"])
