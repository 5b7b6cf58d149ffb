"""Decoder-only LM, dense, SSM and hybrid families: the port of
``repro.models.transformer``.

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

The MoE, enc-dec and VLM families are a later slice of the port: their
configs raise ``NotImplementedError`` naming the ROADMAP item.  With them
go the reference's MoE aux loss and VLM frontend embeddings, which the
ported families do not have: here ``lm_forward`` returns the logits
alone.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.layers import ParamSpec, TensorSpec, apply_rope, \
    gated_mlp, rmsnorm

PORTED = ("dense", "ssm", "hybrid")


def check_family(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port has not yet."""
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP A13c); the port runs the {', '.join(PORTED)} "
            "families")


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
        **dense_ffn_specs(cfg, L, dtype),
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
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    b, s = x.shape[:2]
    out = out.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim)
    return out @ lp["wo"], k, v


def mlp_block(cfg, lp, x):
    """Dense SwiGLU FFN."""
    return gated_mlp(x, lp["wi"], lp["wg"], lp["wo_mlp"])


def _cast(lp: dict, dtype) -> dict:
    return {k: p.to(dtype) for k, p in lp.items()}


def _layer(cfg, x, lp, positions):
    # mixed precision: params stored f32, computed in x.dtype (bf16)
    lp = _cast(lp, x.dtype)
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if cfg.family in ("ssm", "hybrid"):  # hybrid inner layers are Mamba-2
        return x + ssd_lib.ssd_block(cfg, lp, h, cfg.norm_eps)
    a, _, _ = attn_block(cfg, lp, h, positions, window=cfg.sliding_window)
    x = x + a
    return x + mlp_block(cfg, lp, rmsnorm(x, lp["ln2"], cfg.norm_eps))


def shared_block(cfg, sp, x, positions, window):
    """The hybrid family's shared attention+MLP block."""
    sp = _cast(sp, x.dtype)
    h = rmsnorm(x, sp["ln1"], cfg.norm_eps)
    a, _, _ = attn_block(cfg, sp, h, positions, window=window)
    x = x + a
    return x + mlp_block(cfg, sp, rmsnorm(x, sp["ln2"], cfg.norm_eps))


def _layer_params(params, *idx) -> dict:
    """One layer's parameters: index ``(i,)``, or ``(chunk, j)`` of the
    hybrid family's (n_chunks, period) stack."""
    return {k: p[idx] for k, p in params["layers"].items()}


# ---------------------------------------------------------------------------
# Forward (prefill trunk)
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens, dtype):
    """Gather, then cast: the same values as casting the table first,
    without a cast copy of the whole vocabulary."""
    return params["embed"][tokens].to(dtype)


def lm_trunk(cfg: ArchConfig, params, x, positions):
    """Embeddings -> final norm. x: (B,S,D)."""
    if cfg.family == "hybrid":
        for c in range(cfg.num_layers // cfg.hybrid_period):
            x = shared_block(cfg, params["shared"], x, positions,
                             cfg.sliding_window)
            for j in range(cfg.hybrid_period):
                x = _layer(cfg, x, _layer_params(params, c, j), positions)
    else:
        for i in range(cfg.num_layers):
            x = _layer(cfg, x, _layer_params(params, i), positions)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def lm_logits(cfg, params, x):
    dtype = x.dtype
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(dtype).T
    else:
        logits = x @ params["unembed"].to(dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30  # fresh tensor: in place
    return logits


def lm_forward(cfg, params, tokens, *, dtype=torch.bfloat16,
               last_only=False):
    x = embed_tokens(params, tokens, dtype)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x = lm_trunk(cfg, params, x, positions)
    if last_only:
        # serving prefill wants only the next-token distribution: slice
        # BEFORE the unembed so the (B, S, V) logits never materialise.
        x = x[:, -1:, :]
    return lm_logits(cfg, params, x)


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


def init_cache(cfg, batch, seq_len, dtype, device):
    """Zero K/V, ``pos_buf`` all -1 (the empty sentinel), ``cur`` 0."""
    cache = {k: torch.full(s.shape, -1, dtype=s.dtype, device=device)
             if not s.dtype.is_floating_point
             else torch.zeros(s.shape, dtype=s.dtype, device=device)
             for k, s in init_cache_specs(cfg, batch, seq_len,
                                          dtype).items()}
    cache["cur"] = 0
    return cache


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

    ages = cur - pos_buf       # pos_buf already holds this step's position
    valid = (pos_buf >= 0) & (ages >= 0)
    if cfg.sliding_window:
        valid &= ages < cfg.sliding_window

    # grouped GQA against the (B, S, Hkv, h) cache, no repeated K/V
    rep = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, rep, h)
    scores = torch.einsum("bgrd,bkgd->bgrk", qg.float(),
                          k_cache.float()) / math.sqrt(h)
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
            x = x + gated_mlp(h2, lp["wi"], lp["wg"], lp["wo_mlp"])
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
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
