"""Whisper-style encoder-decoder (audio backbone, conv frontend stubbed):
the port of ``repro.models.encdec``.

The batch carries precomputed frame embeddings (B, encoder_seq, d_model)
standing in for the two-conv downsampled mel spectrogram.  Positions are
sinusoidal on both sides, as in the reference.  Layers are stacked over
the layer axis and run in a Python loop; every full-sequence attention
goes through ``ops.flash_attention``: the encoder's self-attention and
the decoder's cross-attention non-causal (Sk = encoder_seq, which no kv
tile divides at whisper's 1500), the decoder's self-attention causal.
There is no remat here, as in the reference.

Decoding keeps the self-attention K/V and the cross K/V of every layer
(``precompute_cross_kv``, once per request) in a dict of tensors that
``encdec_decode_step`` updates in place; its attention is the plain
softmax over the cache (``transformer.decode_out``), and the decode
position ``cache["cur"]`` is a Python int.  On a mesh whose ``model``
axis splits the layers, the decode step computes on this rank's shards
against its ``cache_pspecs`` shard of the cache.

Sharded parameters are gathered where they are used
(``sharding/fsdp.py``): a layer's leaves by ``_cast``, the embedding,
``frontend_proj`` and the final norms where they are applied.  ``shard``
is called where the reference calls it, with its specs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamSpec, TensorSpec, gelu_mlp,
                                       layernorm, shard,
                                       sinusoidal_positions)
from repro_torch.models import transformer as tr
from repro_torch.models.transformer import Z_LOSS_WEIGHT, _cast
from repro_torch.sharding import fsdp, tp

# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _ln(lead, d, dtype):
    lax_ = tuple("layers" for _ in lead)
    return {
        "scale": ParamSpec(lead + (d,), lax_ + (None,), dtype, "ones"),
        "bias": ParamSpec(lead + (d,), lax_ + (None,), dtype, "zeros"),
    }


def _attn(cfg, lead, dtype):
    d = cfg.d_model
    h = cfg.resolved_head_dim
    qf, kf = cfg.n_heads * h, cfg.n_kv_heads * h
    lax_ = tuple("layers" for _ in lead)
    return {
        "wq": ParamSpec(lead + (d, qf), lax_ + ("embed", "q_feat"), dtype),
        "wk": ParamSpec(lead + (d, kf), lax_ + ("embed", "kv_feat"), dtype),
        "wv": ParamSpec(lead + (d, kf), lax_ + ("embed", "kv_feat"), dtype),
        "wo": ParamSpec(lead + (qf, d), lax_ + ("q_feat", "embed"), dtype),
    }


def _mlp(cfg, lead, dtype):
    d, f = cfg.d_model, cfg.d_ff
    lax_ = tuple("layers" for _ in lead)
    return {
        "w1": ParamSpec(lead + (d, f), lax_ + ("embed", "mlp"), dtype),
        "b1": ParamSpec(lead + (f,), lax_ + ("mlp",), dtype, "zeros"),
        "w2": ParamSpec(lead + (f, d), lax_ + ("mlp", "embed"), dtype),
        "b2": ParamSpec(lead + (d,), lax_ + (None,), dtype, "zeros"),
    }


def encdec_specs(cfg: ArchConfig, dtype=torch.float32) -> dict:
    d = cfg.d_model
    Le = (cfg.encoder_layers,)
    Ld = (cfg.num_layers,)
    return {
        "embed": ParamSpec((cfg.padded_vocab, d), ("vocab", "embed"), dtype),
        "frontend_proj": ParamSpec((d, d), ("embed", None), dtype),
        "enc": {
            "ln1": _ln(Le, d, dtype),
            **_attn(cfg, Le, dtype),
            "ln2": _ln(Le, d, dtype),
            **_mlp(cfg, Le, dtype),
        },
        "dec": {
            "ln1": _ln(Ld, d, dtype),
            **_attn(cfg, Ld, dtype),
            "lnx": _ln(Ld, d, dtype),
            **{f"x_{k}": s for k, s in _attn(cfg, Ld, dtype).items()},
            "ln2": _ln(Ld, d, dtype),
            **_mlp(cfg, Ld, dtype),
        },
        "enc_norm": _ln((), d, dtype),
        "dec_norm": _ln((), d, dtype),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _unstack(stack: dict) -> list:
    """The layers of a stacked (nested) tree, one dict each: one unbind
    per leaf, whose backward stacks the layers' gradients once."""
    per = {k: _unstack(v) if isinstance(v, dict) else fsdp.unstack(v)
           for k, v in stack.items()}
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _ln_apply(cfg, x, ln):
    return layernorm(x, ln["scale"], ln["bias"], cfg.norm_eps)


def _mha(cfg, w, xq, xkv, *, causal):
    """Attention of ``xq`` over ``xkv`` on the leaves ``w``
    (``transformer.attn_weights``); split over ``model``, this rank's
    heads and its part of the output product.  ``xq`` and ``xkv`` enter
    through ``tp.f`` (the caller's, for ``xkv``)."""
    b, sq = xq.shape[:2]
    h = cfg.resolved_head_dim
    heads = w["heads"]
    q = (xq @ w["wq"]).reshape(b, sq, heads.q, h)
    k = (xkv @ w["wk"]).reshape(b, xkv.shape[1], heads.kv, h)
    v = (xkv @ w["wv"]).reshape(b, xkv.shape[1], heads.kv, h)
    if heads.kv_idx is not None:
        idx = torch.tensor(heads.kv_idx, device=xq.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    q = shard(q, "batch", None, "heads", None)
    out = ops.flash_attention(q, k, v, causal=causal)
    return tp.row(out.reshape(b, sq, heads.q * h), w["wo"], w["tp"])


def _self_attn(cfg, w, x, *, causal):
    ax = w["tp"]
    xf = tp.f(x, ax)
    return tp.g(_mha(cfg, w, xf, xf, causal=causal), ax, x.dtype)


def mlp_weights(lp, dtype) -> dict:
    """The GELU MLP's leaves of ``lp`` in ``dtype``, with ``"tp"``: split
    over ``model``, this rank's hidden columns of ``w1`` and ``b1`` and
    rows of ``w2``; ``b2`` whole."""
    w = tr.mlp_weights(lp, dtype, ("w1", "b1", "w2"))
    return {**w, "b2": fsdp.gather(lp["b2"], dtype)}


def _mlp_apply(w, x):
    """The GELU MLP on the leaves ``w`` (:func:`mlp_weights`): split over
    ``model``, ``b2`` is added once, after the ranks' parts are summed."""
    return gelu_mlp(x, w["w1"], w["b1"], w["w2"], w["b2"], w["tp"])


def _layer_weights(cfg, lp, dtype, *attn_prefixes) -> dict:
    """A layer's leaves: the norms whole, each attention's
    (``transformer.attn_weights``) and the MLP's as their blocks take
    them."""
    out = {k: _cast(v, dtype) for k, v in lp.items() if k.startswith("ln")}
    for pre in attn_prefixes:
        out[pre + "attn"] = tr.attn_weights(cfg, lp, dtype, pre)
    out["mlp"] = mlp_weights(lp, dtype)
    return out


def encode(cfg, params, frames, *, dtype=torch.bfloat16, unroll=False):
    """frames: (B, Senc, D) precomputed embeddings (conv stub upstream),
    cast to ``dtype`` before ``frontend_proj``.  ``unroll`` (the
    reference's layer-scan unroll) is accepted and has no effect: the
    layer loop runs eagerly."""
    x = frames.to(dtype) @ fsdp.gather(params["frontend_proj"], dtype)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(dtype)[None]
    x = shard(x, "batch", None, None)
    for lp in _unstack(params["enc"]):
        w = _layer_weights(cfg, lp, dtype, "")
        h = _ln_apply(cfg, x, w["ln1"])
        x = x + _self_attn(cfg, w["attn"], h, causal=False)
        h = _ln_apply(cfg, x, w["ln2"])
        x = x + _mlp_apply(w["mlp"], h)
    return _ln_apply(cfg, x, fsdp.gather_tree(params["enc_norm"]))


def _logits(cfg, params, x):
    """The logits of ``x`` against the tied embedding, and the axis their
    columns are split over (``transformer.vocab_logits``)."""
    return tr.vocab_logits(cfg, params["embed"], x, tied=True)


def _decoder(cfg, params, tokens, enc_out, dtype):
    x = tr._lookup(params["embed"], tokens, dtype)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(dtype)[None]
    x = shard(x, "batch", None, None)
    enc_f = None        # enc_out through tp.f once: one sum of its gradient
    for lp in _unstack(params["dec"]):
        w = _layer_weights(cfg, lp, dtype, "", "x_")
        h = _ln_apply(cfg, x, w["ln1"])
        x = x + _self_attn(cfg, w["attn"], h, causal=True)
        h = _ln_apply(cfg, x, w["lnx"])
        ax = w["x_attn"]["tp"]
        if enc_f is None:
            enc_f = tp.f(enc_out, ax)
        x = x + tp.g(_mha(cfg, w["x_attn"], tp.f(h, ax), enc_f,
                          causal=False), ax, x.dtype)
        h = _ln_apply(cfg, x, w["ln2"])
        x = x + _mlp_apply(w["mlp"], h)
    return _ln_apply(cfg, x, fsdp.gather_tree(params["dec_norm"]))


def decode_train(cfg, params, tokens, enc_out, *, dtype=torch.bfloat16,
                 last_only=False, unroll=False):
    """Teacher-forced decoder: (B, S, V) logits (B, 1, V with
    ``last_only``), the padded vocabulary at -1e30, the embedding tied as
    the unembedding (split over ``model``, each rank's columns
    gathered).  ``unroll`` is accepted and has no effect."""
    x = _decoder(cfg, params, tokens, enc_out, dtype)
    if last_only:
        x = x[:, -1:, :]
    return tp.gather_last(*_logits(cfg, params, x))


def encdec_loss(cfg, params, batch, *, dtype=torch.bfloat16, unroll=False):
    """Next-token CE + z-loss in float32 on (frames, tokens); returns
    (loss, {"ce"}) -- the reference's enc-dec metrics.  Over a vocabulary
    split over ``model``, as ``transformer.lm_loss``.  ``unroll`` is
    accepted and has no effect."""
    enc_out = encode(cfg, params, batch["frames"], dtype=dtype)
    x = _decoder(cfg, params, batch["tokens"], enc_out, dtype)
    logits, ax = _logits(cfg, params, x)
    ce, logz = tr.next_token_ce(logits[:, :-1].float(),
                                batch["tokens"][:, 1:].long(), ax)
    loss = ce + Z_LOSS_WEIGHT * torch.mean(logz ** 2)
    return loss, {"ce": ce}


# ---------------------------------------------------------------------------
# Decode (incremental)
# ---------------------------------------------------------------------------


def encdec_cache_specs(cfg, batch, seq_len, dtype):
    """Tensor shapes of the decode cache: self-attention K/V over
    ``seq_len`` positions, cross K/V over the encoder's, ``pos_buf``; the
    decode position ``cur`` is a Python int beside them."""
    h = cfg.resolved_head_dim
    kv = TensorSpec((cfg.num_layers, batch, seq_len, cfg.n_kv_heads, h),
                    dtype)
    xkv = TensorSpec((cfg.num_layers, batch, cfg.encoder_seq,
                      cfg.n_kv_heads, h), dtype)
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv,
            "pos_buf": TensorSpec((seq_len,), torch.int32)}


def precompute_cross_kv(cfg, params, enc_out):
    """Every decoder layer's cross K and V of ``enc_out`` (B, Senc, D):
    two (L, B, Senc, Hkv, h) tensors, computed as the reference does in
    the promoted dtype of ``enc_out`` and the stored weights.  On a mesh
    whose ``model`` axis splits the cache (``cache_pspecs``), this rank's
    chunk of them: its kv heads, from its shards of ``x_wk``/``x_wv``, or
    its encoder positions of every head, from the leaves gathered whole
    (once a request)."""
    h = cfg.resolved_head_dim
    b, s = enc_out.shape[:2]
    dec = params["dec"]
    ax = tp.tree_axis(params)
    split = tp.kv_split(cfg.plan.decode_kv_shard, ax.size, cfg.n_kv_heads,
                        s) if ax is not None else None
    dt = torch.promote_types(enc_out.dtype, dec["x_wk"].dtype)
    x = enc_out.to(dt)
    if split == "seq":
        n = s // ax.size
        x = x[:, ax.rank * n:(ax.rank + 1) * n]
    get = tp.local if split == "heads" else fsdp.gather

    def kv(stack):
        return torch.stack([(x @ get(w, dt)).reshape(b, x.shape[1], -1, h)
                            for w in fsdp.unstack(stack)])
    return kv(dec["x_wk"]), kv(dec["x_wv"])


def encdec_decode_step(cfg, params, cache, tokens, *, dtype=torch.bfloat16):
    """tokens: (B,).  The cross K/V must be in the cache (from
    :func:`precompute_cross_kv`).  Writes this step's K/V and position
    into the cache in place and returns (logits (B, V), cache);
    ``cache["cur"]`` advances by one.  On a mesh whose ``model`` axis
    splits the layers, the cache is this rank's ``cache_pspecs`` shard
    and both attentions, the MLP, the embedding and the logits compute on
    this rank's shards, as ``transformer.lm_decode_step``'s."""
    cur = cache["cur"]
    ax = tp.tree_axis(params)
    pos_buf = cache["pos_buf"]
    x = tr._lookup(params["embed"], tokens, dtype)
    # row cur of the (seq_len, D) table: each element is computed alone
    x = x + sinusoidal_positions(cur + 1, cfg.d_model,
                                 x.device).to(dtype)[cur][None]
    pos_buf[cur] = cur
    for i, lp in enumerate(_unstack(params["dec"])):
        ln = {k: _cast(lp[k], dtype) for k in ("ln1", "lnx", "ln2")}
        # self attention (positions sinusoidal, no RoPE)
        a, qax = tr._decode_attn(cfg, tr.decode_attn_weights(cfg, lp, dtype),
                                 _ln_apply(cfg, x, ln["ln1"]),
                                 cache["k"][i], cache["v"][i], pos_buf, cur,
                                 dtype, ax, rope=False)
        x = x + tp.g(a, qax, dtype)
        # cross attention
        hh = _ln_apply(cfg, x, ln["lnx"])
        w = tr.decode_attn_weights(cfg, lp, dtype, "x_")
        xk, xv = cache["xk"][i], cache["xv"][i]
        split = tr.cache_split(cfg, ax, xk, cfg.encoder_seq)
        a = tr.decode_out(cfg, w, tr._decode_q(cfg, w, hh), xk, xv, None,
                          split, ax, dtype)
        x = x + tp.g(a, w["tp"], dtype)
        # mlp
        x = x + _mlp_apply(mlp_weights(lp, dtype),
                           _ln_apply(cfg, x, ln["ln2"]))
    x = _ln_apply(cfg, x, fsdp.gather_tree(params["dec_norm"]))
    cache["cur"] = cur + 1
    return tp.gather_last(*_logits(cfg, params, x)), cache
