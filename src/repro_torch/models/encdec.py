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
softmax over the cache, and the decode position ``cache["cur"]`` is a
Python int.

Sharded parameters are gathered where they are used
(``sharding/fsdp.py``): a layer's leaves by ``_cast``, the embedding,
``frontend_proj`` and the final norms where they are applied.  ``shard``
is called where the reference calls it, with its specs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamSpec, TensorSpec, gelu_mlp,
                                       layernorm, shard,
                                       sinusoidal_positions)
from repro_torch.models.transformer import Z_LOSS_WEIGHT, _cast, \
    embed_tokens
from repro_torch.sharding import fsdp

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


def _mha(cfg, lp, xq, xkv, *, causal, prefix=""):
    b, sq = xq.shape[:2]
    h = cfg.resolved_head_dim
    q = (xq @ lp[prefix + "wq"]).reshape(b, sq, cfg.n_heads, h)
    k = (xkv @ lp[prefix + "wk"]).reshape(b, xkv.shape[1], cfg.n_kv_heads, h)
    v = (xkv @ lp[prefix + "wv"]).reshape(b, xkv.shape[1], cfg.n_kv_heads, h)
    q = shard(q, "batch", None, "heads", None)
    out = ops.flash_attention(q, k, v, causal=causal)
    return out.reshape(b, sq, cfg.n_heads * h) @ lp[prefix + "wo"]


def _mlp_apply(lp, x):
    return gelu_mlp(x, lp["w1"], lp["b1"], lp["w2"], lp["b2"])


def encode(cfg, params, frames, *, dtype=torch.bfloat16):
    """frames: (B, Senc, D) precomputed embeddings (conv stub upstream),
    cast to ``dtype`` before ``frontend_proj``."""
    x = frames.to(dtype) @ fsdp.gather(params["frontend_proj"], dtype)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(dtype)[None]
    x = shard(x, "batch", None, None)
    for lp in _unstack(params["enc"]):
        lp = _cast(lp, dtype)
        h = _ln_apply(cfg, x, lp["ln1"])
        x = x + _mha(cfg, lp, h, h, causal=False)
        h = _ln_apply(cfg, x, lp["ln2"])
        x = x + _mlp_apply(lp, h)
    return _ln_apply(cfg, x, fsdp.gather_tree(params["enc_norm"]))


def _logits(cfg, params, x):
    logits = x @ fsdp.gather(params["embed"], x.dtype).T
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30  # fresh tensor: in place
    return shard(logits, "batch", None, "vocab")


def decode_train(cfg, params, tokens, enc_out, *, dtype=torch.bfloat16,
                 last_only=False):
    """Teacher-forced decoder: (B, S, V) logits (B, 1, V with
    ``last_only``), the padded vocabulary at -1e30, the embedding tied as
    the unembedding."""
    x = embed_tokens(params, tokens, dtype)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(dtype)[None]
    x = shard(x, "batch", None, None)
    for lp in _unstack(params["dec"]):
        lp = _cast(lp, dtype)
        h = _ln_apply(cfg, x, lp["ln1"])
        x = x + _mha(cfg, lp, h, h, causal=True)
        h = _ln_apply(cfg, x, lp["lnx"])
        x = x + _mha(cfg, lp, h, enc_out, causal=False, prefix="x_")
        h = _ln_apply(cfg, x, lp["ln2"])
        x = x + _mlp_apply(lp, h)
    x = _ln_apply(cfg, x, fsdp.gather_tree(params["dec_norm"]))
    if last_only:
        x = x[:, -1:, :]
    return _logits(cfg, params, x)


def encdec_loss(cfg, params, batch, *, dtype=torch.bfloat16):
    """Next-token CE + z-loss in float32 on (frames, tokens); returns
    (loss, {"ce"}) -- the reference's enc-dec metrics."""
    enc_out = encode(cfg, params, batch["frames"], dtype=dtype)
    logits = decode_train(cfg, params, batch["tokens"], enc_out, dtype=dtype)
    logits = logits[:, :-1].float()
    targets = batch["tokens"][:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = torch.mean(logz - tgt)
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
    the promoted dtype of ``enc_out`` and the stored weights."""
    h = cfg.resolved_head_dim
    b, s = enc_out.shape[:2]
    dec = params["dec"]
    dt = torch.promote_types(enc_out.dtype, dec["x_wk"].dtype)
    x = enc_out.to(dt)
    xk = torch.stack([(x @ fsdp.gather(w, dt))
                      .reshape(b, s, cfg.n_kv_heads, h)
                      for w in fsdp.unstack(dec["x_wk"])])
    xv = torch.stack([(x @ fsdp.gather(w, dt))
                      .reshape(b, s, cfg.n_kv_heads, h)
                      for w in fsdp.unstack(dec["x_wv"])])
    return xk, xv


def _attend(q, k, v, scale, dtype, valid=None):
    """q (B, H, h) against k, v (B, S, H, h): float32 scores, softmax over
    the ``valid`` positions, probabilities in ``dtype``."""
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    if valid is not None:
        s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1).to(dtype)
    return torch.einsum("bhk,bkhd->bhd", p, v.to(dtype))


def encdec_decode_step(cfg, params, cache, tokens, *, dtype=torch.bfloat16):
    """tokens: (B,).  The cross K/V must be in the cache (from
    :func:`precompute_cross_kv`).  Writes this step's K/V and position
    into the cache in place and returns (logits (B, V), cache);
    ``cache["cur"]`` advances by one."""
    cur = cache["cur"]
    b = tokens.shape[0]
    h = cfg.resolved_head_dim
    pos_buf = cache["pos_buf"]
    x = embed_tokens(params, tokens, dtype)
    # row cur of the (seq_len, D) table: each element is computed alone
    x = x + sinusoidal_positions(cur + 1, cfg.d_model,
                                 x.device).to(dtype)[cur][None]
    pos_buf[cur] = cur
    valid = (pos_buf >= 0) & (pos_buf <= cur)
    scale = 1.0 / math.sqrt(h)
    for i, lp in enumerate(_unstack(params["dec"])):
        lp = _cast(lp, dtype)
        kc, vc = cache["k"][i], cache["v"][i]
        # self attention
        hh = _ln_apply(cfg, x, lp["ln1"])
        q = (hh @ lp["wq"]).reshape(b, cfg.n_heads, h)
        kc[:, cur] = (hh @ lp["wk"]).reshape(b, cfg.n_kv_heads, h)
        vc[:, cur] = (hh @ lp["wv"]).reshape(b, cfg.n_kv_heads, h)
        a = _attend(q, kc, vc, scale, dtype, valid)
        x = x + a.reshape(b, cfg.n_heads * h) @ lp["wo"]
        # cross attention
        hh = _ln_apply(cfg, x, lp["lnx"])
        q = (hh @ lp["x_wq"]).reshape(b, cfg.n_heads, h)
        a = _attend(q, cache["xk"][i], cache["xv"][i], scale, dtype)
        x = x + a.reshape(b, cfg.n_heads * h) @ lp["x_wo"]
        # mlp
        x = x + _mlp_apply(lp, _ln_apply(cfg, x, lp["ln2"]))
    x = _ln_apply(cfg, x, fsdp.gather_tree(params["dec_norm"]))
    cache["cur"] = cur + 1
    return _logits(cfg, params, x), cache
