"""Mamba-2 block via SSD (state-space duality): the port of
``repro.models.ssd``.

Within a chunk the recurrence is a masked attention-like dense product;
across chunks a small state (nh, hd, ds) is carried.  The prefill's scan
is ``kernels.ops.ssd_scan``: the hand-written CUDA kernel on the card,
the chunked dual form on the CPU.  ``ssd_chunked`` is that dual form
(``kernels.ssd_scan.ssd_scan_ref``), re-exported under the reference's
name, so the algorithm has one copy.  B and C are group-shared
(``ngroups=1``).  ``shard`` is called on the heads before the scan, as
in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import segsum as _segsum  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_scan_ref as ssd_chunked
from repro_torch.models.layers import ParamSpec, TensorSpec, rmsnorm, \
    shard
from repro_torch.sharding import fsdp, tp

__all__ = ["ssd_specs", "ssd_chunked", "ssd_block", "ssd_decode_state_specs",
           "ssd_block_decode", "ssd_weights", "ssd_decode_weights"]


def ssd_specs(cfg, n_layers: int, dtype) -> dict:
    d = cfg.d_model
    di = cfg.ssm_d_inner
    nh = cfg.ssm_n_heads
    ds = cfg.ssm_state
    w = cfg.ssm_conv_width
    L = (n_layers,)
    return {
        # in_proj split by group: z, x over the inner width; B, C, dt small
        "w_zx": ParamSpec(L + (d, 2 * di), ("layers", "embed", "ssm_inner"),
                          dtype),
        "w_bc": ParamSpec(L + (d, 2 * ds), ("layers", "embed", None), dtype),
        "w_dt": ParamSpec(L + (d, nh), ("layers", "embed", "ssm_heads"),
                          dtype),
        "dt_bias": ParamSpec(L + (nh,), ("layers", "ssm_heads"), dtype,
                             "zeros"),
        # depthwise causal conv over (x | B | C) channels
        "conv_x": ParamSpec(L + (w, di), ("layers", "conv", "ssm_inner"),
                            dtype, "conv"),
        "conv_bc": ParamSpec(L + (w, 2 * ds), ("layers", "conv", None), dtype,
                             "conv"),
        "A_log": ParamSpec(L + (nh,), ("layers", "ssm_heads"), dtype,
                           "zeros"),
        "D": ParamSpec(L + (nh,), ("layers", "ssm_heads"), dtype, "ones"),
        "gate_norm": ParamSpec(L + (di,), ("layers", "ssm_inner"), dtype,
                               "ones"),
        "w_out": ParamSpec(L + (di, d), ("layers", "ssm_inner", "embed"),
                           dtype),
    }


SSD_LEAVES = ("w_zx", "w_bc", "w_dt", "dt_bias", "conv_x", "conv_bc",
              "A_log", "D", "gate_norm", "w_out")


def _causal_conv(x, w):
    """Depthwise causal conv via shifted adds (no cuDNN convolution, which
    would run in TF32 unless told not to). x: (B,S,C); w: (W,C)."""
    out = torch.zeros_like(x)
    width, s = w.shape[0], x.shape[1]
    for i in range(width):
        shift = width - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + xi * w[i]
    return out


def _dt(x, lp):
    """softplus(x @ w_dt + dt_bias) in float32."""
    return F.softplus((x @ lp["w_dt"]).float() + lp["dt_bias"].float())


def ssd_weights(cfg, lp: dict, dtype) -> dict:
    """The block's leaves of ``lp`` in ``dtype`` as :func:`ssd_block` takes
    them, with ``"tp"`` (the axis or None).

    Split over ``model``, a rank runs ``ssm_n_heads / m`` heads: its
    shards of ``w_dt``, ``dt_bias``, ``A_log``, ``D``, ``conv_x``,
    ``gate_norm`` and the rows of ``w_out``.  ``w_zx`` packs the z and
    the x columns in one leaf, so a contiguous shard holds z for one
    rank and x for another: the rank gathers it whole (``tp.whole``, its
    gradient reduce-scattered back over ``model``) and takes the z and x
    columns of its own heads.  ``w_bc`` and ``conv_bc``, which the rules
    replicate over ``model``, are taken whole: every rank computes the
    whole B and C, which enter its heads' scan through ``tp.f`` (their
    gradient summed over ``model`` once, in the activations, before the
    convolution's and the product's backward).  The block splits where
    the rules split both ``ssm_heads`` and ``ssm_inner``."""
    ax = tp.axis_of(lp["w_dt"])
    if ax is None or not tp.splits(lp["w_zx"]):
        return {**{k: fsdp.gather(v, dtype) for k, v in lp.items()
                   if k in SSD_LEAVES}, "tp": None}
    out = {k: tp.local(lp[k], dtype) for k in SSD_LEAVES if k != "w_zx"}
    di = cfg.ssm_d_inner
    n = di // ax.size
    w_zx = tp.whole(lp["w_zx"], dtype, ax)                   # (D, 2 di)
    lo = ax.rank * n
    out["w_zx"] = torch.cat([w_zx[:, lo:lo + n],
                             w_zx[:, di + lo:di + lo + n]], dim=-1)
    return {**out, "tp": ax}


def _gated_norm(y, scale, eps: float, ax, width: int):
    """RMSNorm over the whole inner width ``width`` of ``y``, which holds
    this rank's columns of it where ``ax`` splits the block: the sum of
    squares is summed over the axis (``tp.stat_sum``)."""
    if ax is None:
        return rmsnorm(y, scale, eps)
    dt = y.dtype
    y = y.float()
    ss = tp.stat_sum(torch.sum(y * y, dim=-1, keepdim=True), ax)
    y = y * torch.rsqrt(ss / width + eps)
    return (y * scale.float()).to(dt)


def ssd_block(cfg, lp: dict, x, eps: float):
    """Full Mamba-2 block (the pre-norm residual is the caller's).
    x: (B, S, d_model) -> (B, S, d_model).  With leaves split over
    ``model`` (``ssd_weights``), the scan runs on this rank's heads and
    the output is its part of the output product: the caller sums it
    over the axis (``tp.g``)."""
    b, s, _ = x.shape
    ax = lp.get("tp")
    m = ax.size if ax is not None else 1
    nh, hd = cfg.ssm_n_heads // m, cfg.ssm_head_dim
    di = nh * hd

    bc = x @ lp["w_bc"]                                      # (B,S,2ds)
    x = tp.f(x, ax)
    z, xin = (x @ lp["w_zx"]).chunk(2, dim=-1)              # (B,S,di) each
    dt = _dt(x, lp)                                          # (B,S,nh) f32

    xin = F.silu(_causal_conv(xin, lp["conv_x"]))
    bc = F.silu(_causal_conv(bc, lp["conv_bc"]))
    # every rank's heads read all of B and C: their gradient is summed
    # over the ranks
    bc = tp.f(bc, ax)
    B_mat, C_mat = bc.chunk(2, dim=-1)

    A = -torch.exp(lp["A_log"].float())                      # (nh,)
    xh = xin.reshape(b, s, nh, hd)
    xh = shard(xh, "batch", None, "ssm_heads", None)
    y = ops.ssd_scan(xh, dt, A, B_mat, C_mat, chunk=cfg.ssm_chunk)
    y = y + xh * lp["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, di)
    y = _gated_norm(y * F.silu(z), lp["gate_norm"], eps, ax,
                    cfg.ssm_d_inner)                         # gated RMSNorm
    return tp.row(y, lp["w_out"], ax)


# ---------------------------------------------------------------------------
# Decode (single-token recurrent step)
# ---------------------------------------------------------------------------


def ssd_decode_state_specs(cfg, n_layers: int, batch: int, dtype) -> dict:
    """(shape, dtype) of the decode state: ``ssm`` always float32,
    ``conv`` (the last W-1 inputs) in the compute dtype."""
    nh, hd, ds = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.ssm_d_inner
    w = cfg.ssm_conv_width
    return {
        "ssm": TensorSpec((n_layers, batch, nh, hd, ds), torch.float32),
        "conv": TensorSpec((n_layers, batch, w - 1, di + 2 * ds), dtype),
    }


def ssd_decode_weights(cfg, lp: dict, dtype) -> dict:
    """The block's leaves of ``lp`` in ``dtype`` as
    :func:`ssd_block_decode` takes them, with ``"tp"`` (the axis or
    None).  Split over ``model`` (where :func:`ssd_weights` splits), a
    rank takes its shards as they are placed (``tp.local``): its heads of
    ``w_dt``, ``dt_bias``, ``A_log``, ``D``, ``gate_norm`` and ``w_out``,
    and its contiguous chunk of ``w_zx``'s packed z | x columns, whose
    product the rank gathers over ``model`` (activations, not the leaf);
    ``w_bc`` and ``conv_bc`` whole, and ``conv_x`` gathered whole (W x
    d_inner), since the rank convolves the channel block that its conv
    state holds, which is not its heads' (see
    :func:`ssd_block_decode`)."""
    ax = tp.axis_of(lp["w_dt"])
    if ax is None or not tp.splits(lp["w_zx"]):
        return {**{k: fsdp.gather(v, dtype) for k, v in lp.items()
                   if k in SSD_LEAVES}, "tp": None}
    out = {k: tp.local(lp[k], dtype) for k in SSD_LEAVES if k != "conv_x"}
    return {**out, "conv_x": fsdp.gather(lp["conv_x"], dtype), "tp": ax}


def ssd_block_decode(cfg, lp: dict, x, state: dict, eps: float, ax=None):
    """x: (B, d_model); state {'ssm': (B,nh,hd,ds) f32, 'conv': (B,W-1,C)},
    both written in place.  Returns (out (B, d_model), state).

    On a ``model`` axis the state is laid out by ``cache_pspecs``: the
    SSM state is this rank's heads where the leaves split
    (:func:`ssd_decode_weights`, ``lp["tp"]``), and the conv state its
    contiguous block of the C = d_inner + 2 ds channels [x | B | C] where
    ``ax`` divides C -- a block that is not the rank's heads' x channels
    (every head reads all of B and C).  The conv is depthwise, so the
    rank convolves its block's channels and gathers the (B, C) output
    over ``model``, then takes its heads' x and the whole B and C; the
    token's x enters its block through a gather of the ``w_zx`` product's
    columns.  ``out`` is then this rank's part of the output product,
    which the caller sums (``tp.g``); the gated norm's sum of squares
    runs over the whole inner width (``tp.stat_sum``)."""
    b = x.shape[0]
    wax = lp.get("tp")
    m = wax.size if wax is not None else 1
    nh, hd = cfg.ssm_n_heads // m, cfg.ssm_head_dim
    di = cfg.ssm_d_inner
    if state["ssm"].shape[1] != nh:
        raise ValueError(f"an SSM state of {state['ssm'].shape[1]} heads "
                         f"for {nh} a rank: make it with "
                         "StepBundle.init_cache")

    # every head's z and x: this rank's columns gathered over ``model``
    z, xin = tp.gather_last(x @ lp["w_zx"], wax).chunk(2, dim=-1)
    bc = x @ lp["w_bc"]
    dt = _dt(x, lp)                                          # (B,nh)

    # conv ring: state['conv'] holds the previous W-1 inputs of its
    # channels, all C or this rank's block of them
    xbc = torch.cat([xin, bc], dim=-1)                       # (B, C)
    conv_w = torch.cat([lp["conv_x"], lp["conv_bc"]], dim=-1)  # (W, C)
    c, n = xbc.shape[-1], state["conv"].shape[-1]
    if n != c:
        if ax is None or c != n * ax.size:
            raise ValueError(f"a conv state of {n} channels for {c}: make "
                             "it with StepBundle.init_cache")
        lo = ax.rank * n
        xbc, conv_w = xbc[:, lo:lo + n], conv_w[:, lo:lo + n]
    hist = torch.cat([state["conv"], xbc[:, None, :]], dim=1)  # (B, W, n)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, conv_w))
    if n != c:
        conv_out = tp.gather_last(conv_out, ax)              # (B, C)
    xin_c, bc_c = conv_out.split([di, c - di], dim=-1)
    B_mat, C_mat = bc_c.chunk(2, dim=-1)                     # (B, ds)
    if wax is not None:               # this rank's heads' z and x
        lo = wax.rank * nh * hd
        z, xin_c = z[:, lo:lo + nh * hd], xin_c[:, lo:lo + nh * hd]

    A = -torch.exp(lp["A_log"].float())
    xh = xin_c.reshape(b, nh, hd).float()
    decay = torch.exp(dt * A)                                # (B, nh)
    dBx = torch.einsum("bn,bh,bhp->bhpn", B_mat.float(), dt, xh)
    ssm = state["ssm"]
    ssm.mul_(decay[..., None, None]).add_(dBx)
    y = torch.einsum("bn,bhpn->bhp", C_mat.float(), ssm)
    y = y + xh * lp["D"].float()[None, :, None]
    y = y.reshape(b, nh * hd).to(x.dtype)
    y = _gated_norm(y * F.silu(z), lp["gate_norm"], eps, wax, di)
    state["conv"].copy_(hist[:, 1:, :])
    return tp.row(y, lp["w_out"], wax), state
