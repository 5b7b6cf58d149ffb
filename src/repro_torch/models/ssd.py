"""Mamba-2 block via SSD (state-space duality): the port of
``repro.models.ssd``.

Within a chunk the recurrence is a masked attention-like dense product;
across chunks a small state (nh, hd, ds) is carried.  The prefill's scan
is ``kernels.ops.ssd_scan``: the hand-written CUDA kernel on the card,
the chunked dual form on the CPU.  ``ssd_chunked`` is that dual form
(``kernels.ssd_scan.ssd_scan_ref``), re-exported under the reference's
name, so the algorithm has one copy.  B and C are group-shared
(``ngroups=1``).  The reference's sharding constraint has no counterpart
on one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import segsum as _segsum  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_scan_ref as ssd_chunked
from repro_torch.models.layers import ParamSpec, TensorSpec, rmsnorm

__all__ = ["ssd_specs", "ssd_chunked", "ssd_block", "ssd_decode_state_specs",
           "ssd_block_decode"]


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


def ssd_block(cfg, lp: dict, x, eps: float):
    """Full Mamba-2 block (the pre-norm residual is the caller's).
    x: (B, S, d_model) -> (B, S, d_model)."""
    b, s, _ = x.shape
    nh, hd = cfg.ssm_n_heads, cfg.ssm_head_dim
    di = cfg.ssm_d_inner

    z, xin = (x @ lp["w_zx"]).chunk(2, dim=-1)              # (B,S,di) each
    bc = x @ lp["w_bc"]                                      # (B,S,2ds)
    dt = _dt(x, lp)                                          # (B,S,nh) f32

    xin = F.silu(_causal_conv(xin, lp["conv_x"]))
    bc = F.silu(_causal_conv(bc, lp["conv_bc"]))
    B_mat, C_mat = bc.chunk(2, dim=-1)

    A = -torch.exp(lp["A_log"].float())                      # (nh,)
    xh = xin.reshape(b, s, nh, hd)
    y = ops.ssd_scan(xh, dt, A, B_mat, C_mat, chunk=cfg.ssm_chunk)
    y = y + xh * lp["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, di)
    y = rmsnorm(y * F.silu(z), lp["gate_norm"], eps)         # gated RMSNorm
    return y @ lp["w_out"]


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


def ssd_block_decode(cfg, lp: dict, x, state: dict, eps: float):
    """x: (B, d_model); state {'ssm': (B,nh,hd,ds) f32, 'conv': (B,W-1,C)},
    both written in place.  Returns (out (B, d_model), state)."""
    b = x.shape[0]
    nh, hd = cfg.ssm_n_heads, cfg.ssm_head_dim
    di = cfg.ssm_d_inner

    z, xin = (x @ lp["w_zx"]).chunk(2, dim=-1)
    bc = x @ lp["w_bc"]
    dt = _dt(x, lp)                                          # (B,nh)

    # conv ring: state['conv'] holds the previous W-1 inputs
    xbc = torch.cat([xin, bc], dim=-1)                       # (B, C)
    conv_w = torch.cat([lp["conv_x"], lp["conv_bc"]], dim=-1)  # (W, C)
    hist = torch.cat([state["conv"], xbc[:, None, :]], dim=1)  # (B, W, C)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, conv_w))
    xin_c, bc_c = conv_out.split([di, conv_out.shape[-1] - di], dim=-1)
    B_mat, C_mat = bc_c.chunk(2, dim=-1)                     # (B, ds)

    A = -torch.exp(lp["A_log"].float())
    xh = xin_c.reshape(b, nh, hd).float()
    decay = torch.exp(dt * A)                                # (B, nh)
    dBx = torch.einsum("bn,bh,bhp->bhpn", B_mat.float(), dt, xh)
    ssm = state["ssm"]
    ssm.mul_(decay[..., None, None]).add_(dBx)
    y = torch.einsum("bn,bhpn->bhp", C_mat.float(), ssm)
    y = y + xh * lp["D"].float()[None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), lp["gate_norm"], eps)
    state["conv"].copy_(hist[:, 1:, :])
    return y @ lp["w_out"], state
