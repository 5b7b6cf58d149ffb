"""Mixture-of-Experts FFN, GShard-style capacity dispatch: the port of
``repro.models.moe``.

Training and prefill use the reference's formulation step by step: the
router product in float32, its softmax, the Switch load-balancing aux
loss, top-k gates renormalised, each (token, slot)'s position in its
expert's capacity buffer from a cumsum in (k, s) order (so lower k-slots
win across the dispatch group), slots past the capacity dropped, then
one-hot ``dispatch`` and ``combine`` tensors (G, S, E, C) in x's dtype
and four einsums: dispatch, the two expert input products, the expert
output product, combine.  The expert products are batched over the
experts (``bmm``), outside any kernel of the port.  ``dispatch`` and
``combine`` are scattered straight from the routing -- a token's k slots
name k distinct experts, so each (token, expert, position) holds at most
one slot and the reference's sum over k of one-hots is that one value --
without its (G, S, k, E, C) intermediate.  Decode uses dense
all-experts compute, exact (no capacity drops).

Ties in the top-k and in the aux loss's argmax go to the lower expert
index, as ``jax.lax.top_k`` and ``jnp.argmax`` give them: the top-k is a
stable descending sort, and its first pick is the argmax.

``shard`` is called on the expert tensors where the reference calls it,
with its specs; on the plain activations of the port's step it changes
nothing (``layers.shard``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import ParamSpec, shard
from repro_torch.sharding import fsdp, tp

CAPACITY_FACTOR = 1.25
GROUP_SIZE = 2048  # tokens per dispatch group


def moe_specs(cfg, n_layers: int, dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    L = (n_layers,)
    return {
        "router": ParamSpec(L + (d, e), ("layers", "embed", None), dtype),
        "moe_wi": ParamSpec(L + (e, d, f),
                            ("layers", "experts", "embed", "moe_mlp"), dtype),
        "moe_wg": ParamSpec(L + (e, d, f),
                            ("layers", "experts", "embed", "moe_mlp"), dtype),
        "moe_wo": ParamSpec(L + (e, f, d),
                            ("layers", "experts", "moe_mlp", "embed"), dtype),
    }


def _capacity(tokens_per_group: int, n_experts: int, top_k: int) -> int:
    c = int(math.ceil(CAPACITY_FACTOR * top_k * tokens_per_group / n_experts))
    return max(4, int(math.ceil(c / 4) * 4))


def route(router, x, top_k: int, topi=None):
    """(gates (..., E) float32, topv (..., k) renormalised, topi (..., k))
    of tokens ``x`` (..., D) through ``router`` (D, E), the product in
    float32.  ``topi`` pins the picks (a test feeds the reference's
    routing where the two frameworks' last-bit gates would pick apart):
    its gates are then gathered from this router's softmax."""
    logits = x.float() @ router.float()
    gates = torch.softmax(logits, dim=-1)
    if topi is None:
        # stable: equal gates keep their order, so ties go to the lower
        # expert index
        topi = torch.sort(gates, dim=-1, descending=True,
                          stable=True).indices[..., :top_k]
    topv = torch.gather(gates, -1, topi)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return gates, topv, topi


def capacity_positions(topi, n_experts: int, cap: int):
    """(pos, in_cap), each (G, S, k): the position of each (token, slot)
    in its expert's buffer, counted over the group in (k, s) order, and
    whether it lies inside the capacity ``cap``."""
    g, s, k = topi.shape
    mask = torch.nn.functional.one_hot(topi.long(), n_experts)  # (G,S,k,E)
    # (G, E, k S): the count runs along the innermost dim, where a scan
    # is one pass (along the outer dim torch's scan took 6.3 ms a layer
    # at olmoe-1b-7b's prefill on an H100)
    flat = mask.permute(0, 3, 2, 1).reshape(g, n_experts, k * s)
    pos = (torch.cumsum(flat, dim=-1) - 1).reshape(g, n_experts, k, s) \
        .permute(0, 3, 2, 1)                                 # (G,S,k,E)
    pos = torch.gather(pos, -1, topi.long()[..., None])[..., 0]
    return pos, pos < cap


def dispatch_combine(topi, topv, n_experts: int, cap: int, dtype):
    """The one-hot ``dispatch`` and ``combine`` tensors (G, S, E, C) in
    ``dtype`` of a group's routing: slot j of token s sets (topi, pos) to
    1, or to its gate in ``combine``, where pos lies inside ``cap``."""
    g, s, _ = topi.shape
    pos, in_cap = capacity_positions(topi, n_experts, cap)
    col = topi.long() * cap + torch.where(in_cap, pos, 0)
    keep = in_cap.to(dtype)
    zeros = torch.zeros(g, s, n_experts * cap, dtype=dtype,
                        device=topi.device)
    dispatch = zeros.scatter(-1, col, keep).reshape(g, s, n_experts, cap)
    combine = zeros.scatter(-1, col, keep * topv.to(dtype)) \
        .reshape(g, s, n_experts, cap)
    return dispatch, combine


def moe_weights(lp: dict, dtype) -> dict:
    """The layer's leaves of ``lp`` in ``dtype`` as :func:`moe_ffn` takes
    them, with ``"tp"``: where it splits over ``model``, this rank's
    experts (``ep``) or every expert's hidden columns (``tp``); the
    router whole (the rules replicate it over ``model``).  Where the rules
    replicate the expert leaves over ``model``, the layer runs unsplit."""
    ax = tp.axis_of(lp["moe_wi"])
    get = tp.local if ax is not None else fsdp.gather
    return {**{k: get(lp[k], dtype) for k in ("router", "moe_wi", "moe_wg",
                                              "moe_wo")}, "tp": ax}


def moe_ffn(cfg, lp: dict, x, *, topi=None):
    """x: (B, S, D) -> (out (B, S, D), aux loss float32 scalar), capacity
    dispatch over groups of GROUP_SIZE tokens.  ``topi`` (G, S, k) pins
    the routing (see :func:`route`).

    Split over ``model`` (``lp["tp"]``, ``moe_weights``), every rank
    routes all its tokens (the router is replicated, and the ``model``
    ranks hold the same rows, so no all-to-all), and ``out`` is this
    rank's part, which the caller sums (``tp.g``): under ``ep`` its
    experts' dispatch and combine columns through its experts, under
    ``tp`` every expert's products on its hidden columns.  The gates and
    the tokens enter the split products through ``tp.f``, so the
    router's gradient from the combine is summed over ``model``; its
    aux loss is the same on every rank."""
    ax = lp.get("tp")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tokens = b * s
    sg = min(GROUP_SIZE, tokens)
    g = tokens // sg
    if tokens % sg:
        raise ValueError(f"{tokens} tokens do not split into dispatch "
                         f"groups of {sg}")
    xg = x.reshape(g, sg, d)
    gates, topv, topi = route(lp["router"], xg, k, topi)

    # load-balancing auxiliary loss (Switch-style); topi[..., 0] is the
    # argmax of the gates.  The expert loads are means over the global
    # batch, as the reference takes them: on a sharded step, over every
    # rank's rows (``fsdp.batch_mean``)
    me = fsdp.batch_mean(gates.mean(dim=(0, 1)))
    ce = fsdp.batch_mean(torch.nn.functional.one_hot(
        topi[..., 0].long(), e).float().mean(dim=(0, 1)))
    aux = e * torch.sum(me * ce)

    dispatch, combine = dispatch_combine(topi, tp.f(topv, ax), e,
                                         _capacity(sg, e, k), x.dtype)
    n_local = lp["moe_wi"].shape[0]
    if n_local != e:                     # ep: this rank's experts' columns
        lo = ax.rank * n_local
        dispatch = dispatch[:, :, lo:lo + n_local]
        combine = combine[:, :, lo:lo + n_local]
    xe = torch.einsum("gsec,gsd->egcd", dispatch, tp.f(xg, ax))
    del dispatch
    xe = shard(xe, "experts", None, None, None)
    h = torch.einsum("egcd,edf->egcf", xe, lp["moe_wi"])
    gt = torch.einsum("egcd,edf->egcf", xe, lp["moe_wg"])
    del xe
    h = torch.nn.functional.silu(gt) * h
    del gt
    h = shard(h, "experts", None, None, "moe_mlp")
    ye = torch.einsum("egcf,efd->egcd", h, lp["moe_wo"])
    del h
    ye = shard(ye, "experts", None, None, None)
    y = torch.einsum("egcd,gsec->gsd", ye, combine)
    return y.reshape(b, s, d), aux.float()


def dropped_slots(cfg, lp: dict, x):
    """(B, S) int: how many of each token's k slots the capacity drops
    when ``x`` (B, S, D) enters this layer (the forward's routing, without
    its products)."""
    b, s, d = x.shape
    sg = min(GROUP_SIZE, b * s)
    _, _, topi = route(lp["router"], x.reshape(b * s // sg, sg, d),
                       cfg.top_k)
    _, in_cap = capacity_positions(topi, cfg.n_experts,
                                   _capacity(sg, cfg.n_experts, cfg.top_k))
    return (~in_cap).sum(-1).reshape(b, s)


def moe_ffn_decode(cfg, lp: dict, x, *, topi=None):
    """x: (B, D) single-token MoE: the dense all-experts weighted combine.

    Exact (no capacity drops).  At decode every expert's weights are read
    once either way, so the extra products cost little on the
    memory-bound step.  ``topi`` (B, k) pins the routing (see
    :func:`route`).  Split over ``model`` (``lp["tp"]``,
    :func:`moe_weights`), every rank routes every token (the router is
    replicated) and returns its part, which the caller sums (``tp.g``):
    under ``ep`` its experts' products weighted by their gates, under
    ``tp`` every expert's products on its hidden columns."""
    e, k = cfg.n_experts, cfg.top_k
    _, topv, topi = route(lp["router"], x, k, topi)
    w = torch.zeros(x.shape[0], e, dtype=topv.dtype, device=x.device) \
        .scatter(-1, topi, topv)                        # (B, E) sparse
    n_local = lp["moe_wi"].shape[0]
    if n_local != e:                     # ep: this rank's experts' gates
        lo = lp["tp"].rank * n_local
        w = w[:, lo:lo + n_local]
    h = torch.einsum("bd,edf->ebf", x, lp["moe_wi"])
    g = torch.einsum("bd,edf->ebf", x, lp["moe_wg"])
    h = torch.nn.functional.silu(g) * h
    y = torch.einsum("ebf,efd->ebd", h, lp["moe_wo"])
    return torch.einsum("ebd,be->bd", y, w.to(x.dtype))
