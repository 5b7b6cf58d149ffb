"""Tier-2: per-host AR(4) utilisation predictor fitted by RLS (paper
Eq. 2): the port of ``repro.core.ar4``.

    u_hat(t+1) = sum_{i=1..4} alpha_i u(t-i+1)

fitted by Recursive Least Squares with forgetting factor 0.97 at a 1 Hz
tick.  The state batches over any leading axes: the engine carries
(N, H) hosts across N scenarios.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device

ORDER = 4
FORGET = 0.97
WINDOW_S = 30
TICK_HZ = 1.0


class RLSState(NamedTuple):
    theta: torch.Tensor  # (..., ORDER) AR coefficients
    P: torch.Tensor      # (..., ORDER, ORDER) inverse covariance
    hist: torch.Tensor   # (..., ORDER) most recent samples, [..., 0] newest
    steps: torch.Tensor  # (...,) int32 samples seen


def init_rls(n, p0: float = 100.0, *, device="cuda") -> RLSState:
    """Initial state for ``n`` hosts; ``n`` may be a shape tuple."""
    dev = resolve_device(device)
    lead = (n,) if isinstance(n, int) else tuple(n)
    theta = torch.zeros(lead + (ORDER,), dtype=torch.float32, device=dev)
    theta[..., 0] = 1.0
    eye = torch.eye(ORDER, dtype=torch.float32, device=dev)
    return RLSState(
        theta=theta,
        P=(eye * p0).expand(lead + (ORDER, ORDER)).clone(),
        hist=torch.zeros(lead + (ORDER,), dtype=torch.float32, device=dev),
        steps=torch.zeros(lead, dtype=torch.int32, device=dev),
    )


def predict(state: RLSState) -> torch.Tensor:
    """One-step-ahead prediction u_hat(t+1) per host."""
    return (state.theta * state.hist).sum(-1)


def rls_update(state: RLSState, u_new: torch.Tensor,
               lam: float = FORGET) -> tuple[RLSState, torch.Tensor]:
    """Observe u(t+1) = u_new, update theta, slide the window.

    Returns (new_state, |a-priori one-step error|).  Feed normalised
    series: float32 RLS on O(100) inputs loses positive-definiteness.
    """
    phi = state.hist
    err = u_new - (state.theta * phi).sum(-1)
    Pphi = (state.P * phi.unsqueeze(-2)).sum(-1)
    denom = lam + (phi * Pphi).sum(-1)
    k = Pphi / denom.unsqueeze(-1)
    theta = state.theta + k * err.unsqueeze(-1)
    P = (state.P - k.unsqueeze(-1) * Pphi.unsqueeze(-2)) / lam
    # symmetry (float32 drift) and the covariance ceiling against windup
    P = 0.5 * (P + P.transpose(-1, -2))
    tr = torch.diagonal(P, dim1=-2, dim2=-1).sum(-1)
    max_tr = 1e4 * ORDER
    P = P * torch.clamp(max_tr / torch.clamp(tr, min=1e-9),
                        max=1.0)[..., None, None]
    # warm-up: trust the model only once the window holds ORDER samples
    warm = (state.steps >= ORDER).unsqueeze(-1)
    theta = torch.where(warm, theta, state.theta)
    P = torch.where(warm.unsqueeze(-1), P, state.P)
    hist = torch.cat([u_new.unsqueeze(-1), state.hist[..., :-1]], dim=-1)
    new = RLSState(theta=theta, P=P, hist=hist, steps=state.steps + 1)
    return new, torch.abs(err)


def host_rebalance(pred_host_power, host_envelope, chip_power,
                   cap_min: float, cap_max: float) -> torch.Tensor:
    """Split each host envelope into per-chip caps proportionally to
    demand: chip_power (..., H, C), pred/envelope (..., H)."""
    scale = torch.where(
        pred_host_power > host_envelope,
        host_envelope / torch.clamp(pred_host_power, min=1e-3), 1.0)
    share = chip_power * scale.unsqueeze(-1)
    headroom = torch.clamp(
        host_envelope.unsqueeze(-1) - share.sum(-1, keepdim=True), min=0.0)
    caps = share + headroom / chip_power.shape[-1]
    return torch.clamp(caps, cap_min, cap_max)
