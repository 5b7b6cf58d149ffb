"""Public entry points of the port's kernels.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain torch version.  Nothing falls
back from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_cuda, flash_attention_ref)
from repro_torch.kernels.pid_update import (DT_S, PIDGains, pid_update_ref,
                                            pid_update as _pid_cuda)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Blocked attention forward: q (B, Sq, H, D), k and v (B, Sk, Hkv, D)
    -> (B, Sq, H, D) in q's dtype.  Non-causal with Sk not a multiple of
    the kv block raises ``NotImplementedError`` on either device."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash_cuda(q, k, v, causal=causal, window=window)


def pid_update(target, power, temp, integ, prev_err, gains: PIDGains, *,
               dt_s: float = DT_S):
    """Fused fleet PID tick over (N,) float32 tensors:
    returns (new_integ, new_prev_err, cap)."""
    if target.device.type == "cpu":
        return pid_update_ref(target, power, temp, integ, prev_err, gains,
                              dt_s=dt_s)
    return _pid_cuda(target, power, temp, integ, prev_err, gains, dt_s=dt_s)
