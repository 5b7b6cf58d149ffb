"""LR schedules: the port of ``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine to ``final_frac`` of it
    at ``total_steps``.  A 0-d float32 tensor on ``step``'s device (the
    CPU for a Python int), so it meets the parameters as a scalar."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup_steps, warm, peak_lr * cos)
