"""Learning-rate schedules: the counterpart of `repro/optim/schedule.py`."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step: torch.Tensor, *, peak_lr: float, warmup_steps: int,
                       total_steps: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to `peak_lr`, then a cosine down to `floor * peak_lr`.
    `step`: a 0-d int32 tensor; returns a 0-d float32 tensor on its device."""
    s = step.to(torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    frac = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < warmup_steps, warm, cos)
