"""LR schedules; counterpart of ``src/repro/optim/schedule.py``."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, peak_lr: float, warmup: int, total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine to ``floor * peak_lr``
    at ``total``; a float32 tensor, as the reference's."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)
