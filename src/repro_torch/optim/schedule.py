"""Learning-rate schedules (counterpart of ``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float = 3e-4, warmup: int = 100,
                  total: int = 10_000, floor: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``.  ``step`` an int (-> a
    float) or a tensor (-> an f32 tensor on its device, computed in
    f32 as the reference computes it)."""
    if not isinstance(step, torch.Tensor):
        return float(warmup_cosine(torch.tensor(step), peak_lr=peak_lr,
                                   warmup=warmup, total=total, floor=floor))
    f32 = torch.float32
    step = step.to(f32)
    warm = peak_lr * torch.clamp_max((step + 1) / warmup, 1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    pi = torch.tensor(math.pi, dtype=f32)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(pi * frac)))
    return torch.where(step < warmup, warm, cos)
