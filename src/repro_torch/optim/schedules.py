"""LR schedules: functions of the 0-d step tensor (the JAX package's
``optim/schedules.py``), giving a 0-d fp32 tensor on its device."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warm-up from 0 to ``peak_lr`` over ``warmup_steps``, then a
    cosine decay to ``min_ratio * peak_lr`` at ``total_steps``."""
    def f(step):
        s = step.float()
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                                 * prog))
        return peak_lr * torch.where(s < warmup_steps, warm, cos)
    return f
