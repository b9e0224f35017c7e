"""Learning-rate schedules (the JAX package's ``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                  min_frac: float = 0.1):
    """lr(step): linear warm-up to ``base_lr`` over ``warmup_steps``, then
    a cosine down to ``min_frac``·base_lr at ``total_steps``; a float32
    tensor on the step's device (a step given as a number: on the CPU)."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        full = lambda v: torch.full_like(step, v)   # a tensor divisor
        warm = base_lr * torch.clamp(step / full(max(warmup_steps, 1)),
                                     max=1.0)
        t = torch.clamp((step - warmup_steps)
                        / full(max(total_steps - warmup_steps, 1)), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
