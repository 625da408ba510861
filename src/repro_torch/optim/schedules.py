"""Learning-rate schedules (the JAX package's ``optim/schedules.py``): a
schedule maps the 0-d int32 step tensor to a 0-d f32 learning rate on its
device, with no host read."""

from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda step: torch.full((), value, dtype=torch.float32,
                                   device=step.device)


def cosine_warmup(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    """Linear warm-up to ``peak`` over ``warmup_steps``, then a cosine down
    to ``floor`` at ``total_steps``."""
    def sched(step):
        step = step.to(torch.float32)
        warm = peak * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)

    return sched
