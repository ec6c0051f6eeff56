"""LR schedules (cosine with linear warmup, constant, rsqrt) on a step
tensor, as the JAX package's ``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    step = step.float()
    warm = step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def rsqrt(step, *, warmup_steps: int):
    step = torch.clamp(step.float(), min=1.0)
    return torch.minimum(step / warmup_steps,
                         torch.sqrt(warmup_steps / step))


def constant(step, **_):
    return torch.ones_like(step, dtype=torch.float32)
