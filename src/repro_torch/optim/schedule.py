"""LR schedules (pure functions of the step counter), as the reference's
``optim/schedule.py``."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_with_warmup"]


def cosine_with_warmup(step, *, warmup: int, total: int,
                       min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``min_ratio`` at ``total``: a float32 scalar on ``step``'s device
    (``step`` an int or an integer tensor), computed in float32 as the
    reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
