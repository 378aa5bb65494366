"""Learning-rate schedules (``repro.optim.schedules``): functions of an
int32 step tensor, computed in float32 as the reference computes them."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    """Linear warmup to ``base_lr``, then a cosine down to
    ``min_ratio * base_lr`` at ``total_steps``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
