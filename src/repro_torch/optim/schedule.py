"""LR schedules (pure functions of the step counter).

Port of ``repro.optim.schedule``: the same float32 arithmetic, on the
step's device when it is a tensor (so a training step needs no host
read of its counter)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, warmup: int, total: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to min_ratio. Returns a float32 scale
    in (0, 1] to multiply the base lr."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
