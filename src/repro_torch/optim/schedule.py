"""LR schedules (pure functions of the step counter; port of
``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, warmup: int, total: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_ratio``; returns a float32
    multiplier on the step tensor's device (no host sync)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
