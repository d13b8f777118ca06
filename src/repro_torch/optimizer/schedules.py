"""Learning-rate schedules (functions of the step tensor), in float32
as the JAX package computes them."""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_warmup_schedule(step, *, warmup_steps: int, total_steps: int,
                           min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to min_ratio; returns a float32
    scale in (0, 1] to multiply the base lr."""
    step = _step_f32(step)
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - warmup_steps) /
                       max(total_steps - warmup_steps, 1), 0.0, 1.0)
    # the float32 argument's cosine taken in float64 and rounded once:
    # XLA's float32 cosine is nearer the correctly rounded value than
    # torch's (they differ on 1.3 % and 4.9 % of arguments in [0, pi])
    c = torch.cos((math.pi * prog).double()).float()
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + c)
    return warm * cos


def linear_warmup_schedule(step, *, warmup_steps: int) -> torch.Tensor:
    step = _step_f32(step)
    return torch.clamp(step / max(warmup_steps, 1), max=1.0)
