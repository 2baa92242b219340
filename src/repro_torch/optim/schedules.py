"""Learning-rate schedules, step -> lr with a 1-based step (port of
``repro/optim/schedules.py``). Each returns a float32 0-d tensor."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_linear", "warmup_cosine"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32)


def warmup_linear(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def sched(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        decay = peak + (floor - peak) * frac
        return torch.where(step < warmup_steps, warm, decay)
    return sched


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def sched(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        decay = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, decay)
    return sched
