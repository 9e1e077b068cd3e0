"""Learning-rate schedules: step (a 0-d integer tensor) → lr (a 0-d
float32 tensor on the step's device).  Port of
``src/repro/optim/schedules.py``: the same float32 operations in the
same order."""
from __future__ import annotations

import math

import torch

f32 = torch.float32


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=f32, device=step.device)


def linear_warmup(peak: float, warmup_steps: int):
    def f(step):
        frac = torch.clamp(step.to(f32) / max(warmup_steps, 1), max=1.0)
        return peak * frac
    return f


def cosine_decay(peak: float, decay_steps: int, floor: float = 0.0):
    def f(step):
        t = torch.clamp(step.to(f32) / decay_steps, 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
    return f


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def f(step):
        s = step.to(f32)
        warm = peak * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, cos)
    return f
