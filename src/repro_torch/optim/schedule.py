"""Learning-rate schedules (pure functions of the step counter), in
float32 as the JAX package computes them; they return a 0-d float32
tensor on the step's device (the CPU for a host int)."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def linear_warmup(step, warmup_steps: int, peak_lr: float) -> torch.Tensor:
    s = _f32(step)
    return peak_lr * torch.clamp((s + 1) / max(1, warmup_steps), max=1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int,
                    peak_lr: float, final_lr_frac: float = 0.1
                    ) -> torch.Tensor:
    s = _f32(step)
    warm = linear_warmup(step, warmup_steps, peak_lr)
    t = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps),
                    0, 1)
    cos = final_lr_frac + (1 - final_lr_frac) * 0.5 * (1 + torch.cos(
        math.pi * t))
    return torch.where(s < warmup_steps, warm, peak_lr * cos)
