"""Learning-rate schedules (cosine with linear warmup, constant, rsqrt),
the reference's ``repro.optim.schedule``: each maps the step, a tensor,
to a 0-d f32 tensor on its device."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_with_warmup", "constant", "rsqrt"]


def cosine_with_warmup(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return sched


def constant(lr: float):
    def sched(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), lr, dtype=torch.float32, device=step.device)

    return sched


def rsqrt(peak_lr: float, warmup: int):
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        return peak_lr * torch.minimum(step / max(warmup, 1),
                                       torch.sqrt(warmup / torch.clamp_min(step, 1.0)))

    return sched
