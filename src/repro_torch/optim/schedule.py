"""Learning-rate schedules (port of ``repro.optim.schedule``): pure
functions of the step counter, returning 0-d f32 tensors.

The step may be a python int or a tensor; a tensor keeps the schedule on
its device, so a train step whose counter lives on the card reads no value
back to the host.
"""

from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor * peak_lr``."""

    def schedule(step):
        step = _step_f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def constant(lr: float):
    def schedule(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.tensor(lr, dtype=torch.float32, device=dev)
    return schedule
