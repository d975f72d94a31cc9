"""Learning-rate schedules — the port of ``repro/optim/schedules.py``:
pure functions of the step. A step given as a tensor gives a float32 0-d
tensor on its device, computed in float32 as the reference computes it;
a Python step gives the same value on the CPU."""
from __future__ import annotations

import math

import torch


def _f32(x, like=None) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def constant(lr: float):
    return lambda step: _f32(lr, step)


def cosine_annealing(lr_max: float, lr_min: float, total_steps: int):
    """Cosine anneal lr_max -> lr_min over total_steps (paper Sec. C.2)."""

    def sched(step):
        t = torch.clamp(_f32(step, step) / max(total_steps, 1), 0.0, 1.0)
        return lr_min + 0.5 * (lr_max - lr_min) * (1.0 + torch.cos(
            _f32(math.pi, t) * t))

    return sched


def linear_warmup_cosine(lr_max: float, lr_min: float, warmup: int,
                         total: int):
    """Linear warmup to lr_max over ``warmup`` steps, then a cosine anneal
    to lr_min by step ``total`` (the trainer's schedule, ``launch/steps.py``)."""

    def sched(step):
        step = _f32(step, step)
        warm = lr_max * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = lr_min + 0.5 * (lr_max - lr_min) * (1.0 + torch.cos(
            _f32(math.pi, t) * t))
        return torch.where(step < warmup, warm, cos)

    return sched
