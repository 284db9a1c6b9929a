"""Learning-rate schedules as step -> lr callables, the port of
``src/repro/optim/schedules.py``: ``step`` an integer tensor (or a Python
int), the rate an f32 tensor on the step's device."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).to(_F32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=_F32, device=torch.as_tensor(step).device)


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        s = _steps(step)
        return lr * torch.clamp_max((s + 1.0) / max(1, warmup_steps), 1.0)

    return fn


def cosine(lr: float, total_steps: int, warmup_steps: int = 0, final_frac: float = 0.1):
    def fn(step):
        s = _steps(step)
        warm = (torch.clamp_max((s + 1.0) / max(1, warmup_steps), 1.0) if warmup_steps
                else 1.0)
        prog = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr * warm * cos

    return fn
