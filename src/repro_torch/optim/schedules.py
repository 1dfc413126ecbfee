"""Learning-rate schedules (step -> multiplier).

Counterpart of ``repro/optim/schedules.py``: each schedule maps a step
count (an int or a tensor) to a 0-d float32 CPU tensor, computed in
float32 as the reference computes it.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

Step = Union[int, torch.Tensor]
Schedule = Callable[[Step], torch.Tensor]


def _f32(step: Step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32).cpu()


def constant_schedule(value: float = 1.0) -> Schedule:
    return lambda step: torch.tensor(value, dtype=torch.float32)


def cosine_schedule(total_steps: int, final_frac: float = 0.1) -> Schedule:
    def fn(step: Step) -> torch.Tensor:
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return final_frac + (1.0 - final_frac) * cos

    return fn


def warmup_cosine(warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    cos = cosine_schedule(max(total_steps - warmup_steps, 1), final_frac)

    def fn(step: Step) -> torch.Tensor:
        s = _f32(step)
        warm = s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm,
                           cos(torch.as_tensor(step) - warmup_steps))

    return fn
