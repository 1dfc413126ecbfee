"""Optimizers of the port (counterpart of ``repro.optim``).

GradientTransformation-style API over dicts of named tensors:
    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    apply_updates(params, updates)
"""
from .optimizers import (AdafactorState, AdamState, GradientTransformation,
                         adafactor, adam, adamw, apply_updates, chain,
                         clip_by_global_norm, global_norm, momentum,
                         scale_by_schedule, sgd)
from .schedules import constant_schedule, cosine_schedule, warmup_cosine

__all__ = [
    "GradientTransformation", "adam", "adamw", "adafactor", "sgd",
    "momentum", "chain", "clip_by_global_norm", "apply_updates",
    "global_norm", "scale_by_schedule", "constant_schedule",
    "cosine_schedule", "warmup_cosine", "AdamState", "AdafactorState",
]
