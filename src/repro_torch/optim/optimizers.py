"""Adam as a transformation of named tensors.

Counterpart of ``repro/optim/optimizers.py::adam`` (no weight decay),
written out as the reference writes it rather than with
``torch.optim.Adam``: eps is added outside the square root of the
bias-corrected second moment, and the bias corrections are float32.

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state)
    apply_updates(params, updates)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[Tensors], "AdamState"]
    update: Callable[[Tensors, "AdamState"], Tuple[Tensors, "AdamState"]]


class AdamState(NamedTuple):
    count: int
    mu: Tensors
    nu: Tensors


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    """params += updates, in place (the parameters are the model's own
    tensors, so the module sees the step without a copy)."""
    for name, p in params.items():
        p.add_(updates[name])
    return params


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    def init(params: Tensors) -> AdamState:
        def zeros():
            return {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in params.items()}
        return AdamState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(grads: Tensors, state: AdamState) -> Tuple[Tensors, AdamState]:
        count = state.count + 1
        mu = {n: b1 * state.mu[n] + (1 - b1) * g.float()
              for n, g in grads.items()}
        nu = {n: b2 * state.nu[n] + (1 - b2) * g.float() ** 2
              for n, g in grads.items()}
        # float32 bias corrections, 1 - b^count, as the reference's
        # count.astype(float32) computes them
        one, c = np.float32(1.0), np.float32(count)
        bc1 = float(one - np.float32(b1) ** c)
        bc2 = float(one - np.float32(b2) ** c)
        updates = {n: -lr * (mu[n] / bc1 / (torch.sqrt(nu[n] / bc2) + eps))
                   for n in grads}
        return updates, AdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)
