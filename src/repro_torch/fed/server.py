"""Server-side aggregation (paper §II-D).

Counterpart of ``repro/fed/server.py`` (plain eq. (19); the reference's
survivor re-normalization belongs to the resilience layer, not ported):

    g_hat = (1/|D̂|) sum_k (|D̂_k|/eps_k) * alpha_k * g_k,

unbiased under alpha_k ~ Bernoulli(eps_k) (Lemma 1).  A device with
eps_k == 0 can never be available; its weight is 0, not 0/0.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core.types import SystemParams


def ipw_weights(sys: SystemParams, alpha: torch.Tensor) -> torch.Tensor:
    """Unnormalized eq.-(19) weights |D̂_k|/eps_k * alpha_k."""
    eps_safe = torch.where(sys.eps > 0, sys.eps, 1.0)
    live = (sys.eps > 0).to(alpha.dtype)
    return (sys.D_hat / eps_safe) * alpha * live


def ipw_mass(sys: SystemParams, alpha: torch.Tensor) -> float:
    """Total realized IPW weight; 0.0 means no upload to aggregate."""
    return float(torch.sum(ipw_weights(sys, alpha)))


def aggregate_gradients(sys: SystemParams,
                        local_grads: Dict[str, torch.Tensor],
                        alpha: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``local_grads``: name -> tensor with a leading K axis."""
    w = ipw_weights(sys, alpha) / sys.D_hat_total
    return {name: torch.tensordot(w.to(leaf.dtype), leaf, dims=1)
            for name, leaf in local_grads.items()}
