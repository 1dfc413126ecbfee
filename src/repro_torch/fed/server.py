"""Server-side aggregation (paper §II-D).

Counterpart of ``repro/fed/server.py``:

    g_hat = (1/|D̂|) sum_k (|D̂_k|/eps_k) * alpha_k * g_k,    (eq. 19)

unbiased under alpha_k ~ Bernoulli(eps_k) (Lemma 1).  A device with
eps_k == 0 can never be available; its weight is 0, not 0/0.

``renormalize=True`` (the resilience layer's survivor aggregation)
divides by the realized IPW mass of the surviving uploads instead of
the planned |D̂| total, so g_hat stays a convex combination of the
surviving local gradients when uploads are lost after the allocation
was fixed.  With no survivor the result is all zeros; callers check
``ipw_mass`` first and skip the optimizer update.
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
                        alpha: torch.Tensor,
                        renormalize: bool = False) -> Dict[str, torch.Tensor]:
    """``local_grads``: name -> tensor with a leading K axis."""
    w = ipw_weights(sys, alpha)
    if renormalize:
        denom = torch.sum(w)
        w = torch.where(denom > 0, w / torch.where(denom > 0, denom, 1.0),
                        0.0)
    else:
        w = w / sys.D_hat_total
    return {name: torch.tensordot(w.to(leaf.dtype), leaf, dims=1)
            for name, leaf in local_grads.items()}
