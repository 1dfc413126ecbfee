"""The convergence-gap objective Delta (paper eqs. (22)/(26)).

Counterpart of ``repro/core/delta.py``: ``delta_raw`` is the literal
eq. (26) double sum, ``delta`` the per-device decoupled form
sum_k A_k * (sum_j delta_kj sigma_kj)/(sum_j delta_kj), and
``objective`` the Problem-4 objective.  All accept soft selections.
"""
from __future__ import annotations

import torch

from . import cost as cost_mod
from .types import SystemParams

EPSDIV = 1e-12


def selected_mean_sigma(dlt: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """(sum_j delta sigma) / (sum_j delta) per device; delta (K, J)."""
    num = torch.sum(dlt * sigma, dim=1)
    den = torch.sum(dlt, dim=1)
    return num / torch.clamp(den, min=EPSDIV)


def delta(sys: SystemParams, dlt: torch.Tensor,
          sigma: torch.Tensor) -> torch.Tensor:
    """Simplified Delta_hat (eq. 26), O(K*J)."""
    return torch.sum(sys.a_weights() * selected_mean_sigma(dlt, sigma))


def delta_raw(sys: SystemParams, dlt: torch.Tensor,
              sigma: torch.Tensor) -> torch.Tensor:
    """Literal eq. (26) double sum, O(K^2 * J); a test oracle."""
    d = sys.D_hat
    mean_sel = selected_mean_sigma(dlt, sigma)
    own = d * d / sys.eps * mean_sel
    cross_t = d * mean_sel
    cross = d * (torch.sum(cross_t) - cross_t)
    return torch.sum(own + cross)


def objective(sys: SystemParams, dlt: torch.Tensor, sigma: torch.Tensor,
              rho: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Problem 2/4 objective: lambda*Delta_hat + (1-lambda)*C_hat (eq. 27)."""
    n_sel = torch.sum(dlt, dim=1)
    c_hat = (cost_mod.cost_upload(sys, rho, p) + cost_mod.cost_compute(sys)
             - torch.sum(sys.q * n_sel))
    return sys.lam * delta(sys, dlt, sigma) + (1.0 - sys.lam) * c_hat


def selection_only_objective(sys: SystemParams, dlt: torch.Tensor,
                             sigma: torch.Tensor) -> torch.Tensor:
    """lambda*Delta_hat(delta) - (1-lambda)*sum_k q_k sum_j delta_kj, the
    delta-dependent part of the Problem-4 objective."""
    n_sel = torch.sum(dlt, dim=1)
    return (sys.lam * delta(sys, dlt, sigma)
            - (1.0 - sys.lam) * torch.sum(sys.q * n_sel))
