"""Energy / reward / net-cost model (paper eqs. (7)-(18)).

Counterpart of ``repro/core/cost.py``.
"""
from __future__ import annotations

import torch

from .types import SystemParams


def compute_time(sys: SystemParams) -> torch.Tensor:
    """tau_k = F_k |D̂_k| / f_k  (eq. 8)."""
    return sys.F * sys.D_hat / sys.f


def energy_compute(sys: SystemParams) -> torch.Tensor:
    """E^cmp_k = kappa F_k |D̂_k| f_k^2  (eq. 9)."""
    return sys.kappa * sys.F * sys.D_hat * sys.f ** 2


def cost_compute(sys: SystemParams) -> torch.Tensor:
    """C^cmp = sum_k c_k E^cmp_k  (eq. 10); constant in every decision."""
    return torch.sum(sys.c * energy_compute(sys))


def energy_upload(sys: SystemParams, rho: torch.Tensor,
                  p: torch.Tensor) -> torch.Tensor:
    """E^com_k = sum_n rho_{k,n} p_{k,n} T  (below eq. 16)."""
    return torch.sum(rho * p, dim=1) * sys.T


def cost_upload(sys: SystemParams, rho: torch.Tensor,
                p: torch.Tensor) -> torch.Tensor:
    """C^com = sum_k c_k E^com_k  (eq. 17)."""
    return torch.sum(sys.c * energy_upload(sys, rho, p))


def reward(sys: SystemParams, n_selected: torch.Tensor) -> torch.Tensor:
    """R(M) = sum_k q_k |M_k|  (eq. 7); n_selected is (K,)."""
    return torch.sum(sys.q * n_selected)


def net_cost(sys: SystemParams, rho: torch.Tensor, p: torch.Tensor,
             n_selected: torch.Tensor) -> torch.Tensor:
    """C = C^com + C^cmp - R  (eq. 18)."""
    return (cost_upload(sys, rho, p) + cost_compute(sys)
            - reward(sys, n_selected))


def resource_cost(sys: SystemParams, rho: torch.Tensor,
                  p: torch.Tensor) -> torch.Tensor:
    """Objective of Problem 3: C^com + C^cmp (the reward is delta-only)."""
    return cost_upload(sys, rho, p) + cost_compute(sys)
