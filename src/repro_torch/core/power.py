"""Power allocation for a fixed RB assignment (paper §IV-B).

Counterpart of ``repro/core/power.py``, closed form only: constraint
(13) makes the program separable per RB, and under the SIC order the
minimum-cost point has every rate constraint tight,

    p_(r) = gamma * N0 * (1 + gamma)^r / h_(r),   r = #weaker co-RB
    gamma = 2^(L / (B*T)) - 1.

The paper-faithful CCP solver (Algorithm 3) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .channel import weaker_than
from .types import SystemParams


def snr_target(sys: SystemParams) -> torch.Tensor:
    """gamma = 2^(L/(B*T)) - 1: per-device SINR needed to push L bits."""
    return 2.0 ** (sys.L / (sys.B * sys.T)) - 1.0


def _weaker(h: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(t, k, n) boolean: active device t is strictly weaker than k on n."""
    return weaker_than(h) & (active[:, None, :] > 0)


def closed_form_power(sys: SystemParams, rho: torch.Tensor, h: torch.Tensor,
                      alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact minimum-cost powers; returns (p, feasible_per_device)."""
    gamma = snr_target(sys)
    active = rho * alpha[:, None]  # only available devices transmit
    rank = torch.einsum("tkn,tn->kn", _weaker(h, active).to(h.dtype), active)
    p = (active * gamma * sys.N0 * (1.0 + gamma) ** rank
         / torch.clamp(h, min=1e-30))
    feas = torch.sum(p, dim=1) <= sys.p_max * (1.0 + 1e-6)
    # an available device with no RB can never satisfy (16)
    matched = torch.sum(active, dim=1) > 0
    return p, feas & (matched | (alpha == 0))


def upload_cost(sys: SystemParams, p: torch.Tensor,
                rho: torch.Tensor) -> torch.Tensor:
    """sum_k c_k sum_n rho p T: the eq. (17) cost of a power matrix."""
    return torch.sum(sys.c[:, None] * rho * p) * sys.T


def allocate_power(sys: SystemParams, rho: torch.Tensor, h: torch.Tensor,
                   alpha: torch.Tensor) -> Tuple[torch.Tensor, float, bool]:
    """Closed-form powers for ``rho``: (p, total upload cost, feasible).

    The reference's ``allocate_power(method="closed_form")``; the cost
    is inf when any device misses its power budget.
    """
    p, feas = closed_form_power(sys, rho, h, alpha)
    ok = bool(torch.all(feas))
    cost = float(upload_cost(sys, p, rho)) if ok else float("inf")
    return p, cost, ok
