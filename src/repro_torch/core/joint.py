"""Algorithm 1: joint resource allocation + data selection.

Counterpart of ``repro/core/joint.py``, no-fault path with the
closed-form power evaluator: solve Problem 3 (RB assignment + power)
with Algorithm 2, then Problem 4 (data selection) with Algorithms 4/5,
and bill the decision (eqs. 18, 26).  The baseline schemes, the CCP
evaluator and the solver fallback chain are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import cost as cost_mod
from . import delta as delta_mod
from . import matching as matching_mod
from . import selection as selection_mod
from .types import RoundState, SystemParams


@dataclasses.dataclass
class RoundDecision:
    """Server decision for one communication round."""

    rho: np.ndarray         # (K, N) RB assignment
    p: torch.Tensor         # (K, N) powers
    delta: torch.Tensor     # (K, J) binary data selection
    net_cost: float         # eq. (18)
    delta_obj: float        # Delta_hat(delta), eq. (26)
    objective: float        # Problem-2 objective
    feasible: bool
    swaps: int = 0
    #: available devices the matching could not give an RB.
    unmatched: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    #: the continuous GP point delta† behind a faithful selection (Alg. 4
    #: output before Alg. 5's rounding); None for the exact selector.
    delta_cont: Optional[torch.Tensor] = None


def _finish(sys: SystemParams, rho: np.ndarray, p: torch.Tensor,
            delta: torch.Tensor, state: RoundState, feasible: bool,
            swaps: int = 0, unmatched=None,
            delta_cont: Optional[torch.Tensor] = None) -> RoundDecision:
    rho_t = torch.as_tensor(rho, dtype=torch.float32, device=sys.device)
    n_sel = torch.sum(delta, dim=1)
    nc = float(cost_mod.net_cost(sys, rho_t, p, n_sel))
    dv = float(delta_mod.delta(sys, delta, state.sigma))
    obj = float(sys.lam) * dv + (1.0 - float(sys.lam)) * nc
    if unmatched is None:
        unmatched = np.zeros(0, np.int64)
    return RoundDecision(rho=np.asarray(rho), p=p, delta=delta, net_cost=nc,
                         delta_obj=dv, objective=obj, feasible=feasible,
                         swaps=swaps,
                         unmatched=np.asarray(unmatched, np.int64),
                         delta_cont=delta_cont)


def proposed_scheme(sys: SystemParams, state: RoundState,
                    selection_method: str = "faithful",
                    gp_steps: int = 400) -> RoundDecision:
    """Algorithm 1 (the paper's proposed scheme)."""
    match = matching_mod.swap_matching(sys, state.h, state.alpha)
    delta, d_cont = selection_mod.solve_selection(
        sys, state.sigma, state.sigma_mask, method=selection_method,
        steps=gp_steps)
    return _finish(sys, match.rho, match.p, delta, state,
                   feasible=match.feasible, swaps=match.swaps,
                   unmatched=match.unmatched, delta_cont=d_cont)
