"""Algorithm 1: joint resource allocation + data selection, and the four
baseline schemes of paper §VI-A.

Counterpart of ``repro/core/joint.py``, no-fault path: solve Problem 3
(RB assignment + power) with Algorithm 2 (closed-form or CCP evaluator),
then Problem 4 (data selection) with Algorithms 4/5, and bill the
decision (eqs. 18, 26).  The solver fallback chain is not ported yet: a
failed solve raises.

Telemetry, as in the reference: the proposed scheme's stages run
``matching`` and ``power`` (inside ``swap_matching``), ``selection``
and ``objective``; a baseline's run ``selection``, ``matching``,
``power`` and ``objective``.  ``_finish`` sets the ``feel_decision*``
metrics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..obs import metrics as metrics_mod
from . import cost as cost_mod
from . import delta as delta_mod
from . import matching as matching_mod
from . import power as power_mod
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
            delta_cont: Optional[torch.Tensor] = None,
            telemetry=None) -> RoundDecision:
    tele = obs.resolve(telemetry)
    with tele.stage("objective"):
        rho_t = torch.as_tensor(rho, dtype=torch.float32, device=sys.device)
        n_sel = torch.sum(delta, dim=1)
        nc = float(cost_mod.net_cost(sys, rho_t, p, n_sel))
        dv = float(delta_mod.delta(sys, delta, state.sigma))
        obj = float(sys.lam) * dv + (1.0 - float(sys.lam)) * nc
    reg = metrics_mod.get_default()
    if reg.enabled:
        reg.counter("feel_decisions_total",
                    "round decisions evaluated (eq. 18 + eq. 26)").inc()
        reg.gauge("feel_decision_net_cost",
                  "net cost (eq. 18) of the last round decision").set(nc)
        reg.gauge("feel_decision_delta_obj",
                  "Delta_hat (eq. 26) of the last round decision").set(dv)
    if unmatched is None:
        unmatched = np.zeros(0, np.int64)
    return RoundDecision(rho=np.asarray(rho), p=p, delta=delta, net_cost=nc,
                         delta_obj=dv, objective=obj, feasible=feasible,
                         swaps=swaps,
                         unmatched=np.asarray(unmatched, np.int64),
                         delta_cont=delta_cont)


def proposed_scheme(sys: SystemParams, state: RoundState,
                    selection_method: str = "faithful",
                    power_evaluator: str = "closed_form",
                    gp_steps: int = 400, telemetry=None) -> RoundDecision:
    """Algorithm 1 (the paper's proposed scheme).  ``power_evaluator``
    prices the matching's candidates (``"closed_form"`` or ``"ccp"``)."""
    tele = obs.resolve(telemetry)
    match = matching_mod.swap_matching(sys, state.h, state.alpha,
                                       evaluator=power_evaluator,
                                       telemetry=tele)
    with tele.stage("selection"):
        delta, d_cont = selection_mod.solve_selection(
            sys, state.sigma, state.sigma_mask, method=selection_method,
            steps=gp_steps, telemetry=tele)
    return _finish(sys, match.rho, match.p, delta, state,
                   feasible=match.feasible, swaps=match.swaps,
                   unmatched=match.unmatched, delta_cont=d_cont,
                   telemetry=tele)


# --------------------------------------------------------------------------
# Baselines 1-4 (paper §VI-A).  Data: random half / all samples.
# RB: each device prefers its min- / max-gain RB (greedy, capacity Q).
# Power: the exact closed form, the optimum of Algorithm 3's problem.
# --------------------------------------------------------------------------

def _greedy_rb(sys: SystemParams, h: np.ndarray, alpha: np.ndarray,
               prefer_max: bool) -> np.ndarray:
    """Available devices, in index order, each take their best (or
    worst) RB that still has one of its Q slots; (K, N) rho."""
    K, N, Q = sys.K, sys.N, sys.Q
    assign = np.full(K, -1, np.int64)
    slots = np.full(N, Q, np.int64)
    for k in np.flatnonzero(alpha > 0):
        prefs = np.argsort(-h[k] if prefer_max else h[k], kind="stable")
        for n in prefs:
            if slots[n] > 0:
                assign[k] = n
                slots[n] -= 1
                break
    rho = np.zeros((K, N), np.float32)
    m = assign >= 0
    rho[np.flatnonzero(m), assign[m]] = 1.0
    return rho


def _random_half(mask: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 scores: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random half of each device's samples (at least one).

    ``scores``: (K, J) uniforms in [0, 1); drawn from ``generator`` on
    the CPU when not given, so a run on the card and its CPU replay pick
    the same half.  The samples with the floor(n/2) largest masked
    scores are kept (stable ranks, as the reference's double argsort).
    """
    if scores is None:
        scores = torch.rand(tuple(mask.shape), generator=generator)
    scores = scores.to(mask.device, torch.float32) * mask
    n_valid = torch.sum(mask, dim=1)
    want = torch.clamp(torch.floor(n_valid / 2.0), min=1.0)
    order = torch.argsort(-scores, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    return (ranks < want[:, None]).to(torch.float32) * mask


def baseline_scheme(sys: SystemParams, state: RoundState, index: int,
                    generator: Optional[torch.Generator] = None,
                    telemetry=None) -> RoundDecision:
    """Baselines 1-4: (half|all data) x (min|max gain RB).  Baselines 1
    and 2 draw their half from ``generator``."""
    if index not in (1, 2, 3, 4):
        raise ValueError("baseline index must be 1..4")
    tele = obs.resolve(telemetry)
    half = index in (1, 2)
    prefer_max = index in (2, 4)
    with tele.stage("selection"):
        if half:
            if generator is None:
                raise ValueError("baselines 1/2 need a generator")
            delta = tele.block(_random_half(state.sigma_mask, generator))
        else:
            delta = state.sigma_mask
    h = state.h.cpu().numpy()
    alpha = state.alpha.cpu().numpy()
    with tele.stage("matching"):
        rho = _greedy_rb(sys, h, alpha, prefer_max)
    with tele.stage("power"):
        p, _, ok = power_mod.allocate_power(sys, rho, state.h, state.alpha,
                                            telemetry=tele)
        p = tele.block(p)
    return _finish(sys, rho, p, delta, state, feasible=ok, telemetry=tele)
