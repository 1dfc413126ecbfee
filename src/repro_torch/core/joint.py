"""Algorithm 1: joint resource allocation + data selection, and the four
baseline schemes of paper §VI-A.

Counterpart of ``repro/core/joint.py``: solve Problem 3 (RB assignment
+ power) with Algorithm 2 (closed-form or CCP evaluator), then Problem 4
(data selection) with Algorithms 4/5, and bill the decision (eqs. 18,
26).

The solver fallback chain, as in the reference: a CCP power failure
degrades to the closed-form evaluator; a failed matching (an exception,
or a fault plan's forced failure) to greedy max-gain RBs with
closed-form powers (``_greedy_fallback``, which cannot raise); with
``repair_infeasible`` a naturally infeasible matching also goes through
the greedy repair when that restores feasibility.  Every degradation is
a ``fault`` trace event, a ``feel_fallbacks_total`` count and a label in
``RoundDecision.fallbacks``.

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
    #: solver degradations taken while producing this decision, e.g.
    #: ("matching->greedy", "ccp->closed_form"); empty = clean solve.
    fallbacks: tuple = ()


def _finish(sys: SystemParams, rho: np.ndarray, p: torch.Tensor,
            delta: torch.Tensor, state: RoundState, feasible: bool,
            swaps: int = 0, unmatched=None,
            delta_cont: Optional[torch.Tensor] = None,
            fallbacks: tuple = (), telemetry=None) -> RoundDecision:
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
                         delta_cont=delta_cont, fallbacks=tuple(fallbacks))


def _count_injected(kind: str, n: int = 1) -> None:
    reg = metrics_mod.get_default()
    if reg.enabled and n:
        reg.counter("feel_faults_injected_total",
                    "faults injected by the FaultPlan, by kind").inc(
                        n, kind=kind)


def _count_fallback(solver: str, to: str) -> None:
    reg = metrics_mod.get_default()
    if reg.enabled:
        reg.counter("feel_fallbacks_total",
                    "solver degradations by solver and target").inc(
                        1, solver=solver, to=to)


def _greedy_fallback(sys: SystemParams, state: RoundState, tele,
                     injected: bool, reason: str):
    """Terminal link of the matching chain: greedy max-gain RB
    assignment (the baseline-3/4 construction) + exact closed-form
    powers.  Host numpy + one closed-form solve; cannot raise."""
    alpha = state.alpha.cpu().numpy()
    with tele.span("joint.greedy_fallback", reason=reason):
        rho = _greedy_rb(sys, state.h.cpu().numpy(), alpha, prefer_max=True)
        with tele.stage("power"):
            p, _, ok = power_mod.allocate_power(sys, rho, state.h,
                                                state.alpha, telemetry=tele)
            p = tele.block(p)
    tele.fault("fallback", injected=injected, solver="matching",
               to="greedy", reason=reason)
    _count_fallback("matching", "greedy")
    avail = np.flatnonzero(alpha > 0)
    unmatched = avail[rho[avail].sum(axis=1) <= 0]
    return rho, p, ok and unmatched.size == 0, unmatched


def proposed_scheme(sys: SystemParams, state: RoundState,
                    selection_method: str = "faithful",
                    power_evaluator: str = "closed_form",
                    gp_steps: int = 400, gp_step0: float = 0.3,
                    matching_mode: str = "auto", selection_chunk: int = 0,
                    faults=None, repair_infeasible: bool = False,
                    telemetry=None) -> RoundDecision:
    """Algorithm 1 (the paper's proposed scheme).  ``power_evaluator``
    prices the matching's candidates (``"closed_form"`` or ``"ccp"``).

    ``matching_mode`` picks the swap-matching sweep (``"scalar"``,
    ``"batched"`` or ``"auto"``; a CCP evaluator always runs ``"auto"``,
    as in the reference), ``selection_chunk`` the reference's
    device-chunked gradient projection (0: the full matrix; the port's
    iterates are the same for every chunk) and ``gp_step0`` its step
    constant.

    ``faults``: an optional ``fed.faults.RoundFaults`` whose
    ``fail_power``/``fail_matching`` force the corresponding solve to
    fail so the fallback chain runs.  The chain also catches natural
    failures: a solver exception degrades instead of propagating.

    ``repair_infeasible``: also route a naturally infeasible matching
    through the greedy fallback when that repairs feasibility.  Off by
    default, so a plain run keeps the matching's decision;
    ``FEELTrainer`` turns it on with its resilience layer.
    """
    tele = obs.resolve(telemetry)
    fallbacks = []
    evaluator = power_evaluator

    # forced power failure: downgrade the evaluator up front; the closed
    # form is the chain's terminal link, so there the failure is only
    # recorded and the solve proceeds
    if faults is not None and faults.fail_power:
        tele.fault("solver_fail", injected=True, solver="power",
                   method=evaluator)
        _count_injected("solver_fail")
        if evaluator != "closed_form":
            tele.fault("fallback", injected=True, solver="power",
                       to="closed_form", reason="injected")
            _count_fallback("power", "closed_form")
            fallbacks.append(f"{evaluator}->closed_form")
            evaluator = "closed_form"

    # matching, with the greedy terminal fallback
    match = None
    if faults is not None and faults.fail_matching:
        tele.fault("solver_fail", injected=True, solver="matching")
        _count_injected("solver_fail")
        matching_reason = "injected"
    else:
        matching_reason = None
        try:
            match = matching_mod.swap_matching(
                sys, state.h, state.alpha, evaluator=evaluator,
                mode=(matching_mode if evaluator == "closed_form"
                      else "auto"),
                telemetry=tele)
        except Exception as e:  # degrade, don't die
            matching_reason = type(e).__name__
            tele.fault("solver_fail", injected=False, solver="matching",
                       reason=matching_reason)
            if evaluator != "closed_form":
                # the CCP scorer may be the culprit: retry the matching
                # with the exact closed-form evaluator first
                tele.fault("fallback", injected=False, solver="power",
                           to="closed_form", reason=matching_reason)
                _count_fallback("power", "closed_form")
                fallbacks.append(f"{evaluator}->closed_form")
                evaluator = "closed_form"
                try:
                    match = matching_mod.swap_matching(
                        sys, state.h, state.alpha, evaluator=evaluator,
                        mode=matching_mode, telemetry=tele)
                except Exception as e2:  # both evaluators failed
                    matching_reason = type(e2).__name__

    if match is not None and match.feasible:
        rho, p = match.rho, match.p
        feasible, swaps, unmatched = True, match.swaps, match.unmatched
    elif match is not None:
        # naturally infeasible (but non-crashing) matching: with
        # repair_infeasible, the greedy fallback often repairs
        # feasibility (max-gain assignments need less power); otherwise
        # the infeasible decision stands
        repaired = False
        if repair_infeasible:
            rho_g, p_g, ok_g, un_g = _greedy_fallback(
                sys, state, tele, injected=False, reason="infeasible")
            if ok_g:
                rho, p, feasible, swaps = rho_g, p_g, True, 0
                unmatched = un_g
                fallbacks.append("matching->greedy")
                repaired = True
        if not repaired:
            rho, p = match.rho, match.p
            feasible, swaps = False, match.swaps
            unmatched = match.unmatched
    else:
        rho, p, feasible, unmatched = _greedy_fallback(
            sys, state, tele,
            injected=bool(faults is not None and faults.fail_matching),
            reason=matching_reason or "unknown")
        swaps = 0
        fallbacks.append("matching->greedy")

    with tele.stage("selection"):
        delta, d_cont = selection_mod.solve_selection(
            sys, state.sigma, state.sigma_mask, method=selection_method,
            steps=gp_steps, step0=gp_step0, device_chunk=selection_chunk,
            telemetry=tele)
    return _finish(sys, rho, p, delta, state, feasible=feasible,
                   swaps=swaps, unmatched=unmatched, delta_cont=d_cont,
                   fallbacks=tuple(fallbacks), telemetry=tele)


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
