"""Swap-matching RB assignment (paper §IV-A, Algorithm 2).

Counterpart of ``repro/core/matching.py``.  Each available device gets
one RB, each RB carries at most Q devices; pairs of devices exchange
RBs (or a device moves into an open slot) whenever that strictly lowers
the upload cost, until a sweep makes no change.

``evaluator``: ``"closed_form"`` prices a candidate RB with the exact
per-RB solution; ``"ccp"`` runs Algorithm 3 (``power.allocate_power``
with ``method="ccp"``) on an assignment holding only that RB's members,
as the reference does.  Every other available device is then unmatched
in that assignment, so the closed-form start is infeasible and the
candidate costs inf unless the RB holds every available device; a
swap's cost difference is then inf - inf = nan, which never counts as a
gain, so the sweep keeps its initial matching (the reference makes the
same decisions).

The sweep stays on the host, in float64 numpy, as in the reference:
the reference casts h and alpha to float64 and ``_BatchScorer`` is
documented to reproduce ``_rb_cost`` bit for bit.  The swap decisions
compare cost differences against 1e-12, so they are defined by that
float64 arithmetic; running the sweep on the device in float32 would
make different decisions, not the same ones faster.  Only the final
power allocation of the chosen assignment runs on the device.

``mode``: ``"scalar"`` scores one candidate per Python call,
``"batched"`` scores all remaining candidate moves of a device in one
vectorized closed-form evaluation and applies the first improving one in
the same enumeration order (same decisions, move for move); ``"auto"``
picks batched at ``AUTO_BATCH_MIN`` available devices with the
closed-form evaluator and stays scalar with the CCP one.

Telemetry, as in the reference: a ``matching`` stage with a
``matching.init`` span and one ``matching.sweep`` span per sweep, then a
``power`` stage for the final powers; the ``matching`` solver event, a
``partial_matching`` fault when an available device stays unmatched, and
the ``feel_matching_*`` counters.  The per-candidate power solves of the
CCP scorer pass the ``NULL`` sink, so they do not flood the trace.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..obs import metrics as metrics_mod
from . import power as power_mod
from .types import SystemParams

_INF = float("inf")

#: ``mode="auto"`` picks the batched sweep at/above this many available
#: devices (the reference's threshold).
AUTO_BATCH_MIN = 32


@dataclasses.dataclass
class MatchingResult:
    assign: np.ndarray    # (K,) RB index per device, -1 = unmatched
    rho: np.ndarray       # (K, N) dense assignment
    p: torch.Tensor       # (K, N) powers, on the system's device
    cost: float           # C^com (upload cost)
    swaps: int
    sweeps: int
    feasible: bool
    #: available devices left without an RB (more available devices
    #: than N*Q slots); they cannot upload this round.
    unmatched: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    #: sweep implementation that ran ("scalar" or "batched").
    mode: str = "scalar"
    #: candidate per-RB cost evaluations, and how many of them ran a CCP
    #: solve (the others had an infeasible closed-form start)
    rb_evals: int = 0
    ccp_solves: int = 0


def _rb_cost(members: np.ndarray, h: np.ndarray, c: np.ndarray,
             p_max: np.ndarray, gamma: float, N0: float,
             T: float) -> float:
    """Exact min upload cost of one RB given its member devices (inf when
    a power exceeds its p_max); ``h`` are the members' gains on the RB."""
    if members.size == 0:
        return 0.0
    order = np.argsort(h, kind="stable")  # ascending: weakest first
    p = np.zeros(members.size)
    cum_i = N0
    for idx in order:
        p[idx] = gamma * cum_i / max(h[idx], 1e-30)
        cum_i += p[idx] * h[idx]
        if p[idx] > p_max[idx] * (1 + 1e-9):
            return _INF
    return float(np.sum(c * p) * T)


class _Scorer:
    """Per-RB costs, one candidate member set per call."""

    def __init__(self, sys: SystemParams, h: np.ndarray, alpha: np.ndarray,
                 evaluator: str):
        self.h = h
        self.alpha = alpha
        self.evaluator = evaluator
        self.gamma = float(power_mod.snr_target(sys))
        # float32, as the reference's scalar scorer keeps them: the
        # p_max tolerance product then rounds as it does there
        self.c = sys.c.cpu().numpy()
        self.p_max = sys.p_max.cpu().numpy()
        self.N0 = float(sys.N0)
        self.T = float(sys.T)
        self.sys64 = power_mod.system64(sys) if evaluator == "ccp" else None
        self.evals = 0
        self.ccp_solves = 0

    def rb_cost(self, n: int, members: np.ndarray) -> float:
        self.evals += 1
        if self.evaluator == "closed_form":
            return _rb_cost(members, self.h[members, n], self.c[members],
                            self.p_max[members], self.gamma, self.N0,
                            self.T)
        # paper-faithful: per-RB CCP (Algorithm 3) on a masked assignment
        rho = np.zeros(self.h.shape)
        rho[members, n] = 1.0
        _, cost, ok = power_mod.allocate_power(self.sys64, rho, self.h,
                                               self.alpha, method="ccp",
                                               telemetry=obs.NULL)
        # CCP solves exactly when its closed-form start is feasible
        self.ccp_solves += ok
        return cost


class _BatchScorer:
    """Vectorized ``_Scorer``: prices a batch of candidate RB member sets
    in one numpy evaluation, row by row in ``_rb_cost``'s op order."""

    def __init__(self, sys: SystemParams, h: np.ndarray):
        self.gamma = float(power_mod.snr_target(sys))
        self.h = h
        self.c = power_mod.host64(sys.c)
        self.p_max = power_mod.host64(sys.p_max)
        self.N0 = float(sys.N0)
        self.T = float(sys.T)
        self.evals = 0

    def rb_costs(self, ids: np.ndarray, rbs: np.ndarray) -> np.ndarray:
        """``ids``: (C, Qp) member ids, -1 padding after the real members;
        ``rbs``: (C,) RB of each row.  Returns (C,) float64 costs."""
        C, Qp = ids.shape
        self.evals += C
        act = ids >= 0
        safe = np.where(act, ids, 0)
        h = np.where(act, self.h[safe, rbs[:, None]], _INF)
        pmax = np.where(act, self.p_max[safe], _INF)
        order = np.argsort(h, axis=1, kind="stable")  # weakest first
        h_s = np.take_along_axis(h, order, axis=1)
        act_s = np.take_along_axis(act, order, axis=1)
        pmax_s = np.take_along_axis(pmax, order, axis=1)
        p_s = np.zeros((C, Qp))
        cum = np.full(C, self.N0)
        feas = np.ones(C, bool)
        for r in range(Qp):  # SIC accumulation over <= Q rank levels
            a = act_s[:, r]
            hr = np.where(a, h_s[:, r], 0.0)
            pr = np.where(a, self.gamma * cum / np.maximum(hr, 1e-30), 0.0)
            p_s[:, r] = pr
            cum = cum + np.where(a, pr * hr, 0.0)
            feas &= ~(a & (pr > pmax_s[:, r] * (1 + 1e-9)))
        p = np.zeros_like(p_s)
        np.put_along_axis(p, order, p_s, axis=1)  # back to member order
        cost = np.sum(np.where(act, self.c[safe], 0.0) * p, axis=1) * self.T
        return np.where(feas, cost, _INF)


def _batched_sweeps(sys: SystemParams, scorer: _BatchScorer,
                    avail: np.ndarray, assign: np.ndarray, M: np.ndarray,
                    counts: np.ndarray, rb_costs: np.ndarray,
                    allow_moves: bool, max_sweeps: int,
                    tele) -> tuple[int, int]:
    """The batched sweep loop; mutates ``assign``/``M``/``counts``/
    ``rb_costs`` in place and returns (swaps, sweeps).

    For each available device u, every remaining candidate (swap
    partners in ``avail`` order, then open-slot moves by RB index) is
    scored at once and the first improving one applied; the suffix
    after it is re-scored under the new assignment, which replays the
    scalar acceptance order exactly.
    """
    N, Q = sys.N, sys.Q
    Qp = M.shape[1]
    P = avail.size
    pos_sw = np.arange(P)
    pos_mv = P + np.arange(N)

    swaps = 0
    sweeps = 0
    improved = True
    while improved and sweeps < max_sweeps:
        improved = False
        sweeps += 1
        sweep_span = tele.span("matching.sweep", sweep=sweeps)
        sweep_span.__enter__()
        for u in avail:
            if assign[u] < 0:
                continue
            cursor = 0
            while True:
                n_u = assign[u]
                swap_ok = ((avail > u) & (assign[avail] >= 0)
                           & (assign[avail] != n_u) & (pos_sw >= cursor))
                sw_pos = np.flatnonzero(swap_ok)
                partners = avail[sw_pos]
                if allow_moves:
                    mv_ok = ((np.arange(N) != n_u) & (counts < Q)
                             & (pos_mv >= cursor))
                    mv_ns = np.flatnonzero(mv_ok)
                else:
                    mv_ns = np.zeros(0, np.int64)
                C1, C2 = partners.size, mv_ns.size
                C = C1 + C2
                if C == 0:
                    break
                # candidate member sets, in the scalar member-array order
                base = M[n_u]
                base = base[(base != u) & (base >= 0)]  # minus the mover
                s0 = base.size
                rows_from = np.full((C, Qp), -1, np.int64)
                rows_from[:, :s0] = base
                rows_to = np.full((C, Qp), -1, np.int64)
                to_rbs = np.empty(C, np.int64)
                if C1:
                    rows_from[:C1, s0] = partners        # j joins n_u
                    n_js = assign[partners]
                    to_rbs[:C1] = n_js
                    ids0 = M[n_js]
                    keep0 = (ids0 >= 0) & (ids0 != partners[:, None])
                    ordr = np.argsort(~keep0, axis=1, kind="stable")
                    comp = np.take_along_axis(
                        np.where(keep0, ids0, -1), ordr, axis=1)
                    comp[np.arange(C1), keep0.sum(axis=1)] = u  # u joins
                    rows_to[:C1] = comp
                if C2:
                    to_rbs[C1:] = mv_ns
                    rows_to[C1:] = M[mv_ns]
                    rows_to[C1 + np.arange(C2), counts[mv_ns]] = u
                costs = scorer.rb_costs(
                    np.concatenate([rows_from, rows_to]),
                    np.concatenate([np.full(C, n_u, np.int64), to_rbs]))
                c_from, c_to = costs[:C], costs[C:]
                d = (c_from + c_to) - (rb_costs[n_u] + rb_costs[to_rbs])
                hits = np.flatnonzero(d < -1e-12)
                if hits.size == 0:
                    break
                i = int(hits[0])
                n_to = int(to_rbs[i])
                M[n_u] = rows_from[i]
                M[n_to] = rows_to[i]
                rb_costs[n_u] = c_from[i]
                rb_costs[n_to] = c_to[i]
                if i < C1:              # pairwise swap with partner j
                    j = int(partners[i])
                    assign[u], assign[j] = n_to, n_u
                    cursor = int(sw_pos[i]) + 1
                else:                   # open-slot move
                    counts[n_u] -= 1
                    counts[n_to] += 1
                    assign[u] = n_to
                    cursor = P + n_to + 1
                swaps += 1
                improved = True
        sweep_span.__exit__(None, None, None)
    return swaps, sweeps


def _scalar_sweeps(sys: SystemParams, scorer: _Scorer, avail: np.ndarray,
                   assign: np.ndarray, members: list, rb_costs: np.ndarray,
                   allow_moves: bool, max_sweeps: int,
                   tele) -> tuple[int, int]:
    """The scalar sweep loop (one candidate per cost call); mutates
    ``assign``/``members``/``rb_costs`` and returns (swaps, sweeps)."""
    N, Q = sys.N, sys.Q

    def try_reassign(k: int, n_from: int, n_to: int, j: Optional[int]):
        """Cost delta of moving k from n_from to n_to (swapping with j)."""
        m_from = members[n_from][members[n_from] != k]
        m_to = members[n_to]
        if j is not None:
            m_to = m_to[m_to != j]
            m_from = np.append(m_from, j)
        m_to = np.append(m_to, k)
        c_from = scorer.rb_cost(n_from, m_from)
        c_to = scorer.rb_cost(n_to, m_to)
        new = c_from + c_to
        old = rb_costs[n_from] + rb_costs[n_to]
        return new - old, (m_from, m_to, c_from, c_to)

    swaps = 0
    sweeps = 0
    improved = True
    while improved and sweeps < max_sweeps:
        improved = False
        sweeps += 1
        # one child span per sweep: a regression in sweep count (or one
        # pathologically slow sweep) is attributable from the trace
        sweep_span = tele.span("matching.sweep", sweep=sweeps)
        sweep_span.__enter__()
        for u in avail:
            if assign[u] < 0:
                continue
            for k in avail:  # pairwise swaps (the paper's swap operation)
                if k <= u or assign[k] < 0 or assign[k] == assign[u]:
                    continue
                d, upd = try_reassign(u, assign[u], assign[k], k)
                if d < -1e-12:
                    n_u, n_k = assign[u], assign[k]
                    members[n_u], members[n_k] = upd[0], upd[1]
                    rb_costs[n_u], rb_costs[n_k] = upd[2], upd[3]
                    assign[u], assign[k] = n_k, n_u
                    swaps += 1
                    improved = True
            if allow_moves:  # open-slot moves (housing-model open houses)
                for n in range(N):
                    if n == assign[u] or members[n].size >= Q:
                        continue
                    d, upd = try_reassign(u, assign[u], n, None)
                    if d < -1e-12:
                        n_u = assign[u]
                        members[n_u], members[n] = upd[0], upd[1]
                        rb_costs[n_u], rb_costs[n] = upd[2], upd[3]
                        assign[u] = n
                        swaps += 1
                        improved = True
        sweep_span.__exit__(None, None, None)
    return swaps, sweeps


def swap_matching(sys: SystemParams, h, alpha, evaluator: str = "closed_form",
                  allow_moves: bool = True, max_sweeps: int = 50,
                  mode: str = "auto", telemetry=None) -> MatchingResult:
    """Algorithm 2. ``h``: (K, N) gains; ``alpha``: (K,) availability,
    as tensors (any device) or arrays.  ``evaluator``: ``"closed_form"``
    or ``"ccp"`` (scalar sweep only); the final powers of the chosen
    assignment are the closed form's with either, as in the reference.
    ``telemetry``: an ``obs`` sink (``None``: the process default)."""
    if mode not in ("auto", "scalar", "batched"):
        raise ValueError(f"unknown matching mode: {mode!r}")
    if evaluator not in ("closed_form", "ccp"):
        raise ValueError(f"unknown power evaluator: {evaluator!r}")
    if mode == "batched" and evaluator != "closed_form":
        raise ValueError("mode='batched' requires evaluator='closed_form' "
                         "(per-candidate CCP solves cannot be vectorized); "
                         "use mode='scalar' or mode='auto'")
    tele = obs.resolve(telemetry)
    h64 = power_mod.host64(h)
    alpha64 = power_mod.host64(alpha)
    K, N, Q = sys.K, sys.N, sys.Q
    avail = np.flatnonzero(alpha64 > 0)
    use_batched = (mode == "batched"
                   or (mode == "auto" and evaluator == "closed_form"
                       and avail.size >= AUTO_BATCH_MIN))
    mode_used = "batched" if use_batched else "scalar"

    stage = tele.stage("matching")
    stage.__enter__()
    # ---- initial matching Psi_0: greedy best-gain with capacity ----
    with tele.span("matching.init"):
        assign = np.full(K, -1, np.int64)
        slots = np.full(N, Q, np.int64)
        order = avail[np.argsort(-h64[avail].max(axis=1), kind="stable")]
        for k in order:
            open_rbs = np.flatnonzero(slots > 0)
            if open_rbs.size == 0:
                # more available devices than N*Q slots: the matching is
                # partial and the rest are reported in ``unmatched``
                break
            n = open_rbs[np.argmax(h64[k, open_rbs])]
            assign[k] = n
            slots[n] -= 1

        if use_batched:
            scorer = _BatchScorer(sys, h64)
            M = np.full((N, max(Q, 1)), -1, np.int64)
            counts = np.zeros(N, np.int64)
            for n in range(N):
                ids = np.flatnonzero(assign == n)
                M[n, :ids.size] = ids
                counts[n] = ids.size
            rb_costs = scorer.rb_costs(M, np.arange(N))
        else:
            scorer = _Scorer(sys, h64, alpha64, evaluator)
            members = [np.flatnonzero(assign == n) for n in range(N)]
            rb_costs = np.array([scorer.rb_cost(n, members[n])
                                 for n in range(N)])

    if use_batched:
        swaps, sweeps = _batched_sweeps(sys, scorer, avail, assign, M,
                                        counts, rb_costs, allow_moves,
                                        max_sweeps, tele)
    else:
        swaps, sweeps = _scalar_sweeps(sys, scorer, avail, assign, members,
                                       rb_costs, allow_moves, max_sweeps,
                                       tele)

    rho = np.zeros((K, N), np.float32)
    matched = assign >= 0
    rho[np.flatnonzero(matched), assign[matched]] = 1.0
    stage.__exit__(None, None, None)

    # final powers of the chosen assignment, on the device
    dev = sys.device
    with tele.stage("power"):
        p, cost, ok = power_mod.allocate_power(
            sys, torch.as_tensor(rho, device=dev),
            torch.as_tensor(h, dtype=torch.float32, device=dev),
            torch.as_tensor(alpha, dtype=torch.float32, device=dev),
            telemetry=tele)
        p = tele.block(p)
    unmatched = avail[assign[avail] < 0]
    feasible = ok and unmatched.size == 0 and np.isfinite(cost)
    tele.solver("matching", swaps=swaps, sweeps=sweeps,
                rb_evals=scorer.evals, unmatched=int(unmatched.size),
                feasible=bool(feasible), mode=mode_used)
    if unmatched.size:
        tele.fault("partial_matching", injected=False,
                   unmatched=[int(k) for k in unmatched])
    reg = metrics_mod.get_default()
    if reg.enabled:
        reg.counter("feel_matching_calls_total",
                    "swap-matching (Alg. 2) invocations").inc()
        reg.counter("feel_matching_swaps_total",
                    "accepted swap/move operations").inc(swaps)
        reg.counter("feel_matching_sweeps_total",
                    "swap sweeps over available devices").inc(sweeps)
        reg.counter("feel_matching_rb_evals_total",
                    "candidate per-RB power evaluations").inc(scorer.evals)
        reg.counter("feel_matching_unmatched_total",
                    "available devices left without an RB").inc(
                        int(unmatched.size))
        if not feasible:
            reg.counter("feel_solver_infeasible_total",
                        "infeasible solver outcomes by solver").inc(
                            1, solver="matching")
    return MatchingResult(assign=assign, rho=rho, p=p, cost=cost,
                          swaps=swaps, sweeps=sweeps, feasible=feasible,
                          unmatched=unmatched, mode=mode_used,
                          rb_evals=scorer.evals,
                          ccp_solves=0 if use_batched else scorer.ccp_solves)
