"""Power allocation for a fixed RB assignment (paper §IV-B, Alg. 3).

Counterpart of ``repro/core/power.py``.  Two solvers:

1. ``closed_form_power``: constraint (13) makes the program separable
   per RB, and under the SIC order the minimum-cost point has every
   rate constraint tight,

       p_(r) = gamma * N0 * (1 + gamma)^r / h_(r),   r = #weaker co-RB
       gamma = 2^(L / (B*T)) - 1.

   It runs in float32 on the system's device, as the reference does.

2. ``ccp_power``: the paper-faithful convex-concave procedure.  The DC
   program (33) is solved by iterating the convexified subproblem (34),
   each with a feasible-start log-barrier method (damped Newton), as in
   the reference.  The solve runs on the host in float64 numpy, next to
   the swap matching (``core/matching.py``), which is its caller inside
   a round: a Newton system has at most K unknowns (at most Q inside the
   matching's per-RB scorer), so on the device every step would be pure
   launch latency.  The gradient and Hessian of the barrier objective
   are written in closed form (``_Subproblem.derivatives``); the
   objective itself (``_Subproblem.phi``) also takes float64 torch
   tensors, so ``torch.func`` can differentiate it to check them.  Only
   the final powers go to the system's device.  The reference solves in
   float32 and pads the active set to bucketed sizes to stop jit
   retraces; eager code has no retraces, so there is no padding here.

``allocate_power_safe`` wraps ``allocate_power`` in the resilience
layer's fallback: a failed CCP solve degrades to the closed form.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Tuple

import numpy as np
import torch

from .. import obs
from ..obs import metrics as metrics_mod
from .channel import weaker_than
from .types import SYSTEM_ARRAYS, SystemParams


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


# --------------------------------------------------------------------------
# Paper-faithful Algorithm 3 (CCP), on the host in float64.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CCPResult:
    p: torch.Tensor          # (K, N) final powers, on the system's device
    trajectory: np.ndarray   # upload cost per CCP iterate (Fig. 3)
    feasible: bool
    iterations: int


def host64(x) -> np.ndarray:
    """``x`` (a tensor on any device, or an array) as a float64 host
    array, the working type of the CCP solver and of the swap matching."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def system64(sys: SystemParams) -> SystemParams:
    """``sys`` with every array field as a float64 CPU tensor (the CCP
    solver's working copy)."""
    return dataclasses.replace(sys, **{
        f: getattr(sys, f).to("cpu", torch.float64) for f in SYSTEM_ARRAYS})


class _Subproblem:
    """The convexified subproblem (34) over the active (device, RB) pairs
    ``(ki[i], ni[i])``, linearized at ``p_v`` by ``linearize``.

    Constraint k, in nats (eq. (34)):
        g_k(p) = sum_n rho_kn [log(S_kn(p)) - log(I^v_kn)
                               - sum_t W_tkn (p_tn - p^v_tn) h_tn / I^v_kn]
                 - alpha_k L log 2 / (B T),
        S_kn(p) = rho_kn p_kn h_kn + I_kn(p),
        I_kn(p) = sum_t W_tkn p_tn h_tn + N0,
    with W_tkn = 1 where active device t is weaker than k on RB n.  The
    barrier objective is t * C^com(p) - sum_k log g_k - sum_i log p_i
    - sum_i log(p_max,i - p_i), over the k with mask_k = 1.  Everything
    but the linearization point depends only on the assignment, so one
    instance serves every CCP iterate.
    """

    def __init__(self, c, T, N0, need, rho, h, weaker, mask_k, ki, ni, pmax):
        K, N = rho.shape
        m = ki.size
        self.c, self.T, self.N0 = c, T, N0
        self.need, self.rho, self.h, self.W = need, rho, h, weaker
        self.mask_k, self.ki, self.ni, self.pmax = mask_k, ki, ni, pmax
        # one-hot maps from the active vector to the (K, N) matrix
        self.Ok = np.zeros((m, K))
        self.Ok[np.arange(m), ki] = 1.0
        self.On = np.zeros((m, N))
        self.On[np.arange(m), ni] = 1.0
        # closed-form derivative terms, per (constraint k, variable i)
        self.h_i = h[ki, ni]
        self.A = weaker[ki, :, ni].T             # (K, m): W[ki, k, ni]
        self.A_own = self.A + (np.arange(K)[:, None] == ki[None, :])
        self.R = rho[:, ni]                      # (K, m): rho[k, ni]
        self.cost_grad = T * c[ki]
        self.same_rb = ni[:, None] == ni[None, :]

    def linearize(self, p_v: np.ndarray) -> "_Subproblem":
        """Linearize the concave part at the (K, N) powers ``p_v``."""
        self.p_v = p_v
        self.I_v = np.einsum("tkn,tn->kn", self.W, p_v * self.h) + self.N0
        self.lin_grad = self.R * self.h_i * self.A / self.I_v[:, self.ni]
        return self

    _ARRAYS = ("c", "need", "rho", "h", "W", "mask_k", "p_v", "pmax", "Ok",
               "On", "I_v")

    def _consts(self, x):
        """(array module, constants): numpy, or for a torch ``x`` the
        constants as float64 tensors (``torch.func`` differentiates
        ``phi`` through them)."""
        if not isinstance(x, torch.Tensor):
            return np, self
        return torch, types.SimpleNamespace(
            T=self.T, N0=self.N0, **{k: torch.as_tensor(getattr(self, k))
                                     for k in self._ARRAYS})

    def to_mat(self, x):
        """(K, N) powers of the active vector ``x``."""
        _, a = self._consts(x)
        return a.Ok.T @ (x[:, None] * a.On)

    def _g(self, x):
        """(constraints g, S, (K, N) powers) at ``x``."""
        xp, a = self._consts(x)
        p = self.to_mat(x)
        S = a.rho * p * a.h + xp.einsum("tkn,tn->kn", a.W, p * a.h) + a.N0
        lin = (xp.log(a.I_v)
               + xp.einsum("tkn,tn->kn", a.W, (p - a.p_v) * a.h) / a.I_v)
        g = (a.rho * (xp.log(S) - lin)).sum(axis=1) - a.need
        return g, S, p

    def phi(self, x, t: float):
        """Barrier objective at the active powers ``x`` (numpy, or a
        float64 torch tensor)."""
        xp, a = self._consts(x)
        g, _, p = self._g(x)
        g_act = xp.where(a.mask_k > 0, g, 1.0)
        barrier = (-xp.where(a.mask_k > 0, xp.log(g_act), 0.0).sum()
                   - xp.log(x).sum() - xp.log(a.pmax - x).sum())
        return t * (a.c[:, None] * a.rho * p).sum() * a.T + barrier

    def feasible(self, x) -> bool:
        """Strict interior: g_k > 0 where masked, 0 < x < p_max."""
        g, _, _ = self._g(x)
        return bool(np.all(np.where(self.mask_k > 0, g > 0, True))
                    and np.all(x > 0) and np.all(x < self.pmax))

    def derivatives(self, x, t: float) -> Tuple[np.ndarray, np.ndarray]:
        """Closed-form gradient and Hessian of ``phi`` in ``x``.

        dS_kn/dx_i = h_i (W[ki, k, n] + [k == ki]) at n = ni, so with
        U_ki = rho_k,ni h_i (W + [k == ki]) / S_k,ni:
            dg_k/dx_i = U_ki - rho_k,ni h_i W[ki, k, ni] / I^v_k,ni,
            d2g_k/dx_i dx_j = -U_ki U_kj [ni == nj].
        """
        g, S, _ = self._g(x)
        U = self.R * self.h_i * self.A_own / S[:, self.ni]
        J = U - self.lin_grad
        w = np.where(self.mask_k > 0, 1.0 / np.where(self.mask_k > 0, g, 1.0),
                     0.0)
        gap = self.pmax - x
        grad = t * self.cost_grad - J.T @ w - 1.0 / x + 1.0 / gap
        hess = ((J * (w * w)[:, None]).T @ J
                + ((U * w[:, None]).T @ U) * self.same_rb
                + np.diag(1.0 / (x * x) + 1.0 / (gap * gap)))
        return grad, hess


def _inner_solve(sub: _Subproblem, newton_iters: int = 25) -> np.ndarray:
    """Solve (34) with a feasible-start log-barrier method (damped
    Newton); returns the (K, N) powers.  The barrier weight t grows by
    20x from 10 / cost0 up to 1e7 * n_con / cost0; at each t up to
    ``newton_iters`` Newton steps, each with a backtracking line search
    of up to 40 halvings that keeps the iterate strictly feasible."""
    m = sub.ki.size
    if m == 0:
        return np.zeros_like(sub.p_v)
    x = np.clip(sub.p_v[sub.ki, sub.ni], 1e-12, sub.pmax * (1 - 1e-6))
    cost0 = max(float(np.sum(sub.cost_grad * x)), 1e-12)
    n_con = m * 2 + int(np.sum(sub.mask_k))
    t = 10.0 / cost0
    t_final = 1e7 * n_con / cost0
    eye = np.eye(m) * 1e-9
    # a line-search candidate may leave the domain (log of a negative
    # S or g); it is then infeasible, so numpy's warnings are noise
    with np.errstate(invalid="ignore", divide="ignore"):
        while t < t_final:
            for _ in range(newton_iters):
                grad, hess = sub.derivatives(x, t)
                try:
                    step = np.linalg.solve(hess + eye, grad)
                except np.linalg.LinAlgError:  # singular: gradient step
                    step = grad
                    _count_singular_newton()
                if not np.all(np.isfinite(step)):
                    step = grad
                    _count_singular_newton()
                f0 = float(sub.phi(x, t))
                a = 1.0
                moved = False
                for _ in range(40):
                    cand = x - a * step
                    if sub.feasible(cand):
                        f1 = float(sub.phi(cand, t))
                        if np.isfinite(f1) and f1 <= f0 - 1e-12 * abs(f0):
                            x = cand
                            moved = True
                            break
                    a *= 0.5
                if not moved:
                    break  # Newton converged (or stalled) at this t
            t *= 20.0
    return sub.to_mat(x)


def subproblem(sys64: SystemParams, rho: np.ndarray, h: np.ndarray,
               alpha: np.ndarray) -> _Subproblem:
    """Subproblem (34) of the assignment ``rho``, to be linearized;
    ``sys64`` from ``system64``, the rest float64 host arrays."""
    active = rho * alpha[:, None]
    weaker = _weaker(torch.from_numpy(h), torch.from_numpy(active))
    mask_k = (np.sum(active, axis=1) > 0) * alpha
    ki, ni = np.nonzero(active > 0)
    need = alpha * float(sys64.L) * np.log(2.0) / float(sys64.B * sys64.T)
    return _Subproblem(sys64.c.numpy(), float(sys64.T), float(sys64.N0),
                       need, rho, h, weaker.to(torch.float64).numpy(), mask_k,
                       ki, ni, sys64.p_max.numpy()[ki])


def ccp_power(sys: SystemParams, rho, h, alpha, p0=None, n_ccp: int = 8,
              tol: float = 1e-4, telemetry=None) -> CCPResult:
    """Algorithm 3: iterate the convexified subproblem until the upload
    cost moves by at most ``tol`` (relative), at most ``n_ccp`` times.

    Without ``p0`` it starts from 1.5x the closed-form powers, clipped
    under p_max (a strictly feasible interior point); when the closed
    form is infeasible it returns that, with ``feasible=False`` and no
    solve.  ``rho``, ``h``, ``alpha`` and ``p0`` may be tensors on any
    device or arrays; ``sys`` may already be a ``system64`` copy.

    ``telemetry``: an ``obs`` sink; each CCP iteration is recorded as a
    ``power.ccp_iter`` span (a child of the enclosing power stage).
    """
    tele = obs.resolve(telemetry)
    s64 = system64(sys)
    rho, h, alpha = host64(rho), host64(h), host64(alpha)
    dev = sys.device
    if p0 is None:
        p_cf, feas = closed_form_power(s64, torch.from_numpy(rho),
                                       torch.from_numpy(h),
                                       torch.from_numpy(alpha))
        if not bool(torch.all(feas)):
            return CCPResult(p=p_cf.to(dev, torch.float32),
                             trajectory=np.array([np.inf]), feasible=False,
                             iterations=0)
        p0 = np.minimum(p_cf.numpy() * 1.5,
                        s64.p_max.numpy()[:, None] * rho * (1 - 1e-4))

    c, T = s64.c.numpy(), float(s64.T)

    def cost(p):
        return float(np.sum(c[:, None] * rho * p) * T)

    sub = subproblem(s64, rho, h, alpha)
    p = host64(p0) * rho
    traj = [cost(p)]
    for v in range(n_ccp):
        with tele.span("power.ccp_iter", iter=v):
            p_new = _inner_solve(sub.linearize(p))
            traj.append(cost(p_new))
        p = p_new
        if abs(traj[-1] - traj[-2]) <= tol * max(abs(traj[-2]), 1e-12):
            break
    return CCPResult(p=torch.as_tensor(p, dtype=torch.float32, device=dev),
                     trajectory=np.asarray(traj), feasible=True,
                     iterations=len(traj) - 1)


def allocate_power(sys: SystemParams, rho, h, alpha,
                   method: str = "closed_form", telemetry=None
                   ) -> Tuple[torch.Tensor, float, bool]:
    """Powers for ``rho``: (p, total upload cost, feasible).

    ``method="closed_form"`` runs on the system's device (``h`` and
    ``alpha`` tensors there); ``"ccp"`` is Algorithm 3 on the host
    (``ccp_power``, which takes tensors or arrays), its cost taken from
    the float64 solution.  The cost is inf when infeasible.

    ``telemetry``: an ``obs`` sink for the ``power`` solver event —
    ``None`` uses the process default; the matching's CCP scorer passes
    ``obs.NULL`` so its per-candidate solves do not flood the trace.
    """
    tele = obs.resolve(telemetry)
    if method == "closed_form":
        rho_t = torch.as_tensor(rho, dtype=torch.float32, device=sys.device)
        p, feas = closed_form_power(sys, rho_t, h, alpha)
        ok = bool(torch.all(feas))
        cost = float(upload_cost(sys, p, rho_t)) if ok else float("inf")
        tele.solver("power", method=method, feasible=ok)
        _count_power(method, ok, 0)
        return p, cost, ok
    if method == "ccp":
        res = ccp_power(sys, rho, h, alpha, telemetry=tele)
        cost = res.trajectory[-1] if res.feasible else float("inf")
        tele.solver("power", method=method, iterations=res.iterations,
                    feasible=bool(res.feasible))
        _count_power(method, bool(res.feasible), res.iterations)
        return res.p, float(cost), res.feasible
    raise ValueError(f"unknown power method: {method}")


def allocate_power_safe(sys: SystemParams, rho, h, alpha,
                        method: str = "closed_form", telemetry=None,
                        force_fail: bool = False):
    """``allocate_power`` with the fallback chain of the resilience layer.

    A failed CCP solve (exception, non-finite powers, infeasible
    outcome), or a fault plan's ``force_fail``, degrades to the exact
    closed-form evaluator instead of propagating; the degradation is
    recorded as a ``fault("fallback")`` trace event and counted in
    ``feel_fallbacks_total``.  The closed form is the chain's terminal
    link: its infeasibility is a property of the assignment, reported
    in the ``feasible`` flag.

    Returns ``(p, cost, feasible, fallback)``; ``fallback`` is None or
    the degradation label (``"ccp->closed_form"``).
    """
    tele = obs.resolve(telemetry)
    fallback = None
    if method != "closed_form":
        failure = None
        if force_fail:
            failure = "injected"
        else:
            try:
                p, cost, ok = allocate_power(sys, rho, h, alpha,
                                             method=method, telemetry=tele)
                if not ok:
                    failure = "infeasible"
                elif not bool(torch.all(torch.isfinite(p))):
                    failure = "non_finite"
                else:
                    return p, cost, ok, None
            except Exception as e:  # solver blew up: degrade, don't die
                failure = type(e).__name__
        fallback = f"{method}->closed_form"
        tele.fault("fallback", injected=force_fail, solver="power",
                   to="closed_form", reason=failure)
        reg = metrics_mod.get_default()
        if reg.enabled:
            reg.counter("feel_fallbacks_total",
                        "solver degradations by solver and target").inc(
                            1, solver="power", to="closed_form")
    p, cost, ok = allocate_power(sys, rho, h, alpha, method="closed_form",
                                 telemetry=tele)
    return p, cost, ok, fallback


def _count_singular_newton() -> None:
    """A singular Newton system inside the CCP inner solve degraded the
    step to plain gradient descent; counted as the reference does."""
    reg = metrics_mod.get_default()
    if reg.enabled:
        reg.counter("feel_solver_infeasible_total",
                    "infeasible solver outcomes by solver").inc(
                        1, solver="power_newton")


def _count_power(method: str, feasible: bool, ccp_iterations: int) -> None:
    """Metrics for one ``allocate_power`` call.  Counters aggregate, so
    (unlike trace events) the matching scorer's per-candidate solves
    are counted too — that is the point of the infeasible-call metric.
    """
    reg = metrics_mod.get_default()
    if not reg.enabled:
        return
    reg.counter("feel_power_calls_total",
                "power allocations by method").inc(1, method=method)
    if ccp_iterations:
        reg.counter("feel_power_ccp_iterations_total",
                    "CCP (Alg. 3) outer iterations").inc(ccp_iterations)
    if not feasible:
        reg.counter("feel_solver_infeasible_total",
                    "infeasible solver outcomes by solver").inc(
                        1, solver="power")
