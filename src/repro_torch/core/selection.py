"""Data selection (paper §V, Problem 4, Algorithms 4-5) + exact oracle.

Counterpart of ``repro/core/selection.py``.  The reference's
device-chunked gradient projection iterates the same rows as its
full-matrix one, so ``device_chunk`` changes nothing here.

1. Alg. 4: gradient projection on the continuous relaxation (36) with a
   diminishing step; the projection (37) onto {0 <= d <= 1, sum_j d >= 1}
   is a box clip, or a capped-simplex projection by 60-step bisection
   when the clipped row sums below 1.
2. Alg. 5: the LP (39) is solved exactly by thresholding at 1/2 and
   selecting argmax_j of a row that would otherwise be empty.
3. ``exact_selection``: global optimum by prefix means of the sorted
   sigmas (beyond the paper).

The 400-step loop issues device work only: its step sizes are host
floats computed before the loop and nothing in it reads a device value
back, so the CPU never waits for the GPU inside it.  The gradient of
the selection objective is written out (the reference takes it with
``jax.grad``); both compute the same expression.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import obs
from ..obs import metrics as metrics_mod
from .delta import EPSDIV
from .types import SystemParams

_BIG = 1e30
BISECTION_STEPS = 60


def project_feasible(z: torch.Tensor, mask: torch.Tensor,
                     mask_is_ones: Optional[bool] = None) -> torch.Tensor:
    """Projection (37), row by row over the last axis. z, mask: (..., J).

    ``mask_is_ones`` lets a caller that already knows the mask is all
    ones skip the multiplications by it (x * 1.0 == x exactly).
    """
    if mask_is_ones is None:
        mask_is_ones = bool(torch.all(mask == 1))

    def masked(x):
        return x if mask_is_ones else x * mask

    clipped = masked(torch.clamp(z, 0.0, 1.0))
    need_simplex = torch.sum(clipped, dim=-1, keepdim=True) < 1.0
    # find tau with sum(clip(z + tau, 0, 1) * mask) == 1 by bisection
    n_valid = torch.clamp(torch.sum(mask, dim=-1, keepdim=True), min=1.0)
    z_max = torch.amax(torch.where(mask > 0, z, -_BIG), dim=-1, keepdim=True)
    z_min = torch.amin(torch.where(mask > 0, z, _BIG), dim=-1, keepdim=True)
    lo = torch.clamp(1.0 / n_valid - z_max, max=0.0) - 1.0
    hi = torch.clamp(1.0 - z_min, min=0.0) + 1.0
    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        s = torch.sum(masked(torch.clamp(z + mid, 0.0, 1.0)), dim=-1,
                      keepdim=True)
        below = s < 1.0
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    tau = 0.5 * (lo + hi)
    simplex = masked(torch.clamp(z + tau, 0.0, 1.0))
    return torch.where(need_simplex, simplex, clipped)


def selection_gradient(lam: torch.Tensor, d: torch.Tensor, sigma: torch.Tensor,
                       mask: torch.Tensor, A: torch.Tensor,
                       q: torch.Tensor) -> torch.Tensor:
    """d/dd of ``delta.selection_only_objective(sys, d * mask, sigma)``,
    row by row over the last axis (A, q: the rows' weights, shaped like
    d without its last axis).

    f = lam * sum_k A_k num_k / max(den_k, eps) - (1-lam) sum_k q_k den_k
    with num_k = sum_j dm_kj sigma_kj and den_k = sum_j dm_kj.
    """
    dm = d * mask
    num = torch.sum(dm * sigma, dim=-1)
    den = torch.sum(dm, dim=-1)
    M = torch.clamp(den, min=EPSDIV)
    gm = lam * A
    g_num = gm / M
    g_den = (-gm * num) * M ** -2 * (den > EPSDIV)
    g = sigma * g_num[..., None] + (g_den - (1.0 - lam) * q)[..., None]
    return g * mask


def _gp_loop(lam: torch.Tensor, sigma: torch.Tensor, mask: torch.Tensor,
             A: torch.Tensor, q: torch.Tensor, steps: int,
             step0: float) -> torch.Tensor:
    """The Alg. 4 iteration on rows of the last axis (any leading axes)."""
    mask_is_ones = bool(torch.all(mask == 1))  # one host read, before the loop
    # step_v = step0 / (1 + v)^0.6 in float32, as the reference's loop
    # computes it; read once so the loop itself never syncs
    rates = (step0 / (1.0 + torch.arange(steps, dtype=torch.float32))
             ** 0.6).tolist()
    d = 0.5 * mask
    for step in rates:
        g = selection_gradient(lam, d, sigma, mask, A, q)
        g = torch.where(torch.isfinite(g), g, 0.0)
        # per-device normalization keeps every device's subproblem
        # moving at the same rate (A_k/m_k spans orders of magnitude)
        norm = torch.amax(torch.abs(g), dim=-1, keepdim=True)
        g = g / torch.clamp(norm, min=1e-12)
        d = project_feasible(d - step * g, mask, mask_is_ones)
    return d


def gradient_projection(sys: SystemParams, sigma: torch.Tensor,
                        mask: torch.Tensor, steps: int = 400,
                        step0: float = 0.3,
                        device_chunk: int = 0) -> torch.Tensor:
    """Algorithm 4: a stationary point delta† of (36) (continuous).

    step0 picks which stationary point the diminishing-step GP lands at
    (see the reference's docstring): ~0.3 gives the threshold-like
    filter that drops high-sigma outliers; ~5.0 chases the global
    optimum of Problem 4, ~1 sample a device.

    ``device_chunk``: the reference's option (its ``_gp_chunked``: 0
    iterates the full (K, J) matrix, a positive value below K the
    devices a block at a time, to bound its peak memory to a block's).
    Every operation of the iteration works row by row over the last
    axis, with the A weights, which carry the only cross-device term,
    computed once for all devices, so the iterates do not depend on
    the chunk: the port takes the option and always iterates the full
    matrix.
    """
    del device_chunk  # the iterates do not depend on it
    return _gp_loop(sys.lam, sigma, mask, sys.a_weights(), sys.q, steps,
                    step0)


def binary_recovery(delta_cont: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Exact solution of LP (39): threshold at 1/2 with >=1 repair."""
    sel = (delta_cont > 0.5).to(torch.float32) * mask
    none = torch.sum(sel, dim=1) < 1.0
    best = torch.argmax(torch.where(mask > 0, delta_cont, -_BIG), dim=1)
    repair = torch.nn.functional.one_hot(
        best, delta_cont.shape[1]).to(torch.float32)
    return torch.where(none[:, None], torch.maximum(sel, repair * mask), sel)


def faithful_selection(sys: SystemParams, sigma: torch.Tensor,
                       mask: torch.Tensor, steps: int = 400,
                       step0: float = 0.3,
                       device_chunk: int = 0) -> torch.Tensor:
    """Algorithms 4 + 5 end to end (the paper's data-selection solver)."""
    return binary_recovery(gradient_projection(
        sys, sigma, mask, steps=steps, step0=step0,
        device_chunk=device_chunk), mask)


def exact_selection(sys: SystemParams, sigma: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Global optimum of Problem 4 in O(K J log J)."""
    A = sys.a_weights()
    big_sigma = torch.where(mask > 0, sigma, _BIG)
    order = torch.argsort(big_sigma, dim=1, stable=True)
    sorted_sigma = torch.take_along_dim(big_sigma, order, dim=1)
    m = torch.arange(1, sigma.shape[1] + 1, dtype=torch.float32,
                     device=sigma.device)
    prefix_mean = torch.cumsum(
        torch.where(sorted_sigma < _BIG, sorted_sigma, 0.0), dim=1) / m
    valid = m[None, :] <= torch.sum(mask, dim=1, keepdim=True)
    obj = (sys.lam * A[:, None] * prefix_mean
           - (1.0 - sys.lam) * sys.q[:, None] * m[None, :])
    obj = torch.where(valid, obj, _BIG)
    best_m = torch.argmin(obj, dim=1) + 1  # (K,) optimal selection size
    ranks = torch.argsort(order, dim=1, stable=True)
    return (ranks < best_m[:, None]).to(torch.float32) * mask


def solve_selection(sys: SystemParams, sigma: torch.Tensor,
                    mask: torch.Tensor, method: str = "faithful",
                    steps: int = 400, step0: float = 0.3,
                    device_chunk: int = 0, telemetry=None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(binary selection, continuous GP point or None for ``exact``).

    ``telemetry``: an ``obs`` sink; the Alg. 4/5 phases run in
    ``selection.gp`` and ``selection.recover`` spans (``selection.exact``
    for the oracle), then one ``selection`` solver event.  The selected
    count is read back (one host sync) only when a sink or a metrics
    registry is on.
    """
    tele = obs.resolve(telemetry)
    reg = metrics_mod.get_default()
    if method == "faithful":
        with tele.span("selection.gp", steps=steps):
            d_cont = tele.block(gradient_projection(
                sys, sigma, mask, steps=steps, step0=step0,
                device_chunk=device_chunk))
        with tele.span("selection.recover"):
            out = tele.block(binary_recovery(d_cont, mask))
        gp_steps = steps
    elif method == "exact":
        with tele.span("selection.exact"):
            out = tele.block(exact_selection(sys, sigma, mask))
        d_cont, gp_steps = None, 0
    else:
        raise ValueError(f"unknown selection method: {method}")
    if tele.enabled or reg.enabled:
        # one host sync, shared by the trace event and the metrics
        n_selected = int(torch.sum(out))
        if tele.enabled:
            tele.solver("selection", method=method, gp_steps=gp_steps,
                        n_selected=n_selected)
        if reg.enabled:
            reg.counter("feel_selection_calls_total",
                        "data-selection solves by method").inc(
                            1, method=method)
            reg.counter("feel_selection_gp_steps_total",
                        "gradient-projection (Alg. 4) steps").inc(gp_steps)
            reg.counter("feel_selection_selected_total",
                        "samples selected across rounds").inc(n_selected)
    return out, d_cont
