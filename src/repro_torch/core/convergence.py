"""Convergence-bound utilities (paper Lemmas 1-3).

Counterpart of ``repro/core/convergence.py``.  These make the theory
executable so tests and monitors can check that the implementation
satisfies the paper's analytical claims:

* ``aggregate`` — eq. (19), inverse-propensity-weighted aggregation;
  Lemma 1: E[g_hat] = grad L(w).
* ``one_round_bound`` — RHS of Lemma 2 for observed quantities
  (``one_round_bound_from_delta`` when the Delta term is already in
  hand, e.g. the round decision's ``delta_obj``).
* ``multi_round_bound`` — Lemma 3's product-form upper bound,
  vectorized with a cumulative product; ``multi_round_bound_ref`` is
  the direct O(i^2) transcription kept as the test oracle.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import delta as delta_mod
from .types import SystemParams


def aggregate(sys: SystemParams, local_grads: torch.Tensor,
              alpha: torch.Tensor) -> torch.Tensor:
    """eq. (19): g_hat = (1/|D̂|) sum_k (|D̂_k|/eps_k) alpha_k g_k.

    ``local_grads``: (K, P) stacked local gradients (already averaged
    over each device's selected samples, eq. (4)).
    """
    w = (sys.D_hat / sys.eps) * alpha  # (K,)
    return torch.einsum("k,kp->p", w, local_grads) / sys.D_hat_total


def one_round_bound_from_delta(sys: SystemParams, gap_i, g_norm_sq, eta,
                               beta, d_term) -> torch.Tensor:
    """Lemma 2 RHS with the Delta(delta) term already evaluated
    (eq. (22)/(26) — the round decision's ``delta_obj``)."""
    return (gap_i - eta * g_norm_sq
            + beta * eta ** 2 / (2.0 * sys.D_hat_total ** 2) * d_term)


def one_round_bound(sys: SystemParams, gap_i, g_norm_sq, eta, beta,
                    dlt: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Lemma 2 RHS: E[L(w+) - L*] <= gap - eta ||g||^2 + (beta eta^2 / 2|D̂|^2) Delta."""
    d_term = delta_mod.delta(sys, dlt, sigma)
    return one_round_bound_from_delta(sys, gap_i, g_norm_sq, eta, beta,
                                      d_term)


def multi_round_bound(sys: SystemParams, gap_1: float, mu: float,
                      beta: float, etas: Sequence[float],
                      deltas: Sequence[float]) -> float:
    """Lemma 3: product contraction + weighted Delta accumulation.

    Vectorized: with f_j = 1 - 2 mu eta_j the coefficient of round t's
    Delta term is the *suffix* product a_t = prod_{j>t} f_j, computed
    for every t at once from one ``torch.cumprod`` over the reversed
    factors (float32, as the reference); ``multi_round_bound_ref`` is
    the scalar transcription (test oracle).
    """
    if len(etas) != len(deltas):
        raise ValueError("etas and deltas must have equal length")
    if len(etas) == 0:
        return float(gap_1)
    etas_t = torch.as_tensor(etas, dtype=torch.float32)
    deltas_t = torch.as_tensor(deltas, dtype=torch.float32)
    f = 1.0 - 2.0 * mu * etas_t                       # (i,)
    # rev[t] = prod_{j>=t} f_j; suffix[t] = rev[t+1], suffix[i-1] = 1
    rev = torch.cumprod(f.flip(0), dim=0).flip(0)
    suffix = torch.cat([rev[1:], torch.ones(1, dtype=rev.dtype)])
    acc = torch.sum(suffix * etas_t ** 2 * deltas_t)
    return (float(rev[0]) * gap_1
            + beta / (2.0 * float(sys.D_hat_total) ** 2) * float(acc))


def multi_round_bound_ref(sys: SystemParams, gap_1: float, mu: float,
                          beta: float, etas: Sequence[float],
                          deltas: Sequence[float]) -> float:
    """Direct O(i^2) transcription of Lemma 3 (oracle for the
    vectorized ``multi_round_bound``), in Python floats."""
    i = len(etas)
    prod = 1.0
    for eta in etas:
        prod *= (1.0 - 2.0 * mu * eta)
    acc = 0.0
    for t in range(i):
        a_t = 1.0
        for j in range(t + 1, i):
            a_t *= (1.0 - 2.0 * mu * etas[j])
        acc += a_t * etas[t] ** 2 * deltas[t]
    return prod * gap_1 + beta / (2.0 * float(sys.D_hat_total) ** 2) * acc
