"""NOMA uplink channel model with SIC decoding (paper §II-C).

Counterpart of ``repro/core/channel.py``.  The server decodes, on each
RB, the strongest device first and treats every weaker co-RB device as
interference: I_{k,n} = sum_{t: h_t < h_k} p_t h_t + N0 (eqs. 29/31).
All functions take dense (K, N) tensors and an RB-assignment matrix
``rho`` in {0,1}^{K x N}.
"""
from __future__ import annotations

import torch

from .types import SystemParams


def weaker_than(h: torch.Tensor) -> torch.Tensor:
    """(t, k, n) boolean: device t is strictly weaker than k on RB n.

    Ties are broken by device index so the SIC order is always strict.
    """
    K = h.shape[0]
    idx = torch.arange(K, device=h.device)
    h_t, h_k = h[:, None, :], h[None, :, :]
    t_idx, k_idx = idx[:, None, None], idx[None, :, None]
    return (h_t < h_k) | ((h_t == h_k) & (t_idx < k_idx))


def interference(rho: torch.Tensor, p: torch.Tensor, h: torch.Tensor,
                 N0: torch.Tensor) -> torch.Tensor:
    """I_{k,n}: interference + noise seen by device k on RB n."""
    contrib = rho * p * h
    interf = torch.einsum("tkn,tn->kn", weaker_than(h).to(p.dtype), contrib)
    return interf + N0


def sinr(rho: torch.Tensor, p: torch.Tensor, h: torch.Tensor,
         N0: torch.Tensor) -> torch.Tensor:
    """Per-(device, RB) SINR under SIC."""
    return rho * p * h / interference(rho, p, h, N0)


def rate(sys: SystemParams, rho: torch.Tensor, p: torch.Tensor,
         h: torch.Tensor) -> torch.Tensor:
    """Achievable rate r_{k,n} [bits/s] (eq. below (15))."""
    return sys.B * torch.log2(1.0 + sinr(rho, p, h, sys.N0))


def rate_per_device(sys: SystemParams, rho: torch.Tensor, p: torch.Tensor,
                    h: torch.Tensor) -> torch.Tensor:
    """sum_n r_{k,n}; each device occupies at most one RB (eq. 13)."""
    return torch.sum(rate(sys, rho, p, h), dim=1)


def upload_feasible(sys: SystemParams, rho: torch.Tensor, p: torch.Tensor,
                    h: torch.Tensor, alpha: torch.Tensor,
                    rtol: float = 1e-4) -> torch.Tensor:
    """Constraint (16): r_k * T >= alpha_k * L, per device (boolean)."""
    lhs = rate_per_device(sys, rho, p, h) * sys.T
    rhs = alpha * sys.L
    return lhs >= rhs * (1.0 - rtol)


def assignment_valid(sys: SystemParams, rho: torch.Tensor,
                     alpha: torch.Tensor) -> bool:
    """Constraints (11)-(14) as a single boolean."""
    binary = torch.all((rho == 0) | (rho == 1))
    per_rb = torch.all(torch.sum(rho, dim=0) <= sys.Q)  # (12)
    per_dev = torch.all(torch.sum(rho, dim=1) <= 1)  # (13)
    avail = torch.all(rho <= alpha[:, None])  # (14)
    return bool(binary & per_rb & per_dev & avail)


def rho_from_assignment(assign: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """Dense rho from an assignment vector (K,) with values in [0,N) or -1."""
    cols = torch.clamp(assign, 0, N - 1)
    onehot = torch.nn.functional.one_hot(cols.long(), N).to(torch.float32)
    return onehot * (assign >= 0).to(torch.float32)[:, None]
