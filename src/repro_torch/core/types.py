"""Typed containers for the FEEL system model (paper §II).

Counterpart of ``repro/core/types.py``.  Every array field is a
float32 tensor on one device (the reference keeps float32 JAX arrays);
``K``, ``N`` and ``Q`` are plain ints.  ``from_arrays`` builds either
container from numpy arrays, which is how the parity tests carry the
reference objects across.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

#: array fields of SystemParams, in the reference's declaration order.
SYSTEM_ARRAYS = ("B", "T", "L", "N0", "p_max", "q", "c", "f", "F", "kappa",
                 "eps", "D_hat", "lam")


def _f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """Static FEEL system parameters (paper Table I / §VI-A defaults).

    Shapes: per-device quantities are (K,), the rest 0-d.
    """

    K: int  # devices
    N: int  # resource blocks
    Q: int  # max devices/RB
    B: torch.Tensor  # bandwidth per RB [Hz]
    T: torch.Tensor  # uplink duration [s]
    L: torch.Tensor  # gradient size [bits]
    N0: torch.Tensor  # noise power [W]
    p_max: torch.Tensor  # (K,) max tx power [W]
    q: torch.Tensor  # (K,) reward per selected sample
    c: torch.Tensor  # (K,) cost per Joule
    f: torch.Tensor  # (K,) CPU frequency [cycles/s]
    F: torch.Tensor  # (K,) CPU cycles per sample
    kappa: torch.Tensor  # energy capacitance coefficient
    eps: torch.Tensor  # (K,) availability probability eps_k
    D_hat: torch.Tensor  # (K,) |D̂_k| sampled sub-dataset sizes
    lam: torch.Tensor  # lambda trade-off in Problem 1

    @property
    def device(self) -> torch.device:
        return self.eps.device

    @property
    def D_hat_total(self) -> torch.Tensor:
        return torch.sum(self.D_hat)

    def a_weights(self) -> torch.Tensor:
        """A_k = |D̂_k|^2/eps_k + |D̂_k|(|D̂| - |D̂_k|)."""
        d = self.D_hat
        total = torch.sum(d)
        return d * d / self.eps + d * (total - d)

    @classmethod
    def from_arrays(cls, K: int, N: int, Q: int,
                    arrays: Mapping[str, np.ndarray],
                    device: DeviceLike = None) -> "SystemParams":
        """Build from numpy arrays keyed by field name (``SYSTEM_ARRAYS``)."""
        dev = resolve_device(device)
        return cls(K=int(K), N=int(N), Q=int(Q),
                   **{name: _f32(arrays[name], dev)
                      for name in SYSTEM_ARRAYS})


def default_system(K: int = 10, N: int = 5, Q: int = 2,
                   D_hat: int = 200, lam: float = 1e-3,
                   L_bits: float = 0.56e6,
                   device: DeviceLike = None) -> SystemParams:
    """Paper §VI-A simulation defaults (same values as the reference).

    c_k=5, q_k=0.002 for odd k (1-indexed), c_k=10, q_k=0.005 otherwise;
    eps_k = 0.2 odd / 0.8 even; f_k = {0.1..1.0} GHz; F_k=20 cycles/sample;
    kappa=1e-28; N=5, Q=2, B=2 MHz, N0=1e-9 W, T=500 ms, lambda=1e-3.
    """
    k_idx = np.arange(1, K + 1)
    odd = (k_idx % 2) == 1
    arrays = dict(
        B=2e6, T=0.5, L=L_bits, N0=1e-9, p_max=np.full(K, 10.0),
        q=np.where(odd, 0.002, 0.005), c=np.where(odd, 5.0, 10.0),
        f=(0.1 + 0.1 * ((k_idx - 1) % 10)) * 1e9, F=np.full(K, 20.0),
        kappa=1e-28, eps=np.where(odd, 0.2, 0.8),
        D_hat=np.full(K, float(D_hat)), lam=lam)
    return SystemParams.from_arrays(K, N, Q, arrays, device)


@dataclasses.dataclass(frozen=True)
class RoundState:
    """Per-round randomness: channel gains, availability, sigma scores."""

    h: torch.Tensor  # (K, N) channel power gains
    alpha: torch.Tensor  # (K,) availability indicators in {0, 1}
    sigma: torch.Tensor  # (K, max_Dhat) per-sample ||g_{k,j}||^2 scores
    sigma_mask: torch.Tensor  # (K, max_Dhat) 1 where a sample exists

    @classmethod
    def from_arrays(cls, h, alpha, sigma, sigma_mask,
                    device: DeviceLike = None) -> "RoundState":
        dev = resolve_device(device)
        return cls(h=_f32(h, dev), alpha=_f32(alpha, dev),
                   sigma=_f32(sigma, dev), sigma_mask=_f32(sigma_mask, dev))
