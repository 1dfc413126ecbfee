"""Label corruption (paper §VI-A): a proportion rho_k of each device's
samples gets a *wrong* label (uniform over the other classes).

Counterpart of ``repro/data/mislabel.py``; numpy, so the same seed gives
the same corruption bit for bit.
"""
from __future__ import annotations

import numpy as np


def mislabel(labels: np.ndarray, proportion: float, num_classes: int,
             seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Returns (corrupted_labels, corrupted_mask)."""
    rng = np.random.default_rng(seed)
    n = labels.shape[0]
    n_bad = int(round(proportion * n))
    idx = rng.choice(n, size=n_bad, replace=False)
    corrupted = labels.copy()
    if n_bad:
        offs = rng.integers(1, num_classes, n_bad)
        corrupted[idx] = (labels[idx] + offs) % num_classes
    mask = np.zeros(n, bool)
    mask[idx] = True
    return corrupted, mask
