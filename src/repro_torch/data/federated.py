"""Federated (non-IID) data placement, mirroring paper §VI-A: each
device holds |D_k| samples of a single label; every round it samples
|D̂_k| of them; a proportion of them is mislabeled.

Counterpart of ``repro/data/federated.py``; numpy, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .mislabel import mislabel
from .synthetic import SyntheticImages


@dataclasses.dataclass
class FederatedDataset:
    """Per-device shards + a common test set."""

    device_images: List[np.ndarray]   # K x (|D_k|, side, side)
    device_labels: List[np.ndarray]   # labels as *seen* (maybe corrupted)
    device_true: List[np.ndarray]     # ground-truth labels
    test_images: np.ndarray
    test_labels: np.ndarray
    num_classes: int

    @property
    def K(self) -> int:
        return len(self.device_images)

    def sample_subsets(self, rng: np.random.Generator,
                       d_hat: int) -> List[np.ndarray]:
        """Round-wise |D̂_k| sampling: index arrays per device."""
        return [rng.choice(len(imgs), size=min(d_hat, len(imgs)),
                           replace=False)
                for imgs in self.device_images]


def non_iid_split(data: SyntheticImages, test: SyntheticImages, K: int,
                  per_device: int, mislabel_prop: float,
                  seed: int = 0) -> FederatedDataset:
    """One label per device (paper: '1000 figures of one label')."""
    rng = np.random.default_rng(seed)
    dev_imgs, dev_labels, dev_true = [], [], []
    for k in range(K):
        label = k % data.num_classes
        pool = np.flatnonzero(data.true_labels == label)
        idx = rng.choice(pool, size=min(per_device, pool.size),
                         replace=False)
        imgs = data.images[idx]
        true = data.true_labels[idx]
        seen, _ = mislabel(true, mislabel_prop, data.num_classes,
                           seed=seed + 1000 + k)
        dev_imgs.append(imgs)
        dev_labels.append(seen)
        dev_true.append(true)
    return FederatedDataset(device_images=dev_imgs, device_labels=dev_labels,
                            device_true=dev_true, test_images=test.images,
                            test_labels=test.true_labels,
                            num_classes=data.num_classes)
