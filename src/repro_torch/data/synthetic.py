"""Offline synthetic MNIST-shaped dataset (paper-validation data), and
the power-law token batches of the zoo's training driver.

Counterpart of ``repro/data/synthetic.py``.  ``SyntheticImages`` is
numpy, so the same seed gives the same images bit for bit: each class
has a fixed smooth prototype plus per-sample shift and pixel noise, so a
small CNN separates the classes and mislabeled samples carry larger
gradients.  ``synthetic_lm_batch`` draws with a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _class_prototypes(num_classes: int, side: int,
                      rng: np.random.Generator) -> np.ndarray:
    """Smooth random low-frequency prototypes, one per class."""
    protos = []
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float64) / side
    for _ in range(num_classes):
        img = np.zeros((side, side))
        for _ in range(4):  # few random Gabor-ish bumps per class
            cx, cy = rng.uniform(0.2, 0.8, 2)
            sx, sy = rng.uniform(0.08, 0.25, 2)
            amp = rng.uniform(0.5, 1.0) * rng.choice([-1.0, 1.0])
            img += amp * np.exp(-((xx - cx) ** 2 / (2 * sx ** 2)
                                  + (yy - cy) ** 2 / (2 * sy ** 2)))
        img = (img - img.min()) / max(img.max() - img.min(), 1e-9)
        protos.append(img)
    return np.stack(protos).astype(np.float32)


@dataclasses.dataclass
class SyntheticImages:
    """MNIST-shaped synthetic classification dataset."""

    images: np.ndarray  # (N, side, side) float32 in [0, 1]
    labels: np.ndarray  # (N,) int32 (possibly corrupted)
    true_labels: np.ndarray  # (N,) int32 ground truth
    num_classes: int

    @staticmethod
    def make(n: int, side: int = 28, num_classes: int = 10,
             noise: float = 0.25, seed: int = 0) -> "SyntheticImages":
        rng = np.random.default_rng(seed)
        # prototypes are the class definition: fixed across splits
        # (train/test must share them), independent of ``seed``
        proto_rng = np.random.default_rng(991_000 + side)
        protos = _class_prototypes(num_classes, side, proto_rng)
        labels = rng.integers(0, num_classes, n).astype(np.int32)
        imgs = protos[labels]
        # per-sample geometric jitter: shift by up to 2px + pixel noise
        shifts = rng.integers(-2, 3, (n, 2))
        out = np.empty_like(imgs)
        for i in range(n):
            out[i] = np.roll(imgs[i], tuple(shifts[i]), axis=(0, 1))
        out += rng.normal(0, noise, out.shape).astype(np.float32)
        out = np.clip(out, 0.0, 1.0)
        return SyntheticImages(images=out, labels=labels.copy(),
                               true_labels=labels, num_classes=num_classes)

    def __len__(self) -> int:
        return self.images.shape[0]


def synthetic_lm_batch(generator: torch.Generator, batch: int, seq: int,
                       vocab: int, device=None) -> dict:
    """Power-law token batch for LM training examples: seq + 1 tokens a
    row drawn i.i.d. from the softmax over -1.1 log(rank) (the
    reference's zipf-ish categorical), from ``generator`` on ``device``
    (the generator's device); tokens are the first seq, labels the last
    seq (int64).  The reference draws with ``jax.random``, so the same
    seed gives other tokens from the same distribution."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    probs = torch.softmax(-1.1 * torch.log(ranks), dim=0)
    tokens = torch.multinomial(probs, batch * (seq + 1), replacement=True,
                               generator=generator).view(batch, seq + 1)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
