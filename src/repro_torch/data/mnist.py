"""Real MNIST/Fashion-MNIST loader (IDX format) with a synthetic fallback.

Counterpart of ``repro/data/mnist.py``, numpy only, so both packages
read the same arrays.  If the four standard IDX files
(train-images-idx3-ubyte etc., raw or ``.gz``) exist under ``root`` they
are parsed directly; otherwise the synthetic generator with the same
shapes is returned, so every experiment still runs.  Only local files
are read: nothing is downloaded.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Tuple

import numpy as np

from .synthetic import SyntheticImages

_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def _open(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _read_idx(path: str) -> np.ndarray:
    """An IDX file: a big-endian magic whose low byte is the number of
    dims, the dims as big-endian uint32, then uint8 data."""
    with _open(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def available(root: str) -> bool:
    """Whether all four IDX files (raw or gzipped) are under ``root``."""
    return all(os.path.exists(os.path.join(root, f))
               or os.path.exists(os.path.join(root, f + ".gz"))
               for f in _FILES.values())


def load_mnist(root: str = "data/mnist",
               fallback_n: Tuple[int, int] = (60000, 10000),
               fallback_side: int = 28,
               seed: int = 0) -> Tuple[SyntheticImages, SyntheticImages]:
    """(train, test) as ``SyntheticImages`` containers: the IDX files'
    images scaled to [0, 1] and their int32 labels when present,
    otherwise ``SyntheticImages.make`` of ``fallback_n`` images of side
    ``fallback_side`` (seeds ``seed`` and ``seed + 1``)."""
    if available(root):
        def read(key: str) -> np.ndarray:
            return _read_idx(os.path.join(root, _FILES[key]))

        tr_x = read("train_images").astype(np.float32) / 255.0
        tr_y = read("train_labels").astype(np.int32)
        te_x = read("test_images").astype(np.float32) / 255.0
        te_y = read("test_labels").astype(np.int32)
        train = SyntheticImages(images=tr_x, labels=tr_y.copy(),
                                true_labels=tr_y, num_classes=10)
        test = SyntheticImages(images=te_x, labels=te_y.copy(),
                               true_labels=te_y, num_classes=10)
        return train, test
    train = SyntheticImages.make(fallback_n[0], side=fallback_side, seed=seed)
    test = SyntheticImages.make(fallback_n[1], side=fallback_side,
                                seed=seed + 1)
    return train, test
