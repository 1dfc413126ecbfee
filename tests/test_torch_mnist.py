"""The port's local MNIST reader against the reference's.

Tiny IDX files (a big-endian magic whose low byte is the number of
dims, the dims, then uint8 data) are written in ``tmp_path``, raw and
gzipped; both readers must return the same arrays, and with no files
both must fall back to the same synthetic set.  Nothing is downloaded.
"""
import gzip
import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import mnist as jmnist  # noqa: E402
from repro_torch import data  # noqa: E402
from repro_torch.data import mnist  # noqa: E402

FILES = (("train-images-idx3-ubyte", (12, 5, 6)),
         ("train-labels-idx1-ubyte", (12,)),
         ("t10k-images-idx3-ubyte", (4, 5, 6)),
         ("t10k-labels-idx1-ubyte", (4,)))


def _write_idx(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        f">{arr.ndim}I", *arr.shape)
    opener = gzip.open if gz else open
    with opener(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


def _same(got, want):
    for split_got, split_want in zip(got, want):
        for field in ("images", "labels", "true_labels"):
            a, b = getattr(split_got, field), getattr(split_want, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b)
        assert split_got.num_classes == split_want.num_classes


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_read_alike(tmp_path, gz):
    rng = np.random.default_rng(0)
    for name, shape in FILES:
        hi = 10 if len(shape) == 1 else 256
        _write_idx(tmp_path / name, rng.integers(0, hi, shape), gz)
    assert mnist.available(str(tmp_path)) and jmnist.available(str(tmp_path))
    got = data.load_mnist(str(tmp_path))
    _same(got, jmnist.load_mnist(str(tmp_path)))
    train, test = got
    assert train.images.shape == (12, 5, 6) and test.labels.shape == (4,)
    assert train.images.dtype == np.float32 and train.images.max() <= 1.0


def test_missing_files_fall_back_alike(tmp_path):
    _write_idx(tmp_path / FILES[0][0], np.zeros(FILES[0][1]), False)
    assert not mnist.available(str(tmp_path))  # one file of four
    kw = dict(fallback_n=(30, 10), fallback_side=8, seed=3)
    got = mnist.load_mnist(str(tmp_path), **kw)
    _same(got, jmnist.load_mnist(str(tmp_path), **kw))
    assert got[0].images.shape == (30, 8, 8)
