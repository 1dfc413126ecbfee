"""Parity of the port's row-norm sigma kernel module with the Pallas one.

On the CPU the port's wrappers run their plain PyTorch versions; those
are held against ``repro.kernels.ref`` and against the Pallas kernel in
interpret mode (as tests/test_kernels.py runs it), at rtol 1e-5 (float32
sums taken in another order).  The CUDA kernel itself runs only on the
card: its tests are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gradnorm import gradnorm_sigma as j_gradnorm_sigma  # noqa: E402
from repro.kernels.gradnorm import rownorm2 as j_rownorm2  # noqa: E402
from repro_torch.kernels import gradnorm, ops, ref  # noqa: E402

torch.set_num_threads(2)

SHAPES = [(10, 50), (300, 700), (8, 4096), (1000, 130)]


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n,f", SHAPES)
def test_rownorm2_matches_reference(n, f):
    x = _normal(n * f, (n, f))
    got = ops.rownorm2(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.rownorm2_ref(x)),
                               rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(j_rownorm2(x, interpret=True)),
                               rtol=1e-5)


@pytest.mark.parametrize("n,f", SHAPES)
def test_gradnorm_sigma_matches_reference(n, f):
    h = _normal(n + f, (n, f))
    d = _normal(n + f + 1, (n, 10))
    got = ops.gradnorm_sigma(torch.from_numpy(h), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.gradnorm_sigma_ref(h, d)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(j_gradnorm_sigma(h, d, interpret=True)), rtol=1e-5)


def test_sigma_from_head_matches_reference():
    rng = np.random.default_rng(7)
    h = rng.standard_normal((64, 84)).astype(np.float32)
    logits = rng.standard_normal((64, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    got = ops.sigma_from_head(torch.from_numpy(h), torch.from_numpy(logits),
                              torch.from_numpy(labels)).numpy()
    want = np.asarray(jops.sigma_from_head(h, logits, labels))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ref_names_are_the_plain_versions():
    x = torch.from_numpy(_normal(3, (5, 9)))
    d = torch.from_numpy(_normal(4, (5, 3)))
    torch.testing.assert_close(ref.rownorm2_ref(x), gradnorm.rownorm2_plain(x))
    torch.testing.assert_close(ref.gradnorm_sigma_ref(x, d),
                               gradnorm.gradnorm_sigma_plain(x, d))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    gradnorm.reset_launch_counts()
    x = torch.from_numpy(_normal(5, (12, 33)))
    d = torch.from_numpy(_normal(6, (12, 10)))
    torch.testing.assert_close(gradnorm.rownorm2(x), gradnorm.rownorm2_plain(x))
    torch.testing.assert_close(gradnorm.gradnorm_sigma(x, d),
                               gradnorm.gradnorm_sigma_plain(x, d))
    assert gradnorm.LAUNCHES == {"rownorm2": 0, "gradnorm_sigma": 0}


def test_non_cpu_non_cuda_tensors_raise_instead_of_falling_back():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gradnorm.rownorm2(x)
    with pytest.raises(ValueError, match="CUDA"):
        gradnorm.gradnorm_sigma(x, torch.empty((4, 3), device="meta"))
    # a CPU tensor paired with a non-CPU one is no plain-version case
    with pytest.raises(ValueError, match="CUDA"):
        gradnorm.gradnorm_sigma(torch.zeros(4, 8),
                                torch.empty((4, 3), device="meta"))
    assert gradnorm.LAUNCHES == {"rownorm2": 0, "gradnorm_sigma": 0}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernel is built from source; with no nvcc there is no
    library and no silent fallback to the plain version."""
    monkeypatch.setattr(gradnorm, "_BUILD", None)
    monkeypatch.setattr(gradnorm, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gradnorm.build()
    assert gradnorm._BUILD is None
    assert not any((tmp_path / "build").glob("*.so"))
