"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips without a GPU:
a CUDA kernel has no CPU mode.  The file imports only torch and
``repro_torch`` (no JAX), so it also runs on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Tolerance: rtol 1e-5, float32 sums taken in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gradnorm  # noqa: E402

SHAPES = [(10, 50), (300, 700), (8, 4096), (1000, 130)]
MAIN_PATH = [(2000, 84), (2000, 10)]  # K*D̂ rows of h and of p - y


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _normal(seed, shape, device):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", SHAPES + MAIN_PATH)
def test_cuda_kernel_matches_plain(cuda, n, f):
    x = _normal(n * f, (n, f), cuda)
    d = _normal(n + 1, (n, 10), cuda)
    gradnorm.reset_launch_counts()
    got = gradnorm.rownorm2(x)
    sig = gradnorm.gradnorm_sigma(x, d)
    torch.cuda.synchronize()
    assert gradnorm.LAUNCHES == {"rownorm2": 1, "gradnorm_sigma": 1}
    torch.testing.assert_close(got, gradnorm.rownorm2_plain(x),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(sig, gradnorm.gradnorm_sigma_plain(x, d),
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernel_does_not_take(cuda):
    x = _normal(0, (64, 32), cuda)
    d = _normal(1, (64, 10), cuda)
    gradnorm.reset_launch_counts()
    with pytest.raises(TypeError):
        gradnorm.rownorm2(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        gradnorm.rownorm2(x.t())
    with pytest.raises(ValueError, match="2-D"):
        gradnorm.rownorm2(x[0])
    with pytest.raises(ValueError, match="row count"):
        gradnorm.gradnorm_sigma(x, d[:10])
    with pytest.raises(ValueError, match="CUDA"):
        gradnorm.gradnorm_sigma(x, d.cpu())
    assert gradnorm.LAUNCHES == {"rownorm2": 0, "gradnorm_sigma": 0}
    empty = gradnorm.rownorm2(torch.empty((0, 8), device=cuda))
    assert empty.shape == (0,) and gradnorm.LAUNCHES["rownorm2"] == 0
