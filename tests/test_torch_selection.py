"""Parity of the port's data selection (Algs. 4-5, exact oracle) and of
Algorithm 1 (``proposed_scheme``) with ``repro.core``.

The gradient-projection iterates are held at atol 1e-5, not tighter:
the reference's own chunked and full-matrix GP differ by up to 2.6e-7
from float32 reduction order alone, and 400 steps carry such drift
along.  Binary selections (Alg. 5 and the exact oracle) must be
identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import RoundState as JRoundState  # noqa: E402
from repro.core import default_system as j_default_system  # noqa: E402
from repro.core import joint as jjoint  # noqa: E402
from repro.core import selection as jselection  # noqa: E402
from repro_torch.core import joint, selection  # noqa: E402
from repro_torch.core.types import (SYSTEM_ARRAYS, RoundState,  # noqa: E402
                                    SystemParams)

torch.set_num_threads(2)

GP_ATOL = 1e-5


def _pair(K, N, Q, D_hat, lam=1e-3):
    ref = j_default_system(K=K, N=N, Q=Q, D_hat=D_hat, lam=lam)
    arrays = {f: np.asarray(getattr(ref, f)) for f in SYSTEM_ARRAYS}
    return ref, SystemParams.from_arrays(K, N, Q, arrays, device="cpu")


def _sigma(seed, K, J, ragged=False):
    """Lognormal scores with a few outliers (mislabeled samples score
    high), and an optional ragged mask."""
    rng = np.random.default_rng(seed)
    sigma = np.exp(rng.standard_normal((K, J)) * 0.5)
    sigma[rng.random((K, J)) < 0.15] *= 20.0
    mask = np.ones((K, J), np.float32)
    if ragged:
        for k in range(K):
            mask[k, rng.integers(J // 2, J + 1):] = 0.0
    return (sigma * mask).astype(np.float32), mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_project_feasible_matches_reference(seed):
    rng = np.random.default_rng(seed)
    K, J = 6, 24
    z = (rng.standard_normal((K, J)) * 0.6).astype(np.float32)
    z[:3] -= 1.5  # rows whose clipped sum falls below 1: the bisection path
    _, mask = _sigma(seed, K, J, ragged=True)
    got = selection.project_feasible(torch.from_numpy(z), torch.from_numpy(mask))
    want = np.asarray(jselection.project_feasible(z, mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert np.all(got.numpy().sum(axis=1) >= 1.0 - 1e-5)


@pytest.mark.parametrize("steps,ragged", [(400, False), (60, True)])
def test_gradient_projection_iterates_match_reference(steps, ragged):
    ref, sys_ = _pair(6, 3, 2, D_hat=24)
    sigma, mask = _sigma(steps + ragged, 6, 24, ragged)
    got = selection.gradient_projection(sys_, torch.from_numpy(sigma),
                                        torch.from_numpy(mask), steps=steps)
    want = np.asarray(jselection.gradient_projection(ref, sigma, mask,
                                                     steps=steps))
    np.testing.assert_allclose(got.numpy(), want, atol=GP_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_binary_and_exact_selection_identical(seed):
    ref, sys_ = _pair(5, 3, 2, D_hat=20)
    sigma, mask = _sigma(10 + seed, 5, 20, ragged=seed % 2 == 1)
    s_t, m_t = torch.from_numpy(sigma), torch.from_numpy(mask)
    got_f = selection.faithful_selection(sys_, s_t, m_t)
    want_f = np.asarray(jselection.faithful_selection(ref, sigma, mask))
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    got_e = selection.exact_selection(sys_, s_t, m_t)
    want_e = np.asarray(jselection.exact_selection(ref, sigma, mask))
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    # Alg. 5 alone, on a continuous point with an all-below-1/2 row
    d = np.random.default_rng(seed).random((5, 20)).astype(np.float32)
    d[0] *= 0.4
    np.testing.assert_array_equal(
        selection.binary_recovery(torch.from_numpy(d), m_t).numpy(),
        np.asarray(jselection.binary_recovery(d, mask)))


def test_solve_selection_methods():
    ref, sys_ = _pair(4, 2, 2, D_hat=16)
    sigma, mask = _sigma(3, 4, 16)
    s_t, m_t = torch.from_numpy(sigma), torch.from_numpy(mask)
    for method in ("faithful", "exact"):
        got, cont = selection.solve_selection(sys_, s_t, m_t, method=method,
                                              steps=100)
        want = np.asarray(jselection.solve_selection(ref, sigma, mask,
                                                     method=method,
                                                     steps=100))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (cont is None) == (method == "exact")
    with pytest.raises(ValueError):
        selection.solve_selection(sys_, s_t, m_t, method="bogus")


@pytest.mark.parametrize("method,seed", [("faithful", 0), ("exact", 1)])
def test_proposed_scheme_matches_reference(method, seed):
    K, N, J = 6, 3, 24
    ref, sys_ = _pair(K, N, 2, D_hat=J)
    rng = np.random.default_rng(50 + seed)
    h = rng.exponential(1e-5, (K, N)).astype(np.float32)
    alpha = (rng.random(K) < 0.8).astype(np.float32)
    sigma, mask = _sigma(60 + seed, K, J)
    got = joint.proposed_scheme(
        sys_, RoundState.from_arrays(h, alpha, sigma, mask, device="cpu"),
        selection_method=method)
    want = jjoint.proposed_scheme(
        ref, JRoundState(h=h, alpha=alpha, sigma=sigma, sigma_mask=mask),
        selection_method=method)
    np.testing.assert_array_equal(got.rho, want.rho)
    np.testing.assert_array_equal(got.delta.numpy(), want.delta)
    assert (got.swaps, got.feasible) == (want.swaps, want.feasible)
    np.testing.assert_array_equal(got.unmatched, want.unmatched)
    np.testing.assert_allclose(got.p.numpy(), want.p, rtol=1e-5)
    for name in ("net_cost", "delta_obj", "objective"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-5, err_msg=name)
