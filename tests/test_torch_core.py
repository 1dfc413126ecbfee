"""Parity of the port's system model and matching with ``repro.core``.

Inputs come from numpy seeds and go through both packages at small
sizes.  Float32 model code (channel, cost, delta, closed-form power) is
held at rtol 1e-5: both sides compute in float32 and may sum in another
order.  The swap matching runs in float64 on the host on both sides, so
its decisions (assignment, swap and sweep counts, unmatched devices)
must be identical, in both sweep modes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import channel as jchannel  # noqa: E402
from repro.core import cost as jcost  # noqa: E402
from repro.core import default_system as j_default_system  # noqa: E402
from repro.core import delta as jdelta  # noqa: E402
from repro.core import matching as jmatching  # noqa: E402
from repro.core import power as jpower  # noqa: E402
from repro_torch.core import channel, cost, delta, matching, power  # noqa: E402
from repro_torch.core.types import (SYSTEM_ARRAYS, RoundState,  # noqa: E402
                                    SystemParams, default_system)

torch.set_num_threads(2)

RTOL = 1e-5


def _pair(K, N, Q, D_hat=8, lam=1e-3):
    """The reference system and the port's, built by the converter."""
    ref = j_default_system(K=K, N=N, Q=Q, D_hat=D_hat, lam=lam)
    arrays = {f: np.asarray(getattr(ref, f)) for f in SYSTEM_ARRAYS}
    return ref, SystemParams.from_arrays(K, N, Q, arrays, device="cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _inputs(seed, K, N, J=8):
    rng = np.random.default_rng(seed)
    h = rng.exponential(1e-5, (K, N)).astype(np.float32)
    alpha = (rng.random(K) < 0.75).astype(np.float32)
    assign = np.where(alpha > 0, rng.integers(0, N, K), -1)
    rho = np.zeros((K, N), np.float32)
    rho[np.flatnonzero(assign >= 0), assign[assign >= 0]] = 1.0
    p = (rng.random((K, N)) * 2.0 * rho).astype(np.float32)
    sigma = np.exp(rng.standard_normal((K, J)) * 0.5).astype(np.float32)
    dlt = rng.random((K, J)).astype(np.float32)
    return h, alpha, assign, rho, p, sigma, dlt


def test_default_system_matches_reference_and_converter():
    ref, conv = _pair(K=6, N=3, Q=2, D_hat=24)
    mine = default_system(K=6, N=3, Q=2, D_hat=24, device="cpu")
    for f in SYSTEM_ARRAYS:
        np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(conv, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
        assert getattr(mine, f).dtype == torch.float32
    assert (mine.K, mine.N, mine.Q) == (ref.K, ref.N, ref.Q)
    _close(mine.a_weights(), ref.a_weights())
    _close(mine.D_hat_total, ref.D_hat_total)


def test_round_state_converter():
    h, alpha, _, _, _, sigma, _ = _inputs(0, 4, 2)
    st = RoundState.from_arrays(h, alpha, sigma, np.ones_like(sigma),
                                device="cpu")
    assert all(getattr(st, f.name).dtype == torch.float32
               for f in dataclasses.fields(st))
    np.testing.assert_array_equal(st.h.numpy(), h)


def test_entry_points_need_a_gpu_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_system(K=4, N=2, Q=2)
    assert default_system(K=4, N=2, Q=2, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_channel_matches_reference(seed):
    K, N = 6, 3
    ref, sys_ = _pair(K, N, 2)
    h, alpha, assign, rho, p, _, _ = _inputs(seed, K, N)
    h[1, 0] = h[2, 0]  # a gain tie: broken by device index on both sides
    _close(channel.interference(_t(rho), _t(p), _t(h), sys_.N0),
           jchannel.interference(rho, p, h, ref.N0))
    _close(channel.sinr(_t(rho), _t(p), _t(h), sys_.N0),
           jchannel.sinr(rho, p, h, ref.N0))
    _close(channel.rate(sys_, _t(rho), _t(p), _t(h)),
           jchannel.rate(ref, rho, p, h))
    _close(channel.rate_per_device(sys_, _t(rho), _t(p), _t(h)),
           jchannel.rate_per_device(ref, rho, p, h))
    np.testing.assert_array_equal(
        channel.upload_feasible(sys_, _t(rho), _t(p), _t(h), _t(alpha)).numpy(),
        np.asarray(jchannel.upload_feasible(ref, rho, p, h, alpha)))
    assert channel.assignment_valid(sys_, _t(rho), _t(alpha)) == bool(
        jchannel.assignment_valid(ref, rho, alpha))
    np.testing.assert_array_equal(
        channel.rho_from_assignment(torch.from_numpy(assign), K, N).numpy(),
        np.asarray(jchannel.rho_from_assignment(assign, K, N)))


@pytest.mark.parametrize("seed", [0, 1])
def test_cost_matches_reference(seed):
    K, N = 6, 3
    ref, sys_ = _pair(K, N, 2)
    _, _, _, rho, p, _, dlt = _inputs(seed, K, N)
    n_sel = dlt.sum(axis=1)
    for name in ("compute_time", "energy_compute", "cost_compute"):
        _close(getattr(cost, name)(sys_), getattr(jcost, name)(ref))
    for name in ("energy_upload", "cost_upload", "resource_cost"):
        _close(getattr(cost, name)(sys_, _t(rho), _t(p)),
               getattr(jcost, name)(ref, rho, p))
    _close(cost.reward(sys_, _t(n_sel)), jcost.reward(ref, n_sel))
    _close(cost.net_cost(sys_, _t(rho), _t(p), _t(n_sel)),
           jcost.net_cost(ref, rho, p, n_sel))


@pytest.mark.parametrize("seed", [0, 1])
def test_delta_matches_reference(seed):
    K, N = 5, 2
    ref, sys_ = _pair(K, N, 2)
    _, _, _, rho, p, sigma, dlt = _inputs(seed, K, N)
    _close(delta.selected_mean_sigma(_t(dlt), _t(sigma)),
           jdelta.selected_mean_sigma(dlt, sigma))
    _close(delta.delta(sys_, _t(dlt), _t(sigma)), jdelta.delta(ref, dlt, sigma))
    _close(delta.delta_raw(sys_, _t(dlt), _t(sigma)),
           jdelta.delta_raw(ref, dlt, sigma))
    _close(delta.objective(sys_, _t(dlt), _t(sigma), _t(rho), _t(p)),
           jdelta.objective(ref, dlt, sigma, rho, p))
    _close(delta.selection_only_objective(sys_, _t(dlt), _t(sigma)),
           jdelta.selection_only_objective(ref, dlt, sigma))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_closed_form_power_matches_reference(seed):
    K, N = 6, 3
    ref, sys_ = _pair(K, N, 2)
    h, alpha, _, rho, _, _, _ = _inputs(seed, K, N)
    assert float(power.snr_target(sys_)) == float(jpower.snr_target(ref))
    p, feas = power.closed_form_power(sys_, _t(rho), _t(h), _t(alpha))
    jp, jfeas = jpower.closed_form_power(ref, rho, h, alpha)
    _close(p, jp)
    np.testing.assert_array_equal(feas.numpy(), np.asarray(jfeas))
    p2, c2, ok2 = power.allocate_power(sys_, _t(rho), _t(h), _t(alpha))
    jp2, jc2, jok2 = jpower.allocate_power(ref, rho, h, alpha,
                                           method="closed_form")
    assert ok2 == jok2
    _close(np.float64(c2), jc2)


MATCH_CASES = [(K, N, seed) for K, N in ((4, 2), (5, 3), (6, 3), (6, 2))
               for seed in range(4)]


@pytest.mark.parametrize("mode", ["scalar", "batched", "auto"])
@pytest.mark.parametrize("allow_moves", [True, False])
def test_swap_matching_matches_reference(mode, allow_moves):
    swaps_seen = 0
    for K, N, seed in MATCH_CASES:
        ref, sys_ = _pair(K, N, 2)
        rng = np.random.default_rng(100 + seed)
        h = rng.exponential(1e-5, (K, N)).astype(np.float32)
        alpha = (rng.random(K) < 0.8).astype(np.float32)
        got = matching.swap_matching(sys_, torch.from_numpy(h),
                                     torch.from_numpy(alpha),
                                     allow_moves=allow_moves, mode=mode)
        want = jmatching.swap_matching(ref, h, alpha, allow_moves=allow_moves,
                                       mode=mode)
        case = (K, N, seed)
        np.testing.assert_array_equal(got.assign, want.assign, err_msg=case)
        np.testing.assert_array_equal(got.rho, want.rho, err_msg=case)
        assert (got.swaps, got.sweeps, got.feasible, got.mode) == (
            want.swaps, want.sweeps, want.feasible, want.mode), case
        np.testing.assert_array_equal(got.unmatched, want.unmatched)
        _close(got.p, want.p)
        if np.isinf(want.cost):
            assert np.isinf(got.cost)
        else:
            _close(np.float64(got.cost), want.cost)
        swaps_seen += got.swaps
    assert swaps_seen > 0  # the cases exercise the swap/move path


def test_swap_matching_partial_when_slots_run_out():
    ref, sys_ = _pair(6, 2, 2)
    h = np.random.default_rng(5).exponential(1e-5, (6, 2)).astype(np.float32)
    alpha = np.ones(6, np.float32)
    got = matching.swap_matching(sys_, h, alpha)
    want = jmatching.swap_matching(ref, h, alpha)
    assert got.unmatched.size == 2 and not got.feasible
    np.testing.assert_array_equal(got.assign, want.assign)
    np.testing.assert_array_equal(got.unmatched, want.unmatched)
    with pytest.raises(ValueError):
        matching.swap_matching(sys_, h, alpha, mode="bogus")
