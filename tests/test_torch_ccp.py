"""The port's Algorithm 3 (CCP power, ``core/power.py``), the CCP
evaluator of the swap matching and the proposed scheme with it, against
the reference.

The port solves the CCP subproblems in float64 on the host; the
reference solves them in float32.  Final costs are held at rtol 1e-3
(the gap measured on these setups is below 4e-6), the trajectory's
first entry (the start, before any solve) at rtol 1e-5, and every final
cost within 5e-3 of the closed-form optimum, the reference's own bound
(tests/test_core_power_matching.py).  The closed-form gradient and
Hessian of the barrier objective are held against ``torch.func`` at
rtol 1e-9 (both float64).  Matching decisions are identical.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import default_system as j_default_system  # noqa: E402
from repro.core import joint as jjoint  # noqa: E402
from repro.core import matching as jmatching  # noqa: E402
from repro.core import power as jpower  # noqa: E402
from repro.core import sample_round  # noqa: E402
from repro.data import SyntheticImages as JSyntheticImages  # noqa: E402
from repro.data import non_iid_split as j_non_iid_split  # noqa: E402
from repro.fed import FEELConfig as JFEELConfig  # noqa: E402
from repro.fed import FEELTrainer as JFEELTrainer  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import default_system, matching, power  # noqa: E402
from repro_torch.core.types import SYSTEM_ARRAYS, SystemParams  # noqa: E402
from repro_torch.data import SyntheticImages, non_iid_split  # noqa: E402
from repro_torch.fed import FEELConfig, FEELTrainer  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(2)

COST_RTOL = 1e-3    # float64 port vs float32 reference solve
START_RTOL = 1e-5   # the start is closed form x 1.5, no solve yet
CF_GAP = 5e-3       # the reference's own CCP-vs-closed-form bound


def _port_sys(ref):
    arrays = {f: np.asarray(getattr(ref, f)) for f in SYSTEM_ARRAYS}
    return SystemParams.from_arrays(ref.K, ref.N, ref.Q, arrays, device="cpu")


@functools.lru_cache(maxsize=None)
def _round_setup(seed, D_hat=16):
    """tests/test_core_power_matching.py's setup: §VI-A system, a
    sampled round, its closed-form swap matching (built once per module
    and shared by the tests; they copy before they edit)."""
    ref = j_default_system(K=10, N=5, Q=2, D_hat=D_hat)
    st = sample_round(jax.random.PRNGKey(seed), ref)
    res = jmatching.swap_matching(ref, st.h, st.alpha)
    return ref, res.rho, np.asarray(st.h), np.asarray(st.alpha)


@functools.lru_cache(maxsize=None)
def _gamma_setup(seed):
    """tests/test_power_retrace.py's ``_ccp_instance``: K=8, N=4, every
    device available, Gamma(2, 1e-5) gains."""
    rng = np.random.default_rng(seed)
    ref = j_default_system(K=8, N=4, Q=2)
    h = rng.gamma(2.0, 1e-5, size=(8, 4))
    alpha = np.ones(8)
    res = jmatching.swap_matching(ref, h, alpha)
    assert res.feasible
    return (ref, res.rho, np.asarray(h, np.float32),
            np.asarray(alpha, np.float32))


SETUPS = {"round7": lambda: _round_setup(7), "round9": lambda: _round_setup(9),
          "gamma0": lambda: _gamma_setup(0), "gamma5": lambda: _gamma_setup(5)}


def _cf_cost(ref, rho, h, alpha):
    p_cf, _ = jpower.closed_form_power(ref, jnp.asarray(rho), jnp.asarray(h),
                                       jnp.asarray(alpha))
    return float(jnp.sum(ref.c[:, None] * rho * p_cf) * ref.T)


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_ccp_power_matches_reference(setup):
    ref, rho, h, alpha = SETUPS[setup]()
    want = jpower.ccp_power(ref, jnp.asarray(rho), jnp.asarray(h),
                            jnp.asarray(alpha))
    got = power.ccp_power(_port_sys(ref), rho, h, alpha)
    assert got.feasible and want.feasible
    traj = got.trajectory
    np.testing.assert_allclose(traj[0], want.trajectory[0], rtol=START_RTOL)
    np.testing.assert_allclose(traj[-1], want.trajectory[-1], rtol=COST_RTOL)
    cost_cf = _cf_cost(ref, rho, h, alpha)
    assert abs(traj[-1] - cost_cf) / cost_cf < CF_GAP
    assert got.iterations == len(traj) - 1 >= 1
    assert all(traj[i + 1] <= traj[i] * (1 + 1e-6)
               for i in range(len(traj) - 1))
    # powers only where assigned, the cost is the last trajectory entry
    p = got.p.numpy()
    assert got.p.dtype == torch.float32 and np.all(p[rho == 0] == 0)
    np.testing.assert_allclose(
        float(np.sum(np.asarray(ref.c)[:, None] * rho * p) * float(ref.T)),
        traj[-1], rtol=1e-6)


def test_ccp_robust_to_initial_point_as_in_fig3():
    """benchmarks/fig3_ccp_convergence.py: 5 starts, scales drawn from
    default_rng(7) in [1.2, 4.0), reach the same cost within 5e-3 (and
    the reference's finals at rtol 1e-3, the closed form within 5e-3)."""
    ref, rho, h, alpha = _round_setup(7, D_hat=20)
    sys_ = _port_sys(ref)
    p_cf, _ = jpower.closed_form_power(ref, jnp.asarray(rho), jnp.asarray(h),
                                       jnp.asarray(alpha))
    rng = np.random.default_rng(7)
    finals = []
    for _ in range(5):
        scale = float(rng.uniform(1.2, 4.0))
        p0 = jnp.minimum(p_cf * scale, ref.p_max[:, None] * rho * (1 - 1e-4))
        got = power.ccp_power(sys_, rho, h, alpha, p0=np.asarray(p0))
        want = jpower.ccp_power(ref, jnp.asarray(rho), jnp.asarray(h),
                                jnp.asarray(alpha), p0=p0)
        np.testing.assert_allclose(got.trajectory[0], want.trajectory[0],
                                   rtol=START_RTOL)
        np.testing.assert_allclose(got.trajectory[-1], want.trajectory[-1],
                                   rtol=COST_RTOL)
        finals.append(got.trajectory[-1])
    assert max(finals) - min(finals) < CF_GAP * max(finals)
    cost_cf = _cf_cost(ref, rho, h, alpha)
    assert all(abs(f - cost_cf) / cost_cf < CF_GAP for f in finals)


@pytest.mark.parametrize("setup", ["round7", "gamma0"])
@pytest.mark.parametrize("scale", [1.05, 1.5, 3.0])
def test_closed_form_derivatives_match_torch_func(setup, scale):
    """The Newton step's gradient and Hessian against torch.func on the
    same barrier objective, at interior points of subproblem (34)."""
    ref, rho, h, alpha = SETUPS[setup]()
    s64 = power.system64(_port_sys(ref))
    rho, h, alpha = (power.host64(a) for a in (rho, h, alpha))
    p_cf, _ = power.closed_form_power(s64, torch.from_numpy(rho),
                                      torch.from_numpy(h),
                                      torch.from_numpy(alpha))
    sub = power.subproblem(s64, rho, h, alpha).linearize(p_cf.numpy() * 1.5)
    x = p_cf.numpy()[sub.ki, sub.ni] * scale
    assert sub.feasible(x)
    t = 10.0 / float(np.sum(sub.cost_grad * x))
    grad, hess = sub.derivatives(x, t)

    def phi(z):
        return sub.phi(z, t)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(grad, torch.func.grad(phi)(xt).numpy(),
                               rtol=1e-9, atol=1e-9 * np.abs(grad).max())
    np.testing.assert_allclose(hess, torch.func.hessian(phi)(xt).numpy(),
                               rtol=1e-9, atol=1e-9 * np.abs(hess).max())
    np.testing.assert_allclose(float(sub.phi(x, t)), float(phi(xt)),
                               rtol=1e-12)


def test_ccp_power_reports_an_infeasible_start():
    """An available device with no RB: the closed form is infeasible, so
    no solve runs (as in the reference) and the cost is inf."""
    ref, rho, h, alpha = _round_setup(7)
    rho = rho.copy()
    rho[np.flatnonzero(alpha > 0)[0]] = 0.0
    got = power.ccp_power(_port_sys(ref), rho, h, alpha)
    want = jpower.ccp_power(ref, jnp.asarray(rho), jnp.asarray(h),
                            jnp.asarray(alpha))
    assert not got.feasible and not want.feasible
    assert got.iterations == want.iterations == 0
    assert list(got.trajectory) == [np.inf]
    p, cost, ok = power.allocate_power(_port_sys(ref), rho, torch.tensor(h),
                                       torch.tensor(alpha), method="ccp")
    assert (cost, ok) == (float("inf"), False)
    with pytest.raises(ValueError, match="power method"):
        power.allocate_power(_port_sys(ref), rho, torch.tensor(h),
                             torch.tensor(alpha), method="cvx")


def test_allocate_power_ccp_lands_on_the_closed_form():
    ref, rho, h, alpha = _round_setup(9)
    sys_ = _port_sys(ref)
    args = (sys_, rho, torch.tensor(h), torch.tensor(alpha))
    p_cf, cost_cf, ok_cf = power.allocate_power(*args)
    p, cost, ok = power.allocate_power(*args, method="ccp")
    assert ok and ok_cf
    assert abs(cost - cost_cf) / cost_cf < CF_GAP
    torch.testing.assert_close(p, p_cf, rtol=CF_GAP, atol=0.0)


# ------------------------------------------------- the CCP matching scorer

def _matching_instances():
    """>= 5 seeded instances: small random ones, the §VI-A size, one with
    p_max small enough that some closed-form starts break it, and one
    whose two available devices share an RB, so the per-RB scorer runs a
    real CCP solve."""
    out = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        ref = j_default_system(K=6, N=3, Q=2)
        out.append((f"small{seed}", ref,
                    rng.exponential(1e-5, (6, 3)).astype(np.float32),
                    (rng.random(6) < 0.75).astype(np.float32)))
    ref = j_default_system(K=10, N=5, Q=2, D_hat=16)
    st = sample_round(jax.random.PRNGKey(0), ref)
    out.append(("paper", ref, np.asarray(st.h), np.asarray(st.alpha)))
    rng = np.random.default_rng(3)
    ref = dataclasses.replace(j_default_system(K=6, N=3, Q=2),
                              p_max=jnp.full(6, 6e-5, jnp.float32))
    out.append(("small_pmax", ref,
                rng.exponential(1e-5, (6, 3)).astype(np.float32),
                np.ones(6, np.float32)))
    ref = j_default_system(K=3, N=2, Q=2)
    out.append(("one_rb", ref,
                np.array([[3e-5, 1e-5], [2e-5, 1e-5], [1e-5, 2e-5]],
                         np.float32), np.array([1, 1, 0], np.float32)))
    return out


@pytest.mark.parametrize("case", range(6))
def test_ccp_matching_matches_reference(case):
    """The reference's per-RB CCP scorer prices each candidate RB on an
    assignment holding only its members; every other available device is
    unmatched there, so the candidate costs inf unless the RB holds all
    of them, and each cost difference is inf - inf = nan, which is never
    a gain.  The port makes the same decisions: no swap, the initial
    matching kept."""
    name, ref, h, alpha = _matching_instances()[case]
    with np.errstate(invalid="ignore"):
        want = jmatching.swap_matching(ref, h, alpha, evaluator="ccp")
        got = matching.swap_matching(_port_sys(ref), torch.tensor(h),
                                     torch.tensor(alpha), evaluator="ccp")
    np.testing.assert_array_equal(got.assign, want.assign, err_msg=name)
    np.testing.assert_array_equal(got.rho, want.rho, err_msg=name)
    assert (got.swaps, got.sweeps) == (want.swaps, want.sweeps) == (0, 1)
    assert got.feasible == want.feasible
    assert got.mode == want.mode == "scalar"
    np.testing.assert_allclose(got.cost, want.cost, rtol=1e-5)
    assert got.rb_evals > sum(alpha > 0)
    if name == "one_rb":
        assert got.ccp_solves >= 1
    if name == "small_pmax":
        assert not got.feasible


def test_ccp_matching_modes():
    sys_ = default_system(K=3, N=2, Q=2, device="cpu")
    h = torch.full((3, 2), 1e-5)
    with pytest.raises(ValueError, match="closed_form"):
        matching.swap_matching(sys_, h, torch.ones(3), evaluator="ccp",
                               mode="batched")
    with pytest.raises(ValueError, match="evaluator"):
        matching.swap_matching(sys_, h, torch.ones(3), evaluator="cvx")
    with np.errstate(invalid="ignore"):
        res = matching.swap_matching(sys_, h, torch.ones(3), evaluator="ccp",
                                     mode="auto")
    assert res.mode == "scalar"


# ------------------------------------------ the proposed scheme with CCP

K, N, Q, D_HAT, SIDE, ROUNDS, GP_STEPS = 6, 3, 2, 24, 12, 2, 100


def _data(mod_synth, mod_split):
    train = mod_synth.make(600, side=SIDE, seed=0)
    test = mod_synth.make(60, side=SIDE, seed=1)
    return mod_split(train, test, K=K, per_device=60, mislabel_prop=0.1,
                     seed=0)


def test_proposed_ccp_rounds_match_reference(monkeypatch):
    rec = []
    real = jjoint.proposed_scheme

    def scheme(sys_, state, **kw):
        dec = real(sys_, state, **kw)
        rec.append({"h": np.asarray(state.h),
                    "alpha": np.asarray(state.alpha), "dec": dec})
        return dec

    monkeypatch.setattr(jjoint, "proposed_scheme", scheme)
    params0 = jcnn.init(jax.random.PRNGKey(0), jcnn.CNNConfig(side=SIDE))
    jmodel = types.SimpleNamespace(features=jcnn.features, apply=jcnn.apply,
                                   loss_fn=jcnn.loss_fn,
                                   accuracy=jcnn.accuracy)
    jtr = JFEELTrainer(j_default_system(K=K, N=N, Q=Q, D_hat=D_HAT),
                       _data(JSyntheticImages, j_non_iid_split), jmodel,
                       params0, JFEELConfig(
                           d_hat=D_HAT, sigma_method="last_layer_kernel",
                           power_evaluator="ccp", gp_steps=GP_STEPS))
    with np.errstate(invalid="ignore"):
        jmetrics = [jtr.run_round(i) for i in range(ROUNDS)]

    model = cnn.CNN(cnn.CNNConfig(side=SIDE))
    model.load_state_dict(cnn.params_from_numpy(
        jax.tree.map(np.asarray, params0)))
    tr = FEELTrainer(default_system(K=K, N=N, Q=Q, D_hat=D_HAT, device="cpu"),
                     _data(SyntheticImages, non_iid_split), model,
                     FEELConfig(d_hat=D_HAT, power_evaluator="ccp",
                                gp_steps=GP_STEPS),
                     channel_source=lambda i: (rec[i]["h"], rec[i]["alpha"]))
    for i in range(ROUNDS):
        with np.errstate(invalid="ignore"):
            m = tr.run_round(i)
        want, dec = rec[i]["dec"], tr.last_decision
        np.testing.assert_array_equal(dec.rho, want.rho, err_msg=f"round {i}")
        np.testing.assert_array_equal(dec.delta.numpy(), want.delta,
                                      err_msg=f"round {i}")
        assert dec.swaps == want.swaps
        np.testing.assert_allclose(m.net_cost, jmetrics[i].net_cost,
                                   rtol=COST_RTOL)
        assert m.n_selected == jmetrics[i].n_selected
