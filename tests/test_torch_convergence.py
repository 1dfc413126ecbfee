"""The paper's convergence bounds (Lemmas 1-3, ``core/convergence.py``)
and the convergence monitor of the port against the reference.

Inputs are made from a seeded numpy generator and fed to both packages;
every bound is held at rtol 1e-5 (both compute in float32).  The
monitors see one scripted sequence of observations (a bound violation,
a divergence run, a straggler round and a straggler stage, Lemma 3 on)
and must raise the same warnings in the same rounds, with the same
bounds at rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.core import convergence as jconv  # noqa: E402
from repro.core import default_system as j_default_system  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import convergence, default_system  # noqa: E402

RTOL = 1e-5
K = 6


@pytest.fixture(autouse=True)
def _reset_port_obs_defaults():
    yield
    obs.set_default(None)
    obs.metrics.set_default(None)


@pytest.fixture(scope="module")
def systems():
    return (j_default_system(K=K, N=3, Q=2, D_hat=40),
            default_system(K=K, N=3, Q=2, D_hat=40, device="cpu"))


def _f32(rng, *shape, lo=0.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_matches_reference(systems, seed):
    jsys, psys = systems
    rng = np.random.default_rng(seed)
    grads = rng.standard_normal((K, 37)).astype(np.float32)
    alpha = (rng.uniform(size=K) < 0.6).astype(np.float32)
    want = np.asarray(jconv.aggregate(jsys, jnp.asarray(grads),
                                      jnp.asarray(alpha)))
    got = convergence.aggregate(psys, torch.from_numpy(grads),
                                torch.from_numpy(alpha))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_round_bounds_match_reference(systems, seed):
    jsys, psys = systems
    rng = np.random.default_rng(seed)
    dlt = (_f32(rng, K, 40) > 0.3).astype(np.float32)
    sigma = _f32(rng, K, 40, hi=5.0)
    gap, g2, eta, beta = (float(v) for v in rng.uniform(0.1, 2.0, 4))
    want = float(jconv.one_round_bound(jsys, gap, g2, eta, beta,
                                       jnp.asarray(dlt), jnp.asarray(sigma)))
    got = float(convergence.one_round_bound(psys, gap, g2, eta, beta,
                                            torch.from_numpy(dlt),
                                            torch.from_numpy(sigma)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    d_term = float(rng.uniform(1e3, 1e6))
    np.testing.assert_allclose(
        float(convergence.one_round_bound_from_delta(psys, gap, g2, eta,
                                                     beta, d_term)),
        float(jconv.one_round_bound_from_delta(jsys, gap, g2, eta, beta,
                                               d_term)), rtol=RTOL)


@pytest.mark.parametrize("seed,rounds", [(0, 1), (1, 7), (2, 60)])
def test_multi_round_bound_matches_reference(systems, seed, rounds):
    jsys, psys = systems
    rng = np.random.default_rng(seed)
    etas = [float(v) for v in rng.uniform(1e-4, 5e-2, rounds)]
    deltas = [float(v) for v in rng.uniform(1e2, 1e5, rounds)]
    gap1, mu, beta = 2.5, float(rng.uniform(0.1, 5.0)), 1.3
    want = jconv.multi_round_bound(jsys, gap1, mu, beta, etas, deltas)
    want_ref = jconv.multi_round_bound_ref(jsys, gap1, mu, beta, etas,
                                           deltas)
    got = convergence.multi_round_bound(psys, gap1, mu, beta, etas, deltas)
    got_ref = convergence.multi_round_bound_ref(psys, gap1, mu, beta, etas,
                                                deltas)
    for value in (got, got_ref, want_ref):
        np.testing.assert_allclose(value, want, rtol=RTOL)
    assert isinstance(got, float) and isinstance(got_ref, float)
    assert convergence.multi_round_bound(psys, gap1, mu, beta, [], []) == gap1
    with pytest.raises(ValueError):
        convergence.multi_round_bound(psys, gap1, mu, beta, etas, [])


def _observations():
    """(gap, ||g||^2, eta, delta_obj, wall_s, stage_s) per round."""
    rng = np.random.default_rng(3)
    gaps = [2.0, 1.9, 2.6, 1.5, 1.2, 1.25, 1.3, 1.35, 1.4, 1.45, 1.5, 0.9]
    out = []
    for i, gap in enumerate(gaps):
        wall = 9.0 if i == 8 else float(rng.uniform(1.0, 1.2))
        stages = {"selection": 4.0 if i == 10 else float(rng.uniform(
            0.5, 0.6)), "sigma": float(rng.uniform(0.01, 0.02))}
        out.append((gap, float(rng.uniform(0.1, 0.3)), 1e-2,
                    float(rng.uniform(1e4, 3e4)), wall, stages))
    return out


def test_monitor_matches_reference(systems):
    jsys, psys = systems
    monitors = []
    for o, sys_ in ((jobs, jsys), (obs, psys)):
        tele, reg = o.Telemetry(), o.Registry()
        mon = o.ConvergenceMonitor(
            sys_, o.MonitorConfig(mu=0.5, divergence_window=4),
            telemetry=tele, registry=reg)
        for i, (gap, g2, eta, d, wall, st) in enumerate(_observations()):
            mon.observe_round(i, gap=gap, g_norm_sq=g2, eta=eta,
                              delta_obj=d, wall_s=wall, stage_s=st)
        monitors.append((mon, tele, reg))
    (jm, jt, jr), (pm, pt, pr) = monitors
    assert [(v.kind, v.round) for v in pm.violations] == \
        [(v.kind, v.round) for v in jm.violations]
    assert {v.kind for v in pm.violations} == {"bound_violation",
                                               "gap_divergence",
                                               "straggler"}
    for a, b in zip(pm.violations, jm.violations):
        np.testing.assert_allclose([a.value, a.threshold],
                                   [b.value, b.threshold], rtol=RTOL)
        assert a.detail.keys() == b.detail.keys()
    assert [b is None for b in pm.bounds] == [b is None for b in jm.bounds]
    np.testing.assert_allclose([b for b in pm.bounds if b is not None],
                               [b for b in jm.bounds if b is not None],
                               rtol=RTOL)
    np.testing.assert_allclose(pm.multi_bounds, jm.multi_bounds, rtol=RTOL)
    assert pm.counts() == jm.counts()
    ps, js = pm.summary(), jm.summary()
    assert ps.keys() == js.keys() and ps["violations"] == js["violations"]
    np.testing.assert_allclose(
        [ps["bound_gap_ratio"], ps["final_bound"]],
        [js["bound_gap_ratio"], js["final_bound"]], rtol=RTOL)
    assert [(e.kind, e.round) for e in pt.events] == \
        [(e.kind, e.round) for e in jt.events]
    assert pr.counter("feel_monitor_violations_total").samples() == \
        jr.counter("feel_monitor_violations_total").samples()
