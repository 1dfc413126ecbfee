"""The port's baseline schemes 1-4 (paper §VI-A) and the trainer's
scheme dispatch against the reference, and the ``--scheme`` flag.

Host decisions (the greedy RB assignment, the random half given the
reference's own uniforms) are held identical.  Float32 model code (the
closed-form powers, the net cost and Delta-hat) is held at rtol 1e-5, as
in ``tests/test_torch_core.py`` and ``tests/test_torch_rounds.py``.  The
trainer runs 3 rounds of each baseline against the reference trainer
under ``tests/test_torch_rounds.py``'s rules: same weights, data subsets,
replayed channel draws and replayed random halves; RB assignments,
selections and counts identical, net cost at rtol 1e-5, the aggregated
gradient at rtol 1e-4, params at atol 1e-6 + rtol 1e-5 except entries
whose Adam first moment is at float32 noise (held at 2 * lr per round).
"""
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import default_system as j_default_system  # noqa: E402
from repro.core import joint as jjoint  # noqa: E402
from repro.core import sample_round  # noqa: E402
from repro.data import SyntheticImages as JSyntheticImages  # noqa: E402
from repro.data import non_iid_split as j_non_iid_split  # noqa: E402
from repro.fed import FEELConfig as JFEELConfig  # noqa: E402
from repro.fed import FEELTrainer as JFEELTrainer  # noqa: E402
from repro.fed import server as jserver  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import __main__ as entry  # noqa: E402
from repro_torch.core import default_system, joint  # noqa: E402
from repro_torch.core.types import (SYSTEM_ARRAYS, RoundState,  # noqa: E402
                                    SystemParams)
from repro_torch.data import SyntheticImages, non_iid_split  # noqa: E402
from repro_torch.fed import FEELConfig, FEELTrainer  # noqa: E402
from repro_torch.kernels import gradnorm  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-5
K, N, Q, D_HAT, SIDE, ROUNDS, LR = 6, 3, 2, 24, 12, 3, 1e-3
NOISE = 1e-6  # |m| / max|m| below this: first moment at float32 noise


def _port_sys(ref):
    arrays = {f: np.asarray(getattr(ref, f)) for f in SYSTEM_ARRAYS}
    return SystemParams.from_arrays(ref.K, ref.N, ref.Q, arrays, device="cpu")


def _port_state(st):
    return RoundState.from_arrays(np.asarray(st.h), np.asarray(st.alpha),
                                  np.asarray(st.sigma),
                                  np.asarray(st.sigma_mask), device="cpu")


# ------------------------------------------------------------ host parts

@pytest.mark.parametrize("prefer_max", [False, True])
@pytest.mark.parametrize("seed,k,n,q", [(0, 10, 5, 2), (1, 7, 3, 2),
                                        (2, 12, 2, 2), (3, 5, 4, 1)])
def test_greedy_rb_matches_reference(seed, k, n, q, prefer_max):
    """Equal assignments, with tied gains (a few discrete levels) and
    unavailable devices; (12, 2, 2) leaves available devices without a
    slot."""
    rng = np.random.default_rng(seed)
    h = (rng.integers(1, 4, (k, n)) * 1e-5).astype(np.float32)
    alpha = (rng.random(k) < 0.7).astype(np.float32)
    alpha[0] = 0.0
    ref = j_default_system(K=k, N=n, Q=q)
    want = jjoint._greedy_rb(ref, h, alpha, prefer_max)
    got = joint._greedy_rb(_port_sys(ref), h, alpha, prefer_max)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_half_matches_reference_given_its_uniforms(seed):
    """Rows with 0, 1, 2, 3 and all valid samples; the reference's own
    uniforms handed in give its mask bit for bit."""
    J = 9
    mask = np.ones((6, J), np.float32)
    for row, n_valid in enumerate((0, 1, 2, 3, 7)):
        mask[row, n_valid:] = 0.0
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jjoint._random_half(key, mask))
    u = np.asarray(jax.random.uniform(key, mask.shape))
    got = joint._random_half(torch.from_numpy(mask),
                             scores=torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.sum(1).numpy(), [0, 1, 1, 1, 3, 4])


def test_random_half_draws_from_the_generator():
    mask = torch.ones(4, 10)
    a = joint._random_half(mask, torch.Generator().manual_seed(5))
    b = joint._random_half(mask, torch.Generator().manual_seed(5))
    c = joint._random_half(mask, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.sum(1).tolist() == [5.0] * 4


# --------------------------------------------------------------- schemes

@pytest.mark.parametrize("index", [1, 2, 3, 4])
@pytest.mark.parametrize("seed,k,n,q", [(0, 10, 5, 2), (4, 12, 2, 2)])
def test_baseline_scheme_matches_reference(monkeypatch, index, seed, k, n,
                                           q):
    """(12, 2, 2) at seed 4 has 8 available devices for 4 slots, so
    ``feasible`` is False on both sides."""
    ref = j_default_system(K=k, N=n, Q=q, D_hat=16)
    st = sample_round(jax.random.PRNGKey(seed), ref)
    key = jax.random.PRNGKey(seed + 100)
    want = jjoint.baseline_scheme(ref, st, index, key=key)
    u = torch.from_numpy(np.array(jax.random.uniform(
        key, st.sigma_mask.shape)))
    real = joint._random_half
    monkeypatch.setattr(joint, "_random_half",
                        lambda mask, generator: real(mask, scores=u))
    got = joint.baseline_scheme(_port_sys(ref), _port_state(st), index,
                                generator=torch.Generator())
    np.testing.assert_array_equal(got.rho, want.rho)
    np.testing.assert_array_equal(got.delta.numpy(), want.delta)
    np.testing.assert_allclose(got.p.numpy(), want.p, rtol=RTOL, atol=0.0)
    np.testing.assert_allclose(got.net_cost, want.net_cost, rtol=RTOL)
    np.testing.assert_allclose(got.delta_obj, want.delta_obj, rtol=RTOL)
    assert got.feasible == want.feasible
    assert got.swaps == 0


def test_baseline_scheme_rejects_bad_calls():
    ref = j_default_system(K=4, N=2, Q=2, D_hat=8)
    sys_, st = _port_sys(ref), _port_state(sample_round(
        jax.random.PRNGKey(0), ref))
    for index in (0, 5):
        with pytest.raises(ValueError, match="1..4"):
            joint.baseline_scheme(sys_, st, index)
    with pytest.raises(ValueError, match="generator"):
        joint.baseline_scheme(sys_, st, 1)


# ----------------------------------------------------- round for round

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _data(mod_synth, mod_split):
    train = mod_synth.make(600, side=SIDE, seed=0)
    test = mod_synth.make(60, side=SIDE, seed=1)
    return mod_split(train, test, K=K, per_device=60, mislabel_prop=0.1,
                     seed=0)


def _run_reference(monkeypatch, scheme, data):
    """3 reference rounds of a baseline; per-round h, alpha, the random
    half, the decision, g_hat, params and Adam mu, as numpy."""
    rec = []
    real_scheme, real_half = jjoint.baseline_scheme, jjoint._random_half
    real_agg = jserver.aggregate_gradients

    def baseline(sys_, state, index, **kw):
        rec.append({"h": np.asarray(state.h),
                    "alpha": np.asarray(state.alpha)})
        dec = real_scheme(sys_, state, index, **kw)
        rec[-1]["dec"] = dec
        return dec

    def half(key, mask):
        out = real_half(key, mask)
        rec[-1]["half"] = np.asarray(out)
        return out

    def aggregate(*a, **kw):
        g = real_agg(*a, **kw)
        rec[-1]["g_hat"] = _np_tree(g)
        return g

    monkeypatch.setattr(jjoint, "baseline_scheme", baseline)
    monkeypatch.setattr(jjoint, "_random_half", half)
    monkeypatch.setattr(jserver, "aggregate_gradients", aggregate)
    params0 = jcnn.init(jax.random.PRNGKey(0), jcnn.CNNConfig(side=SIDE))
    model = types.SimpleNamespace(features=jcnn.features, apply=jcnn.apply,
                                  loss_fn=jcnn.loss_fn, accuracy=jcnn.accuracy)
    cfg = JFEELConfig(scheme=scheme, d_hat=D_HAT,
                      sigma_method="last_layer_kernel", lr=LR)
    tr = JFEELTrainer(j_default_system(K=K, N=N, Q=Q, D_hat=D_HAT), data,
                      model, params0, cfg)
    metrics = []
    for i in range(ROUNDS):
        metrics.append(tr.run_round(i, eval_now=i == ROUNDS - 1))
        rec[i]["params"] = _np_tree(tr.params)
        rec[i]["mu"] = _np_tree(tr.opt_state.mu)
    return params0, rec, metrics


@pytest.mark.parametrize("scheme", ["baseline1", "baseline2", "baseline3",
                                    "baseline4"])
def test_three_baseline_rounds_match_reference(monkeypatch, scheme):
    params0, rec, jmetrics = _run_reference(
        monkeypatch, scheme, _data(JSyntheticImages, j_non_iid_split))
    half = iter([r.get("half") for r in rec])
    monkeypatch.setattr(joint, "_random_half",
                        lambda mask, generator: torch.from_numpy(next(half)))
    entries = []
    real_sigma = gradnorm.gradnorm_sigma

    def sigma_entry(h, d):
        entries.append(h.device)
        return real_sigma(h, d)

    monkeypatch.setattr(gradnorm, "gradnorm_sigma", sigma_entry)

    model = cnn.CNN(cnn.CNNConfig(side=SIDE))
    model.load_state_dict(cnn.params_from_numpy(_np_tree(params0)))
    tr = FEELTrainer(
        default_system(K=K, N=N, Q=Q, D_hat=D_HAT, device="cpu"),
        _data(SyntheticImages, non_iid_split), model,
        FEELConfig(scheme=scheme, d_hat=D_HAT, lr=LR),
        channel_source=lambda i: (rec[i]["h"], rec[i]["alpha"]))
    gradnorm.reset_launch_counts()
    noise_entries = 0
    for i in range(ROUNDS):
        m = tr.run_round(i, eval_now=i == ROUNDS - 1)
        want, jm = rec[i]["dec"], jmetrics[i]
        dec = tr.last_decision
        np.testing.assert_array_equal(dec.rho, want.rho, err_msg=f"round {i}")
        np.testing.assert_array_equal(dec.delta.numpy(), want.delta,
                                      err_msg=f"round {i}")
        assert dec.swaps == want.swaps == 0
        assert dec.feasible == want.feasible
        np.testing.assert_allclose(m.net_cost, jm.net_cost, rtol=1e-5)
        np.testing.assert_allclose(m.delta_obj, jm.delta_obj, rtol=1e-5)
        assert (m.n_selected, m.n_uploaded) == (jm.n_selected, jm.n_uploaded)
        assert m.n_selected == K * (D_HAT // 2 if scheme in (
            "baseline1", "baseline2") else D_HAT)
        assert m.frac_mislabeled_selected == jm.frac_mislabeled_selected

        g_want = cnn.params_from_numpy(rec[i]["g_hat"])
        for name, g in tr.last_g_hat.items():
            scale = float(g_want[name].abs().max())
            torch.testing.assert_close(g, g_want[name], rtol=1e-4,
                                       atol=1e-4 * scale, msg=name)

        p_want = cnn.params_from_numpy(rec[i]["params"])
        mu = cnn.params_from_numpy(rec[i]["mu"])
        for name, p in tr.params.items():
            m_abs = mu[name].abs()
            noise = (m_abs > 0) & (m_abs <= NOISE * m_abs.max())
            noise_entries += int(noise.sum())
            diff = (p.detach() - p_want[name]).abs()
            tight = 1e-6 + 1e-5 * p_want[name].abs()
            assert bool(torch.all(diff[~noise] <= tight[~noise])), name
            assert bool(torch.all(diff[noise] <= 2 * LR * (i + 1))), name
    total = sum(p.numel() for p in tr.params.values())
    assert noise_entries < 0.05 * total * ROUNDS
    assert m.test_acc == pytest.approx(jm.test_acc, abs=1.0 / 60)
    # sigma went through the kernel's entry once a round; on the CPU the
    # entry runs its plain version, so no launch is counted
    assert entries == [torch.device("cpu")] * ROUNDS
    assert gradnorm.LAUNCHES["gradnorm_sigma"] == 0


def test_trainer_draws_the_half_after_the_channel():
    """Baseline 1's half comes from the trainer's generator, after h and
    alpha: two runs agree, and the first round's half is the one a
    generator advanced past the channel draws picks."""
    def run():
        data = non_iid_split(SyntheticImages.make(300, side=8, seed=0),
                             SyntheticImages.make(20, side=8, seed=1), K=4,
                             per_device=30, mislabel_prop=0.1)
        sys_ = default_system(K=4, N=2, Q=2, D_hat=8, device="cpu")
        tr = FEELTrainer(sys_, data, cnn.CNN(cnn.CNNConfig(side=8),
                                             torch.Generator().manual_seed(0)),
                         FEELConfig(scheme="baseline1", d_hat=8, seed=3))
        tr.run_round(0)
        return tr.last_decision
    d1, d2 = run(), run()
    torch.testing.assert_close(d1.delta, d2.delta)
    gen = torch.Generator().manual_seed(3)
    torch.empty(4, 2).exponential_(generator=gen)
    torch.rand(4, generator=gen)
    want = joint._random_half(torch.ones(4, 8), gen)
    torch.testing.assert_close(d1.delta, want)


def test_config_rejects_unknown_schemes_and_evaluators():
    with pytest.raises(ValueError, match="scheme"):
        FEELConfig(scheme="baseline5")
    with pytest.raises(ValueError, match="evaluator"):
        FEELConfig(power_evaluator="cvx")


# ---------------------------------------------------------- entry point

def test_entry_point_scheme_flag(monkeypatch, capsys):
    metrics = entry.main(["--scheme", "baseline4", "--rounds", "2",
                          "--d-hat", "12", "--side", "10", "--device", "cpu"])
    assert [m.round for m in metrics] == [0, 1]
    assert all(m.n_selected == 10 * 12 and m.swaps == 0 for m in metrics)
    assert "FINAL" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        entry.main(["--scheme", "baseline5", "--device", "cpu"])
    assert "invalid choice" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.main(["--scheme", "baseline2", "--rounds", "1"])
