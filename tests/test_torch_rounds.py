"""The port's FEEL trainer against the reference, round for round, and
its entry point.

Both trainers start from the same weights (``params_from_numpy``) and
draw the same data subsets (numpy, same seed); the reference's channel
gains and availability (``jax.random``) are recorded through its
``proposed_scheme`` and replayed into the port via ``channel_source``.

Held identical: RB assignments, selections, swap counts.  ``net_cost``
at rtol 1e-5 (float32 sums).  The aggregated gradient at rtol 1e-4.
Params: Adam moves an entry by about lr * sign(m) per step whatever the
gradient's size, so an entry whose first moment is at float32-noise
level (0 < |m| below 1e-6 of its tensor's largest |m|: there the two
frameworks' gradients may differ in sign) may differ by up to 2 * lr
per round; every other entry, exact zeros of dead units included, is
held at atol 1e-6 + rtol 1e-5.
"""
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import default_system as j_default_system  # noqa: E402
from repro.core import joint as jjoint  # noqa: E402
from repro.data import SyntheticImages as JSyntheticImages  # noqa: E402
from repro.data import non_iid_split as j_non_iid_split  # noqa: E402
from repro.fed import FEELConfig as JFEELConfig  # noqa: E402
from repro.fed import FEELTrainer as JFEELTrainer  # noqa: E402
from repro.fed import server as jserver  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import __main__ as entry  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import default_system  # noqa: E402
from repro_torch.data import SyntheticImages, non_iid_split  # noqa: E402
from repro_torch.fed import FEELConfig, FEELTrainer  # noqa: E402
from repro_torch.kernels import gradnorm  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(2)

K, N, Q, D_HAT, SIDE, ROUNDS, LR = 6, 3, 2, 24, 12, 3, 1e-3
NOISE = 1e-6  # |m| / max|m| below this: first moment at float32 noise


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _run_reference(monkeypatch, data):
    """3 reference rounds; returns per-round (state, decision, g_hat,
    params, adam mu) as numpy."""
    rec = []
    real_scheme, real_agg = jjoint.proposed_scheme, jserver.aggregate_gradients

    def scheme(sys_, state, **kw):
        dec = real_scheme(sys_, state, **kw)
        rec.append({"h": np.asarray(state.h), "alpha": np.asarray(state.alpha),
                    "dec": dec})
        return dec

    def aggregate(*a, **kw):
        g = real_agg(*a, **kw)
        rec[-1]["g_hat"] = _np_tree(g)
        return g

    monkeypatch.setattr(jjoint, "proposed_scheme", scheme)
    monkeypatch.setattr(jserver, "aggregate_gradients", aggregate)
    params0 = jcnn.init(jax.random.PRNGKey(0), jcnn.CNNConfig(side=SIDE))
    model = types.SimpleNamespace(features=jcnn.features, apply=jcnn.apply,
                                  loss_fn=jcnn.loss_fn, accuracy=jcnn.accuracy)
    cfg = JFEELConfig(d_hat=D_HAT, sigma_method="last_layer_kernel", lr=LR)
    tr = JFEELTrainer(j_default_system(K=K, N=N, Q=Q, D_hat=D_HAT), data,
                      model, params0, cfg)
    metrics = []
    for i in range(ROUNDS):
        metrics.append(tr.run_round(i, eval_now=i == ROUNDS - 1))
        rec[i]["params"] = _np_tree(tr.params)
        rec[i]["mu"] = _np_tree(tr.opt_state.mu)
    return params0, rec, metrics


def _data(mod_synth, mod_split):
    train = mod_synth.make(600, side=SIDE, seed=0)
    test = mod_synth.make(60, side=SIDE, seed=1)
    return mod_split(train, test, K=K, per_device=60, mislabel_prop=0.1,
                     seed=0)


def test_three_rounds_match_reference(monkeypatch):
    params0, rec, jmetrics = _run_reference(
        monkeypatch, _data(JSyntheticImages, j_non_iid_split))

    model = cnn.CNN(cnn.CNNConfig(side=SIDE))
    model.load_state_dict(cnn.params_from_numpy(_np_tree(params0)))
    tele = obs.Telemetry()  # in memory: the stage times of each round
    tr = FEELTrainer(default_system(K=K, N=N, Q=Q, D_hat=D_HAT, device="cpu"),
                     _data(SyntheticImages, non_iid_split), model,
                     FEELConfig(d_hat=D_HAT, lr=LR),
                     channel_source=lambda i: (rec[i]["h"], rec[i]["alpha"]),
                     telemetry=tele)
    gradnorm.reset_launch_counts()
    noise_entries = 0
    for i in range(ROUNDS):
        m = tr.run_round(i, eval_now=i == ROUNDS - 1)
        want, jm = rec[i]["dec"], jmetrics[i]
        dec = tr.last_decision
        np.testing.assert_array_equal(dec.rho, want.rho, err_msg=f"round {i}")
        np.testing.assert_array_equal(dec.delta.numpy(), want.delta,
                                      err_msg=f"round {i}")
        assert dec.swaps == want.swaps
        np.testing.assert_allclose(m.net_cost, jm.net_cost, rtol=1e-5)
        np.testing.assert_allclose(m.delta_obj, jm.delta_obj, rtol=1e-5)
        assert (m.n_selected, m.n_uploaded) == (jm.n_selected, jm.n_uploaded)
        assert m.frac_mislabeled_selected == jm.frac_mislabeled_selected
        stages = {e.stage for e in tele.events
                  if isinstance(e, obs.StageEvent) and e.round == i}
        assert stages >= {"data", *obs.REQUIRED_STAGES, "objective"}

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
    assert noise_entries < 0.05 * total * ROUNDS  # the loose rule is rare
    assert m.test_acc == pytest.approx(jm.test_acc, abs=1.0 / 60)
    assert gradnorm.LAUNCHES["gradnorm_sigma"] == 0  # CPU: plain version


def test_entry_point_runs_on_cpu_and_refuses_without_a_gpu(monkeypatch,
                                                           capsys):
    metrics = entry.main(["--rounds", "2", "--d-hat", "8", "--side", "8",
                          "--selection", "exact", "--device", "cpu"])
    assert [m.round for m in metrics] == [0, 1]
    assert metrics[-1].test_acc is not None
    assert "FINAL" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.main(["--rounds", "1"])


def test_trainer_draws_its_own_channel_deterministically():
    def run():
        data = non_iid_split(SyntheticImages.make(300, side=8, seed=0),
                             SyntheticImages.make(20, side=8, seed=1), K=4,
                             per_device=30, mislabel_prop=0.1)
        tr = FEELTrainer(default_system(K=4, N=2, Q=2, D_hat=8, device="cpu"),
                         data, cnn.CNN(cnn.CNNConfig(side=8),
                                       torch.Generator().manual_seed(0)),
                         FEELConfig(d_hat=8, gp_steps=20))
        tr.run_round(0)
        return tr.last_state, tr.last_decision
    (s1, d1), (s2, d2) = run(), run()
    torch.testing.assert_close(s1.h, s2.h)
    torch.testing.assert_close(s1.alpha, s2.alpha)
    assert float(s1.h.mean()) == pytest.approx(1e-5, rel=0.9)
    assert set(np.unique(s1.alpha.numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(d1.rho, d2.rho)
