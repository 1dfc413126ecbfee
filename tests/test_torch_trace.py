"""A traced round of the port's FEEL trainer against a traced round of
the reference's, and the trainer's observability switches.

Both trainers run at the size of ``tests/test_obs.py``'s tiny trainer
(K=4, N=3, Q=2, D̂=8, 8x8 images, 20 GP steps) from the same weights and
data subsets; the reference's channel draws are recorded through its
scheme and replayed into the port (``channel_source``), as in
``tests/test_torch_rounds.py``.  For the proposed scheme and baseline 4,
over 2 rounds (the first with an eval stage), the two traces must have
the same ordered stages per round, the same span tree as name paths (and
span attributes), the same solver events with equal counters, the same
metric families and label sets; ``devices`` arrays and ``round`` fields
(not ``wall_s``) at rtol 1e-5, selected/uploaded counts exact.  The
reference's reader and ``diff_traces`` read the port's trace.
"""
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.core import default_system as j_default_system  # noqa: E402
from repro.core import joint as jjoint  # noqa: E402
from repro.data import SyntheticImages as JSyntheticImages  # noqa: E402
from repro.data import non_iid_split as j_non_iid_split  # noqa: E402
from repro.fed import FEELConfig as JFEELConfig  # noqa: E402
from repro.fed import FEELTrainer as JFEELTrainer  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import __main__ as entry  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import default_system  # noqa: E402
from repro_torch.data import SyntheticImages, non_iid_split  # noqa: E402
from repro_torch.fed import FEELConfig, FEELTrainer  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-5
K, N, Q, D_HAT, SIDE, GP_STEPS, ROUNDS = 4, 3, 2, 8, 8, 20, 2


@pytest.fixture(autouse=True)
def _reset_port_obs_defaults():
    """The port's process-wide sink and registry, reset after every
    test (the shared conftest resets only the reference's)."""
    yield
    obs.set_default(None)
    obs.metrics.set_default(None)


def _data(synth, split):
    return split(synth.make(200, side=SIDE, seed=0),
                 synth.make(50, side=SIDE, seed=1), K=K, per_device=20,
                 mislabel_prop=0.2, seed=0)


def _params0():
    return jcnn.init(jax.random.PRNGKey(0), jcnn.CNNConfig(side=SIDE))


def _reference(scheme, tmp_path, monkeypatch):
    """2 traced reference rounds with a registry; returns (trace records,
    per-round (h, alpha))."""
    channels = []
    name = "proposed_scheme" if scheme == "proposed" else "baseline_scheme"
    real = getattr(jjoint, name)

    def recording(sys_, state, *a, **kw):
        channels.append((np.asarray(state.h), np.asarray(state.alpha)))
        return real(sys_, state, *a, **kw)

    monkeypatch.setattr(jjoint, name, recording)
    path = str(tmp_path / f"jax_{scheme}.jsonl")
    tele = jobs.Telemetry(path=path)
    jobs.metrics.set_default(jobs.Registry())
    model = types.SimpleNamespace(features=jcnn.features, apply=jcnn.apply,
                                  loss_fn=jcnn.loss_fn, accuracy=jcnn.accuracy)
    cfg = JFEELConfig(scheme=scheme, d_hat=D_HAT, gp_steps=GP_STEPS,
                      sigma_method="last_layer_kernel")
    tr = JFEELTrainer(j_default_system(K=K, N=N, Q=Q, D_hat=D_HAT),
                      _data(JSyntheticImages, j_non_iid_split), model,
                      _params0(), cfg, telemetry=tele)
    for i in range(ROUNDS):
        tr.run_round(i, eval_now=i == 0)
    tele.close()
    jobs.metrics.set_default(None)
    return jobs.load_trace(path), channels


def _port_trainer(scheme, channels=None, **kw):
    model = cnn.CNN(cnn.CNNConfig(side=SIDE))
    model.load_state_dict(cnn.params_from_numpy(
        jax.tree.map(np.asarray, _params0())))
    return FEELTrainer(default_system(K=K, N=N, Q=Q, D_hat=D_HAT,
                                      device="cpu"),
                       _data(SyntheticImages, non_iid_split), model,
                       FEELConfig(scheme=scheme, d_hat=D_HAT,
                                  gp_steps=GP_STEPS),
                       channel_source=(None if channels is None
                                       else lambda i: channels[i]), **kw)


def _port(scheme, channels, tmp_path):
    path = str(tmp_path / f"torch_{scheme}.jsonl")
    tele = obs.Telemetry(path=path)
    obs.metrics.set_default(obs.Registry())
    tr = _port_trainer(scheme, channels, telemetry=tele)
    for i in range(ROUNDS):
        tr.run_round(i, eval_now=i == 0)
    tele.close()
    obs.metrics.set_default(None)
    return obs.load_trace(path)


def _of(records, kind, i=None):
    return [r for r in records if r["ev"] == kind
            and (i is None or r["round"] == i)]


def _span_paths(records, i):
    """(name path, attrs) of round ``i``'s spans in tree order."""
    roots, orphans = obs.build_tree(_of(records, "stage", i)
                                    + _of(records, "span", i), strict=True)
    assert not orphans
    return [(n.path(), n.attrs) for root in roots for n in root.walk()]


def _label_sets(records):
    fams = _of(records, "metrics")[-1]["families"]
    return {f["name"]: sorted(tuple(sorted(s["labels"].items()))
                              for s in f["samples"]) for f in fams}


@pytest.mark.parametrize("scheme", ["proposed", "baseline4"])
def test_traced_round_matches_reference_trace(scheme, tmp_path, monkeypatch):
    jrec, channels = _reference(scheme, tmp_path, monkeypatch)
    prec = _port(scheme, channels, tmp_path)
    for i in range(ROUNDS):
        assert ([r["stage"] for r in _of(prec, "stage", i)]
                == [r["stage"] for r in _of(jrec, "stage", i)]), i
        assert _span_paths(prec, i) == _span_paths(jrec, i), i
        assert ([(r["solver"], r["counters"]) for r in _of(prec, "solver", i)]
                == [(r["solver"], r["counters"])
                    for r in _of(jrec, "solver", i)]), i
        (pd,), (jd,) = _of(prec, "devices", i), _of(jrec, "devices", i)
        for key in ("energy_cmp_j", "energy_com_j", "cost", "reward",
                    "mislabel_frac"):
            np.testing.assert_allclose(pd[key], jd[key], rtol=RTOL,
                                       err_msg=f"round {i} {key}")
        assert (pd["selected"], pd["uploaded"]) == (jd["selected"],
                                                   jd["uploaded"])
        (pr,), (jr,) = _of(prec, "round", i), _of(jrec, "round", i)
        assert set(pr) == set(jr)
        for key in set(pr) - {"wall_s", "ev", "v"}:
            if isinstance(jr[key], float):
                np.testing.assert_allclose(pr[key], jr[key], rtol=RTOL,
                                           err_msg=f"round {i} {key}")
            else:
                assert pr[key] == jr[key], (i, key)
        assert set(obs.REQUIRED_STAGES) <= {r["stage"]
                                           for r in _of(prec, "stage", i)}
    assert _label_sets(prec) == _label_sets(jrec)

    # the reference's own tools read the port's trace
    js, ps = jobs.summarize(jrec), jobs.summarize(prec)
    assert set(js.stages) == set(ps.stages)
    assert js.n_rounds == ps.n_rounds == ROUNDS
    d = jobs.diff_traces(jrec, prec, min_wall_delta_s=0.0)
    paths = {p for p, _, _ in d.wall_by_path}
    assert paths == set(jobs.self_seconds_by_path(jrec)) \
        == set(jobs.self_seconds_by_path(prec))
    assert {p.split("/")[1] for p in paths if "/" in p} \
        == set(js.stages)
    assert d.counters == [] and d.faults == []


def test_full_observability_leaves_the_run_bit_for_bit(tmp_path):
    plain = _port_trainer("proposed")
    want = []
    for i in range(2):
        m = plain.run_round(i)
        want.append((m, plain.last_decision,
                     {n: p.detach().clone() for n, p in plain.params.items()}))
    reg = obs.Registry()
    obs.metrics.set_default(reg)
    tele = obs.Telemetry(path=str(tmp_path / "t.jsonl"), profile=True,
                         annotate=True)
    sys_ = default_system(K=K, N=N, Q=Q, D_hat=D_HAT, device="cpu")
    traced = _port_trainer("proposed", telemetry=tele,
                           monitor=obs.ConvergenceMonitor(sys_,
                                                          telemetry=tele))
    for i, (a, da, params) in enumerate(want):
        b = traced.run_round(i)
        db = traced.last_decision
        np.testing.assert_array_equal(da.rho, db.rho)
        assert torch.equal(da.delta, db.delta)
        assert (a.net_cost, a.delta_obj, a.n_selected) == (
            b.net_cost, b.delta_obj, b.n_selected)
        for name, p in params.items():
            assert torch.equal(p, traced.params[name]), (i, name)
    tele.close()
    assert torch.equal(plain.gen.get_state(), traced.gen.get_state())
    profiles = [e for e in tele.events if isinstance(e, obs.ProfileEvent)]
    assert {p.name for p in profiles} == {"sigma_all", "local_grads"}
    assert all(p.flops > 0 and p.bytes_accessed > 0 for p in profiles)
    assert len(traced.monitor.gaps) == 2
    assert reg.counter("feel_rounds_total").value() == 2


def test_untraced_round_records_nothing():
    tr = _port_trainer("proposed")
    assert tr.obs is obs.NULL and tr.monitor is None
    m = tr.run_round(0)
    assert not hasattr(m, "stage_s")


def test_entry_point_writes_a_readable_trace(tmp_path, capsys):
    trace, prom = str(tmp_path / "t.jsonl"), str(tmp_path / "m.prom")
    entry.main(["--rounds", "2", "--d-hat", "8", "--side", "8",
                "--device", "cpu", "--trace", trace, "--metrics", prom,
                "--monitor"])
    out = capsys.readouterr().out
    assert "telemetry.stage.selection" in out and "monitor: rounds=2" in out
    for reader in (obs, jobs):
        s = reader.summarize(reader.load_trace(trace))
        assert s.n_rounds == 2
        assert set(obs.REQUIRED_STAGES) <= set(s.stages)
    assert "feel_rounds_total 2" in open(prom).read()
    entry.main(["--rounds", "1", "--d-hat", "8", "--side", "8",
                "--device", "cpu"])
    assert "telemetry." not in capsys.readouterr().out
