"""The port's resilience layer against the reference's (docs/robustness.md).

Fault plan: the port's copy draws the reference's faults (rounds 0-19,
K in {4, 10}, two specs).  Aggregation: survivor re-normalization at
rtol 1e-6.  Fallback chain: forced matching and power failures give the
reference's fallbacks, RB assignment and fault records, in order.

Trainer, at the reference's fault-test size (K=4, N=2, side 10, D̂=8,
30 GP steps): both start from the same weights; the port replays the
reference's h and alpha (its jax.random stream, recomputed from the
seed) through ``channel_source``.  Four fault rounds give equal counts,
fallbacks and fault records (kinds and devices), the net cost at rtol
1e-5, and params under ``test_torch_rounds.py``'s Adam-noise rule; the
port resumes the reference's round-2 checkpoint and matches its rounds
2-3 the same way.  Then the port alone, as ``tests/test_faults.py``:
zero rates are bit-identical to a plain run, total dropout skips every
update, NaN uploads quarantine, the resolve policy runs, and a resume is
bit-identical.  Last, ``python -m repro_torch --faults chaos
--check-resume`` on the CPU.
"""
import dataclasses
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.core import default_system as j_default_system  # noqa: E402
from repro.core import joint as jjoint  # noqa: E402
from repro.core import sample_round as j_sample_round  # noqa: E402
from repro.data import SyntheticImages as JSyntheticImages  # noqa: E402
from repro.data import non_iid_split as j_non_iid_split  # noqa: E402
from repro.fed import CHAOS_SPEC as J_CHAOS_SPEC  # noqa: E402
from repro.fed import FEELConfig as JFEELConfig  # noqa: E402
from repro.fed import FEELTrainer as JFEELTrainer  # noqa: E402
from repro.fed import FaultPlan as JFaultPlan  # noqa: E402
from repro.fed import FaultSpec as JFaultSpec  # noqa: E402
from repro.fed import ResilienceConfig as JResilienceConfig  # noqa: E402
from repro.fed import server as jserver  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import __main__ as entry  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import RoundState, default_system, joint  # noqa: E402
from repro_torch.data import SyntheticImages, non_iid_split  # noqa: E402
from repro_torch.fed import (CHAOS_SPEC, FEELConfig, FEELTrainer,  # noqa: E402
                             FaultPlan, FaultSpec, ResilienceConfig, server)
from repro_torch.fed.rounds import CKPT_NAME  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(2)

K, N, Q, D_HAT, SIDE, GP_STEPS, LR, ROUNDS = 4, 2, 2, 8, 10, 30, 1e-3, 4
NOISE = 1e-6  # |m| / max|m| below this: first moment at float32 noise
SPEC = dict(seed=2, dropout_prob=0.4, straggler_prob=0.4, nan_prob=0.3,
            matching_fail_prob=0.3, power_fail_prob=0.3)
OTHER_SPEC = dict(seed=7, dropout_prob=0.2, straggler_prob=0.6,
                  straggler_delay_s=2.0, nan_prob=0.5,
                  matching_fail_prob=0.5, power_fail_prob=0.1,
                  start_round=3, stop_round=15)


# ----------------------------------------------------------------------
# fault plan, aggregation, fallback chain
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 10])
@pytest.mark.parametrize("spec", ["chaos", "other"])
def test_fault_plan_matches_reference(k, spec):
    if spec == "chaos":
        assert CHAOS_SPEC.to_dict() == J_CHAOS_SPEC.to_dict()
        ours, ref = FaultPlan(CHAOS_SPEC), JFaultPlan(J_CHAOS_SPEC)
    else:
        ours = FaultPlan(FaultSpec.from_dict(OTHER_SPEC))
        ref = JFaultPlan(JFaultSpec.from_dict(OTHER_SPEC))
    for i in range(20):
        a, b = ours.for_round(i, k), ref.for_round(i, k)
        for field in ("dropout", "straggler", "delay_s", "nan_upload"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field),
                                          err_msg=f"{field} round {i}")
        assert (a.fail_matching, a.fail_power) == (b.fail_matching,
                                                   b.fail_power)
        for dev in range(k):
            for attempt in (1, 2):
                assert (ours.retry_delay_s(i, dev, attempt)
                        == ref.retry_delay_s(i, dev, attempt))


def test_fault_spec_round_trip_and_unknown_fields():
    spec = FaultSpec.from_dict(OTHER_SPEC)
    assert FaultSpec.from_dict(spec.to_dict()) == spec
    assert FaultPlan.from_dict(spec.to_dict()).spec == spec
    with pytest.raises(ValueError, match="unknown FaultSpec"):
        FaultSpec.from_dict({"seed": 0, "nope": 1})


def test_renormalized_aggregation_matches_reference():
    rng = np.random.default_rng(0)
    eps = np.array([0.0, 0.5, 0.9, 0.2, 0.8], np.float32)
    grads = {"w": rng.standard_normal((5, 3, 4)).astype(np.float32),
             "b": rng.standard_normal((5, 7)).astype(np.float32)}
    j_sys = dataclasses.replace(j_default_system(K=5, N=3, Q=2, D_hat=4),
                                eps=jnp.asarray(eps))
    sys_ = dataclasses.replace(default_system(K=5, N=3, Q=2, D_hat=4,
                                              device="cpu"),
                               eps=torch.as_tensor(eps))
    for alpha in ([1, 1, 0, 1, 1], [1, 0, 0, 0, 0], [0, 0, 0, 0, 0],
                  [0, 1, 1, 1, 1]):
        a = np.asarray(alpha, np.float32)
        for renorm in (True, False):
            want = jserver.aggregate_gradients(
                j_sys, {k: jnp.asarray(v) for k, v in grads.items()},
                jnp.asarray(a), renormalize=renorm)
            got = server.aggregate_gradients(
                sys_, {k: torch.as_tensor(v) for k, v in grads.items()},
                torch.as_tensor(a), renormalize=renorm)
            for name in grads:
                assert bool(torch.isfinite(got[name]).all())
                np.testing.assert_allclose(got[name].numpy(),
                                           np.asarray(want[name]),
                                           rtol=1e-6, atol=1e-7)
        assert server.ipw_mass(sys_, torch.as_tensor(a)) == pytest.approx(
            jserver.ipw_mass(j_sys, jnp.asarray(a)), rel=1e-6)


def _faults_of(events, fault_cls):
    return [(e.kind, e.injected, e.device, e.detail) for e in events
            if isinstance(e, fault_cls)]


@pytest.mark.parametrize("evaluator", ["closed_form", "ccp"])
@pytest.mark.parametrize("fail_matching", [True, False])
def test_fallback_chain_matches_reference(evaluator, fail_matching):
    j_sys = j_default_system(K=K, N=N, Q=Q, D_hat=D_HAT)
    st = j_sample_round(jax.random.PRNGKey(1), j_sys)
    rf = types.SimpleNamespace(fail_matching=fail_matching, fail_power=True,
                               dropout=np.zeros(K, bool))
    j_tele = jobs.Telemetry()
    want = jjoint.proposed_scheme(j_sys, st, gp_steps=GP_STEPS, faults=rf,
                                  power_evaluator=evaluator,
                                  telemetry=j_tele)
    reg = obs.Registry()
    obs.metrics.set_default(reg)
    try:
        tele = obs.Telemetry()
        state = RoundState.from_arrays(
            *(np.asarray(x) for x in (st.h, st.alpha, st.sigma,
                                      st.sigma_mask)), device="cpu")
        got = joint.proposed_scheme(
            default_system(K=K, N=N, Q=Q, D_hat=D_HAT, device="cpu"), state,
            gp_steps=GP_STEPS, faults=rf, power_evaluator=evaluator,
            telemetry=tele)
    finally:
        obs.metrics.set_default(None)
    assert got.fallbacks == want.fallbacks
    assert ("matching->greedy" in got.fallbacks) == fail_matching
    assert ("ccp->closed_form" in got.fallbacks) == (evaluator == "ccp")
    assert got.feasible == want.feasible
    np.testing.assert_array_equal(got.rho, want.rho)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=1e-5)
    np.testing.assert_array_equal(got.delta.numpy(), np.asarray(want.delta))
    assert got.net_cost == pytest.approx(want.net_cost, rel=1e-5)
    assert _faults_of(tele.events, obs.FaultEvent) == _faults_of(
        j_tele.events, jobs.FaultEvent)
    rendered = reg.render()
    assert 'feel_faults_injected_total{kind="solver_fail"}' in rendered
    if fail_matching:
        assert ('feel_fallbacks_total{solver="matching",to="greedy"}'
                in rendered)


@pytest.mark.parametrize("case", ["clean", "forced", "infeasible"])
def test_allocate_power_safe_matches_reference(case):
    """A forced or infeasible CCP solve degrades to the closed form with
    the reference's label, powers, flag and fault record; a clean one
    keeps the CCP powers (at the CCP tests' rtol 1e-3: the reference
    solves in float32, the port in float64)."""
    from repro.core import power as jpower
    from repro_torch.core import power
    j_sys = j_default_system(K=K, N=N, Q=Q, D_hat=D_HAT)
    st = j_sample_round(jax.random.PRNGKey(1), j_sys)
    h, alpha = np.array(st.h), np.array(st.alpha)
    if case == "infeasible":  # gains too weak for any power under p_max
        h = h * 1e-6
    rho = jjoint._greedy_rb(j_sys, h, alpha, prefer_max=True)
    j_tele = jobs.Telemetry()
    want = jpower.allocate_power_safe(j_sys, jnp.asarray(rho),
                                      jnp.asarray(h), jnp.asarray(alpha),
                                      method="ccp", telemetry=j_tele,
                                      force_fail=case == "forced")
    tele = obs.Telemetry()
    got = power.allocate_power_safe(
        default_system(K=K, N=N, Q=Q, D_hat=D_HAT, device="cpu"), rho,
        torch.as_tensor(h), torch.as_tensor(alpha), method="ccp",
        telemetry=tele, force_fail=case == "forced")
    assert got[3] == want[3] == (None if case == "clean"
                                 else "ccp->closed_form")
    assert got[2] == want[2] == (case != "infeasible")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-3 if case == "clean" else 1e-5)
    assert _faults_of(tele.events, obs.FaultEvent) == _faults_of(
        j_tele.events, jobs.FaultEvent)


def test_no_faults_no_fallbacks():
    j_sys = j_default_system(K=K, N=N, Q=Q, D_hat=D_HAT)
    st = j_sample_round(jax.random.PRNGKey(1), j_sys)
    state = RoundState.from_arrays(
        *(np.asarray(x) for x in (st.h, st.alpha, st.sigma, st.sigma_mask)),
        device="cpu")
    dec = joint.proposed_scheme(
        default_system(K=K, N=N, Q=Q, D_hat=D_HAT, device="cpu"), state,
        gp_steps=GP_STEPS)
    assert dec.fallbacks == ()
    assert dec.unmatched.size == 0


# ----------------------------------------------------------------------
# the trainer against the reference
# ----------------------------------------------------------------------

def _data(mod_synth, mod_split):
    train = mod_synth.make(240, side=SIDE, seed=0)
    test = mod_synth.make(80, side=SIDE, seed=1)
    return mod_split(train, test, K=K, per_device=40, mislabel_prop=0.1,
                     seed=0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_channel(j_sys, rounds):
    """The reference trainer's (h, alpha) of each round: its key stream
    from PRNGKey(seed), split four ways a round."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(rounds):
        key, kh, ka, _ = jax.random.split(key, 4)
        h = jax.random.exponential(kh, (j_sys.K, j_sys.N)) * 1e-5
        alpha = (jax.random.uniform(ka, (j_sys.K,)) < j_sys.eps
                 ).astype(jnp.float32)
        out.append((np.asarray(h), np.asarray(alpha)))
    return out


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """Four reference fault rounds with a checkpoint every two; the
    round-2 checkpoint is copied aside before round 4's overwrites it."""
    tmp = tmp_path_factory.mktemp("reference")
    at2 = tmp / "at2"
    at2.mkdir()
    params0 = jcnn.init(jax.random.PRNGKey(0), jcnn.CNNConfig(side=SIDE))
    model = types.SimpleNamespace(features=jcnn.features, apply=jcnn.apply,
                                  loss_fn=jcnn.loss_fn,
                                  accuracy=jcnn.accuracy)
    j_sys = j_default_system(K=K, N=N, Q=Q, D_hat=D_HAT)
    tele = jobs.Telemetry()
    tr = JFEELTrainer(
        j_sys, _data(JSyntheticImages, j_non_iid_split), model, params0,
        JFEELConfig(d_hat=D_HAT, gp_steps=GP_STEPS, lr=LR, eval_every=100,
                    sigma_method="last_layer_kernel"),
        telemetry=tele, faults=JFaultSpec(**SPEC),
        resilience=JResilienceConfig(quarantine_threshold=1,
                                     checkpoint_every=2,
                                     checkpoint_dir=str(tmp / "ckpt")))
    rounds = []
    for i in range(ROUNDS):
        m = tr.run_round(i)
        rounds.append({"m": m, "params": _np_tree(tr.params),
                       "mu": _np_tree(tr.opt_state.mu),
                       "faults": [(e.kind, e.device) for e in tele.events
                                  if isinstance(e, jobs.FaultEvent)
                                  and e.round == i]})
        if i == 1:
            for f in os.listdir(tmp / "ckpt"):
                shutil.copy(tmp / "ckpt" / f, at2 / f)
    return {"params0": _np_tree(params0), "rounds": rounds,
            "channel": _reference_channel(j_sys, ROUNDS), "at2": str(at2)}


def _port_trainer(params0_np=None, channel=None, faults=None, res=None,
                  telemetry=None):
    model = cnn.CNN(cnn.CNNConfig(side=SIDE),
                    generator=torch.Generator().manual_seed(0))
    if params0_np is not None:
        model.load_state_dict(cnn.params_from_numpy(params0_np))
    return FEELTrainer(
        default_system(K=K, N=N, Q=Q, D_hat=D_HAT, device="cpu"),
        _data(SyntheticImages, non_iid_split), model,
        FEELConfig(d_hat=D_HAT, gp_steps=GP_STEPS, lr=LR, eval_every=100),
        channel_source=None if channel is None else (lambda i: channel[i]),
        telemetry=telemetry, faults=faults, resilience=res)


def _check_round(tr, m, want, i, rounds_run):
    jm = want["m"]
    for field in ("n_dropped", "n_retries", "n_quarantined", "n_uploaded",
                  "n_selected", "skipped_update", "fallbacks"):
        assert getattr(m, field) == getattr(jm, field), (field, i)
    np.testing.assert_allclose(m.net_cost, jm.net_cost, rtol=1e-5)
    np.testing.assert_allclose(m.cum_net_cost, jm.cum_net_cost, rtol=1e-5)
    # Adam's noise rule, as tests/test_torch_rounds.py states it
    p_want = cnn.params_from_numpy(want["params"])
    mu = cnn.params_from_numpy(want["mu"])
    for name, p in tr.params.items():
        assert bool(torch.isfinite(p).all()), name
        m_abs = mu[name].abs()
        noise = (m_abs > 0) & (m_abs <= NOISE * m_abs.max())
        diff = (p.detach() - p_want[name]).abs()
        tight = 1e-6 + 1e-5 * p_want[name].abs()
        assert bool(torch.all(diff[~noise] <= tight[~noise])), (name, i)
        assert bool(torch.all(diff[noise] <= 2 * LR * rounds_run)), (name, i)


def test_four_fault_rounds_match_reference(reference_run, tmp_path):
    ref = reference_run
    tele = obs.Telemetry()
    tr = _port_trainer(ref["params0"], ref["channel"], FaultSpec(**SPEC),
                       ResilienceConfig(quarantine_threshold=1,
                                        checkpoint_every=2,
                                        checkpoint_dir=str(tmp_path)),
                       telemetry=tele)
    fired = set()
    for i in range(ROUNDS):
        m = tr.run_round(i)
        want = ref["rounds"][i]
        _check_round(tr, m, want, i, i + 1)
        got = [(e.kind, e.device) for e in tele.events
               if isinstance(e, obs.FaultEvent) and e.round == i]
        assert got == want["faults"], i
        fired |= {kind for kind, _ in got}
    # the plan exercises every path the comparison is meant to hold
    assert {"dropout", "nan_upload", "quarantine", "solver_fail", "retry",
            "checkpoint"} <= fired


def test_port_resumes_reference_checkpoint(reference_run):
    ref = reference_run
    tr = _port_trainer(channel=ref["channel"], faults=FaultSpec(**SPEC),
                       res=ResilienceConfig(quarantine_threshold=1))
    assert tr.resume(ref["at2"]) == 2
    ms = tr.run(ROUNDS)
    assert [m.round for m in ms] == [2, 3]
    for m in ms:
        _check_round(tr, m, ref["rounds"][m.round], m.round, m.round - 1)


def test_reference_checkpoint_needs_a_channel_source(reference_run):
    tr = _port_trainer(faults=FaultSpec(**SPEC),
                       res=ResilienceConfig(quarantine_threshold=1))
    before = {n: p.detach().clone() for n, p in tr.params.items()}
    with pytest.raises(ValueError, match="no torch generator state"):
        tr.resume(os.path.join(reference_run["at2"], CKPT_NAME))
    assert all(torch.equal(before[n], p) for n, p in tr.params.items())
    assert tr._start_round == 0


# ----------------------------------------------------------------------
# the port alone (as tests/test_faults.py for the reference)
# ----------------------------------------------------------------------

def _params_equal(a, b):
    return all(torch.equal(a.params[n], b.params[n]) for n in a.params)


def test_disabled_faults_bit_identical():
    plain = _port_trainer()
    plain.run(3)
    guarded = _port_trainer(faults=FaultSpec(seed=0), res=ResilienceConfig())
    guarded.run(3)
    assert _params_equal(plain, guarded)


def test_chaos_deterministic_and_finite():
    spec = FaultSpec(straggler_delay_s=0.5, **SPEC)
    a = _port_trainer(faults=spec, res=ResilienceConfig())
    ms = a.run(4)
    assert all(bool(torch.isfinite(p).all()) for p in a.params.values())
    assert sum(m.n_dropped for m in ms) > 0
    b = _port_trainer(faults=spec, res=ResilienceConfig())
    b.run(4)
    assert _params_equal(a, b)


def test_total_dropout_skips_updates():
    tr = _port_trainer(faults=FaultSpec(seed=0, dropout_prob=1.0),
                       res=ResilienceConfig())
    init = {n: p.detach().clone() for n, p in tr.params.items()}
    ms = tr.run(2)
    assert all(m.skipped_update for m in ms)
    assert all(m.n_uploaded == 0 for m in ms)
    assert tr.opt_state.count == 0
    assert all(torch.equal(init[n], p) for n, p in tr.params.items())


def test_nan_uploads_trigger_quarantine():
    tele = obs.Telemetry()
    tr = _port_trainer(faults=FaultSpec(seed=0, nan_prob=1.0),
                       res=ResilienceConfig(quarantine_threshold=1,
                                            quarantine_rounds=2),
                       telemetry=tele)
    ms = tr.run(3)
    assert all(bool(torch.isfinite(p).all()) for p in tr.params.values())
    kinds = [e.kind for e in tele.events if isinstance(e, obs.FaultEvent)]
    assert "nan_upload" in kinds and "quarantine" in kinds
    assert any(m.n_quarantined > 0 for m in ms[1:])


def test_resolve_policy_runs():
    tr = _port_trainer(faults=FaultSpec(seed=1, dropout_prob=0.5),
                       res=ResilienceConfig(dropout_policy="resolve"))
    ms = tr.run(3)
    assert any("resolve_survivors" in m.fallbacks for m in ms)
    assert all(bool(torch.isfinite(p).all()) for p in tr.params.values())


def test_checkpoint_resume_bit_identical(tmp_path):
    spec = FaultSpec(seed=5, dropout_prob=0.3, nan_prob=0.2)
    res = ResilienceConfig(checkpoint_every=2, checkpoint_dir=str(tmp_path))
    full = _port_trainer(faults=spec, res=res)
    ms_full = full.run(4)
    half = _port_trainer(faults=spec, res=res)
    half.run(2)  # the checkpoint written at round 2
    assert os.path.exists(tmp_path / f"{CKPT_NAME}.npz")
    resumed = _port_trainer(faults=spec, res=res)
    assert resumed.resume() == 2
    ms = resumed.run(4)
    assert _params_equal(full, resumed)
    for name in full.params:
        assert torch.equal(full.opt_state.mu[name],
                           resumed.opt_state.mu[name])
        assert torch.equal(full.opt_state.nu[name],
                           resumed.opt_state.nu[name])
    assert resumed.opt_state.count == full.opt_state.count
    assert [m.cum_net_cost for m in ms] == [m.cum_net_cost
                                            for m in ms_full[2:]]


# ----------------------------------------------------------------------
# the entry point
# ----------------------------------------------------------------------

ENTRY_ARGS = ["--device", "cpu", "--faults", "chaos", "--check-resume",
              "--rounds", "4", "--d-hat", "12", "--side", "10"]


def test_entry_point_check_resume(monkeypatch, capsys):
    metrics = entry.main(ENTRY_ARGS)
    assert [m.round for m in metrics] == [0, 1, 2, 3]
    out = capsys.readouterr().out
    assert "check-resume: resumed_at=2 bit_identical=True finite=True" in out
    assert "FINAL" in out

    real_resume = FEELTrainer.resume

    def perturbed(self, path=None):  # a resume that loses one bit
        start = real_resume(self, path)
        with torch.no_grad():
            self.params["out.bias"][0] += 1e-3
        return start

    monkeypatch.setattr(FEELTrainer, "resume", perturbed)
    with pytest.raises(SystemExit) as exc:
        entry.main(["--device", "cpu", "--check-resume", "--rounds", "1",
                    "--d-hat", "12", "--side", "10", "--selection", "exact"])
    assert exc.value.code == 1
    out, err = capsys.readouterr()
    assert "resumed_at=1 bit_identical=False finite=True" in out
    assert "check-resume FAILED\n" in err
