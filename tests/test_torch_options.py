"""The port's FEEL trainer options against the reference trainer, round
for round: FedAvg local steps, the optimizers, warmup, ``gp_step0``,
both matching sweeps, the chunked gradient projection and the two
plain sigma methods; the chunked GP's iterates; checkpoints of every
optimizer in both directions.

Both trainers start from the same weights (``params_from_numpy``) and
draw the same data subsets (numpy, same seed); the reference's channel
gains and availability are its own key stream from ``PRNGKey(seed)``,
replayed into the port through ``channel_source``.  Every run sets
``sigma_method`` on both sides (the port's default is the kernel's
``last_layer_kernel``, the reference's ``last_layer``).

Held, each round: RB assignments, selections and swap counts equal;
net cost and Delta at rtol 1e-5 (float32 sums); sigma at rtol 1e-4
(from round 1 on it is scored with params that agree only to float32
tolerance, and ``full`` sums per-sample gradients of every parameter,
each from another autodiff); the aggregated gradient at rtol 1e-4 with
an atol of 1e-4 of its tensor's largest magnitude.
FedAvg's uploads (w - w') / lr: each of the ``local_steps`` updates
w - lr * g rounds to float32 on each side, so w' may differ by up to
one ulp of max|w| a step, float32 eps * max|w|, and the upload by
local_steps * eps * max|w| / lr, on top of the gradients' rtol 1e-4
(the run takes sgd steps, as ``chip_smoke.py`` does: an Adam step
would turn that absolute error into a relative one on small entries).
Params after the optimizer step: Adam and adafactor move an entry by
about lr * sign(g) whatever the gradient's size when the entry's
second moment is as small as its gradient, so an entry whose gradient
(Adam: first moment) is at float32 noise (0 < |.| below 1e-6 of its
tensor's largest) may differ by up to 2 * lr per round under Adam,
and under adafactor, whose clipped step of an entry is not bounded by
lr, by |u| + max|u| per round, u the reference's own step of the
entry and max|u| its tensor's largest; every other entry, and every
entry under sgd and momentum, at atol 1e-6 + rtol 1e-5.
"""
import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import default_system as j_default_system  # noqa: E402
from repro.core import joint as jjoint  # noqa: E402
from repro.core import selection as jselection  # noqa: E402
from repro.data import SyntheticImages as JSyntheticImages  # noqa: E402
from repro.data import non_iid_split as j_non_iid_split  # noqa: E402
from repro.fed import FEELConfig as JFEELConfig  # noqa: E402
from repro.fed import FEELTrainer as JFEELTrainer  # noqa: E402
from repro.fed import server as jserver  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import default_system, selection  # noqa: E402
from repro_torch.data import SyntheticImages, non_iid_split  # noqa: E402
from repro_torch.fed import FEELConfig, FEELTrainer  # noqa: E402
from repro_torch.fed.rounds import CKPT_NAME  # noqa: E402
from repro_torch.kernels import gradnorm  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(2)

K, N, Q, D_HAT, SIDE, GP_STEPS, LR, ROUNDS = 4, 2, 2, 16, 12, 30, 1e-2, 2
NOISE = 1e-6
EPS32 = float(np.finfo(np.float32).eps)

#: each run: (its FEELConfig options, sigma method on both sides)
RUNS = {
    "local_steps3": dict(local_steps=3, optimizer="sgd"),
    "sgd": dict(optimizer="sgd"),
    "momentum": dict(optimizer="momentum"),
    "adafactor": dict(optimizer="adafactor"),
    "warmup": dict(warmup_rounds=1),
    "gp_step0": dict(gp_step0=5.0),
    "matching_scalar": dict(matching_mode="scalar"),
    "matching_batched": dict(matching_mode="batched"),
    "chunk1": dict(selection_chunk=1),
    "chunk3": dict(selection_chunk=3),
    "sigma_last_layer": dict(sigma_method="last_layer"),
    "sigma_full": dict(sigma_method="full"),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _options(name):
    return {"sigma_method": "last_layer_kernel", **RUNS[name]}


def _data(mod_synth, mod_split):
    train = mod_synth.make(240, side=SIDE, seed=0)
    test = mod_synth.make(40, side=SIDE, seed=1)
    return mod_split(train, test, K=K, per_device=40, mislabel_prop=0.1,
                     seed=0)


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


@contextlib.contextmanager
def _patched(module, name, wrap):
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


_REFERENCE = {}


def _reference(name):
    """ROUNDS reference rounds of run ``name`` (memoized): per round the
    decision, sigma, uploads, aggregated gradient, params and optimizer
    state as numpy; and the trainer."""
    if name in _REFERENCE:
        return _REFERENCE[name]
    rec = []

    def finish(real):
        def wrapped(sys_, rho, p, delta, state, **kw):
            dec = real(sys_, rho, p, delta, state, **kw)
            rec[-1].update(dec=dec, sigma=np.asarray(state.sigma))
            return dec
        return wrapped

    def aggregate(real):
        def wrapped(*a, **kw):
            g = real(*a, **kw)
            rec[-1]["g_hat"] = _np_tree(g)
            return g
        return wrapped

    params0 = jcnn.init(jax.random.PRNGKey(0), jcnn.CNNConfig(side=SIDE))
    model = types.SimpleNamespace(features=jcnn.features, apply=jcnn.apply,
                                  loss_fn=jcnn.loss_fn, accuracy=jcnn.accuracy)
    j_sys = j_default_system(K=K, N=N, Q=Q, D_hat=D_HAT)
    tr = JFEELTrainer(j_sys, _data(JSyntheticImages, j_non_iid_split), model,
                      params0, JFEELConfig(d_hat=D_HAT, gp_steps=GP_STEPS,
                                           lr=LR, eval_every=100,
                                           **_options(name)))
    real_deltas = tr._local_deltas

    def deltas(*a):
        out = real_deltas(*a)
        rec[-1]["uploads"] = _np_tree(out)
        return out

    tr._local_deltas = deltas
    metrics = []
    with _patched(jjoint, "_finish", finish), \
            _patched(jserver, "aggregate_gradients", aggregate):
        for i in range(ROUNDS):
            rec.append({})
            metrics.append(tr.run_round(i))
            rec[i]["params"] = _np_tree(tr.params)
            rec[i]["opt_state"] = _np_tree(tr.opt_state)
    out = {"params0": _np_tree(params0), "rec": rec, "metrics": metrics,
           "channel": _reference_channel(j_sys, ROUNDS), "trainer": tr}
    _REFERENCE[name] = out
    return out


def _port_trainer(params0_np, channel, telemetry=None, **options):
    model = cnn.CNN(cnn.CNNConfig(side=SIDE))
    model.load_state_dict(cnn.params_from_numpy(params0_np))
    return FEELTrainer(
        default_system(K=K, N=N, Q=Q, D_hat=D_HAT, device="cpu"),
        _data(SyntheticImages, non_iid_split), model,
        FEELConfig(d_hat=D_HAT, gp_steps=GP_STEPS, lr=LR, eval_every=100,
                   **options),
        channel_source=lambda i: channel[i], telemetry=telemetry)


def _named(tree):
    return cnn.params_from_numpy(tree)


def _adafactor_bound(ref, i):
    """Per parameter, the most an adafactor entry whose gradient is at
    float32 noise may differ by after round ``i``: the sum over rounds
    0..i of |u| + max|u|, u the reference's own step of that round (a
    flipped sign moves the entry by its own step on one side and at
    most its leaf's largest step on the other)."""
    before, bound = _named(ref["params0"]), {}
    for j in range(i + 1):
        after = _named(ref["rec"][j]["params"])
        for pname, w in after.items():
            u = (w - before[pname]).abs()
            bound[pname] = bound.get(pname, 0) + u + u.max()
        before = after
    return bound


def _hold_params(name, tr, ref, i):
    """The params rule of the module docstring; returns the number of
    entries held by the noise rule."""
    opt = tr.cfg.optimizer
    want = _named(ref["rec"][i]["params"])
    signal = {"adam": lambda: _named(ref["rec"][i]["opt_state"].mu),
              "adafactor": lambda: _named(ref["rec"][i]["g_hat"])
              }.get(opt, dict)()
    loose = _adafactor_bound(ref, i) if opt == "adafactor" else {}
    n_noise = 0
    for pname, p in tr.params.items():
        diff = (p.detach() - want[pname]).abs()
        tight = 1e-6 + 1e-5 * want[pname].abs()
        noise = torch.zeros_like(diff, dtype=torch.bool)
        if pname in signal:
            s = signal[pname].abs()
            noise = (s > 0) & (s <= NOISE * s.max())
            bound = loose.get(pname, torch.full_like(diff, 2 * LR * (i + 1)))
            assert bool(torch.all(diff[noise] <= bound[noise])), \
                (name, pname)
        n_noise += int(noise.sum())
        assert bool(torch.all(diff[~noise] <= tight[~noise])), \
            (name, pname, float(diff[~noise].max()))
    return n_noise


@pytest.mark.parametrize("name", list(RUNS))
def test_option_matches_reference(name):
    ref = _reference(name)
    tele = obs.Telemetry()  # in memory: the stages of each round
    tr = _port_trainer(ref["params0"], ref["channel"], telemetry=tele,
                       **_options(name))
    uploads = []
    real_deltas = tr._local_deltas

    def deltas(*a):
        out = real_deltas(*a)
        uploads.append(out)
        return out

    tr._local_deltas = deltas
    gradnorm.reset_launch_counts()
    n_noise = 0
    for i in range(ROUNDS):
        w_before = {n: p.detach().clone() for n, p in tr.params.items()}
        m = tr.run_round(i)
        want, jm = ref["rec"][i], ref["metrics"][i]
        dec = tr.last_decision
        np.testing.assert_array_equal(dec.rho, want["dec"].rho,
                                      err_msg=f"{name} round {i}")
        np.testing.assert_array_equal(dec.delta.numpy(), want["dec"].delta,
                                      err_msg=f"{name} round {i}")
        assert dec.swaps == want["dec"].swaps
        np.testing.assert_allclose(m.net_cost, jm.net_cost, rtol=1e-5)
        np.testing.assert_allclose(m.delta_obj, jm.delta_obj, rtol=1e-5)
        assert (m.n_selected, m.n_uploaded) == (jm.n_selected, jm.n_uploaded)
        np.testing.assert_allclose(tr.last_state.sigma.numpy(),
                                   want["sigma"], rtol=1e-4)
        stages = {e.stage for e in tele.events
                  if isinstance(e, obs.StageEvent) and e.round == i}
        assert stages >= {"data", *obs.REQUIRED_STAGES, "objective"}
        if tr.cfg.local_steps > 1:
            w_max = max(float(p.abs().max()) for p in w_before.values())
            atol = tr.cfg.local_steps * EPS32 * w_max / LR
            for k in range(K):
                device_k = _named(jax.tree.map(lambda a: a[k],
                                               want["uploads"]))
                for pname, u in device_k.items():
                    torch.testing.assert_close(
                        uploads[-1][pname][k], u, rtol=1e-4,
                        atol=atol + 1e-4 * float(u.abs().max()),
                        msg=f"{name} upload {pname} device {k}")
        g_want = _named(want["g_hat"])
        for pname, g in tr.last_g_hat.items():
            scale = float(g_want[pname].abs().max())
            torch.testing.assert_close(g, g_want[pname], rtol=1e-4,
                                       atol=1e-4 * scale, msg=pname)
        n_noise += _hold_params(name, tr, ref, i)
    total = sum(p.numel() for p in tr.params.values())
    assert n_noise < 0.05 * total * ROUNDS  # the loose rule is rare
    assert gradnorm.LAUNCHES["gradnorm_sigma"] == 0  # CPU: plain version


def test_warmup_selects_everything_and_keeps_the_selection_stage():
    ref = _reference("warmup")
    tele = obs.Telemetry()
    tr = _port_trainer(ref["params0"], ref["channel"], telemetry=tele,
                       **_options("warmup"))
    m0, m1 = tr.run_round(0), tr.run_round(1)
    assert m0.n_selected == K * D_HAT and m1.n_selected < K * D_HAT
    assert tr.last_decision.delta_cont is not None  # round 1 ran Alg. 4
    for i in (0, 1):
        assert "selection" in {e.stage for e in tele.events
                               if isinstance(e, obs.StageEvent)
                               and e.round == i}


def test_unknown_option_values_raise():
    for bad in (dict(sigma_method="bogus"), dict(matching_mode="fast"),
                dict(optimizer="lamb"), dict(selection_method="greedy"),
                dict(local_steps=0), dict(selection_chunk=-1),
                dict(warmup_rounds=-2), dict(scheme="baseline5"),
                dict(power_evaluator="sca")):
        with pytest.raises(ValueError):
            FEELConfig(**bad)
    assert ({f.name for f in dataclasses.fields(FEELConfig)}
            == {f.name for f in dataclasses.fields(JFEELConfig)})
    assert FEELConfig().sigma_method == "last_layer_kernel"


# ------------------------------------------------------------ chunked GP

@pytest.mark.parametrize("chunk", [1, 3, 10])
@pytest.mark.parametrize("ragged", [False, True])
def test_chunked_gp_matches_reference(chunk, ragged):
    """The device-chunked Alg. 4 against the reference's chunked GP
    (chunk 10 = K: the full-matrix path on both sides), iterates within
    1e-5: the reference's own chunked-vs-full test sees 2.6e-7 of
    reduction-order drift, so the two frameworks are not held tighter;
    Alg. 5 on top gives the same selection."""
    rng = np.random.default_rng(7 + chunk)
    j_sys = j_default_system(K=10, D_hat=32)
    sys_ = default_system(K=10, D_hat=32, device="cpu")
    sigma = rng.gamma(2.0, 1.0, size=(10, 16)).astype(np.float32)
    mask = np.ones((10, 16), np.float32)
    if ragged:
        mask[rng.random((10, 16)) < 0.3] = 0.0
        mask[:, 0] = 1.0
    got = selection.gradient_projection(
        sys_, torch.from_numpy(sigma), torch.from_numpy(mask), steps=40,
        device_chunk=chunk)
    want = np.asarray(jselection.gradient_projection(
        j_sys, jnp.asarray(sigma), jnp.asarray(mask), steps=40,
        device_chunk=chunk))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        selection.binary_recovery(got, torch.from_numpy(mask)).numpy(),
        np.asarray(jselection.binary_recovery(jnp.asarray(want),
                                              jnp.asarray(mask))))
    sel, _ = selection.solve_selection(sys_, torch.from_numpy(sigma),
                                       torch.from_numpy(mask), steps=40,
                                       device_chunk=chunk)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(
        jselection.faithful_selection(j_sys, jnp.asarray(sigma),
                                      jnp.asarray(mask), steps=40,
                                      device_chunk=chunk)))


# ------------------------------------------------------------ checkpoints

OPT_RUNS = {"sgd": "sgd", "momentum": "momentum", "adam": "gp_step0",
            "adafactor": "adafactor"}


def _reference_like(opt_name, params0):
    make = {"adam": joptim.adam, "sgd": joptim.sgd,
               "momentum": joptim.momentum,
               "adafactor": joptim.adafactor}[opt_name]
    return {"params": params0, "opt_state": make(LR).init(params0)}


@pytest.mark.parametrize("opt_name", list(OPT_RUNS))
def test_checkpoint_of_every_optimizer_crosses(tmp_path, opt_name):
    """The port's checkpoint has the reference's keys and shapes and
    the reference's ``load_pytree`` reads it into its own state; the
    port resumes the reference trainer's checkpoint and holds its
    params and optimizer state as the reference wrote them."""
    ref = _reference(OPT_RUNS[opt_name])
    run = _options(OPT_RUNS[opt_name])
    jparams0 = jax.tree.map(jnp.asarray, ref["params0"])
    like = _reference_like(opt_name, jparams0)

    # port -> reference
    tr = _port_trainer(ref["params0"], ref["channel"], **run)
    tr.run(ROUNDS)
    path = tr.save_checkpoint(str(tmp_path / "port" / CKPT_NAME),
                              next_round=ROUNDS)
    keys, _ = jckpt.checkpoint._flatten(like)
    with np.load(path + ".npz") as f:
        stored = {k: f[k].shape for k in f.files if k != "__dtypes__"}
    assert stored == {k: v.shape for k, v in keys.items()}
    loaded = jckpt.load_pytree(path, like)
    port_tree = tr._checkpoint_tree()
    flat_port = ckpt.checkpoint._flatten(port_tree)
    flat_ref, _ = jckpt.checkpoint._flatten(loaded)
    assert set(flat_ref) == set(flat_port)
    for k, v in flat_ref.items():
        assert v.dtype == np.asarray(flat_port[k]).dtype, k
        np.testing.assert_array_equal(v, np.asarray(flat_port[k]), err_msg=k)

    # reference -> port
    jtr = ref["trainer"]
    jpath = jtr.save_checkpoint(str(tmp_path / "ref" / CKPT_NAME),
                                next_round=ROUNDS)
    fresh = _port_trainer(ref["params0"], ref["channel"], **run)
    assert fresh.resume(jpath) == ROUNDS
    got = ckpt.checkpoint._flatten(fresh._checkpoint_tree())
    want, _ = jckpt.checkpoint._flatten(
        {"params": jtr.params, "opt_state": jtr.opt_state})
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    assert fresh.rng.bit_generator.state == jtr.rng.bit_generator.state
