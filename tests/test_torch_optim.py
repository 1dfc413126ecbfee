"""The port's optimizers, combinators and schedules against the
reference's (``repro.optim``), step for step on the same tensors.

Every case draws its params and five steps of gradients from a numpy
seed and feeds both packages the same arrays.  Tolerance: rtol 1e-6
with an atol of 1e-7 of the tensor's largest magnitude.  The
elementwise optimizers (sgd, momentum, adam) do the reference's float32
operations in its order; adafactor and the global norm reduce (means,
sums) in another order, which moves the last bit or two, well inside
1e-6.  The one layout-dependent optimizer, adafactor, is also run on
the CNN in each package's own layout: with ``cnn.reference_layout`` the
port's factored moments and updates are the reference's; without it
they are not (the trap the layout exists for).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as joptim  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

STEPS, RTOL, ATOL_FRAC = 5, 1e-6, 1e-7
SHAPES = {"b": (7,), "k": (3, 3, 4, 5), "w": (6, 7)}  # 1-D, 4-D HWIO, 2-D


def _close(got, want, msg=""):
    want = np.asarray(want, np.float32)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_FRAC * float(np.abs(want).max()),
                               err_msg=msg)


def _draws(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    # one near-zero gradient entry per leaf: Adam/adafactor's sign-like
    # steps and the clip's scale meet small values too
    for g in grads:
        for v in g.values():
            v.reshape(-1)[0] = 1e-9
    return params, grads


CASES = {
    "sgd": (lambda m: m.sgd(0.1)),
    "momentum": (lambda m: m.momentum(0.05, beta=0.9)),
    "nesterov": (lambda m: m.momentum(0.05, beta=0.8, nesterov=True)),
    "adam_weight_decay": (lambda m: m.adam(0.01, weight_decay=0.1)),
    "adamw": (lambda m: m.adamw(0.01)),
    "adafactor": (lambda m: m.adafactor(0.3)),
    "chain_clip_sgd": (lambda m: m.chain(m.clip_by_global_norm(2.0),
                                         m.sgd(0.5))),
    "scale_by_schedule": (lambda m: m.chain(
        m.scale_by_schedule(m.warmup_cosine(2, 5)), m.sgd(0.5))),
}


def _state_leaves(state):
    """A state's leaves in flatten order: tensors, numpy/jax arrays and
    Python step counts (as arrays)."""
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _state_leaves(state[k])]
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _state_leaves(s)]
    return [state]


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_reference(name):
    params_np, grads_np = _draws()
    jopt, opt = CASES[name](joptim), CASES[name](optim)
    jparams = {k: jnp.asarray(v) for k, v in params_np.items()}
    params = {k: torch.from_numpy(v.copy()) for k, v in params_np.items()}
    jstate, state = jopt.init(jparams), opt.init(params)
    for step, g_np in enumerate(grads_np):
        jupd, jstate = jopt.update({k: jnp.asarray(v)
                                    for k, v in g_np.items()}, jstate,
                                   jparams)
        upd, state = opt.update({k: torch.from_numpy(v.copy())
                                 for k, v in g_np.items()}, state, params)
        jparams = joptim.apply_updates(jparams, jupd)
        optim.apply_updates(params, upd)
        for k in SHAPES:
            _close(upd[k], jupd[k], f"{name} step {step} update {k}")
            _close(params[k], jparams[k], f"{name} step {step} param {k}")
    # the state: same leaves, shapes and values (step counts equal)
    jleaves = _state_leaves(jax.tree.map(np.asarray, jstate)
                            if not hasattr(jstate, "_fields") else
                            {f: jax.tree.map(np.asarray, getattr(jstate, f))
                             for f in jstate._fields})
    leaves = _state_leaves(state if not hasattr(state, "_fields") else
                           {f: getattr(state, f) for f in state._fields})
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        if isinstance(got, int):
            assert got == int(want)
        else:
            assert tuple(got.shape) == tuple(np.shape(want))
            _close(got, want, f"{name} state")


def test_adafactor_state_shapes_follow_the_reference():
    params_np, _ = _draws()
    st = optim.adafactor(1e-2).init({k: torch.from_numpy(v)
                                     for k, v in params_np.items()})
    jst = joptim.adafactor(1e-2).init({k: jnp.asarray(v)
                                       for k, v in params_np.items()})
    for k in SHAPES:
        assert tuple(st.vr[k].shape) == jst.vr[k].shape
        assert tuple(st.vc[k].shape) == jst.vc[k].shape
    assert st.vc["b"].shape == ()  # a leaf under 2-D keeps a dummy vc


@pytest.mark.parametrize("layout", [True, False])
def test_adafactor_on_the_cnn_layout(layout):
    """The port's OIHW convs and (out, in) dense kernels, factored on the
    reference's HWIO and (in, out) axes (fc1's rows reordered), give the
    reference's factored moments and updates; factored on the port's
    own trailing axes they give another function."""
    jparams = jcnn.init(jax.random.PRNGKey(0), jcnn.CNNConfig(side=12))
    params_np = jax.tree.map(np.asarray, jparams)
    params = cnn.params_from_numpy(params_np)
    rng = np.random.default_rng(1)
    jopt = joptim.adafactor(0.1)
    opt = optim.adafactor(
        0.1, layout=cnn.reference_layout(params) if layout else None)
    jstate, state = jopt.init(jparams), opt.init(params)
    worst = 0.0
    for step in range(STEPS):
        g_np = jax.tree.map(
            lambda x: rng.normal(0, 1, x.shape).astype(np.float32), params_np)
        jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate,
                                   jparams)
        upd, state = opt.update(cnn.params_from_numpy(g_np), state, params)
        want = cnn.params_from_numpy(jax.tree.map(np.asarray, jupd))
        for name, u in upd.items():
            if layout:
                _close(u, want[name], f"step {step} {name}")
            worst = max(worst, float((u - want[name]).abs().max()))
    if not layout:
        assert worst > 1e-3  # factored on the wrong axes: not the function
        return
    for field in ("vr", "vc"):
        got = cnn.nest(getattr(state, field))
        ref = jax.tree.map(np.asarray, getattr(jstate, field))
        for lname, leaves in ref.items():
            for leaf, arr in leaves.items():
                assert tuple(got[lname][leaf].shape) == arr.shape
                _close(got[lname][leaf], arr, f"{field} {lname}/{leaf}")


def test_global_norm_and_clip():
    params_np, grads_np = _draws(3)
    g = {k: torch.from_numpy(v) for k, v in grads_np[0].items()}
    jg = {k: jnp.asarray(v) for k, v in grads_np[0].items()}
    _close(optim.global_norm(g), joptim.global_norm(jg))
    opt = optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(1.0))
    upd, _ = opt.update({"w": torch.tensor([3.0, 4.0, 0.0])},
                        opt.init({"w": torch.zeros(3)}))
    assert float(torch.linalg.norm(upd["w"])) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("which,steps", [
    ("constant", (0, 3, 7)),
    ("cosine", (0, 50, 100, 130)),
    ("warmup_cosine", (0, 5, 10, 60, 110, 150)),
])
def test_schedules_match_reference(which, steps):
    build = {"constant": lambda m: m.constant_schedule(0.7),
             "cosine": lambda m: m.cosine_schedule(100, final_frac=0.1),
             "warmup_cosine": lambda m: m.warmup_cosine(10, 110)}[which]
    fn, jfn = build(optim), build(joptim)
    for s in steps:
        got = fn(s)
        assert got.dtype == torch.float32 and got.shape == ()
        want = float(jfn(jnp.asarray(s, jnp.int32)))
        assert float(got) == pytest.approx(want, rel=RTOL, abs=1e-7), s


def test_exports_match_reference():
    assert set(joptim.__all__) <= set(optim.__all__)
