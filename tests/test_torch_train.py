"""Parity of the port's training path (``repro_torch.models.model``'s
train API, the train mode of every block kind, the scan's gradient, the
FEEL step and ``launch.train``) with the JAX zoo, on the CPU at the
smoke sizes.

Weights are the reference's ``init_model`` trees carried over by
``params_from_numpy``; batches are drawn with numpy from a seed (some
labels -1) and handed to both.  Tolerances and why:
- ``per_example_loss`` and ``sigma_scores`` in fp32 at rtol 1e-5 (sums
  in another order; the port forms ||p - y||^2 directly where the
  reference expands it to sum p^2 - 2 p_y + 1);
- the train-mode forward (logits, hidden, aux) in fp32 at atol/rtol
  1e-4, the decoders' existing fp32 rule; in bf16 at rtol 3e-2 with an
  atol of 3e-2 times the largest reference value, the existing bf16
  rule (XLA's bf16 sigmoid rounds otherwise than torch's,
  tests/test_torch_llm.py);
- gradients per leaf by the replay rule (``launch/replay.py``): rtol
  1e-4 with an atol of 1e-4 times the leaf's largest |g|;
- params after whole train steps by the replay rule: each step starts
  from the reference's params and optimizer state; an entry whose
  gradient is above that atol within 1e-6 + 1e-5 |w|; an AdamW entry at
  gradient noise within |the reference's own update| + lr (1 + wd |w|);
  adafactor's entries within their own update plus their leaf's
  largest;
- selections equal where every client's smallest sigma gap exceeds 10
  times the measured sigma error; elsewhere the port's step takes the
  reference's delta (``selection_given``);
- the scan's gradient at atol/rtol 1e-5 against autograd through the
  plain loop and against ``jax.grad`` of the reference's associative
  scan (another order of sums, as the forward is held).
The CUDA kernels run on the card (tests/test_torch_cuda.py and
chip_smoke.py); CPU tensors take their plain versions here.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as j_optim  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.core import selection as j_sel  # noqa: E402
from repro.launch.shapes import make_optimizer as j_make_optimizer  # noqa: E402
from repro.models import FeelIntegration as JFeel  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import make_train_step as j_make_train_step  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import lru_scan, ops  # noqa: E402
from repro_torch.launch import replay  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.shapes import make_optimizer  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.transformer import _layer_plan  # noqa: E402
from repro_torch.optim import AdafactorState, AdamState  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["llama3.2-3b", "gemma3-12b", "falcon-mamba-7b",
         "recurrentgemma-9b", "deepseek-v2-236b", "qwen2-vl-2b",
         "musicgen-medium"]
#: smoke configs cut otherwise, by a name of their own: deepseek-v2's
#: cut to 3 layers (a dense head layer and two body repeats, so
#: adafactor steps a stacked body of two); gemma3's and llama's with the
#: reference's attention logit softcapping, at Gemma 2's published 50.0
#: and at 1.5, where it bites at the smoke decoders' logits
CUTS = {"deepseek-v2-236b@3": ("deepseek-v2-236b", {"n_layers": 3}),
        "gemma3-12b@softcap": ("gemma3-12b", {"attn_logit_softcap": 50.0}),
        "llama3.2-3b@softcap": ("llama3.2-3b", {"attn_logit_softcap": 50.0}),
        "gemma3-12b@softcap1.5": ("gemma3-12b",
                                  {"attn_logit_softcap": 1.5})}
SOFTCAP = ["gemma3-12b@softcap", "llama3.2-3b@softcap",
           "gemma3-12b@softcap1.5"]
K = 4
B, S = 8, 24
ALPHA = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
FP32_TOL, BF16_TOL = 1e-4, 3e-2


def _close(got, want, dtype="float32"):
    want = np.asarray(want, np.float32)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    atol = tol if dtype == "float32" else tol * float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=atol,
                               rtol=tol)


def _np(t):
    return t.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype="float32"):
    base, cut = CUTS.get(arch, (arch, {}))
    cfg_j = j_smoke_config(base).scaled(dtype=dtype, **cut)
    tree = j_init_model(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, tree


def _config(arch, dtype="float32", **cut):
    base, own = CUTS.get(arch, (arch, {}))
    return smoke_config(base).scaled(dtype=dtype, **own, **cut)


def _port(arch, dtype="float32", tree=None, **cut):
    """The port's model on the CPU with the reference's weights (``tree``,
    or the reference's initial ones), gradients on."""
    cfg = _config(arch, dtype, **cut)
    tree = _reference(arch, dtype)[1] if tree is None else tree
    return cfg, tm.trainable(tm.params_from_numpy(
        cfg, jax.tree.map(np.asarray, tree), "cpu"))


def _batch(cfg, seed=0, alpha=ALPHA):
    """A numpy batch of ``cfg``'s modality handed to both sides: text
    tokens and labels (B, S); vlm embeds (B, S, d), (B, 3, S) positions
    whose three rows differ (a (2, 2, 3) image grid between two runs of
    text) and labels; audio tokens and labels (B, C, S), the -1s in one
    codebook.  Some labels -1; alpha (K,)."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio":
        toks = rng.integers(0, cfg.vocab, (B, cfg.n_codebooks, S + 1))
        labels = toks[..., 1:].copy()
        labels[0, 0, :5] = -1
        labels[3, -1, -2:] = -1
        b = {"tokens": toks[..., :-1], "labels": labels}
    else:
        toks = rng.integers(0, cfg.vocab, (B, S + 1))
        labels = toks[:, 1:].copy()
        labels[0, :5] = -1
        labels[3, -2:] = -1
        b = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.modality == "vlm":
        grid = np.stack(np.meshgrid(np.arange(2), np.arange(2), np.arange(3),
                                    indexing="ij")).reshape(3, -1)
        n_img = grid.shape[1]
        pos = np.concatenate([np.tile(np.arange(4), (3, 1)), 4 + grid,
                              np.tile(7 + np.arange(S - 4 - n_img), (3, 1))],
                             axis=1)
        b = {"embeds": rng.standard_normal((B, S, cfg.d_model)),
             "positions": np.broadcast_to(pos, (B, 3, S)),
             "labels": labels}
    b = {k: np.ascontiguousarray(v, np.float32 if k == "embeds"
                                 else np.int32) for k, v in b.items()}
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bj["alpha"] = jnp.asarray(alpha)
    dtype = getattr(torch, cfg.dtype)
    bt = {k: torch.from_numpy(v).long() if k != "embeds"
          else torch.from_numpy(v).to(dtype) for k, v in b.items()}
    bt["alpha"] = torch.from_numpy(alpha.copy())
    if "embeds" in bj:
        bj["embeds"] = bj["embeds"].astype(jnp.dtype(cfg.dtype))
    return bj, bt


def _leaves(cfg, tree):
    """{port parameter name: (the reference tree's leaf, its repeat index
    r for a stacked body leaf, else None)}."""
    head, n_body, pattern, tail = _layer_plan(cfg)
    out = {}

    def walk(prefix, t, r=None):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}.{k}", v, r)
        else:
            out[prefix] = (t, r)

    dec = tree["decoder"]
    for part in ("head", "tail"):
        for i, blk in enumerate(dec[part]):
            walk(f"decoder.{part}.{i}", blk)
    P = len(pattern)
    for r in range(n_body):
        for p in range(P):
            walk(f"decoder.body.{r * P + p}", dec["body"][f"pos{p}"], r)
    walk("decoder.final_norm", dec["final_norm"])
    for k in tree:
        if k != "decoder":
            walk(k, tree[k])
    return out


def _flat(cfg, tree):
    """The reference tree (params, grads or Adam moments) by the port's
    parameter names, as float32 tensors."""
    return {n: torch.from_numpy(np.asarray(
        leaf if r is None else leaf[r], np.float32).copy())
        for n, (leaf, r) in _leaves(cfg, tree).items()}


def _capture():
    """A reference optimizer whose state is the step's gradient and whose
    update is zero: the reference's own train step then returns its
    gradients."""
    return j_optim.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@functools.lru_cache(maxsize=None)
def _ref_grad_step(arch, feel):
    cfg_j, _ = _reference(arch)
    return jax.jit(j_make_train_step(cfg_j, _capture(),
                                     JFeel(n_clients=K) if feel else None))


def _ref_grads(arch, tree, bj, feel=True):
    cfg_j, _ = _reference(arch)
    _, grads, metrics = _ref_grad_step(arch, feel)(
        tree, _capture().init(tree), bj)
    return grads, metrics


@functools.lru_cache(maxsize=None)
def _ref_forward(arch, dtype="float32"):
    return jax.jit(jm.make_forward(_reference(arch, dtype)[0]))


@functools.lru_cache(maxsize=None)
def _ref_select(arch):
    cfg_j, _ = _reference(arch)

    def select(logits, hidden, bj):
        sigma = jm.sigma_scores(cfg_j, hidden, logits, bj)
        return sigma, j_sel.exact_selection(
            JFeel(n_clients=K).system(B // K), sigma.reshape(K, -1),
            jnp.ones((K, B // K)))

    return jax.jit(select)


def _ref_selection(arch, tree, bj):
    """The reference's sigma (B,) and delta (K, B/K) for a batch."""
    logits, hidden, _ = _ref_forward(arch)(tree, bj)
    sigma, delta = _ref_select(arch)(logits, hidden, bj)
    return np.array(sigma), np.array(delta)


def _given_delta(sigma_t, sigma_j, delta_j):
    """The replay rule's selection: None (the port solves, and must
    match) where every client's sigma gap clears 10x the sigma error,
    else the reference's delta."""
    err = replay.max_rel(sigma_t, torch.from_numpy(sigma_j))
    if replay.selection_given(torch.from_numpy(sigma_j), err, K):
        return torch.from_numpy(delta_j)
    return None


# ------------------------------------------------------------ losses

def test_per_example_loss_and_sigma_match_reference():
    cfg = smoke_config("llama3.2-3b")
    rng = np.random.default_rng(3)
    V, d = 40, 12
    logits = (rng.standard_normal((B, S, V)) * 3).astype(np.float32)
    hidden = rng.standard_normal((B, S, d)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[1, :7] = -1
    labels[5] = -1                                  # no valid token
    bj = {"labels": jnp.asarray(labels)}
    bt = {"labels": torch.from_numpy(labels).long()}
    ex_j, n_j = jm.per_example_loss(cfg, jnp.asarray(logits), bj)
    ex_t, n_t = tm.per_example_loss(cfg, torch.from_numpy(logits), bt)
    np.testing.assert_allclose(_np(ex_t), np.asarray(ex_j), rtol=1e-5)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    sig_j = jm.sigma_scores(cfg, jnp.asarray(hidden), jnp.asarray(logits), bj)
    sig_t = tm.sigma_scores(cfg, torch.from_numpy(hidden),
                            torch.from_numpy(logits), bt)
    np.testing.assert_allclose(_np(sig_t), np.asarray(sig_j), rtol=1e-5,
                               atol=1e-6)
    assert float(sig_t[5]) == 0.0


def test_sigma_from_head_forms_p_minus_y_without_a_one_hot(monkeypatch):
    """The helper equals its former form, softmax - one_hot (on the CPU
    the softmax is exp(x - logsumexp x), written out here), at the FEEL
    shape (2000, 84) + (2000, 10), and before the row-norm call it makes
    one (N, V) plane, the fp32 softmax's (x - logsumexp x, exponentiated
    in place), and no int64 one: p - y is formed in place."""
    from torch.utils._python_dispatch import TorchDispatchMode
    rng = np.random.default_rng(4)
    N, d, V = 2000, 84, 10
    h = torch.from_numpy(rng.standard_normal((N, d)).astype(np.float32))
    logits = torch.from_numpy(rng.standard_normal((N, V)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, V, N))
    former = ops.gradnorm_sigma(
        h, torch.exp(logits - torch.logsumexp(logits, -1, keepdim=True))
        - torch.nn.functional.one_hot(labels, V).float())

    class Planes(TorchDispatchMode):
        """New (N, V)-sized tensors made by each op (not in place)."""

        def __init__(self):
            super().__init__()
            self.made = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.numel() >= N * V \
                        and not any(t is a for a in args):
                    self.made.append((str(func), t.dtype))
            return out

    seen = {}

    def row_norms(h_, dlogits):
        seen["dlogits"] = dlogits
        return former

    monkeypatch.setattr(ops, "gradnorm_sigma", row_norms)
    with Planes() as planes:
        ops.sigma_from_head(h, logits, labels)
    assert planes.made == [("aten.sub.Tensor", torch.float32)]
    monkeypatch.undo()
    assert seen["dlogits"].dtype == torch.float32
    assert torch.equal(ops.sigma_from_head(h, logits, labels), former)


def test_sigma_stays_accurate_at_a_long_vocabulary():
    """At gemma3-12b's 262144 columns, each row's mass on one token other
    than its label (p - y then near 1 + p_max^2, as in a trained
    model's confident miss), the helper's sigma is within 5e-6 of a
    float64 recompute on the CPU: 1e-6 here, where torch's CPU softmax
    gave 4.5e-05 (and 1.5e-4 in a card-vs-CPU replay of gemma3's train
    steps, the card's within 2.3e-06)."""
    gen = torch.Generator().manual_seed(5)
    N, V, d = 16, 262144, 8
    logits = torch.randn(N, V, generator=gen) * 3
    labels = torch.randint(0, V, (N,), generator=gen)
    logits[torch.arange(N), (labels + 1) % V] += 24.0
    h = torch.randn(N, d, generator=gen)
    p64 = torch.softmax(logits.double(), -1)
    p64[torch.arange(N), labels] -= 1.0
    want = (h.double().square().sum(-1) + 1.0) * p64.square().sum(-1)
    got = ops.sigma_from_head(h, logits, labels).double()
    assert float(((got - want).abs() / want).max()) < 5e-6


def test_per_example_loss_gradient_stays_accurate_at_a_long_vocabulary():
    """At 262144 columns the per-example loss's gradient in the logits is
    within 5e-6 of float64 on the CPU (torch's CPU log_softmax gave
    5.2e-05, which in a card-vs-CPU replay of gemma3's train steps moved
    an AdamW embedding entry past the replay rule's bound)."""
    cfg = smoke_config("llama3.2-3b")
    gen = torch.Generator().manual_seed(6)
    B, S, V = 2, 8, 262144
    logits = torch.randn(B, S, V, generator=gen) * 3
    labels = torch.randint(0, V, (B, S), generator=gen)
    logits.view(-1, V)[torch.arange(B * S),
                       (labels.view(-1) + 1) % V] += 24.0
    grads = []
    for dt in (torch.float32, torch.float64):
        x = logits.to(dt, copy=True).requires_grad_()
        loss, _ = tm.per_example_loss(cfg, x, {"labels": labels})
        loss.sum().backward()
        grads.append(x.grad.double())
    g, g64 = grads
    big = g64.abs() > 1e-6
    assert float(((g - g64).abs() / g64.abs())[big].max()) < 5e-6


# ------------------------------------------------------- train forward

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS + SOFTCAP)
def test_train_forward_matches_reference(arch, dtype):
    cfg_j, tree = _reference(arch, dtype)
    cfg, model = _port(arch, dtype)
    bj, bt = _batch(cfg)
    logits_j, hidden_j, aux_j = _ref_forward(arch, dtype)(tree, bj)
    logits, hidden, aux = tm.make_forward(cfg)(model, bt)
    assert logits.dtype == torch.float32 and hidden.dtype == cfg.act_dtype
    _close(_np(logits), logits_j, dtype)
    _close(_np(hidden), hidden_j, dtype)
    aux_tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(float(aux.detach()), float(aux_j),
                               rtol=aux_tol)
    assert (float(aux.detach()) > 0) == (cfg.n_experts > 0)


@pytest.mark.parametrize("arch", SOFTCAP)
def test_softcapped_per_example_loss_matches_reference(arch):
    """The train mode's per-example loss with softcapped attention (every
    global and local layer's through the differentiable plain paths);
    at the 1.5 cap the logits also differ from the uncapped forward's."""
    cfg_j, tree = _reference(arch)
    cfg, model = _port(arch)
    bj, bt = _batch(cfg)
    logits_j, _, _ = _ref_forward(arch)(tree, bj)
    logits, _, _ = tm.make_forward(cfg)(model, bt)
    ex_j, n_j = jm.per_example_loss(cfg_j, logits_j, bj)
    ex, n = tm.per_example_loss(cfg, logits, bt)
    _close(_np(ex), ex_j)
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
    if cfg.attn_logit_softcap < 50:
        uncapped, _, _ = tm.make_forward(cfg.scaled(attn_logit_softcap=0.0))(
            model, bt)
        assert float((uncapped - logits).detach().abs().max()) > 100 * FP32_TOL


# ------------------------------------------------------------ gradients

@pytest.mark.parametrize("arch,feel", [(a, True) for a in ARCHS + SOFTCAP]
                         + [("llama3.2-3b", False),
                            ("falcon-mamba-7b", False)])
def test_gradients_match_reference(arch, feel):
    """Every leaf's gradient of the reference's train-step loss
    (``jax.value_and_grad`` inside its jitted step) by the replay rule,
    with the selection by the replay rule."""
    cfg_j, tree = _reference(arch)
    cfg, model = _port(arch)
    bj, bt = _batch(cfg, seed=1)
    grads_j, metrics_j = _ref_grads(arch, tree, bj, feel)
    loss_fn = tm.make_loss_fn(cfg, tm.FeelIntegration(n_clients=K)
                              if feel else None)
    delta = None
    if feel:
        sigma_j, delta_j = _ref_selection(arch, tree, bj)
        _, m0 = loss_fn(model, bt)
        delta = _given_delta(m0["sigma"], sigma_j, delta_j)
    grads, metrics = tm.grads_of(loss_fn, model, bt, delta)
    for k in ("loss", "aux_loss", "selected_frac"):
        np.testing.assert_allclose(float(metrics[k]), float(metrics_j[k]),
                                   rtol=1e-4, atol=1e-7)
    want = _flat(cfg, grads_j)
    assert set(grads) == set(want)
    replay.check_grads(grads, want)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "recurrentgemma-9b",
                                  "deepseek-v2-236b"])
def test_remat_on_and_off_give_equal_gradients(arch):
    bt = _batch(_config(arch), seed=2)[1]
    out = []
    for remat in (True, False):
        cfg, model = _port(arch, remat=remat)
        out.append(tm.grads_of(tm.make_loss_fn(
            cfg, tm.FeelIntegration(n_clients=K)), model, bt))
    (g_on, m_on), (g_off, m_off) = out
    assert float(m_on["loss"]) == float(m_off["loss"])
    for name in g_on:
        torch.testing.assert_close(g_on[name], g_off[name], rtol=0, atol=0)


# ------------------------------------------------------ whole steps

@functools.lru_cache(maxsize=None)
def _ref_train(arch, steps):
    """The reference's jitted train step from its initial params and
    optimizer state: [(params, state, grads) before step t] and the
    params after the last, with each step's batch."""
    cfg_j, tree = _reference(arch)
    opt = j_make_optimizer(cfg_j)
    step = jax.jit(j_make_train_step(cfg_j, opt, JFeel(n_clients=K)))
    state = opt.init(tree)
    states = []
    for t in range(steps):
        bj, _ = _batch(cfg_j, seed=10 + t,
                       alpha=np.array([1.0, 1.0, 0.0, 1.0], np.float32))
        grads, _ = _ref_grads(arch, tree, bj)
        states.append((tree, state, grads, bj))
        tree, state, _ = step(tree, state, bj)
    return states, tree


def _port_state(cfg, kind, state_j, opt):
    """The reference's optimizer state as the port's: Adam's moments by
    parameter name (body leaves unstacked); adafactor's as they are,
    each stacked body leaf under its group's name (``stacked_groups``)
    and each head and tail leaf under its parameter name."""
    count = int(state_j.count)
    if kind in ("adam", "adamw"):
        return AdamState(count=count, mu=_flat(cfg, state_j.mu),
                         nu=_flat(cfg, state_j.nu))

    def by_name(tree):
        out = {}
        for name, (leaf, r) in _leaves(cfg, tree).items():
            key = next((g for g, ms in opt.groups.items() if name in ms),
                       None) if r is not None else name
            out[key] = torch.from_numpy(np.array(leaf, np.float32))
        return out

    return AdafactorState(count=count, vr=by_name(state_j.vr),
                          vc=by_name(state_j.vc))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "falcon-mamba-7b",
                                  "deepseek-v2-236b"])
def test_train_steps_match_reference(arch, steps):
    """``steps`` train steps with FEEL and the config's optimizer (adamw
    for llama and mamba, adafactor for deepseek), each started from the
    reference's params and state before it, held by the replay rule."""
    _check_train_steps(arch, steps)


def test_train_steps_of_a_stacked_adafactor_body_match_reference():
    """2 train steps of deepseek-v2's smoke decoder cut to 3 layers, two
    body repeats, whose adafactor state is stacked as the reference's,
    held by the replay rule."""
    _check_train_steps("deepseek-v2-236b@3", 2)


def _check_train_steps(arch, steps):
    states, final = _ref_train(arch, 3)
    cfg_j, _ = _reference(arch)
    kind = cfg_j.optimizer
    assert kind == ("adafactor" if arch.startswith("deepseek") else "adamw")
    opt = make_optimizer(_config(arch))
    for t in range(steps):
        tree, state_j, grads_j, bj = states[t]
        after = states[t + 1][0] if t + 1 < len(states) else final
        cfg, model = _port(arch, tree=tree)
        params = dict(model.named_parameters())
        before = {n: p.detach().clone() for n, p in params.items()}
        state = _port_state(cfg, kind, state_j, opt)
        _, bt = _batch(cfg, seed=10 + t,
                       alpha=np.array([1.0, 1.0, 0.0, 1.0], np.float32))
        sigma_j, delta_j = _ref_selection(arch, tree, bj)
        step = tm.make_train_step(cfg, opt, tm.FeelIntegration(n_clients=K))
        _, m0 = tm.make_loss_fn(cfg, tm.FeelIntegration(n_clients=K))(
            model, bt)
        delta = _given_delta(m0["sigma"], sigma_j, delta_j)
        if delta is None:
            np.testing.assert_array_equal(_np(m0["delta"]), delta_j)
        _, new_state, metrics = step(model, state, bt, delta)
        assert new_state.count == t + 1
        replay.check_rel("sigma", metrics["sigma"], torch.from_numpy(sigma_j))
        replay.check_params(before, dict(model.named_parameters()),
                            _flat(cfg, after), _flat(cfg, grads_j), kind,
                            cfg.learning_rate,
                            0.01 if kind == "adamw" else 0.0)


# ---------------------------------------------------- the scan's gradient

def _scan_inputs(seed, shape, lo=0.3, hi=0.999):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("shape,lo", [((2, 1, 5), 0.3), ((2, 37, 6), 0.3),
                                      ((1, 300, 4), 0.999)])
def test_scan_gradient_matches_autograd_and_reference(shape, lo):
    """``ops.lru_scan``'s gradient (the adjoint recurrence run
    backwards through the scan) against autograd through the plain loop
    and against ``jax.grad`` of the reference's associative scan; S = 1,
    an S that is a multiple of nothing, gates in (0.999, 1)."""
    a, b, w = _scan_inputs(5, shape, lo=lo, hi=0.9999 if lo > 0.9 else 0.999)
    at = torch.from_numpy(a).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    h = ops.lru_scan(at, bt)
    ga, gb = torch.autograd.grad((h * torch.from_numpy(w)).sum(), (at, bt))
    a2 = torch.from_numpy(a).requires_grad_()
    b2 = torch.from_numpy(b).requires_grad_()
    want = torch.autograd.grad(
        (lru_scan.lru_scan_plain(a2, b2) * torch.from_numpy(w)).sum(),
        (a2, b2))
    torch.testing.assert_close(ga, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gb, want[1], rtol=1e-5, atol=1e-5)
    ja, jb = jax.jit(jax.grad(
        lambda x, y: jnp.sum(jssm._scan_assoc(x, y) * w),
        argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(b))
    scale = max(float(np.abs(np.asarray(ja)).max()), 1.0)
    np.testing.assert_allclose(_np(ga), np.asarray(ja), rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(_np(gb), np.asarray(jb), rtol=1e-5,
                               atol=1e-5 * scale)


# ------------------------------------------------------------------ FEEL

@pytest.mark.parametrize("alpha", [[1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 1, 1]])
def test_feel_selection_and_weights_match_reference(alpha):
    """delta, selected_frac, sigma_mean and the eq.-(19) weighted loss
    (0 when no client is available) equal the reference's for the same
    alpha."""
    arch = "falcon-mamba-7b"
    cfg_j, tree = _reference(arch)
    cfg, model = _port(arch)
    bj, bt = _batch(cfg, seed=6, alpha=np.array(alpha, np.float32))
    sigma_j, delta_j = _ref_selection(arch, tree, bj)
    _, metrics_j = _ref_grads(arch, tree, bj)
    with torch.no_grad():
        _, m = tm.make_loss_fn(cfg, tm.FeelIntegration(n_clients=K))(model,
                                                                     bt)
    assert _given_delta(m["sigma"], sigma_j, delta_j) is None
    np.testing.assert_array_equal(_np(m["delta"]), delta_j)
    np.testing.assert_allclose(_np(m["sigma"]), sigma_j, rtol=1e-5)
    for k in ("selected_frac", "sigma_mean", "loss"):
        np.testing.assert_allclose(float(m[k]), float(metrics_j[k]),
                                   rtol=1e-5, atol=1e-7)
    if not any(alpha):
        assert float(m["loss"]) == 0.0


def test_feel_system_is_the_reference_one():
    sys_j = JFeel(n_clients=6, eps=0.7, lam=2e-3).system(5)
    sys_t = tm.FeelIntegration(n_clients=6, eps=0.7, lam=2e-3).system(
        5, "cpu")
    assert (sys_t.K, sys_t.N, sys_t.Q) == (sys_j.K, sys_j.N, sys_j.Q)
    for name in ("B", "T", "L", "N0", "p_max", "q", "c", "f", "F", "kappa",
                 "eps", "D_hat", "lam"):
        np.testing.assert_array_equal(getattr(sys_t, name).numpy(),
                                      np.asarray(getattr(sys_j, name)))


def test_train_step_marks_its_stages_in_order():
    """The train step's ``mark`` sees each stage as it ends, in order;
    without FEEL there is no sigma or selection stage."""
    for feel, want in ((True, ["forward", "loss", "sigma", "selection",
                               "backward", "optimizer"]),
                       (False, ["forward", "loss", "backward",
                                "optimizer"])):
        cfg, model = _port("llama3.2-3b")
        opt = make_optimizer(cfg)
        state = opt.init(dict(model.named_parameters()))
        step = tm.make_train_step(cfg, opt, tm.FeelIntegration(n_clients=K)
                                  if feel else None)
        seen = []
        step(model, state, _batch(cfg)[1], mark=seen.append)
        assert seen == want


def test_train_step_needs_gradients_on_and_a_per_leaf_optimizer():
    cfg = smoke_config("llama3.2-3b")
    model = tm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    _, bt = _batch(cfg)
    with pytest.raises(ValueError, match="trainable"):
        tm.grads_of(tm.make_loss_fn(cfg), model, bt)
    clip = make_optimizer(cfg)
    from repro_torch import optim
    chained = optim.chain(optim.clip_by_global_norm(1.0), clip)
    assert clip.per_leaf and not chained.per_leaf
    with pytest.raises(ValueError, match="each leaf"):
        tm.apply_optimizer(chained, {}, (), {})


def test_apply_optimizer_equals_the_whole_dict_update():
    """Leaf by leaf (group by group) in place, the values of
    ``opt.update`` on the whole dict and ``apply_updates``, for adamw,
    adafactor and adafactor with a group of two leaves over 2 steps."""
    from repro_torch import optim
    rng = np.random.default_rng(8)
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 4, 6), "d": (7,)}
    for opt in (optim.adamw(1e-2, weight_decay=0.01), optim.adafactor(1e-2),
                optim.adafactor(1e-2, groups={"bd": ("b", "d")})):
        p1 = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for n, s in shapes.items()}
        p2 = {n: t.clone() for n, t in p1.items()}
        s1, s2 = opt.init(p1), opt.init(p2)
        for _ in range(2):
            g = {n: torch.from_numpy(rng.standard_normal(s).astype(
                np.float32)) for n, s in shapes.items()}
            upd, s1 = opt.update(dict(g), s1, p1)
            optim.apply_updates(p1, upd)
            s2 = tm.apply_optimizer(opt, dict(g), s2, p2)
        assert s1.count == s2.count == 2
        for n in shapes:
            assert torch.equal(p1[n], p2[n])


# --------------------------------------------------------------- driver

def test_train_driver_runs_on_the_cpu():
    """``python -m repro_torch.launch.train --smoke --steps 3 --device
    cpu`` exits 0 with a finite loss."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "3", "--device", "cpu"], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    last = [ln for ln in out.stdout.splitlines() if ln.startswith("step")][-1]
    assert np.isfinite(float(last.split("loss=")[1].split()[0]))


def test_train_run_counts_launches_and_takes_every_arch():
    """``run`` on CPU tensors: finite losses, every metric per step, and
    no kernel launch (CPU tensors take the plain versions); the 100M
    llama-family config of the example has its dims."""
    res = train_mod.run("deepseek-v2-236b", steps=2, batch=4, seq=8,
                        smoke=True, device="cpu")
    assert len(res.losses) == len(res.step_s) == len(res.sigma_mean) == 2
    assert all(np.isfinite(res.losses)) and res.aux_loss[0] > 0
    assert res.launches == [{"gradnorm_sigma": 0, "flash_attention": 0,
                             "lru_scan": 0, "lru_scan_backward": 0}] * 2
    cfg = train_mod.config_of("llama3.2-3b", full_100m=True)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.head_dim_) == (
        12, 768, 32000, 64)
    if not torch.cuda.is_available():  # no quiet CPU path
        with pytest.raises(RuntimeError, match="CUDA"):
            train_mod.run(smoke=True, steps=1)
