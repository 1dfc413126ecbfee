"""Parity of the port's RG-LRU slice (``repro_torch.models.rglru``, the
``rglru`` and ``attn_local`` blocks, the recurrentgemma-9b and
gemma3-12b decoders and their serves) with the JAX reference, on the CPU
at the smoke sizes.

Inputs are drawn with numpy from a seed, or taken from the reference
side (its ``init_rglru`` / ``init_model`` trees, carried over by
``params_from_numpy``), and handed to both.  Tolerances:
- the mixer in fp32 at atol/rtol 1e-5 (float32 sums and the scan taken
  in another order);
- the decoders in fp32 at atol/rtol 1e-4, with equal greedy tokens, and
  in bf16 at rtol 3e-2 with an atol of 3e-2 times the largest reference
  value, the rule tests/test_torch_llm.py states for the attention
  decoder (XLA's bf16 sigmoid, in SiLU, rounds differently from
  torch's);
- the recurrent state of a prefill against the same tokens stepped one
  by one at 1e-4 in fp32 (the reference checks its own two paths so in
  tests/test_models_correctness.py, at 3e-2).
On CPU tensors the scan and the flash kernel take their plain versions,
so no kernel launch is counted; the kernels' card tests are in
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import make_cache as j_make_cache  # noqa: E402
from repro.models import make_decode_step as j_make_decode_step  # noqa: E402
from repro.models import make_prefill_step as j_make_prefill_step  # noqa: E402
from repro.models import param_count as j_param_count  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention, lru_scan  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import rglru  # noqa: E402

torch.set_num_threads(2)

ARCH = "recurrentgemma-9b"
GEMMA = "gemma3-12b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MIXER_TOL = 1e-5
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype, tol=None):
    """fp32: atol = rtol = ``tol`` (default 1e-4).  bf16: rtol 3e-2 with
    an atol of 3e-2 times the largest |want| (see the module
    docstring)."""
    want = _f32(want)
    tol = TOL[dtype] if tol is None or dtype == "bfloat16" else tol
    atol = tol * float(np.abs(want).max()) if dtype == "bfloat16" else tol
    np.testing.assert_allclose(_f32(got), want, atol=atol, rtol=tol)


# ----------------------------------------------------------------- mixer

def _j_mixer_params(dtype, seed=0):
    cfg_j = j_smoke_config(ARCH).scaled(dtype=dtype)
    p = jrg.init_rglru(jax.random.PRNGKey(seed), cfg_j, cfg_j.act_dtype)
    return cfg_j, p


def _t_mixer(p, dtype):
    td = DTYPES[dtype][1]
    return rglru.RGLRU(**{
        n: torch.from_numpy(_f32(p[n]).copy()).to(
            torch.float32 if n in rglru.FP32_LEAVES else td)
        for n in rglru.RGLRU.LEAVES})


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_init_rglru_has_the_reference_shapes_and_dtypes(dtype):
    _, p = _j_mixer_params(dtype)
    cfg = smoke_config(ARCH).scaled(dtype=dtype)
    got = rglru.init_rglru(torch.Generator().manual_seed(0), cfg,
                           cfg.act_dtype)
    assert set(rglru.RGLRU.LEAVES) == set(p)
    for name in rglru.RGLRU.LEAVES:
        leaf = getattr(got, name)
        assert tuple(leaf.shape) == p[name].shape, name
        assert str(leaf.dtype).removeprefix("torch.") == str(p[name].dtype)
        assert not leaf.requires_grad
    assert not got.conv_b.float().any()
    # a^c = exp(-c softplus(lam)) lies in (0.9, 0.999), as in the reference
    ac = torch.exp(-8.0 * torch.nn.functional.softplus(got.lam))
    assert float(ac.min()) >= 0.9 * (1 - 1e-5)
    assert float(ac.max()) <= 0.999 * (1 + 1e-5)


@pytest.mark.parametrize("S", [1, 2, 12])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_mixer_prefill_matches_reference(dtype, S):
    """Output and both cache entries; S < k - 1 zero-pads the conv
    state on the left."""
    cfg_j, p = _j_mixer_params(dtype)
    cfg = smoke_config(ARCH).scaled(dtype=dtype)
    jd, td = DTYPES[dtype]
    B, w, k = 2, cfg.lru_width_, cfg.ssm_conv
    x = _normal(S, (B, S, cfg.d_model))
    y_j, c_j = jrg.rglru_mixer(cfg_j, p, jnp.asarray(x, jd), "prefill",
                               None)
    cache = {"conv": torch.full((B, k - 1, w), 7.0, dtype=td),
             "h": torch.full((B, w), 7.0)}
    lru_scan.reset_launch_counts()
    y = rglru.rglru_mixer(cfg, _t_mixer(p, dtype),
                          torch.from_numpy(x).to(td), "prefill", cache)
    assert lru_scan.LAUNCHES == {"lru_scan": 0,
                                 "lru_scan_backward": 0}  # CPU: plain version
    assert y.dtype == td and cache["h"].dtype == torch.float32
    _close(y, y_j, dtype, MIXER_TOL)
    _close(cache["conv"], c_j["conv"], dtype, MIXER_TOL)
    _close(cache["h"], c_j["h"], dtype, MIXER_TOL)
    if S < k - 1:
        assert not cache["conv"][:, :k - 1 - S].float().any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_mixer_decode_matches_reference(dtype):
    cfg_j, p = _j_mixer_params(dtype)
    cfg = smoke_config(ARCH).scaled(dtype=dtype)
    jd, td = DTYPES[dtype]
    B, w, k = 2, cfg.lru_width_, cfg.ssm_conv
    x = _normal(20, (B, 1, cfg.d_model))
    conv, h = _normal(21, (B, k - 1, w)), _normal(22, (B, w), 0.5)
    y_j, c_j = jrg.rglru_mixer(
        cfg_j, p, jnp.asarray(x, jd), "decode",
        {"conv": jnp.asarray(conv, jd), "h": jnp.asarray(h)})
    cache = {"conv": torch.from_numpy(conv).to(td),
             "h": torch.from_numpy(h.copy())}
    y = rglru.rglru_mixer(cfg, _t_mixer(p, dtype),
                          torch.from_numpy(x).to(td), "decode", cache)
    _close(y, y_j, dtype, MIXER_TOL)
    _close(cache["conv"], c_j["conv"], dtype, MIXER_TOL)
    _close(cache["h"], c_j["h"], dtype, MIXER_TOL)


def test_rglru_mixer_prefill_state_equals_stepwise_decode():
    """The mixer's prefill over S tokens leaves the state that a 1-token
    prefill and S - 1 decode steps leave, in both packages."""
    cfg_j, p = _j_mixer_params("float32")
    cfg = smoke_config(ARCH).scaled(dtype="float32")
    B, S, w, k = 2, 9, cfg.lru_width_, cfg.ssm_conv
    x = _normal(30, (B, S, cfg.d_model))
    mixer = _t_mixer(p, "float32")
    xt = torch.from_numpy(x)

    def fresh():
        return {"conv": torch.zeros(B, k - 1, w), "h": torch.zeros(B, w)}

    whole = fresh()
    y_whole = rglru.rglru_mixer(cfg, mixer, xt, "prefill", whole)
    step = fresh()
    ys = [rglru.rglru_mixer(cfg, mixer, xt[:, :1], "prefill", step)]
    for t in range(1, S):
        ys.append(rglru.rglru_mixer(cfg, mixer, xt[:, t:t + 1], "decode",
                                    step))
    for name in ("conv", "h"):
        _close(step[name], whole[name], "float32")
    _close(torch.cat(ys, dim=1), y_whole, "float32")
    _, c_j = jrg.rglru_mixer(cfg_j, p, jnp.asarray(x), "prefill", None)
    _close(step["h"], c_j["h"], "float32")


def test_rglru_mixer_train_mode_is_not_ported():
    """(Kept name.) The train mode is ported: in fp32 the output and the
    gradients of sum(y * w) with respect to x and every mixer weight
    match ``jax.grad`` of the reference's train-mode mixer, the output
    at atol/rtol 1e-4 and each gradient by the replay rule (rtol 1e-4,
    atol 1e-4 times the leaf's largest |g|); no cache is kept."""
    from repro_torch.launch import replay
    cfg_j, p = _j_mixer_params("float32")
    cfg = smoke_config(ARCH).scaled(dtype="float32")
    x, w = _normal(30, (2, 9, cfg.d_model)), _normal(31, (2, 9, cfg.d_model))

    def loss_j(params, xj):
        y, cache = jrg.rglru_mixer(cfg_j, params, xj, "train", None)
        assert cache is None
        return jnp.sum(y * w), y

    (_, y_j), (g_j, gx_j) = jax.value_and_grad(loss_j, argnums=(0, 1),
                                               has_aux=True)(p, jnp.asarray(x))
    mixer = _t_mixer(p, "float32").requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    y = rglru.rglru_mixer(cfg, mixer, xt, "train", None)
    _close(y.detach(), y_j, "float32", 1e-4)
    names = list(rglru.RGLRU.LEAVES)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                                [xt] + [getattr(mixer, n) for n in names])
    replay.check_grads(dict(zip(["x"] + names, grads)),
                       {"x": torch.from_numpy(np.array(gx_j, np.float32)),
                        **{n: torch.from_numpy(np.array(g_j[n], np.float32))
                           for n in names}})


# --------------------------------------------------------------- configs

def test_configs_carry_the_published_dims():
    """The reference's dims (the configs' equality with the reference's
    is checked in tests/test_torch_llm.py)."""
    rg = get_config(ARCH)
    assert (rg.n_layers, rg.d_model, rg.n_heads, rg.n_kv_heads, rg.head_dim_,
            rg.d_ff, rg.vocab, rg.window, rg.lru_width_, rg.ssm_conv,
            rg.tie_embeddings, rg.layer_pattern) == (
                38, 4096, 16, 1, 256, 12288, 256000, 2048, 4096, 4, False,
                ("rglru", "rglru", "attn_local"))
    g3 = get_config(GEMMA)
    assert (g3.n_layers, g3.d_model, g3.n_heads, g3.n_kv_heads, g3.head_dim_,
            g3.d_ff, g3.vocab, g3.window, g3.qk_norm, g3.rope_theta,
            g3.rope_theta_local, g3.tie_embeddings) == (
                48, 3840, 16, 8, 256, 15360, 262144, 1024, True, 1e6, 1e4,
                False)
    assert g3.layer_pattern == ("attn_local",) * 5 + ("attn",)


@pytest.mark.parametrize("arch,n_params", [(ARCH, 10_444_771_328),
                                           (GEMMA, 12_772_052_736)])
def test_full_width_model_has_the_reference_parameter_count_and_bytes(
        arch, n_params):
    """Shapes only: the port's model on the meta device against
    ``jax.eval_shape`` of the reference's ``init_model``."""
    cfg = get_config(arch)
    with torch.device("meta"):
        model = tm.init_model(cfg, None, "meta")
    shapes = jax.eval_shape(lambda: j_init_model(jax.random.PRNGKey(0),
                                                 j_get_config(arch)))
    leaves = jax.tree.leaves(shapes)
    want_n = sum(int(np.prod(x.shape)) for x in leaves)
    want_bytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in leaves)
    assert tm.param_count(model) == want_n == n_params
    assert sum(p.numel() * p.element_size() for p in model.parameters()) \
        == want_bytes


# ----------------------------------------------------------------- weights

def _reference(arch, dtype, seed=0):
    cfg_j = j_smoke_config(arch).scaled(dtype=dtype)
    tree = j_init_model(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, tree, jax.tree.map(np.asarray, tree)


def _pairs(blk, leaves, r):
    """(port leaf, reference leaf r) for every leaf of one block."""
    out = [(blk.ln1, leaves["ln1"]), (blk.ln2, leaves["ln2"])]
    out += [(getattr(blk.ffn, n), leaves["ffn"][n])
            for n in ("w_gate", "w_up", "w_down")]
    if "mixer" in leaves:
        out += [(getattr(blk.mixer, n), leaves["mixer"][n])
                for n in rglru.RGLRU.LEAVES]
    else:
        out += [(getattr(blk.attn, n), leaves["attn"][n])
                for n in leaves["attn"]]
    return [(g, w if r is None else w[r]) for g, w in out]


@pytest.mark.parametrize("arch", [ARCH, GEMMA])
def test_params_from_numpy_carries_every_weight(arch):
    cfg_j, tree, np_tree = _reference(arch, "bfloat16")
    cfg = smoke_config(arch)
    model = tm.params_from_numpy(cfg, np_tree)
    assert tm.param_count(model) == j_param_count(tree)
    dec = np_tree["decoder"]
    P = len(cfg.layer_pattern)
    pairs = []
    for i, blk in enumerate(model.decoder.body):
        pairs += _pairs(blk, dec["body"][f"pos{i % P}"], i // P)
    for blk, leaves in zip(model.decoder.tail, dec["tail"]):
        pairs += _pairs(blk, leaves, None)
    assert len(model.decoder.body) + len(model.decoder.tail) == cfg.n_layers
    for got, want in pairs:
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(), _f32(want))
    if arch == ARCH:
        assert model.decoder.body[0].mixer.lam.dtype == torch.float32
    else:
        assert model.decoder.body[0].attn.q_norm.shape == (cfg.head_dim_,)
    np.testing.assert_array_equal(model.lm_head.float().numpy(),
                                  _f32(np_tree["lm_head"]))


@pytest.mark.parametrize("arch", [ARCH, GEMMA])
def test_cache_has_the_reference_layout(arch):
    cfg = smoke_config(arch)
    got = tm.make_cache(cfg, 3, 10)
    want = j_make_cache(j_smoke_config(arch), 3, 10)
    flat_g = dict(_leaves(got))
    flat_w = dict(_leaves(want))
    assert flat_g.keys() == flat_w.keys()
    for name, w in flat_w.items():
        g = flat_g[name]
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ----------------------------------------------------------------- decoder

def _graft(full, cache):
    def graft(dst, src):
        pad = [(0, d - s) for d, s in zip(dst.shape, src.shape)]
        return jnp.pad(src, pad).astype(dst.dtype)
    return jax.tree.map(graft, full, cache)


def _hold_caches(cache_t, cache_j, dtype, S=None):
    """Every cache leaf of the port against the reference's: recurrent
    states and rolling buffers whole, a global layer's k/v on [0, S)."""
    want = dict(_leaves(cache_j))
    for name, got in _leaves(cache_t):
        w = _f32(want[name])
        if S is not None and got.shape != w.shape:  # a global k/v cache
            got = got[..., :S, :, :]
        _close(got, w, dtype)


# prompts longer than the smoke window (64 for recurrentgemma, 32 for
# gemma3), so the banded mask bites in prefill, and decode steps that
# write the rolling buffers past their wrap
DECODERS = [(ARCH, 70, 8), (GEMMA, 40, 8)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch,S,steps", DECODERS)
def test_decoder_prefill_and_greedy_decode_match_reference(arch, S, steps,
                                                           dtype):
    B = 2
    cfg_j, tree, np_tree = _reference(arch, dtype)
    cfg = smoke_config(arch).scaled(dtype=dtype)
    assert S > cfg.window
    model = tm.params_from_numpy(cfg, np_tree)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)
                                             ).astype(np.int32)

    logits_j, cache_j = jax.jit(j_make_prefill_step(cfg_j))(
        tree, {"tokens": jnp.asarray(toks)})
    cache_t = tm.make_cache(cfg, B, S + steps)
    lru_scan.reset_launch_counts()
    flash_attention.reset_launch_counts()
    logits_t, cache_t = tm.make_prefill_step(cfg)(
        model, {"tokens": torch.from_numpy(toks).long()}, cache_t)
    # CPU: plain versions
    assert lru_scan.LAUNCHES == {"lru_scan": 0,
                                 "lru_scan_backward": 0}
    assert flash_attention.LAUNCHES == {"flash_attention": 0}
    _close(logits_t, logits_j, dtype)
    _hold_caches(cache_t, cache_j, dtype, S)

    cache_j = _graft(j_make_cache(cfg_j, B, S + steps), cache_j)
    decode_j = jax.jit(j_make_decode_step(cfg_j))
    decode_t = tm.make_decode_step(cfg)
    tok_j = np.asarray(jnp.argmax(logits_j[:, -1], -1))
    tok_t = torch.argmax(logits_t[:, -1], -1)
    for i in range(steps):
        np.testing.assert_array_equal(tok_t.numpy(), tok_j)
        logits_j, cache_j = decode_j(tree, cache_j, {
            "tokens": jnp.asarray(tok_j)[:, None],
            "cache_index": jnp.int32(S + i)})
        logits_t, cache_t = decode_t(model, cache_t, {
            "tokens": tok_t[:, None], "cache_index": S + i})
        _close(logits_t, logits_j, dtype)
        tok_j = np.asarray(jnp.argmax(logits_j[:, -1], -1))
        tok_t = torch.argmax(logits_t[:, -1], -1)
    np.testing.assert_array_equal(tok_t.numpy(), tok_j)
    _hold_caches(cache_t, cache_j, dtype)


def test_prefill_state_equals_stepwise_decode():
    """The decoder's prefill leaves the rglru states and rolling buffers
    that prefilling 1 token and decoding the rest one by one leaves (the
    port's own two paths; the reference checks its own in
    tests/test_models_correctness.py).  The prompt crosses the window,
    so the step-by-step buffers wrap."""
    cfg = smoke_config(ARCH).scaled(dtype="float32", window=4)
    model = tm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 1, 7
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1))
    prefill, decode = tm.make_prefill_step(cfg), tm.make_decode_step(cfg)
    _, whole = prefill(model, {"tokens": toks}, tm.make_cache(cfg, B, S))
    _, step = prefill(model, {"tokens": toks[:, :1]},
                      tm.make_cache(cfg, B, S))
    for t in range(1, S):
        _, step = decode(model, step, {"tokens": toks[:, t:t + 1],
                                       "cache_index": t})
    for (name, got), (_, want) in zip(_leaves(step), _leaves(whole)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4,
                                   msg=name)


# ----------------------------------------------------------------- serve

@pytest.mark.parametrize("arch,n_params", [(ARCH, 995_712),
                                           (GEMMA, 1_017_856)])
def test_serve_smoke_on_cpu_launches_no_kernel(arch, n_params):
    res = serve_mod.serve(arch, batch=2, prompt_len=9, new_tokens=3,
                          smoke=True, seed=0, device="cpu")
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int64
    assert bool(((res.tokens >= 0) & (res.tokens < 512)).all())
    none = {"flash_attention": 0, "lru_scan": 0}  # CPU: plain versions
    assert res.launches == {"prefill": none, "decode": none}
    assert res.n_params == n_params
    again = serve_mod.serve(arch, batch=2, prompt_len=9, new_tokens=3,
                            smoke=True, seed=0, device="cpu")
    assert torch.equal(again.tokens, res.tokens)  # seeded end to end


@pytest.mark.parametrize("arch", [ARCH, GEMMA])
def test_serve_main_runs_on_cpu_when_asked(arch, capsys):
    res = serve_mod.main(["--arch", arch, "--device", "cpu", "--batch", "1",
                          "--prompt-len", "3", "--new-tokens", "2"])
    assert res.tokens.shape == (1, 3)
    assert f"arch={arch}" in capsys.readouterr().out
