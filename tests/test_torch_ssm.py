"""Parity of the port's Mamba slice (``repro_torch``: ``kernels.lru_scan``,
``models.ssm``, the mamba decoder and its serve) with the JAX reference,
on the CPU at small sizes.

Inputs are drawn with numpy from a seed, or taken from the reference
side (its ``init_mamba`` / ``init_model`` trees), and handed to both.
Tolerances:
- the scan at atol/rtol 1e-5 against the Pallas kernel in interpret mode
  and ``repro.kernels.ref.lru_scan_ref`` (float32, the same sequential
  products); against the reference models' associative scan at rtol
  1e-4 / atol 1e-5 (another order of sums), as tests/test_kernels.py
  holds the two;
- the mixer and the decoder in fp32 at atol/rtol 1e-4, with equal
  greedy tokens;
- in bf16 at rtol 3e-2 with an atol of 3e-2 times the largest reference
  value: XLA's bf16 sigmoid (in SiLU, here ``silu(conv)`` and
  ``silu(z)``) rounds differently from torch's, the limit that
  tests/test_torch_llm.py states for the attention decoder.
On CPU tensors the scan takes its plain version, so no kernel launch is
counted; the CUDA kernel's tests are in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.lru_scan import lru_scan as j_lru_scan  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import make_cache as j_make_cache  # noqa: E402
from repro.models import make_decode_step as j_make_decode_step  # noqa: E402
from repro.models import make_prefill_step as j_make_prefill_step  # noqa: E402
from repro.models import param_count as j_param_count  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import lru_scan, ops, ref  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

torch.set_num_threads(2)

ARCH = "falcon-mamba-7b"
SCAN_SHAPES = [(1, 17, 8), (2, 300, 130), (3, 256, 256), (2, 512, 64)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _ab(seed, shape, lo=0.3, hi=0.999):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    return a, rng.standard_normal(shape).astype(np.float32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    """fp32: atol = rtol = 1e-4.  bf16: rtol 3e-2 with an atol of 3e-2
    times the largest |want| (see the module docstring)."""
    want = _f32(want)
    tol = TOL[dtype]
    atol = tol * float(np.abs(want).max()) if dtype == "bfloat16" else tol
    np.testing.assert_allclose(_f32(got), want, atol=atol, rtol=tol)


# ------------------------------------------------------------------ scan

@pytest.mark.parametrize("b,s,c", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lru_scan_plain_matches_pallas_and_ref(b, s, c, dtype):
    jd, td = DTYPES[dtype]
    a, bb = _ab(b * s + c, (b, s, c))
    aj, bj = jnp.asarray(a, jd), jnp.asarray(bb, jd)
    at, bt = torch.from_numpy(a).to(td), torch.from_numpy(bb).to(td)
    lru_scan.reset_launch_counts()
    got_plain = lru_scan.lru_scan_plain(at, bt)
    got_ops = ops.lru_scan(at, bt)
    assert lru_scan.LAUNCHES == {"lru_scan": 0,
                                 "lru_scan_backward": 0}  # CPU: plain version
    assert got_ops.dtype == torch.float32 and got_ops.shape == (b, s, c)
    np.testing.assert_array_equal(got_ops.numpy(), got_plain.numpy())
    for want in (j_lru_scan(aj, bj, interpret=True),
                 jref.lru_scan_ref(aj, bj)):
        np.testing.assert_allclose(got_plain.numpy(), _f32(want),
                                   atol=1e-5, rtol=1e-5)
    assert ref.lru_scan_ref is lru_scan.lru_scan_plain


def test_lru_scan_with_zero_a_is_the_identity_on_b():
    _, bb = _ab(5, (3, 40, 24))
    b = torch.from_numpy(bb)
    got = ops.lru_scan(torch.zeros_like(b), b)
    np.testing.assert_allclose(got.numpy(), bb, atol=1e-6, rtol=1e-5)


def test_lru_scan_matches_the_associative_scan_path():
    """The port's scan == the jnp associative scan the JAX mixer uses."""
    a, bb = _ab(9, (2, 64, 32), lo=0.5, hi=0.99)
    got = ops.lru_scan(torch.from_numpy(a), torch.from_numpy(bb))
    want = jssm._scan_assoc(jnp.asarray(a)[..., None],
                            jnp.asarray(bb)[..., None])[..., 0]
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-4,
                               atol=1e-5)


def test_lru_scan_on_other_devices_raises_and_never_counts():
    a = torch.zeros((1, 4, 8), device="meta")
    lru_scan.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        lru_scan.lru_scan(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        lru_scan.lru_scan(torch.zeros((1, 4, 8)), a)  # one CPU, one not
    assert lru_scan.LAUNCHES == {"lru_scan": 0,
                                 "lru_scan_backward": 0}
    empty = ops.lru_scan(torch.zeros((2, 0, 3)), torch.zeros((2, 0, 3)))
    assert empty.shape == (2, 0, 3) and empty.dtype == torch.float32


# ----------------------------------------------------------------- mixer

def _j_mixer_params(dtype, seed=0):
    cfg_j = j_smoke_config(ARCH).scaled(dtype=dtype)
    p = jssm.init_mamba(jax.random.PRNGKey(seed), cfg_j, cfg_j.act_dtype)
    return cfg_j, p


def _t_mixer(p, dtype):
    td = DTYPES[dtype][1]
    return ssm.Mamba(**{
        n: torch.from_numpy(_f32(p[n]).copy()).to(
            torch.float32 if n in ssm.FP32_LEAVES else td)
        for n in ssm.Mamba.LEAVES})


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_init_mamba_has_the_reference_shapes_and_dtypes(dtype):
    cfg_j, p = _j_mixer_params(dtype)
    cfg = smoke_config(ARCH).scaled(dtype=dtype)
    got = ssm.init_mamba(torch.Generator().manual_seed(0), cfg,
                         cfg.act_dtype)
    assert set(ssm.Mamba.LEAVES) == set(p)
    for name in ssm.Mamba.LEAVES:
        leaf = getattr(got, name)
        assert tuple(leaf.shape) == p[name].shape, name
        assert str(leaf.dtype).removeprefix("torch.") == str(p[name].dtype)
        assert not leaf.requires_grad
    # log(1..n): torch's and XLA's float32 log differ by an ulp at most
    np.testing.assert_allclose(got.A_log.numpy(), _f32(p["A_log"]),
                               rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(got.D.numpy(), _f32(p["D"]))
    assert not got.conv_b.float().any()
    # dt = softplus(dt_bias) is log-uniform in [1e-3, 1e-1]
    dt = torch.nn.functional.softplus(got.dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-4)


@pytest.mark.parametrize("S", [1, 2, 12])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_mixer_prefill_matches_reference(dtype, S):
    """Output and both cache entries; S < k - 1 zero-pads the conv
    state on the left."""
    cfg_j, p = _j_mixer_params(dtype)
    cfg = smoke_config(ARCH).scaled(dtype=dtype)
    jd, td = DTYPES[dtype]
    B, di, n, k = 2, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_conv
    x = _normal(S, (B, S, cfg.d_model))
    y_j, c_j = jssm.mamba_mixer(cfg_j, p, jnp.asarray(x, jd), "prefill",
                                None)
    cache = {"conv": torch.full((B, k - 1, di), 7.0, dtype=td),
             "h": torch.full((B, di, n), 7.0)}
    y = ssm.mamba_mixer(cfg, _t_mixer(p, dtype), torch.from_numpy(x).to(td),
                        "prefill", cache)
    assert y.dtype == td and cache["h"].dtype == torch.float32
    _close(y, y_j, dtype)
    _close(cache["conv"], c_j["conv"], dtype)
    _close(cache["h"], c_j["h"], dtype)
    if S < k - 1:
        assert not cache["conv"][:, :k - 1 - S].float().any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_mixer_decode_matches_reference(dtype):
    cfg_j, p = _j_mixer_params(dtype)
    cfg = smoke_config(ARCH).scaled(dtype=dtype)
    jd, td = DTYPES[dtype]
    B, di, n, k = 2, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_conv
    x = _normal(20, (B, 1, cfg.d_model))
    conv, h = _normal(21, (B, k - 1, di)), _normal(22, (B, di, n), 0.1)
    y_j, c_j = jssm.mamba_mixer(
        cfg_j, p, jnp.asarray(x, jd), "decode",
        {"conv": jnp.asarray(conv, jd), "h": jnp.asarray(h)})
    cache = {"conv": torch.from_numpy(conv).to(td),
             "h": torch.from_numpy(h.copy())}
    y = ssm.mamba_mixer(cfg, _t_mixer(p, dtype), torch.from_numpy(x).to(td),
                        "decode", cache)
    _close(y, y_j, dtype)
    _close(cache["conv"], c_j["conv"], dtype)
    _close(cache["h"], c_j["h"], dtype)


def test_mamba_mixer_train_mode_is_not_ported():
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
        y, cache = jssm.mamba_mixer(cfg_j, params, xj, "train", None)
        assert cache is None
        return jnp.sum(y * w), y

    (_, y_j), (g_j, gx_j) = jax.value_and_grad(loss_j, argnums=(0, 1),
                                               has_aux=True)(p, jnp.asarray(x))
    mixer = _t_mixer(p, "float32").requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    y = ssm.mamba_mixer(cfg, mixer, xt, "train", None)
    _close(y.detach(), y_j, "float32")
    names = list(ssm.Mamba.LEAVES)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                                [xt] + [getattr(mixer, n) for n in names])
    replay.check_grads(dict(zip(["x"] + names, grads)),
                       {"x": torch.from_numpy(np.array(gx_j, np.float32)),
                        **{n: torch.from_numpy(np.array(g_j[n], np.float32))
                           for n in names}})


# --------------------------------------------------------------- decoder

def _reference(dtype, seed=0):
    cfg_j = j_smoke_config(ARCH).scaled(dtype=dtype)
    tree = j_init_model(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, tree, jax.tree.map(np.asarray, tree)


def test_configs_carry_the_reference_dims():
    assert get_config(ARCH).__dict__ == j_get_config(ARCH).__dict__
    assert smoke_config(ARCH).__dict__ == j_smoke_config(ARCH).__dict__
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.ssm_d_inner, full.ssm_state,
            full.ssm_conv, full.ssm_dt_rank_, full.vocab,
            full.tie_embeddings, full.layer_pattern) == (
                64, 4096, 8192, 16, 4, 256, 65024, False, ("mamba",))


def test_full_width_model_has_the_reference_parameter_count_and_bytes():
    """Shapes only: the port's model on the meta device against
    ``jax.eval_shape`` of the reference's ``init_model``."""
    cfg = get_config(ARCH)
    with torch.device("meta"):
        model = tm.init_model(cfg, None, "meta")
    shapes = jax.eval_shape(lambda: j_init_model(jax.random.PRNGKey(0),
                                                 j_get_config(ARCH)))
    leaves = jax.tree.leaves(shapes)
    want_n = sum(int(np.prod(x.shape)) for x in leaves)
    want_bytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in leaves)
    assert tm.param_count(model) == want_n == 7_272_665_088
    assert sum(p.numel() * p.element_size() for p in model.parameters()) \
        == want_bytes == 14_564_204_544


def test_params_from_numpy_carries_every_weight():
    cfg_j, tree, np_tree = _reference("bfloat16")
    cfg = smoke_config(ARCH)
    model = tm.params_from_numpy(cfg, np_tree)
    assert tm.param_count(model) == j_param_count(tree)
    body = np_tree["decoder"]["body"]["pos0"]
    assert len(model.decoder.body) == cfg.n_layers
    for r, blk in enumerate(model.decoder.body):
        assert not hasattr(blk, "ln2") and not hasattr(blk, "ffn")
        pairs = [(blk.ln1, body["ln1"])] + [
            (getattr(blk.mixer, n), body["mixer"][n])
            for n in ssm.Mamba.LEAVES]
        for got, want in pairs:
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
            np.testing.assert_array_equal(got.float().numpy(),
                                          _f32(want[r]))
    assert model.decoder.body[0].mixer.A_log.dtype == torch.float32
    np.testing.assert_array_equal(model.lm_head.float().numpy(),
                                  _f32(np_tree["lm_head"]))


def test_cache_has_the_reference_layout():
    cfg = smoke_config(ARCH)
    got = tm.make_cache(cfg, 3, 10)
    want = j_make_cache(j_smoke_config(ARCH), 3, 10)
    for name in ("conv", "h"):
        g, w = got["body"]["pos0"][name], want["body"]["pos0"][name]
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    assert got["head"] == [] and got["tail"] == []


def _graft(full, cache):
    def graft(dst, src):
        pad = [(0, d - s) for d, s in zip(dst.shape, src.shape)]
        return jnp.pad(src, pad).astype(dst.dtype)
    return jax.tree.map(graft, full, cache)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decoder_prefill_and_greedy_decode_match_reference(dtype):
    B, S, steps = 2, 12, 8
    cfg_j, tree, np_tree = _reference(dtype)
    cfg = smoke_config(ARCH).scaled(dtype=dtype)
    model = tm.params_from_numpy(cfg, np_tree)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)
                                             ).astype(np.int32)

    logits_j, cache_j = jax.jit(j_make_prefill_step(cfg_j))(
        tree, {"tokens": jnp.asarray(toks)})
    cache_t = tm.make_cache(cfg, B, S + steps)
    lru_scan.reset_launch_counts()
    logits_t, cache_t = tm.make_prefill_step(cfg)(
        model, {"tokens": torch.from_numpy(toks).long()}, cache_t)
    assert lru_scan.LAUNCHES == {"lru_scan": 0,
                                 "lru_scan_backward": 0}  # CPU: plain version
    _close(logits_t, logits_j, dtype)
    for name in ("conv", "h"):
        _close(cache_t["body"]["pos0"][name],
               cache_j["body"]["pos0"][name], dtype)

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
    for name in ("conv", "h"):
        _close(cache_t["body"]["pos0"][name],
               cache_j["body"]["pos0"][name], dtype)


def test_prefill_state_equals_stepwise_decode():
    """Prefill's final state == prefilling 1 token and decoding the rest
    one by one (the port's own two paths; as the reference checks its
    own in tests/test_models_correctness.py)."""
    cfg = smoke_config(ARCH).scaled(dtype="float32")
    model = tm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 1, 6
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1))
    prefill, decode = tm.make_prefill_step(cfg), tm.make_decode_step(cfg)
    _, whole = prefill(model, {"tokens": toks}, tm.make_cache(cfg, B, S))
    _, step = prefill(model, {"tokens": toks[:, :1]},
                      tm.make_cache(cfg, B, S))
    for t in range(1, S):
        _, step = decode(model, step, {"tokens": toks[:, t:t + 1],
                                       "cache_index": t})
    for name in ("conv", "h"):
        torch.testing.assert_close(step["body"]["pos0"][name],
                                   whole["body"]["pos0"][name],
                                   atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------------- serve

def test_serve_mamba_smoke_on_cpu_launches_no_kernel():
    res = serve_mod.serve(ARCH, batch=2, prompt_len=9, new_tokens=3,
                          smoke=True, seed=0, device="cpu")
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int64
    assert bool(((res.tokens >= 0) & (res.tokens < 512)).all())
    none = {"flash_attention": 0, "lru_scan": 0}  # CPU: plain versions
    assert res.launches == {"prefill": none, "decode": none}
    assert res.n_params == 352_128
    assert len(res.decode_s) == 3 and res.prefill_s > 0
    again = serve_mod.serve(ARCH, batch=2, prompt_len=9, new_tokens=3,
                            smoke=True, seed=0, device="cpu")
    assert torch.equal(again.tokens, res.tokens)  # seeded end to end


def test_serve_mamba_main_runs_on_cpu_when_asked(capsys):
    res = serve_mod.main(["--arch", ARCH, "--device", "cpu", "--batch", "1",
                          "--prompt-len", "2", "--new-tokens", "2"])
    assert res.tokens.shape == (1, 3)
    assert f"arch={ARCH}" in capsys.readouterr().out


def test_serve_mamba_raises_without_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_mod.main(["--arch", ARCH, "--full", "--batch", "1",
                        "--prompt-len", "4", "--new-tokens", "1"])
