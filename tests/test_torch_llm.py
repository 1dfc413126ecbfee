"""Parity of the port's text decoder (``repro_torch.models``) with the JAX
zoo (``repro.models``), on the CPU at the smoke size of llama3.2-3b.

Inputs are drawn with numpy from a seed and handed to both; weights are
the reference's ``init_model`` tree carried over by
``params_from_numpy``.  Tolerances: the layers in fp32 at atol/rtol
1e-5 (float32 sums in another order); the decoder's prefill logits, KV
cache and 8 greedy decode steps at atol/rtol 1e-4 in fp32, with equal
greedy tokens.  In bf16 the same run is held at rtol 3e-2 (the bf16
tolerance of tests/test_models_correctness.py) with an atol of 3e-2
times the largest reference value: XLA's bf16 sigmoid (in SiLU) rounds
differently from torch's in about a third of the elements, and the
logits are bf16 values of magnitude ~3 (an ulp of 1.6e-2), so the two
frameworks differ by 2-3 ulps at the logits' scale (0.041 at most on
these inputs), also where a logit itself is near 0.  The
port's prefill attention runs the flash kernel's plain version here
(CPU tensors); the card runs the kernel (tests/test_torch_cuda.py and
chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import make_cache as j_make_cache  # noqa: E402
from repro.models import make_decode_step as j_make_decode_step  # noqa: E402
from repro.models import make_prefill_step as j_make_prefill_step  # noqa: E402
from repro.models import param_count as j_param_count  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

torch.set_num_threads(2)

ARCH = "llama3_2-3b"
TOL = 1e-5


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol, scaled=False):
    """allclose at atol = rtol = tol; with ``scaled`` the atol is tol
    times the largest |want| (the bf16 comparisons, see above)."""
    want = np.asarray(want, np.float32)
    atol = tol * float(np.abs(want).max()) if scaled else tol
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=atol, rtol=tol)


# ------------------------------------------------------------------ layers

def test_rmsnorm_matches_reference():
    x, s = _normal(0, (2, 5, 96)), _normal(1, (96,))
    _close(tl.rmsnorm(_t(x), _t(s)), jl.rmsnorm(x, s), TOL)


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches_reference(fraction, theta):
    x = _normal(2, (2, 7, 4, 24))
    pos = (np.arange(7)[None, :] + np.array([[0], [33]])).astype(np.int32)
    got = tl.apply_rope(_t(x), _t(pos), theta, fraction)
    _close(got, jl.apply_rope(x, pos, theta, fraction), TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    x = _normal(3, (3, 5, 16))
    w = {"w_gate": _normal(4, (16, 40), 0.25),
         "w_up": _normal(5, (16, 40), 0.25),
         "w_down": _normal(6, (40, 16), 0.15)}
    got = tl.mlp(tl.MLP(*(_t(w[n]) for n in ("w_gate", "w_up", "w_down"))),
                 _t(x), act)
    _close(got, jl.mlp(w, x, act), TOL)


@pytest.mark.parametrize("h,hk", [(4, 2), (6, 2), (4, 4)])
def test_causal_attend_gqa_matches_reference(h, hk):
    q = _normal(7, (2, 9, h, 8))
    k, v = _normal(8, (2, 9, hk, 8)), _normal(9, (2, 9, hk, 8))
    got = tl.causal_attend(_t(q), _t(k), _t(v))
    _close(got, jl.causal_attend(q, k, v), TOL)


@pytest.mark.parametrize("index", [0, 6, 9])
def test_decode_attend_matches_reference(index):
    q = _normal(10, (2, 1, 6, 8))
    kc, vc = _normal(11, (2, 10, 2, 8)), _normal(12, (2, 10, 2, 8))
    got = tl.decode_attend(_t(q), _t(kc), _t(vc), index)
    _close(got, jl.decode_attend(q, kc, vc, jnp.int32(index)), TOL)


def test_unported_attention_paths_raise():
    """Softcapping and a window are ported: each of the three attention
    paths runs with a softcap, and ``causal_attend`` with a window, as
    the reference does; a config that sets the softcap, text or vlm, is
    supported.  What still raises is a negative ``q_offset`` (rows that
    see no key), a ``ValueError`` on every route."""
    q = _normal(40, (1, 12, 4, 8), 2.0)
    k, v = _normal(41, (1, 12, 2, 8), 2.0), _normal(42, (1, 12, 2, 8))
    for got, want in (
            (tl.causal_attend(_t(q), _t(k), _t(v), window=3),
             jl.causal_attend(q, k, v, window=3)),
            (tl.causal_attend(_t(q), _t(k), _t(v), softcap=2.0),
             jl.causal_attend(q, k, v, softcap=2.0)),
            (tl.local_attend_chunked(_t(q), _t(k), _t(v), 5, softcap=2.0),
             jl.local_attend_chunked(q, k, v, 5, softcap=2.0)),
            (tl.decode_attend(_t(q[:, :1]), _t(k), _t(v), 9, window=5,
                              rolling=True, softcap=2.0),
             jl.decode_attend(q[:, :1], k, v, jnp.int32(9), window=5,
                              rolling=True, softcap=2.0))):
        _close(got, want, TOL)
    with pytest.raises(ValueError, match="q_offset"):
        tl.causal_attend(_t(q), _t(k), _t(v), q_offset=-1)
    cfg = smoke_config(ARCH)
    for capped in (cfg.scaled(attn_logit_softcap=50.0),
                   smoke_config("qwen2-vl-2b").scaled(attn_logit_softcap=30.0)):
        tt.check_supported(capped)
        tt.init_decoder(capped, torch.Generator().manual_seed(0))


# ------------------------------------------------------------ configs

def test_configs_carry_the_reference_dims():
    from repro.configs import get_config as j_get_config
    for name in ("llama3.2-3b", ARCH, "recurrentgemma-9b", "gemma3-12b"):
        want = j_get_config(name)
        got = get_config(name)
        assert got.__dict__ == want.__dict__
        assert smoke_config(name).__dict__ == j_smoke_config(name).__dict__
    full = get_config("llama3.2-3b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab, full.rope_theta) == (
                28, 3072, 24, 8, 8192, 128256, 5e5)
    assert full.act_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        full.scaled(n_layers=0).validate()


# ------------------------------------------------------------ weights

def _reference(dtype, seed=0):
    cfg_j = j_smoke_config(ARCH).scaled(dtype=dtype)
    tree = j_init_model(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, tree, jax.tree.map(np.asarray, tree)


def test_params_from_numpy_carries_every_weight():
    cfg_j, tree, np_tree = _reference("bfloat16")
    cfg = smoke_config(ARCH)
    model = tm.params_from_numpy(cfg, np_tree)
    assert tm.param_count(model) == j_param_count(tree)
    body = np_tree["decoder"]["body"]["pos0"]
    assert len(model.decoder.body) == cfg.n_layers
    for r, blk in enumerate(model.decoder.body):
        pairs = [(blk.ln1, body["ln1"]), (blk.ln2, body["ln2"])]
        pairs += [(getattr(blk.attn, n), body["attn"][n])
                  for n in ("wq", "wk", "wv", "wo")]
        pairs += [(getattr(blk.ffn, n), body["ffn"][n])
                  for n in ("w_gate", "w_up", "w_down")]
        for got, want in pairs:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want[r], np.float32))
    for got, want in ((model.embed, np_tree["embed"]),
                      (model.lm_head, np_tree["lm_head"]),
                      (model.decoder.final_norm,
                       np_tree["decoder"]["final_norm"])):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_init_model_draws_the_reference_shapes_and_scales():
    cfg = smoke_config(ARCH).scaled(dtype="float32")
    model = tm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    _, tree, _ = _reference("float32")
    want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert tm.param_count(model) == sum(int(np.prod(s))
                                        for s in want.values())
    wq = model.decoder.body[0].attn.wq
    assert wq.shape == want["decoder/body/pos0/attn/wq"][1:]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert not any(p.requires_grad for p in model.parameters())


# ------------------------------------------------------------ decoder

def _graft(full, cache):
    def graft(dst, src):
        pad = [(0, d - s) for d, s in zip(dst.shape, src.shape)]
        return jnp.pad(src, pad).astype(dst.dtype)
    return jax.tree.map(graft, full, cache)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_decoder_prefill_and_greedy_decode_match_reference(dtype, tol):
    B, S, steps = 2, 12, 8
    scaled = dtype == "bfloat16"
    cfg_j, tree, np_tree = _reference(dtype)
    cfg = smoke_config(ARCH).scaled(dtype=dtype)
    model = tm.params_from_numpy(cfg, np_tree)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)
                                             ).astype(np.int32)

    logits_j, cache_j = jax.jit(j_make_prefill_step(cfg_j))(
        tree, {"tokens": jnp.asarray(toks)})
    cache_t = tm.make_cache(cfg, B, S + steps)
    flash_attention.reset_launch_counts()
    logits_t, cache_t = tm.make_prefill_step(cfg)(
        model, {"tokens": _t(toks).long()}, cache_t)
    assert flash_attention.LAUNCHES["flash_attention"] == 0  # CPU: plain
    _close(logits_t, logits_j, tol, scaled)
    for name in ("k", "v"):
        got = cache_t["body"]["pos0"][name]
        want = np.asarray(cache_j["body"]["pos0"][name], np.float32)
        assert got.shape == (cfg.n_layers, B, S + steps) + want.shape[3:]
        _close(got[:, :, :S].float(), want, tol, scaled)
        assert not got[:, :, S:].any()

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
        _close(logits_t, logits_j, tol, scaled)
        tok_j = np.asarray(jnp.argmax(logits_j[:, -1], -1))
        tok_t = torch.argmax(logits_t[:, -1], -1)
    np.testing.assert_array_equal(tok_t.numpy(), tok_j)
    _close(cache_t["body"]["pos0"]["k"].float(),
           np.asarray(cache_j["body"]["pos0"]["k"], np.float32), tol, scaled)
