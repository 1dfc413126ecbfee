"""Parity of the port's decoders with the JAX zoo for the dense configs
stablelm-12b (partial rotary, head_dim 160 at full width) and
command-r-35b, and the latent-attention + MoE configs deepseek-v2-236b
and deepseek-v3-671b, on the CPU at their smoke sizes; their parameter
counts at full width; and their serves.

Inputs are drawn with numpy from a seed; weights are the reference's
``init_model`` tree carried over by ``params_from_numpy``.  Tolerances
as tests/test_torch_llm.py states them: prefill logits, the caches and
8 greedy decode steps at atol/rtol 1e-4 in fp32, with equal greedy
tokens; in bf16 rtol 3e-2 with an atol of 3e-2 times the largest
reference value (the bf16 rule of tests/test_torch_llm.py), and equal
greedy tokens but at a near-tie of the reference's logits
(``_greedy``).  The DeepSeek decoders decode on both latent-attention
paths, naive and absorbed.  Full-width counts are taken
on the ``meta`` device (nothing is allocated) and held against
``jax.eval_shape`` of the reference's ``init_model``.
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
from repro_torch.configs import ARCHS, get_config, smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

torch.set_num_threads(2)

DENSE = ("stablelm-12b", "command-r-35b")
DEEPSEEK = ("deepseek-v2-236b", "deepseek-v3-671b")
NEW = DENSE + DEEPSEEK


def _close(got, want, tol, scaled=False):
    want = np.asarray(want, np.float32)
    atol = tol * float(np.abs(want).max()) if scaled else tol
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=atol, rtol=tol)


def _reference(arch, dtype, seed=0):
    cfg_j = j_smoke_config(arch).scaled(dtype=dtype)
    tree = j_init_model(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, tree, jax.tree.map(np.asarray, tree)


def _graft(full, cache):
    def graft(dst, src):
        pad = [(0, d - s) for d, s in zip(dst.shape, src.shape)]
        return jnp.pad(src, pad).astype(dst.dtype)
    return jax.tree.map(graft, full, cache)


def _cache_leaves(cfg, cache_t, cache_j):
    """(port, reference, slot axis) of every cache entry: the head
    layers', then the body's stacked ones."""
    names = ("ckv", "kr") if "mla" in cfg.layer_pattern else ("k", "v")
    out = [(cache_t["head"][i][n], cache_j["head"][i][n], 1)
           for i in range(len(cache_t["head"])) for n in names]
    out += [(cache_t["body"]["pos0"][n], cache_j["body"]["pos0"][n], 2)
            for n in names]
    return out


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", NEW)
def test_configs_carry_the_reference_dims(arch):
    assert arch in ARCHS
    assert get_config(arch).__dict__ == j_get_config(arch).__dict__
    assert smoke_config(arch).__dict__ == j_smoke_config(arch).__dict__
    full = get_config(arch)
    if arch == "stablelm-12b":
        assert (full.head_dim_, full.rope_fraction) == (160, 0.25)
    if arch in DEEPSEEK:
        assert (full.qk_nope_dim + full.qk_rope_dim, full.v_head_dim) == (
            192, 128)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_counts_match_reference(arch):
    """Every architecture of the port at full width and depth, counted
    on the meta device, against the reference's abstract tree."""
    cfg = get_config(arch)
    model = tm.init_model(cfg, torch.Generator().manual_seed(0), "meta")
    shapes = jax.eval_shape(lambda k: j_init_model(k, j_get_config(arch)),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert tm.param_count(model) == want
    if arch == "deepseek-v2-236b":
        ffn = model.decoder.body[0].ffn
        assert tuple(ffn.w_gate.shape) == (160, 5120, 1536)
        assert ffn.router.dtype == torch.float32
        assert tuple(model.decoder.head[0].ffn.w_gate.shape) == (5120, 12288)


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_params_from_numpy_carries_every_moe_and_mla_weight(arch):
    cfg_j, tree, np_tree = _reference(arch, "bfloat16")
    cfg = smoke_config(arch)
    model = tm.params_from_numpy(cfg, np_tree)
    assert tm.param_count(model) == j_param_count(tree)
    head = np_tree["decoder"]["head"][0]
    blk = model.decoder.head[0]
    np.testing.assert_array_equal(blk.ffn.w_gate.float().numpy(),
                                  np.asarray(head["ffn"]["w_gate"],
                                             np.float32))
    body = np_tree["decoder"]["body"]["pos0"]
    for r, blk in enumerate(model.decoder.body):
        assert isinstance(blk.ffn, tmoe.MoE)
        assert blk.ffn.router.dtype == torch.float32
        pairs = [(getattr(blk.ffn, n), body["ffn"][n])
                 for n in tmoe.MoE.LEAVES]
        pairs += [(getattr(blk.attn, n), body["attn"][n])
                  for n in body["attn"]]
        if cfg.n_shared_experts:
            pairs += [(getattr(blk.ffn.shared, n), body["ffn"]["shared"][n])
                      for n in ("w_gate", "w_up", "w_down")]
        else:
            assert blk.ffn.shared is None
        for got, want in pairs:
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want[r], np.float32))


# ------------------------------------------------------------ decoders

def _greedy(logits_t, logits_j, tol, scaled):
    """The reference's greedy tokens, which both sides decode next.  The
    port's must be the same, except in bf16 at a near-tie: where the
    reference's logit of the port's token is within the step's atol of
    its largest (stablelm's smoke decoder meets one at step 2, reference
    logits 2.65625 and 2.671875, one bf16 ulp apart, which the port's
    bf16 rounds to one value)."""
    ref = np.asarray(logits_j[:, -1], np.float32)
    want = ref.argmax(-1)
    got = torch.argmax(logits_t[:, -1], -1).numpy()
    if scaled:
        gap = ref.max(-1) - ref[np.arange(len(got)), got]
        assert (gap <= tol * float(np.abs(ref).max())).all(), (got, want)
    else:
        np.testing.assert_array_equal(got, want)
    return want.astype(np.int32)


def _cases():
    for arch in NEW:
        for dtype, tol in (("float32", 1e-4), ("bfloat16", 3e-2)):
            for absorbed in ((False, True) if arch in DEEPSEEK else (False,)):
                yield arch, dtype, tol, absorbed


@pytest.mark.parametrize("arch,dtype,tol,absorbed", list(_cases()))
def test_decoder_prefill_and_greedy_decode_match_reference(arch, dtype, tol,
                                                           absorbed):
    B, S, steps = 2, 12, 8
    scaled = dtype == "bfloat16"
    cfg_j, tree, np_tree = _reference(arch, dtype)
    cfg = smoke_config(arch).scaled(dtype=dtype)
    model = tm.params_from_numpy(cfg, np_tree)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)
                                             ).astype(np.int32)

    logits_j, cache_j = jax.jit(j_make_prefill_step(cfg_j))(
        tree, {"tokens": jnp.asarray(toks)})
    cache_t = tm.make_cache(cfg, B, S + steps)
    flash_attention.reset_launch_counts()
    logits_t, cache_t = tm.make_prefill_step(cfg)(
        model, {"tokens": torch.from_numpy(toks).long()}, cache_t)
    assert flash_attention.LAUNCHES["flash_attention"] == 0  # CPU: plain
    _close(logits_t, logits_j, tol, scaled)
    for got, want, axis in _cache_leaves(cfg, cache_t, cache_j):
        _close(got.narrow(axis, 0, S).float(), want, tol, scaled)
        assert not got.narrow(axis, S, steps).any()

    cache_j = _graft(j_make_cache(cfg_j, B, S + steps), cache_j)
    decode_j = jax.jit(j_make_decode_step(cfg_j, mla_absorbed=absorbed))
    decode_t = tm.make_decode_step(cfg, mla_absorbed=absorbed)
    for i in range(steps):
        tok = _greedy(logits_t, logits_j, tol, scaled)
        logits_j, cache_j = decode_j(tree, cache_j, {
            "tokens": jnp.asarray(tok)[:, None],
            "cache_index": jnp.int32(S + i)})
        logits_t, cache_t = decode_t(model, cache_t, {
            "tokens": torch.from_numpy(tok).long()[:, None],
            "cache_index": S + i})
        _close(logits_t, logits_j, tol, scaled)
    _greedy(logits_t, logits_j, tol, scaled)
    for got, want, _ in _cache_leaves(cfg, cache_t, cache_j):
        _close(got.float(), want, tol, scaled)


# ------------------------------------------------------------ serving

@pytest.mark.parametrize("arch", NEW)
def test_serve_smoke_on_cpu(arch):
    """``serve`` on the CPU: greedy tokens in the vocabulary, no kernel
    launch (plain versions), and for the MoE configs the prefill's
    dispatch per MoE layer (C = 32 slots for the 32 prompt tokens at the
    smoke capacity factor, none dropped).  The absorbed decode takes the
    same prefill."""
    res = serve_mod.serve(arch, batch=2, prompt_len=16, new_tokens=3,
                          seed=0, device="cpu")
    assert res.tokens.shape == (2, 4)
    assert bool(((res.tokens >= 0) & (res.tokens < 512)).all())
    none = {"flash_attention": 0, "lru_scan": 0}
    assert res.launches == {"prefill": none, "decode": none}
    model = tm.init_model(smoke_config(arch), torch.Generator(), "meta")
    assert res.n_params == tm.param_count(model)
    if arch in DEEPSEEK:
        assert res.moe_dispatch == [(32, 0)]
        absorbed = serve_mod.serve(arch, batch=2, prompt_len=16,
                                   new_tokens=3, seed=0, device="cpu",
                                   mla_absorbed=True)
        assert torch.equal(absorbed.tokens[:, 0], res.tokens[:, 0])
    else:
        assert res.moe_dispatch == []


def test_serve_takes_a_config_cut_in_depth():
    """An ``ArchConfig`` is served as it is: deepseek-v3's smoke decoder
    at 3 layers, one dense head layer and two MoE layers, whose
    capacity drops tokens at capacity_factor 0.5."""
    cfg = smoke_config("deepseek-v3-671b").scaled(n_layers=3,
                                                   capacity_factor=0.5)
    res = serve_mod.serve(cfg, batch=2, prompt_len=16, new_tokens=2,
                          device="cpu")
    model = tm.init_model(cfg, torch.Generator(), "meta")
    assert res.n_params == tm.param_count(model)
    assert [c for c, _ in res.moe_dispatch] == [8, 8]
    assert all(dropped > 0 for _, dropped in res.moe_dispatch)


def test_main_takes_mla_absorbed(capsys):
    res = serve_mod.main(["--device", "cpu", "--arch", "deepseek-v2-236b",
                          "--mla-absorbed", "--batch", "1", "--prompt-len",
                          "5", "--new-tokens", "2"])
    assert res.tokens.shape == (1, 3)
    out = capsys.readouterr().out
    assert "arch=deepseek-v2-236b" in out and "dispatch" in out
