"""Parity of the port's vlm and audio modalities with the JAX zoo, on the
CPU at the smoke sizes of qwen2-vl-2b (embeddings in, M-RoPE) and
musicgen-medium (a grid of codebook tokens in, one head per codebook);
their full-width parameter counts; and adafactor on the reference's
stacked layer body.

Inputs are drawn with numpy from a seed and handed to both; weights are
the reference's ``init_model`` tree carried over by
``params_from_numpy``.  The vlm positions are an image grid of (t, h, w)
ids between two runs of text, so the three M-RoPE rows differ (with
three equal rows M-RoPE is 1-D RoPE, and a mistake in the sections would
not show).  Tolerances and why:
- the RoPE tables and rotations at atol/rtol 1e-6: the port raises the
  frequencies in float64 and rounds them, the reference raises them in
  float32, which agree to an ulp, and the angles are products of those
  with positions under 40;
- prefill logits, the KV cache and the decode steps' logits at atol/rtol
  1e-4 in fp32, with equal greedy tokens; in bf16 at rtol 3e-2 with an
  atol of 3e-2 times the largest reference value (the bf16 rule of
  tests/test_torch_llm.py: the frameworks round bf16 at other places);
- ``per_example_loss`` and ``sigma_scores`` at rtol 1e-5 (sums in
  another order; the port forms ||p - y||^2 directly where the
  reference expands it);
- adafactor's step in fp32 at atol 1e-8 and rtol 1e-5 on the params
  and its moments at rtol 1e-5: the same arithmetic, means taken in
  another order.  An update differs from the reference's per-layer
  clip by about a tenth of lr here, far above that.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as j_optim  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.launch.shapes import make_optimizer as j_make_optimizer  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import make_cache as j_make_cache  # noqa: E402
from repro.models import make_decode_step as j_make_decode_step  # noqa: E402
from repro.models import make_prefill_step as j_make_prefill_step  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import param_count as j_param_count  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import ARCHS, get_config, smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.shapes import make_optimizer  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.transformer import check_supported  # noqa: E402

torch.set_num_threads(2)

VLM, AUDIO = "qwen2-vl-2b", "musicgen-medium"
FULL_PARAMS = {VLM: 1_543_656_960, AUDIO: 1_837_254_144}
GRID = (2, 3, 4)  # the image's (t, h, w) patches


def _close(got, want, tol, scaled=False):
    want = np.asarray(want, np.float32)
    atol = tol * float(np.abs(want).max()) if scaled else tol
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=atol, rtol=tol)


def _np(t):
    return t.detach().float().numpy()


def mrope_positions(batch, prefix, grid, suffix):
    """(batch, 3, S) M-RoPE ids as Qwen2-VL lays them out: ``prefix``
    text positions (one id on all three rows), the image's t x h x w
    patches at prefix + (t, h, w), then ``suffix`` text positions from
    prefix + max(grid); sequence b shifted by 5 b."""
    t, h, w = grid
    ti, hi, wi = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                             indexing="ij")
    start = prefix + max(grid)
    pos = np.concatenate([
        np.tile(np.arange(prefix), (3, 1)),
        prefix + np.stack([ti.ravel(), hi.ravel(), wi.ravel()]),
        np.tile(start + np.arange(suffix), (3, 1))], axis=1)
    return (pos[None] + 5 * np.arange(batch)[:, None, None]).astype(np.int32)


# ------------------------------------------------------------------- rope

@pytest.mark.parametrize("sections,head_dim,theta",
                         [((4, 6, 6), 32, 1e6), ((16, 24, 24), 128, 1e6),
                          ((16, 24, 24), 128, 1e4)])
def test_mrope_matches_reference(sections, head_dim, theta):
    """The cos/sin tables and the rotation on positions whose three rows
    differ, at the smoke sections and the full ones."""
    pos = mrope_positions(2, 3, GRID, 5)
    assert (pos[:, 0] != pos[:, 1]).any() and (pos[:, 1] != pos[:, 2]).any()
    n_pairs = head_dim // 2
    cos_t, sin_t = tl._rope_cos_sin(torch.from_numpy(pos), n_pairs, theta,
                                    sections)
    cos_j, sin_j = jl._rope_cos_sin(jnp.asarray(pos), n_pairs, theta,
                                    sections)
    assert tuple(cos_t.shape) == (2, pos.shape[2], n_pairs)
    _close(cos_t, cos_j, 1e-6)
    _close(sin_t, sin_j, 1e-6)
    x = np.random.default_rng(0).standard_normal(
        (2, pos.shape[2], 3, head_dim)).astype(np.float32)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta,
                        1.0, sections)
    _close(got, jl.apply_rope(x, jnp.asarray(pos), theta, 1.0, sections),
           1e-6)
    # each section reads its own row: not the 1-D RoPE of any one row
    for row in range(3):
        one = tl.apply_rope(torch.from_numpy(x),
                            torch.from_numpy(pos[:, row].copy()), theta)
        assert not torch.allclose(got, one, atol=1e-3)


def test_mrope_with_equal_rows_is_1d_rope():
    pos = np.arange(9, dtype=np.int32)[None].repeat(2, 0)
    x = torch.randn(2, 9, 2, 32, generator=torch.Generator().manual_seed(1))
    got = tl.apply_rope(x, torch.from_numpy(np.stack([pos] * 3, 1)), 1e6,
                        1.0, (4, 6, 6))
    torch.testing.assert_close(got, tl.apply_rope(x, torch.from_numpy(pos),
                                                  1e6), rtol=0, atol=0)


def test_mrope_rejects_sections_that_do_not_cover_the_pairs():
    pos = torch.zeros(1, 3, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="M-RoPE"):
        tl._rope_cos_sin(pos, 16, 1e6, (4, 6, 5))
    with pytest.raises(ValueError, match="M-RoPE"):
        tl._rope_cos_sin(pos[:, :2], 16, 1e6, (4, 6, 6))


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_configs_carry_the_reference_dims(arch):
    assert arch in ARCHS
    assert get_config(arch).__dict__ == j_get_config(arch).__dict__
    assert smoke_config(arch).__dict__ == j_smoke_config(arch).__dict__
    check_supported(get_config(arch))
    full = get_config(arch)
    if arch == VLM:
        assert (full.mrope_sections, full.n_heads, full.n_kv_heads,
                full.head_dim_) == ((16, 24, 24), 12, 2, 128)
    else:
        assert (full.n_codebooks, full.act, full.head_dim_,
                full.n_kv_heads) == (4, "gelu", 64, 24)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_full_width_parameter_counts_and_head_shapes(arch):
    """At full width and depth on the meta device: the reference's
    ``eval_shape`` count, and the vlm's missing embedding table and the
    audio's stacked codebook embeddings and wide head."""
    cfg = get_config(arch)
    model = tm.init_model(cfg, None, "meta")
    shapes = jax.eval_shape(lambda k: j_init_model(k, j_get_config(arch)),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert tm.param_count(model) == want == FULL_PARAMS[arch]
    if arch == VLM:
        assert model.embed is None and "embed" not in shapes
        assert tuple(model.lm_head.shape) == (1536, 151936)
    else:
        assert tuple(model.embed.shape) == shapes["embed"].shape == (
            4, 2048, 1536)
        assert tuple(model.lm_head.shape) == (1536, 4 * 2048)


# --------------------------------------------------------------- decoders

@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    cfg_j = j_smoke_config(arch).scaled(dtype=dtype)
    tree = j_init_model(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, tree, jax.tree.map(np.asarray, tree)


def _requests(cfg, B, S, steps, seed=1):
    """numpy prefill batch and each decode step's extra inputs: vlm
    embeds with image-grid positions (decode: zero embeds at the next
    text positions); audio (B, C, S) tokens."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "vlm":
        pos = mrope_positions(B, 3, GRID, S - 3 - int(np.prod(GRID)))
        last = pos[:, :, -1:]
        return ({"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
                    np.float32), "positions": pos},
                [np.broadcast_to(last + 1 + i, (B, 3, 1)).astype(np.int32)
                 for i in range(steps)])
    toks = rng.integers(0, cfg.vocab, (B, cfg.n_codebooks, S))
    return {"tokens": toks.astype(np.int32)}, [None] * steps


def _as_port(cfg, b):
    out = {}
    for k, v in b.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(cfg.act_dtype) if k == "embeds" else t.long()
    return out


def _greedy(logits_t, logits_j, tol, scaled):
    """The reference's greedy tokens (per codebook for audio); the
    port's must be the same but at a bf16 near-tie (the rule of
    tests/test_torch_zoo.py)."""
    ref = np.asarray(logits_j[:, -1], np.float32)
    want = ref.argmax(-1)
    got = torch.argmax(logits_t[:, -1], -1).numpy()
    if scaled:
        top = np.take_along_axis(ref, got[..., None], -1)[..., 0]
        assert (ref.max(-1) - top <= tol * float(np.abs(ref).max())).all()
    else:
        np.testing.assert_array_equal(got, want)
    return want.astype(np.int32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_prefill_and_greedy_decode_match_reference(arch, dtype, tol):
    B, S, steps = 2, 32, 4
    scaled = dtype == "bfloat16"
    cfg_j, tree, np_tree = _reference(arch, dtype)
    cfg = smoke_config(arch).scaled(dtype=dtype)
    model = tm.params_from_numpy(cfg, np_tree)
    assert tm.param_count(model) == j_param_count(tree)
    prompt, positions = _requests(cfg, B, S, steps)
    bj = {k: jnp.asarray(v) for k, v in prompt.items()}
    if "embeds" in bj:
        bj["embeds"] = bj["embeds"].astype(cfg_j.act_dtype)
    logits_j, cache_j = jax.jit(j_make_prefill_step(cfg_j))(tree, bj)
    cache_t = tm.make_cache(cfg, B, S + steps)
    flash_attention.reset_launch_counts()
    logits_t, cache_t = tm.make_prefill_step(cfg)(model,
                                                  _as_port(cfg, prompt),
                                                  cache_t)
    assert flash_attention.LAUNCHES["flash_attention"] == 0  # CPU: plain
    want_shape = ((B, 1, cfg.n_codebooks, cfg.vocab) if arch == AUDIO
                  else (B, 1, cfg.vocab))
    assert tuple(logits_t.shape) == want_shape == logits_j.shape
    _close(logits_t, logits_j, tol, scaled)
    for n in ("k", "v"):
        got = cache_t["body"]["pos0"][n]
        _close(got[:, :, :S].float(), cache_j["body"]["pos0"][n], tol,
               scaled)

    def graft(dst, src):
        return jnp.pad(src, [(0, d - s) for d, s in zip(dst.shape, src.shape)]
                       ).astype(dst.dtype)

    cache_j = jax.tree.map(graft, j_make_cache(cfg_j, B, S + steps), cache_j)
    decode_j = jax.jit(j_make_decode_step(cfg_j))
    decode_t = tm.make_decode_step(cfg)
    for i in range(steps):
        tok = _greedy(logits_t, logits_j, tol, scaled)
        if arch == VLM:
            step = {"embeds": np.zeros((B, 1, cfg.d_model), np.float32),
                    "positions": positions[i]}
        else:
            step = {"tokens": tok[:, :, None]}
        sj = {k: jnp.asarray(v) for k, v in step.items()}
        if "embeds" in sj:
            sj["embeds"] = sj["embeds"].astype(cfg_j.act_dtype)
        logits_j, cache_j = decode_j(tree, cache_j,
                                     {**sj, "cache_index": jnp.int32(S + i)})
        logits_t, cache_t = decode_t(model, cache_t,
                                     {**_as_port(cfg, step),
                                      "cache_index": S + i})
        _close(logits_t, logits_j, tol, scaled)
    _greedy(logits_t, logits_j, tol, scaled)
    for n in ("k", "v"):
        _close(cache_t["body"]["pos0"][n].float(),
               cache_j["body"]["pos0"][n], tol, scaled)


# ---------------------------------------------------------- loss and sigma

def test_audio_loss_and_sigma_match_reference():
    """(B, S, C, V) logits against (B, C, S) labels, some -1 in one
    codebook only: the mean over every valid (position, codebook) pair,
    and sigma summed over the valid codebooks and divided by codebook
    0's valid count."""
    cfg = smoke_config(AUDIO)
    B, S, C, V, d = 4, 7, cfg.n_codebooks, 11, 6
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((B, S, C, V)) * 3).astype(np.float32)
    hidden = rng.standard_normal((B, S, d)).astype(np.float32)
    labels = rng.integers(0, V, (B, C, S)).astype(np.int32)
    labels[0, 1, :4] = -1          # codebook 1 only
    labels[1, 0, 2:5] = -1         # codebook 0 only: the denominator
    labels[3] = -1                 # no valid pair
    bj = {"labels": jnp.asarray(labels)}
    bt = {"labels": torch.from_numpy(labels).long()}
    ex_j, n_j = jm.per_example_loss(cfg, jnp.asarray(logits), bj)
    ex_t, n_t = tm.per_example_loss(cfg, torch.from_numpy(logits), bt)
    np.testing.assert_allclose(_np(ex_t), np.asarray(ex_j), rtol=1e-5)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert n_t.tolist() == [C * S - 4, C * S - 3, C * S, 1]
    sig_j = jm.sigma_scores(cfg, jnp.asarray(hidden), jnp.asarray(logits), bj)
    sig_t = tm.sigma_scores(cfg, torch.from_numpy(hidden),
                            torch.from_numpy(logits), bt)
    np.testing.assert_allclose(_np(sig_t), np.asarray(sig_j), rtol=1e-5,
                               atol=1e-6)
    assert float(sig_t[3]) == 0.0


def test_audio_sigma_makes_one_row_norm_call_on_folded_codebooks(
        monkeypatch):
    """One ``gradnorm_sigma`` call on (B S, C V) rows: the kernel's one
    launch a step on the card."""
    cfg = smoke_config(AUDIO)
    B, S, C, V = 2, 5, cfg.n_codebooks, 9
    seen = []
    real = tm.ops.gradnorm_sigma

    def spy(h, d):
        seen.append((tuple(h.shape), tuple(d.shape)))
        return real(h, d)

    monkeypatch.setattr(tm.ops, "gradnorm_sigma", spy)
    labels = torch.zeros(B, C, S, dtype=torch.long)
    tm.sigma_scores(cfg, torch.ones(B, S, 4), torch.zeros(B, S, C, V),
                    {"labels": labels})
    assert seen == [((B * S, 4), (B * S, C * V))]


# ----------------------------------------------------------- serve, train

@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_serve_and_train_smoke_on_cpu(arch):
    """``serve`` takes the reference's request (audio tokens per
    codebook) and ``run`` the reference's batch; no kernel launch on CPU
    tensors, finite losses."""
    cfg = smoke_config(arch)
    res = serve_mod.serve(arch, batch=2, prompt_len=12, new_tokens=3,
                          device="cpu")
    want = (2, 4, cfg.n_codebooks) if arch == AUDIO else (2, 4)
    assert tuple(res.tokens.shape) == want
    assert bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all())
    none = {"flash_attention": 0, "lru_scan": 0}
    assert res.launches == {"prefill": none, "decode": none}
    assert res.n_params == tm.param_count(tm.init_model(cfg, None, "meta"))
    out = train_mod.run(arch, steps=2, batch=4, seq=8, smoke=True,
                        device="cpu")
    assert all(np.isfinite(out.losses)) and len(out.sigma_mean) == 2
    assert out.launches == [{"gradnorm_sigma": 0, "flash_attention": 0,
                             "lru_scan": 0, "lru_scan_backward": 0}] * 2
    b = train_mod.synth_batch(cfg, torch.Generator().manual_seed(0), 4, 8,
                              4, True)
    if arch == AUDIO:
        assert tuple(b["tokens"].shape) == tuple(b["labels"].shape) == (
            4, cfg.n_codebooks, 8)
        assert torch.equal(b["tokens"][..., 1:], b["labels"][..., :-1])
    else:
        assert tuple(b["embeds"].shape) == (4, 8, cfg.d_model)
        assert tuple(b["positions"].shape) == (4, 3, 8)


def test_vlm_decode_batch_feeds_zero_embeds_at_text_positions():
    cfg = smoke_config(VLM)
    b = serve_mod.decode_batch(cfg, torch.zeros(3, dtype=torch.long), 17)
    assert not b["embeds"].any() and tuple(b["embeds"].shape) == (3, 1, 128)
    assert b["positions"].tolist() == [[[17]] * 3] * 3
    assert b["cache_index"] == 17
    assert serve_mod.decode_batch(cfg, torch.zeros(1, dtype=torch.long), 4,
                                  position=9)["positions"].tolist() == [
        [[9]] * 3]


# ---------------------------------------------------- adafactor, stacked

def test_adafactor_steps_a_group_as_one_stacked_leaf():
    """A group of two (R, C) members and a group of two 1-D members (a
    norm scale) beside a lone leaf, two steps, against the reference's
    adafactor on the stacked leaves.  Step 2's gradient jumps 100x in
    member 0 only, so its clip by the per-member RMS differs from the
    clip by the RMS over the stack; the 1-D group is factored as (2, d)."""
    rng = np.random.default_rng(3)
    shapes = {"w0": (6, 5), "w1": (6, 5), "s0": (7,), "s1": (7,),
              "lone": (4,)}
    groups = {"w": ("w0", "w1"), "s": ("s0", "s1")}
    p = {n: rng.standard_normal(s).astype(np.float32)
         for n, s in shapes.items()}
    opt = optim.adafactor(0.1, groups=groups)
    jopt = j_optim.adafactor(0.1)

    def stack(tree):
        return {"w": np.stack([tree["w0"], tree["w1"]]),
                "s": np.stack([tree["s0"], tree["s1"]]),
                "lone": tree["lone"]}

    pt = {n: torch.from_numpy(v.copy()) for n, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in stack(p).items()}
    st, sj = opt.init(pt), jopt.init(pj)
    assert {k: tuple(v.shape) for k, v in st.vr.items()} == {
        k: v.shape for k, v in sj.vr.items()}
    assert {k: tuple(v.shape) for k, v in st.vc.items()} == {
        k: v.shape for k, v in sj.vc.items()}
    for step in range(2):
        g = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
        if step == 1:
            g["w0"] *= 100.0
            g["s0"] *= 100.0
        st = tm.apply_optimizer(
            opt, {n: torch.from_numpy(v) for n, v in g.items()}, st, pt)
        upd, sj = jopt.update({k: jnp.asarray(v) for k, v in
                               stack(g).items()}, sj, pj)
        pj = j_optim.apply_updates(pj, upd)
        got = stack({n: t.numpy() for n, t in pt.items()})
        for k in pj:
            np.testing.assert_allclose(got[k], np.asarray(pj[k]),
                                       rtol=1e-5, atol=1e-8)
            np.testing.assert_allclose(st.vr[k].numpy(), np.asarray(sj.vr[k]),
                                       rtol=1e-5)
            np.testing.assert_allclose(st.vc[k].numpy(), np.asarray(sj.vc[k]),
                                       rtol=1e-5)
    with pytest.raises(ValueError, match="misses"):
        opt.init({"w0": pt["w0"]})


def _flat_paths(tree, prefix=""):
    """{dotted tree path: leaf} of nested dicts and lists (a list's items
    by index): the port's parameter names of head and tail layers, and
    its group names of the stacked body."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat_paths(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_deepseek_adafactor_steps_the_reference_stacked_body():
    """deepseek-v2's smoke decoder cut to 3 layers (``first_dense=1``: a
    head layer and two body repeats), 2 adafactor steps of
    ``make_optimizer`` through ``apply_optimizer`` on the same gradients
    as the reference's optimizer on its stacked tree; repeat 0's
    gradient jumps 100x at step 2.  Params and every moment, which has
    the reference's stacked shape under its group's name."""
    arch = "deepseek-v2-236b"
    cfg_j = j_smoke_config(arch).scaled(dtype="float32", n_layers=3)
    cfg = smoke_config(arch).scaled(dtype="float32", n_layers=3)
    tree = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(0),
                                                 cfg_j))
    model = tm.params_from_numpy(cfg, tree)
    params = dict(model.named_parameters())
    opt, jopt = make_optimizer(cfg), j_make_optimizer(cfg_j)
    assert set(opt.groups) == {k for k in _flat_paths(tree)
                               if k.startswith("decoder.body.")}
    assert all(len(ms) == 2 for ms in opt.groups.values())
    state, jstate = opt.init(params), jopt.init(tree)
    jtree = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(4)
    for step in range(2):
        gj = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32), tree)
        if step == 1:
            gj["decoder"]["body"] = jax.tree.map(
                lambda x: x * np.array([100.0, 1.0], np.float32).reshape(
                    (2,) + (1,) * (x.ndim - 1)), gj["decoder"]["body"])
        flat_g = _flat_paths(gj)
        grads = {}
        for name in params:
            for key, members in opt.groups.items():
                if name in members:
                    grads[name] = torch.from_numpy(np.array(
                        flat_g[key][members.index(name)]))
                    break
            else:
                grads[name] = torch.from_numpy(np.array(flat_g[name]))
        state = tm.apply_optimizer(opt, grads, state, params)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, gj), jstate,
                                  jtree)
        jtree = j_optim.apply_updates(jtree, upd)
        want = _flat_paths(jax.tree.map(np.asarray, jtree))
        for key, members in opt.groups.items():
            got = np.stack([params[m].detach().numpy() for m in members])
            np.testing.assert_allclose(got, want[key], rtol=1e-5, atol=1e-8)
        for name, p in params.items():
            if not name.startswith("decoder.body."):
                np.testing.assert_allclose(p.detach().numpy(), want[name],
                                           rtol=1e-5, atol=1e-8)
        for field in ("vr", "vc"):
            want_m = _flat_paths(jax.tree.map(np.asarray,
                                              getattr(jstate, field)))
            got_m = getattr(state, field)
            assert set(got_m) == set(want_m)
            for k, v in want_m.items():
                assert tuple(got_m[k].shape) == v.shape, k
                np.testing.assert_allclose(got_m[k].numpy(), v, rtol=1e-5,
                                           atol=1e-30)
