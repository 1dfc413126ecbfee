"""Parity of the port's attention logit softcapping and of
``causal_attend``'s whole signature (a query offset, keys longer than the
queries, a window, a scale) with the JAX zoo, on the CPU: every
attention path of ``repro_torch.models.layers``, the flash kernel's
plain version, a prefill taken in two chunks, and the softcapped smoke
decoders of gemma3-12b and llama3.2-3b (Gemma 2's published cap, 50.0,
and 1.5, where the cap bites at the smoke decoders' logits), served.
deepseek-v2's latent attention ignores the cap, as the reference's does.
The train mode's softcapped forward and gradients are held in
tests/test_torch_train.py.

Inputs are drawn with numpy from a seed and handed to both; the layers'
inputs at scale 2, so that logits reach the 1.5 cap.  Tolerances: the
layers and their gradients in fp32 at atol/rtol 1e-5 (float32 sums in
another order); the decoders' prefill logits and 8 greedy decode steps
at atol/rtol 1e-4 in fp32 with equal greedy tokens, and in bf16 at rtol
3e-2 with an atol of 3e-2 times the largest reference value (the bf16
rule of tests/test_torch_llm.py).  CPU tensors take the flash kernel's
plain version; the card runs the kernels (tests/test_torch_cuda.py and
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
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention, ops  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5
CAP = 1.5


def _normal(seed, shape, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol=TOL, scaled=False):
    want = np.asarray(want, np.float32)
    atol = tol * float(np.abs(want).max()) if scaled else tol
    got = got.detach().float() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=atol,
                               rtol=tol)


def _qkv(seed, sq, sk, h=6, hk=2, d=8, b=2):
    return (_normal(seed, (b, sq, h, d)), _normal(seed + 1, (b, sk, hk, d)),
            _normal(seed + 2, (b, sk, hk, d)))


# ------------------------------------------------------------ causal_attend

#: (Sq, Sk, keyword arguments of both sides' causal_attend)
CAUSAL_CASES = {
    "softcap": (9, 9, {"softcap": CAP}),
    "softcap-50": (9, 9, {"softcap": 50.0}),
    "scale": (9, 9, {"scale": 0.3}),
    "offset-to-the-end": (7, 19, {"q_offset": 12}),      # Sk == off + Sq
    "offset-short-of-the-end": (7, 19, {"q_offset": 5}),  # Sk > off + Sq
    "offset-past-the-keys": (4, 6, {"q_offset": 9}),      # every key seen
    "window": (13, 13, {"window": 4, "q_chunk": 5}),
    "window-offset": (7, 19, {"window": 4, "q_offset": 12, "q_chunk": 3}),
    "all": (7, 19, {"q_offset": 12, "softcap": CAP, "scale": 0.4}),
    "all-window": (7, 19, {"q_offset": 12, "softcap": CAP, "scale": 0.4,
                           "window": 5, "q_chunk": 4}),
}


@pytest.mark.parametrize("case", list(CAUSAL_CASES))
def test_causal_attend_matches_reference(case):
    sq, sk, kw = CAUSAL_CASES[case]
    q, k, v = _qkv(sq + sk, sq, sk)
    got = tl.causal_attend(_t(q), _t(k), _t(v), **kw)
    assert got.shape == q.shape
    _close(got, jl.causal_attend(q, k, v, **kw))


@pytest.mark.parametrize("offset", [0, 5, 12])
def test_causal_attend_takes_a_0d_offset(offset):
    """A 0-d integer array offset (as the reference's jitted callers
    pass one) gives what the int gives."""
    q, k, v = _qkv(3, 7, 19)
    got = tl.causal_attend(_t(q), _t(k), _t(v), q_offset=torch.tensor(offset),
                           softcap=CAP)
    _close(got, jl.causal_attend(q, k, v, q_offset=jnp.int32(offset),
                                 softcap=CAP))
    want = tl.causal_attend(_t(q), _t(k), _t(v), q_offset=offset, softcap=CAP)
    assert torch.equal(got, want)


def test_a_prefill_in_two_chunks_equals_the_one_shot_prefill():
    """Two ``causal_attend`` calls, the first half of the queries at
    offset 0 against the first half of the keys and the second at S/2
    against all of them, give the one-shot prefill (and the
    reference's)."""
    S = 16
    q, k, v = _qkv(7, S, S)
    tq, tk, tv = _t(q), _t(k), _t(v)
    first = tl.causal_attend(tq[:, :S // 2], tk[:, :S // 2], tv[:, :S // 2],
                             softcap=CAP)
    second = tl.causal_attend(tq[:, S // 2:], tk, tv, q_offset=S // 2,
                              softcap=CAP)
    chunked = torch.cat([first, second], dim=1)
    one_shot = tl.causal_attend(tq, tk, tv, softcap=CAP)
    _close(chunked, one_shot.numpy())
    _close(chunked, jl.causal_attend(q, k, v, softcap=CAP))


def test_flash_plain_version_takes_softcap_and_offset():
    """The kernel's plain version in both layouts, with softcap and
    offset, against the reference's ``causal_attend`` (the kernels are
    held against it on the card)."""
    q, k, v = _qkv(11, 7, 19, h=4, hk=4, d=16, b=1)
    want = jl.causal_attend(q, k, v, q_offset=12, softcap=CAP, scale=0.3)
    got = ops.flash_attention_bhsd(_t(q), _t(k), _t(v), scale=0.3,
                                   softcap=CAP, q_offset=12)
    _close(got, want)
    fold = lambda x: _t(x)[0].movedim(1, 0)  # noqa: E731  (H, S, d)
    folded = flash_attention.flash_attention_plain(
        fold(q), fold(k), fold(v), scale=0.3, softcap=CAP, q_offset=12)
    _close(folded.movedim(0, 1)[None], want)
    # GQA and a narrower v in the serving layout
    q, k, v = _qkv(12, 5, 9, h=6, hk=2, d=16)
    got = ops.flash_attention_bhsd(_t(q), _t(k), _t(v)[..., :8],
                                   softcap=CAP, q_offset=4)
    _close(got, jl.causal_attend(q, k, v[..., :8], q_offset=4, softcap=CAP))


def test_negative_offsets_raise_on_every_route():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="q_offset"):
        tl.causal_attend(q, q, q, q_offset=-1)
    with pytest.raises(ValueError, match="q_offset"):
        tl.causal_attend(q, q, q, q_offset=torch.tensor(-2), window=2)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention_bhsd(q, q, q, q_offset=-1)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention.flash_attention_plain(q[0], q[0], q[0], q_offset=-3)


def test_flash_flops_count_the_offset_pairs():
    """Query i sees min(Sk, q_offset + i + 1) keys."""
    for sq, sk, off in ((7, 19, 12), (7, 19, 5), (4, 6, 9), (9, 9, 0),
                        (5, 3, 0)):
        want = sum(min(sk, off + i + 1) for i in range(sq))
        assert flash_attention.causal_pairs(sq, sk, off) == want


# ------------------------------------------------ local and decode paths

@pytest.mark.parametrize("cap", [CAP, 50.0])
@pytest.mark.parametrize("S", [5, 19])
def test_local_attend_chunked_softcap_matches_reference(S, cap):
    q, k, v = _qkv(S, S, S, h=4, hk=2, d=16)
    got = tl.local_attend_chunked(_t(q), _t(k), _t(v), 8, softcap=cap)
    _close(got, jl.local_attend_chunked(q, k, v, 8, softcap=cap))


@pytest.mark.parametrize("index", [3, 9, 13])
@pytest.mark.parametrize("rolling", [False, True])
def test_decode_attend_softcap_matches_reference(rolling, index):
    q = _normal(10, (2, 1, 6, 8))
    kc, vc = _normal(11, (2, 8, 2, 8)), _normal(12, (2, 8, 2, 8))
    if not rolling:
        kc, vc = (np.concatenate([x, x[:, :6]], axis=1) for x in (kc, vc))
    window = 8 if rolling else 0
    got = tl.decode_attend(_t(q), _t(kc), _t(vc), index, window=window,
                           rolling=rolling, softcap=CAP)
    _close(got, jl.decode_attend(q, kc, vc, jnp.int32(index), window=window,
                                 rolling=rolling, softcap=CAP))


@pytest.mark.parametrize("path", ["local", "global"])
def test_softcapped_train_attention_gradients_match_reference(path):
    """Autograd through the softcap (in place in the local path) against
    ``jax.grad`` of the reference's attention: d/dq, d/dk, d/dv of a
    weighted sum of the output."""
    S = 19
    q, k, v = _qkv(21, S, S, h=4, hk=2, d=16)
    g = _normal(24, (2, S, 4, 16), 1.0)

    def ref(q, k, v):
        out = (jl.local_attend_chunked(q, k, v, 8, softcap=CAP)
               if path == "local" else
               jl.causal_attend(q, k, v, softcap=CAP, q_chunk=8))
        return jnp.sum(out * g)

    want = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    out = (tl.local_attend_chunked(*xs, 8, softcap=CAP) if path == "local"
           else tl.causal_attend_chunked(*xs, softcap=CAP, q_chunk=8))
    (out * _t(g)).sum().backward()
    for x, w in zip(xs, want):
        _close(x.grad, w, 1e-4)


# ------------------------------------------------------------ decoders

def _greedy(logits_t, logits_j, tol, scaled):
    """The reference's greedy tokens, which both sides decode next; the
    port's must be the same but, in bf16, at a near-tie of the
    reference's logits (the rule of tests/test_torch_zoo.py)."""
    ref = np.asarray(logits_j[:, -1], np.float32)
    want = ref.argmax(-1)
    got = torch.argmax(logits_t[:, -1], -1).numpy()
    if scaled:
        gap = ref.max(-1) - ref[np.arange(len(got)), got]
        assert (gap <= tol * float(np.abs(ref).max())).all(), (got, want)
    else:
        np.testing.assert_array_equal(got, want)
    return want.astype(np.int32)


def _graft(full, cache):
    def graft(dst, src):
        pad = [(0, d - s) for d, s in zip(dst.shape, src.shape)]
        return jnp.pad(src, pad).astype(dst.dtype)
    return jax.tree.map(graft, full, cache)


def _serve_both(arch, cap, dtype, tol, B=2, S=40, steps=8):
    """Prefill (S past gemma3's smoke window, 32) and ``steps`` greedy
    decode steps of ``arch``'s smoke decoder with ``attn_logit_softcap =
    cap`` on both sides, each step's logits held; returns the port's
    prefill logits."""
    scaled = dtype == "bfloat16"
    cfg_j = j_smoke_config(arch).scaled(dtype=dtype, attn_logit_softcap=cap)
    tree = j_init_model(jax.random.PRNGKey(0), cfg_j)
    cfg = smoke_config(arch).scaled(dtype=dtype, attn_logit_softcap=cap)
    model = tm.params_from_numpy(cfg, jax.tree.map(np.asarray, tree))
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
    first = logits_t
    cache_j = _graft(j_make_cache(cfg_j, B, S + steps), cache_j)
    decode_j = jax.jit(j_make_decode_step(cfg_j))
    decode_t = tm.make_decode_step(cfg)
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
    return first, model, cfg, toks


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("cap", [50.0, CAP])
@pytest.mark.parametrize("arch", ["gemma3-12b", "llama3.2-3b"])
def test_softcapped_decoder_serves_as_the_reference(arch, cap, dtype, tol):
    """Prefill logits and 8 greedy steps, both sides capped; at the 1.5
    cap the port's logits also differ from its uncapped decoder's, so
    the cap reaches every layer's attention."""
    logits, model, cfg, toks = _serve_both(arch, cap, dtype, tol)
    if cap == CAP and dtype == "float32":
        plain = cfg.scaled(attn_logit_softcap=0.0)
        uncapped, _ = tm.make_prefill_step(plain)(
            model, {"tokens": torch.from_numpy(toks).long()},
            tm.make_cache(plain, 2, toks.shape[1]))
        assert float((uncapped - logits).abs().max()) > 100 * tol


def test_latent_attention_ignores_the_softcap():
    """deepseek-v2's smoke decoder with ``attn_logit_softcap`` set
    serves as the reference's (whose ``mla_attention`` never reads it),
    and bit-identically to its uncapped self."""
    logits, model, cfg, toks = _serve_both("deepseek-v2-236b", 50.0,
                                           "float32", 1e-4, S=12)
    plain = cfg.scaled(attn_logit_softcap=0.0)
    uncapped, _ = tm.make_prefill_step(plain)(
        model, {"tokens": torch.from_numpy(toks).long()},
        tm.make_cache(plain, 2, toks.shape[1]))
    assert torch.equal(uncapped, logits)


def test_softcap_keeps_one_more_plane_for_the_local_backward():
    """The local path caps in place: under autograd the tanh's backward
    keeps its output, one (B, n, Hk, G, W, 2W) fp32 plane more than the
    uncapped path saves, and nothing else."""
    B, S, H, Hk, Dh, W = 2, 19, 4, 2, 16, 8
    q, k, v = (_t(x).requires_grad_() for x in _qkv(31, S, S, H, Hk, Dh, B))

    def saved_bytes(cap):
        seen = {}

        def pack(t):
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tl.local_attend_chunked(q, k, v, W, softcap=cap)
        return sum(seen.values())

    n = -(-S // W)
    plane = B * n * Hk * (H // Hk) * W * 2 * W * 4
    assert saved_bytes(CAP) - saved_bytes(0.0) == plane
