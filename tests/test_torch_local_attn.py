"""Parity of the port's sliding-window attention (``repro_torch.models.
layers``: ``local_attend_chunked``, the rolling and windowed masks of
``decode_attend``, qk-norm and the local RoPE theta of the attention
sublayer) with the JAX zoo (``repro.models.layers``), on the CPU.

Inputs are drawn with numpy from a seed and handed to both.
Tolerances: fp32 at atol/rtol 1e-5 (float32 sums in another order);
bf16 at rtol 2e-2 with an atol of 2e-2 times the largest reference
value (bf16 probabilities times bf16 values, summed in another order).
Local attention is plain torch on every device, as the reference's is
jnp: the flash kernel takes no window.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5
W = 8


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol=TOL, scaled=False):
    want = np.asarray(want, np.float32)
    atol = tol * float(np.abs(want).max()) if scaled else tol
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32), want, atol=atol, rtol=tol)


# ------------------------------------------------------ chunked prefill

@pytest.mark.parametrize("S", [W - 3, W, 2 * W + 3])
@pytest.mark.parametrize("h,hk", [(4, 1), (4, 2), (3, 3)])
def test_local_attend_chunked_matches_reference(S, h, hk):
    """S < W (one padded chunk), S = W (one whole chunk) and S = 2W + 3
    (three chunks, the last padded): the banded (W, 2W) mask and chunk
    0's own mask."""
    q = _normal(S, (2, S, h, 16))
    k, v = _normal(S + 1, (2, S, hk, 16)), _normal(S + 2, (2, S, hk, 16))
    got = tl.local_attend_chunked(_t(q), _t(k), _t(v), W)
    assert got.shape == (2, S, h, 16) and got.dtype == torch.float32
    _close(got, jl.local_attend_chunked(q, k, v, W))
    # the same function as the reference's windowed q-chunked attention
    _close(got, jl.causal_attend(q, k, v, window=W))


@pytest.mark.parametrize("S", [W - 3, 2 * W + 3])
def test_local_attend_chunked_bf16_matches_reference(S):
    q = _normal(40, (1, S, 4, 32))
    k, v = _normal(41, (1, S, 2, 32)), _normal(42, (1, S, 2, 32))
    bf = jnp.bfloat16
    want = jl.local_attend_chunked(jnp.asarray(q, bf), jnp.asarray(k, bf),
                                   jnp.asarray(v, bf), W)
    got = tl.local_attend_chunked(*(_t(x).bfloat16() for x in (q, k, v)), W)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2, scaled=True)


def test_local_attend_chunked_window_covering_the_sequence_is_causal():
    """A window at least S long masks nothing but the future."""
    q, k, v = (_normal(50 + i, (2, 11, 4, 8)) for i in range(3))
    got = tl.local_attend_chunked(_t(q), _t(k), _t(v), 16)
    _close(got, flash_attention.flash_attention_bhsd_plain(
        _t(q), _t(k), _t(v), causal=True))


# ------------------------------------------------------- rolling decode

@pytest.mark.parametrize("index", [0, 3, W - 1, W, W + 5, 3 * W + 2])
def test_decode_attend_rolling_matches_reference(index):
    """A window-sized rolling cache before, at and past its wrap."""
    q = _normal(60, (2, 1, 4, 16))
    kc, vc = _normal(61, (2, W, 2, 16)), _normal(62, (2, W, 2, 16))
    got = tl.decode_attend(_t(q), _t(kc), _t(vc), index, window=W,
                           rolling=True)
    _close(got, jl.decode_attend(q, kc, vc, jnp.int32(index), window=W,
                                 rolling=True))


@pytest.mark.parametrize("index", [2, 9, 13])
def test_decode_attend_windowed_plain_cache_matches_reference(index):
    q = _normal(63, (2, 1, 4, 16))
    kc, vc = _normal(64, (2, 14, 2, 16)), _normal(65, (2, 14, 2, 16))
    got = tl.decode_attend(_t(q), _t(kc), _t(vc), index, window=5)
    _close(got, jl.decode_attend(q, kc, vc, jnp.int32(index), window=5))


# ------------------------------------------------------- the sublayer

def _attn_params(cfg, seed):
    d, H, Hk, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {"wq": _normal(seed, (d, H * Dh), d ** -0.5),
         "wk": _normal(seed + 1, (d, Hk * Dh), d ** -0.5),
         "wv": _normal(seed + 2, (d, Hk * Dh), d ** -0.5),
         "wo": _normal(seed + 3, (H * Dh, d), (H * Dh) ** -0.5)}
    if cfg.qk_norm:
        p["q_norm"] = 1 + _normal(seed + 4, (Dh,), 0.1)
        p["k_norm"] = 1 + _normal(seed + 5, (Dh,), 0.1)
    return p


@pytest.mark.parametrize("kind", ["attn_local", "attn"])
def test_gemma3_attention_sublayer_prefill_and_decode_match_reference(kind):
    """qk-norm before RoPE, theta 1e4 on local layers and 1e6 on global
    ones, the local prefill's rolling write at slots p % W and a decode
    step past the wrap."""
    cfg = smoke_config("gemma3-12b").scaled(dtype="float32")
    cfg_j = j_smoke_config("gemma3-12b").scaled(dtype="float32")
    p = _attn_params(cfg, 70)
    B, S = 2, cfg.window + 5
    x = _normal(80, (B, S, cfg.d_model))
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    y_j, c_j = jt._attn_apply(cfg_j, kind, {"attn": p}, jnp.asarray(x),
                              jnp.asarray(pos), "prefill", None, 0, False)
    block = tt.Block(torch.ones(1), tl.Attention(
        *(_t(p[n]) for n in ("wq", "wk", "wv", "wo", "q_norm", "k_norm"))),
        torch.ones(1), None)
    cache = tt.init_cache(cfg.scaled(layer_pattern=(kind,), n_layers=1),
                          B, S + 1)["body"]["pos0"]
    cache = {n: c[0] for n, c in cache.items()}
    y = tt._attn_apply(cfg, kind, block, _t(x), _t(pos).long(), "prefill",
                       cache, 0)
    _close(y, y_j)
    for n in ("k", "v"):
        _close(cache[n][:, :c_j[n].shape[1]], c_j[n])

    xd = _normal(81, (B, 1, cfg.d_model))
    c_j = {n: jnp.pad(c_j[n], ((0, 0), (0, cache[n].shape[1]
                                        - c_j[n].shape[1]), (0, 0), (0, 0)))
           for n in ("k", "v")}
    pos_d = np.full((B, 1), S, np.int32)
    y_j, c_j = jt._attn_apply(cfg_j, kind, {"attn": p}, jnp.asarray(xd),
                              jnp.asarray(pos_d), "decode", c_j,
                              jnp.int32(S), False)
    y = tt._attn_apply(cfg, kind, block, _t(xd), _t(pos_d).long(), "decode",
                       cache, S)
    _close(y, y_j)
    for n in ("k", "v"):
        _close(cache[n], c_j[n])
