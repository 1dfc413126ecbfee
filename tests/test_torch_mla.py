"""Parity of the port's multi-head latent attention
(``repro_torch.models.mla``) with the JAX zoo's (``repro.models.mla``),
on the CPU at deepseek-v2-236b's smoke dims, with and without the query
bottleneck (``q_lora=0``).

Inputs are drawn with numpy from a seed and handed to both; the weights
are the reference's ``init_mla`` tree.  Tolerance: fp32 at atol/rtol
1e-5 (float32 sums in another order): the prefill output and both cache
entries (the latent ``ckv`` and the rotary key ``kr``), then decode
steps past the prompt on the naive and on the absorbed path, each step's
output and cache, and the absorbed path against the naive one.  The
prefill's attention runs the flash kernel's plain version here (CPU
tensors) with v narrower than q and k (d = nope + rope = 24, dv = 16),
held against the reference's ``causal_attend`` too, at the flash tests'
2e-5 (tests/test_torch_flash.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention, ops  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
TOL = 1e-5
B, S, SC = 2, 10, 14   # prompt S, then decode steps at positions S..SC-1


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _pair(q_lora):
    """(cfg_j, params_j, cfg, port MLA) on the same fp32 weights."""
    over = {"dtype": "float32"}
    if q_lora is not None:
        over["q_lora"] = q_lora
    cfg_j = j_smoke_config(ARCH).scaled(**over)
    cfg = smoke_config(ARCH).scaled(**over)
    p_j = jmla.init_mla(jax.random.PRNGKey(3), cfg_j, jnp.float32)
    assert set(p_j) == set(tmla.leaves(cfg))
    p_t = tmla.MLA(**{n: torch.from_numpy(np.array(p_j[n]))
                      for n in tmla.leaves(cfg)})
    return cfg_j, p_j, cfg, p_t


def _positions(start, n):
    return np.broadcast_to(np.arange(start, start + n, dtype=np.int32),
                           (B, n))


def _prefill(cfg_j, p_j, cfg, p_t):
    x = _normal(0, (B, S, cfg.d_model))
    pos = _positions(0, S)
    y_j, cache_j = jmla.mla_attention(cfg_j, p_j, jnp.asarray(x),
                                      jnp.asarray(pos), "prefill", None, 0)
    cache_t = {"ckv": torch.zeros(B, SC, cfg.kv_lora),
               "kr": torch.zeros(B, SC, cfg.qk_rope_dim)}
    y_t = tmla.mla_attention(cfg, p_t, torch.from_numpy(x),
                             torch.from_numpy(pos.copy()), "prefill",
                             cache_t, 0)
    return y_j, cache_j, y_t, cache_t


@pytest.mark.parametrize("q_lora", [None, 0])
def test_mla_prefill_matches_reference(q_lora):
    cfg_j, p_j, cfg, p_t = _pair(q_lora)
    assert ("w_dq" in p_j) == (q_lora is None)
    y_j, cache_j, y_t, cache_t = _prefill(cfg_j, p_j, cfg, p_t)
    assert y_t.shape == (B, S, cfg.d_model)
    _close(y_t, y_j)
    for name in ("ckv", "kr"):
        _close(cache_t[name][:, :S], cache_j[name])
        assert not cache_t[name][:, S:].any()


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("q_lora", [None, 0])
def test_mla_decode_matches_reference(q_lora, absorbed):
    cfg_j, p_j, cfg, p_t = _pair(q_lora)
    _, cache_j, _, cache_t = _prefill(cfg_j, p_j, cfg, p_t)
    cache_j = {n: jnp.pad(c, ((0, 0), (0, SC - S), (0, 0)))
               for n, c in cache_j.items()}
    for i in range(S, SC):
        x = _normal(100 + i, (B, 1, cfg.d_model))
        pos = _positions(i, 1)
        y_j, cache_j = jmla.mla_attention(
            cfg_j, p_j, jnp.asarray(x), jnp.asarray(pos), "decode", cache_j,
            jnp.int32(i), absorbed=absorbed)
        y_t = tmla.mla_attention(cfg, p_t, torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()), "decode",
                                 cache_t, i, absorbed=absorbed)
        assert y_t.shape == (B, 1, cfg.d_model)
        _close(y_t, y_j)
        for name in ("ckv", "kr"):
            _close(cache_t[name], cache_j[name])


@pytest.mark.parametrize("q_lora", [None, 0])
def test_mla_absorbed_decode_matches_naive(q_lora):
    _, _, cfg, p_t = _pair(q_lora)
    x = torch.from_numpy(_normal(7, (B, S, cfg.d_model)))
    caches = []
    for _ in range(2):
        c = {"ckv": torch.zeros(B, SC, cfg.kv_lora),
             "kr": torch.zeros(B, SC, cfg.qk_rope_dim)}
        tmla.mla_attention(cfg, p_t, x, torch.from_numpy(
            _positions(0, S).copy()), "prefill", c, 0)
        caches.append(c)
    for i in range(S, SC):
        x1 = torch.from_numpy(_normal(200 + i, (B, 1, cfg.d_model)))
        pos = torch.from_numpy(_positions(i, 1).copy())
        naive = tmla.mla_attention(cfg, p_t, x1, pos, "decode", caches[0], i)
        absorbed = tmla.mla_attention(cfg, p_t, x1, pos, "decode", caches[1],
                                      i, absorbed=True)
        _close(absorbed, naive)
    for name in ("ckv", "kr"):
        assert torch.equal(caches[0][name], caches[1][name])


def test_mla_init_draws_the_reference_shapes():
    cfg = smoke_config(ARCH)
    p_j = jmla.init_mla(jax.random.PRNGKey(0), j_smoke_config(ARCH),
                        jnp.bfloat16)
    p_t = tmla.init_mla(torch.Generator().manual_seed(0), cfg,
                        cfg.act_dtype)
    for n in tmla.leaves(cfg):
        w = getattr(p_t, n)
        assert tuple(w.shape) == p_j[n].shape and w.dtype == torch.bfloat16
        assert not w.requires_grad
    assert bool((p_t.kv_norm == 1).all())
    with pytest.raises(NotImplementedError, match="train"):
        tmla.mla_attention(cfg, p_t, torch.zeros(1, 2, cfg.d_model,
                                                 dtype=torch.bfloat16),
                           torch.zeros(1, 2, dtype=torch.long), "train",
                           None, 0)


# ---------------------------------- flash attention with a narrower v

@pytest.mark.parametrize("h,hk,d,dv", [(4, 4, 24, 16), (6, 2, 40, 8),
                                       (3, 3, 192, 128)])
def test_flash_bhsd_plain_with_narrower_v_matches_causal_attend(h, hk, d,
                                                                  dv):
    """MLA's prefill shape: q, k of width d and v of width dv < d; the
    port's ``flash_attention_bhsd`` (plain here) against the reference's
    ``causal_attend``, at its own scale and at MLA's."""
    q = _normal(1, (2, 19, h, d))
    k = _normal(2, (2, 19, hk, d))
    v = _normal(3, (2, 19, hk, dv))
    for scale in (None, 0.2):
        got = ops.flash_attention_bhsd(*(torch.from_numpy(a)
                                         for a in (q, k, v)), scale=scale)
        assert got.shape == (2, 19, h, dv) and got.is_contiguous()
        _close(got, jl.causal_attend(q, k, v, scale=scale), 2e-5)
        _close(tl.causal_attend(*(torch.from_numpy(a) for a in (q, k, v)),
                                scale=scale), got, 0)


def test_zero_padded_v_leaves_attention_unchanged():
    """What the card's route relies on for dv < d: v zero-padded to d
    gives the same first dv columns and zeros in the rest."""
    q, k = (torch.from_numpy(_normal(i, (1, 33, 4, 24))) for i in (4, 5))
    v = torch.from_numpy(_normal(6, (1, 33, 4, 16)))
    pad = flash_attention._value_operand(v, 24)
    assert pad.shape == (1, 33, 4, 24) and pad.is_contiguous()
    got = flash_attention.flash_attention_bhsd_plain(q, k, pad)
    want = flash_attention.flash_attention_bhsd_plain(q, k, v)
    torch.testing.assert_close(got[..., :16], want, atol=2e-5, rtol=2e-5)
    assert not got[..., 16:].any()


def test_flash_bhsd_refuses_a_wider_v():
    q = torch.zeros(1, 8, 2, 16)
    for v in (torch.zeros(1, 8, 2, 24), torch.zeros(1, 8, 1, 16),
              torch.zeros(1, 7, 2, 16)):
        with pytest.raises(ValueError, match="dv <= d"):
            ops.flash_attention_bhsd(q, q, v)
    with pytest.raises(ValueError, match="dv <= d"):
        tl.causal_attend(q, q, torch.zeros(1, 8, 2, 32))
