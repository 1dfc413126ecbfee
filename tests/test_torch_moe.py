"""Parity of the port's mixture-of-experts FFN (``repro_torch.models.moe``)
with the JAX zoo's (``repro.models.moe``), on the CPU at
deepseek-v2-236b's smoke dims (4 experts, top-2, one shared expert).

Inputs are drawn with numpy from a seed and handed to both; the weights
are the reference's ``init_moe`` tree (router float32).  Cases: the
smoke config (capacity_factor 8, no token dropped), a capacity_factor
of 0.5 (C = 16 slots for 96 routed pairs: tokens are dropped), a
decode-sized G (B = 4 tokens, C = G), and no shared expert.  In fp32
y and the aux loss are held at atol/rtol 1e-5 (float32 sums in
another order), and the routing is equal: each token's top-k experts,
and each expert's dispatched tokens where the gate is > 0 (slots of gate
0 fill an expert's unused capacity with tokens whose order the two
top-k implementations may break differently, and they add nothing).
In bf16, y at rtol 3e-2 with an atol of 3e-2 times its largest value
(the bf16 rule of tests/test_torch_llm.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import MLP  # noqa: E402

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
CASES = {"smoke": ((2, 24), {}),
         "drops": ((2, 24), {"capacity_factor": 0.5}),
         "decode": ((4, 1), {}),
         "no-shared": ((2, 24), {"n_shared_experts": 0})}


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(dtype, **over):
    cfg_j = j_smoke_config(ARCH).scaled(dtype=dtype, **over)
    cfg = smoke_config(ARCH).scaled(dtype=dtype, **over)
    p_j = jmoe.init_moe(jax.random.PRNGKey(5), cfg_j, cfg_j.act_dtype)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    leaves = {n: t(p_j[n]).to(torch.float32 if n in tmoe.FP32_LEAVES
                              else cfg.act_dtype)
              for n in tmoe.MoE.LEAVES}
    shared = (MLP(*(t(p_j["shared"][n]).to(cfg.act_dtype)
                    for n in ("w_gate", "w_up", "w_down")))
              if "shared" in p_j else None)
    return cfg_j, p_j, cfg, tmoe.MoE(shared=shared, **leaves)


def _reference_routing(cfg, p_j, x):
    """The reference's dispatch, step for step as ``moe_ffn`` takes it."""
    xf = jnp.asarray(x).reshape(-1, cfg.d_model)
    probs = jax.nn.softmax((xf @ p_j["router"].astype(xf.dtype)
                            ).astype(jnp.float32), axis=-1)
    top_vals, top_idx = jax.lax.top_k(probs, cfg.topk)
    top_vals = top_vals / jnp.maximum(top_vals.sum(-1, keepdims=True), 1e-9)
    G = xf.shape[0]
    gate = jnp.zeros((G, cfg.n_experts), jnp.float32).at[
        jnp.arange(G)[:, None], top_idx].set(top_vals)
    w_ec, idx_ec = jax.lax.top_k(gate.T, jmoe.capacity(cfg, G))
    return np.asarray(top_idx), np.asarray(w_ec), np.asarray(idx_ec)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference_fp32(case):
    (b, s), over = CASES[case]
    cfg_j, p_j, cfg, p_t = _pair("float32", **over)
    x = _normal(11, (b, s, cfg.d_model))
    y_j, aux_j = jmoe.moe_ffn(cfg_j, p_j, jnp.asarray(x))
    p_t.routing_log = []
    y_t, aux_t = tmoe.moe_ffn(cfg, p_t, torch.from_numpy(x))
    assert y_t.shape == (b, s, cfg.d_model) and aux_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)

    (rec,) = p_t.routing_log
    top_idx, w_ec, idx_ec = _reference_routing(cfg_j, p_j, x)
    G = b * s
    assert set(rec) == {"probs", "top_idx", "w_ec", "idx_ec", "routed"}
    C = rec["w_ec"].shape[1]
    assert C == jmoe.capacity(cfg_j, G) == tmoe.capacity(cfg, G)
    np.testing.assert_array_equal(rec["top_idx"].numpy(), top_idx)
    np.testing.assert_allclose(rec["w_ec"].numpy(), w_ec, atol=1e-6)
    for e in range(cfg.n_experts):
        got = rec["idx_ec"][e][rec["w_ec"][e] > 0].numpy()
        np.testing.assert_array_equal(np.sort(got),
                                      np.sort(idx_ec[e][w_ec[e] > 0]))
    dropped = G * cfg.topk - int((w_ec > 0).sum())
    assert int(tmoe.dropped(rec)) == dropped
    assert (dropped > 0) == (case == "drops")
    probs = np.sort(rec["probs"].numpy(), axis=-1)[:, ::-1]
    gap = (probs[:, cfg.topk - 1] - probs[:, cfg.topk]).min()
    assert float(tmoe.topk_gap(rec)) == gap > 0
    if case == "decode":
        assert C == G  # every expert takes every token


@pytest.mark.parametrize("case", ["smoke", "drops"])
def test_moe_ffn_matches_reference_bf16(case):
    (b, s), over = CASES[case]
    cfg_j, p_j, cfg, p_t = _pair("bfloat16", **over)
    assert p_t.router.dtype == torch.float32
    x = _normal(12, (b, s, cfg.d_model))
    y_j, aux_j = jmoe.moe_ffn(cfg_j, p_j, jnp.asarray(x, jnp.bfloat16))
    y_t, aux_t = tmoe.moe_ffn(cfg, p_t, torch.from_numpy(x).bfloat16())
    assert y_t.dtype == torch.bfloat16
    want = np.asarray(y_j, np.float32)
    np.testing.assert_allclose(y_t.float().numpy(), want, rtol=3e-2,
                               atol=3e-2 * float(np.abs(want).max()))
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=3e-2)


def test_capacity_matches_reference():
    for over in ({}, {"capacity_factor": 0.5}, {"capacity_factor": 1.25}):
        cfg_j = j_smoke_config(ARCH).scaled(**over)
        cfg = smoke_config(ARCH).scaled(**over)
        for n in (1, 2, 4, 7, 24, 48, 100, 8192):
            assert tmoe.capacity(cfg, n) == jmoe.capacity(cfg_j, n)
    assert tmoe.capacity(cfg, 4) == 4  # decode: C = G


def test_combine_adds_each_token_in_expert_order():
    """The combine against a loop over tokens that adds each kept
    (expert, slot) contribution in increasing expert order, in bf16: the
    same bits, and the same on a second call (no atomics)."""
    g = torch.Generator().manual_seed(0)
    E, C, d, G, K = 5, 3, 8, 6, 2
    y = torch.randn(E, C, d, generator=g).bfloat16()
    top_idx = torch.stack([torch.randperm(E, generator=g)[:K]
                           for _ in range(G)])
    gate = torch.zeros(G, E).scatter_(1, top_idx, torch.rand(G, K,
                                                             generator=g))
    w_ec, idx_ec = torch.topk(gate.T, C, dim=-1)
    got = tmoe._combine(y, w_ec, idx_ec, top_idx, torch.bfloat16)
    want = torch.zeros(G, d, dtype=torch.bfloat16)
    for tok in range(G):
        for e in sorted(top_idx[tok].tolist()):
            for c in range(C):
                if idx_ec[e, c] == tok and w_ec[e, c] > 0:
                    want[tok] = want[tok] + y[e, c] * w_ec[e, c].bfloat16()
    assert torch.equal(got, want)
    assert torch.equal(tmoe._combine(y, w_ec, idx_ec, top_idx,
                                     torch.bfloat16), got)


def test_init_moe_draws_the_reference_shapes_and_scales():
    cfg = smoke_config(ARCH).scaled(moe_d_ff=96)
    p_j = jmoe.init_moe(jax.random.PRNGKey(0), j_smoke_config(ARCH).scaled(
        moe_d_ff=96), jnp.bfloat16)
    p_t = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, cfg.act_dtype)
    for n in tmoe.MoE.LEAVES:
        w = getattr(p_t, n)
        assert tuple(w.shape) == p_j[n].shape
        assert w.dtype == (torch.float32 if n in tmoe.FP32_LEAVES
                           else torch.bfloat16)
    for n in ("w_gate", "w_up", "w_down"):
        assert tuple(getattr(p_t.shared, n).shape) == p_j["shared"][n].shape
    for n, d_in in (("w_gate", cfg.d_model), ("w_down", cfg.moe_d_ff)):
        std = float(getattr(p_t, n).float().std())
        assert abs(std - d_in ** -0.5) < 0.05 * d_in ** -0.5
    assert p_t.routing_log is None
    assert tmoe.init_moe(torch.Generator().manual_seed(0),
                         cfg.scaled(n_shared_experts=0),
                         cfg.act_dtype).shared is None
