"""Multi-head latent attention (DeepSeek-V2/V3).

Counterpart of ``repro/models/mla.py``.  Queries and keys/values come
through low-rank bottlenecks; the cache keeps only the compressed,
normed latent c_kv (kv_lora dims) and the shared rotary key k_rope:
{"ckv": (B, C, kv_lora), "kr": (B, C, qk_rope_dim)}.  Prefill writes
slots [0, S) in place and decode writes slot ``cache_index``, as the
port's other caches are written.

Prefill expands k and v from the latent and runs causal attention over
q = [q_nope, q_rope] and k = [k_nope, k_rope broadcast over the heads]
(width qk_nope + qk_rope) with v of width v_head_dim, through the flash
kernel (``layers.causal_attend``), as the reference folds the rotary key
in as extra head dims.  The ``train`` mode builds the same q and k and
runs them through the differentiable q-chunked attention
(``layers.causal_attend_chunked``) at the same scale, and keeps no
cache.  Decode has the reference's two paths, in plain
torch with fp32 scores (its ``preferred_element_type=f32`` einsums):

  * naive: expand k and v from the cached latent every step;
  * absorbed: fold W_uk into the query and W_uv into the output, so the
    scores and the context are taken in the latent space.

No path here reads ``cfg.attn_logit_softcap``: the reference's
``mla_attention`` never applies it, so a latent-attention config that
sets it computes the logits uncapped, as there.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from .config import ArchConfig
from .layers import (_NEG_INF, apply_rope, causal_attend,
                     causal_attend_chunked, frozen, init_dense, matmul,
                     on_batch_heads, rmsnorm, write_slots)
from .shard_ctx import constrain, view_as

Tensor = torch.Tensor

_KV_LEAVES = ("w_dkv", "kv_norm", "w_uk", "w_uv", "w_kr", "w_o")


def leaves(cfg: ArchConfig) -> Tuple[str, ...]:
    """The reference's leaf names for ``cfg``: w_dq, q_norm and w_uq
    with a query bottleneck (q_lora > 0), else w_q; then the kv path's."""
    return (("w_dq", "q_norm", "w_uq") if cfg.q_lora else ("w_q",)) \
        + _KV_LEAVES


class MLA(nn.Module):
    """Weights under the reference's names (``leaves``): w_dq (d,
    q_lora), q_norm (q_lora,), w_uq (q_lora, H (nope + rope)) or w_q (d,
    H (nope + rope)); w_dkv (d, kv_lora), kv_norm (kv_lora,), w_uk
    (kv_lora, H nope), w_uv (kv_lora, H v), w_kr (d, rope), w_o (H v,
    d)."""

    def __init__(self, **weights: Tensor):
        super().__init__()
        for name, w in weights.items():
            setattr(self, name, frozen(w))


def init_mla(generator: torch.Generator, cfg: ArchConfig,
             dtype: torch.dtype, device=None) -> MLA:
    """Dense weights N(0, 1/d_in), norm scales 1."""
    d, H = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim

    def dense(d_in, d_out):
        return init_dense(generator, d_in, d_out, dtype, device)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    q = ({"w_dq": dense(d, cfg.q_lora), "q_norm": ones(cfg.q_lora),
          "w_uq": dense(cfg.q_lora, H * qk)} if cfg.q_lora else
         {"w_q": dense(d, H * qk)})
    return MLA(**q, w_dkv=dense(d, cfg.kv_lora), kv_norm=ones(cfg.kv_lora),
               w_uk=dense(cfg.kv_lora, H * cfg.qk_nope_dim),
               w_uv=dense(cfg.kv_lora, H * cfg.v_head_dim),
               w_kr=dense(d, cfg.qk_rope_dim),
               w_o=dense(H * cfg.v_head_dim, d))


def _queries(cfg: ArchConfig, p: MLA, x: Tensor,
             positions: Tensor) -> Tuple[Tensor, Tensor]:
    """(q_nope (B, S, H, nope), roped q_rope (B, S, H, rope))."""
    B, S, _ = x.shape
    nope = cfg.qk_nope_dim
    if cfg.q_lora:
        q = matmul(rmsnorm(matmul(x, p.w_dq), p.q_norm), p.w_uq)
    else:
        q = matmul(x, p.w_q)
    q = view_as(q, (B, S, cfg.n_heads, nope + cfg.qk_rope_dim), "act_bthd")
    return q[..., :nope], apply_rope(q[..., nope:], positions,
                                     cfg.rope_theta)


def _latents(cfg: ArchConfig, p: MLA, x: Tensor,
             positions: Tensor) -> Tuple[Tensor, Tensor]:
    """The normed latent (B, S, kv_lora) and the roped shared key (B, S,
    rope)."""
    ckv = rmsnorm(matmul(x, p.w_dkv), p.kv_norm)
    kr = apply_rope(matmul(x, p.w_kr)[:, :, None, :], positions,
                    cfg.rope_theta)
    return ckv, kr[:, :, 0, :]


def mla_attention(cfg: ArchConfig, p: MLA, x: Tensor, positions: Tensor,
                  mode: str, cache: dict, cache_index: Union[int, Tensor],
                  absorbed: bool = False) -> Tensor:
    """x (B, S, d) -> attention output (B, S, d); in prefill and decode
    it writes this layer's latent and rotary key into ``cache`` (train
    keeps none: pass None)."""
    B, S, _ = x.shape
    H, nope, rope_d, vdim = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                             cfg.v_head_dim)
    scale = (nope + rope_d) ** -0.5
    q_nope, q_rope = _queries(cfg, p, x, positions)
    ckv_new, kr_new = _latents(cfg, p, x, positions)

    if mode in ("train", "prefill"):
        if mode == "prefill":
            write_slots(cache["ckv"], ckv_new, 0)
            write_slots(cache["kr"], kr_new, 0)
        k_nope = view_as(matmul(ckv_new, p.w_uk), (B, S, H, nope),
                         "act_bthd")
        v = view_as(matmul(ckv_new, p.w_uv), (B, S, H, vdim), "act_bthd")
        q_eff = torch.cat([q_nope, q_rope], dim=-1)
        k_eff = torch.cat([k_nope, kr_new[:, :, None, :].expand(
            B, S, H, rope_d)], dim=-1)
        attend = causal_attend_chunked if mode == "train" else causal_attend
        out = attend(q_eff, k_eff, v, scale=scale)
        return matmul(out.reshape(B, S, H * vdim), p.w_o)
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")

    write_slots(cache["ckv"], ckv_new, cache_index)
    write_slots(cache["kr"], kr_new, cache_index)
    ckv, kr = cache["ckv"], cache["kr"]
    Sc = ckv.shape[1]
    if not absorbed:
        k_nope = view_as(matmul(ckv, p.w_uk), (B, Sc, H, nope),
                         "act_bthd")
        values = view_as(matmul(ckv, p.w_uv), (B, Sc, H, vdim),
                         "act_bthd")
        out = on_batch_heads(
            lambda q, q_r, k, k_r, v: _naive_decode(q, q_r, k, k_r, v,
                                                    cache_index, scale),
            q_nope, q_rope, k_nope, kr, values)
        return matmul(out.reshape(B, S, H * vdim), p.w_o)
    valid = torch.arange(Sc, device=x.device) <= cache_index
    rope_scores = torch.einsum("bqhd,bkd->bhqk", q_rope.float(), kr.float())
    q_lat = torch.einsum("bqhn,chn->bqhc", q_nope,
                         view_as(p.w_uk, (cfg.kv_lora, H, nope), None))
    q_lat = constrain(q_lat, "act_bthd")
    scores = torch.einsum("bqhc,bkc->bhqk", q_lat.float(), ckv.float())
    logits = ((scores + rope_scores) * scale).masked_fill(~valid, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(ckv.dtype)
    ctx = torch.einsum("bhqk,bkc->bqhc", probs, ckv)  # latent context
    out = torch.einsum("bqhc,chv->bqhv", ctx,
                       view_as(p.w_uv, (cfg.kv_lora, H, vdim), None))
    return matmul(out.reshape(B, S, H * vdim), p.w_o)


def _naive_decode(q_nope: Tensor, q_rope: Tensor, k_nope: Tensor,
                  kr: Tensor, values: Tensor, cache_index: int,
                  scale: float) -> Tensor:
    """Naive latent decode attention over the expanded cache: q (B, 1,
    H, .), k_nope and values (B, Sc, H, .), the shared rotary key kr
    (B, Sc, rope); slots past ``cache_index`` masked -> (B, 1, H, v)."""
    valid = torch.arange(kr.shape[1], device=kr.device) <= cache_index
    rope_scores = torch.einsum("bqhd,bkd->bhqk", q_rope.float(), kr.float())
    scores = torch.einsum("bqhd,bkhd->bhqk", q_nope.float(),
                          k_nope.float())
    logits = ((scores + rope_scores) * scale).masked_fill(~valid, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(values.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, values)
