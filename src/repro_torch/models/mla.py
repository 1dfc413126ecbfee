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
in as extra head dims.  Decode has the reference's two paths, in plain
torch with fp32 scores (its ``preferred_element_type=f32`` einsums):

  * naive: expand k and v from the cached latent every step;
  * absorbed: fold W_uk into the query and W_uv into the output, so the
    scores and the context are taken in the latent space.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from .config import ArchConfig
from .layers import (_NEG_INF, _TODO, apply_rope, causal_attend, frozen,
                     init_dense, rmsnorm)

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
        q = rmsnorm(x @ p.w_dq, p.q_norm) @ p.w_uq
    else:
        q = x @ p.w_q
    q = q.reshape(B, S, cfg.n_heads, nope + cfg.qk_rope_dim)
    return q[..., :nope], apply_rope(q[..., nope:], positions,
                                     cfg.rope_theta)


def _latents(cfg: ArchConfig, p: MLA, x: Tensor,
             positions: Tensor) -> Tuple[Tensor, Tensor]:
    """The normed latent (B, S, kv_lora) and the roped shared key (B, S,
    rope)."""
    ckv = rmsnorm(x @ p.w_dkv, p.kv_norm)
    kr = apply_rope((x @ p.w_kr)[:, :, None, :], positions, cfg.rope_theta)
    return ckv, kr[:, :, 0, :]


def mla_attention(cfg: ArchConfig, p: MLA, x: Tensor, positions: Tensor,
                  mode: str, cache: dict, cache_index: Union[int, Tensor],
                  absorbed: bool = False) -> Tensor:
    """x (B, S, d) -> attention output (B, S, d); writes this layer's
    latent and rotary key into ``cache``."""
    B, S, _ = x.shape
    H, nope, rope_d, vdim = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                             cfg.v_head_dim)
    scale = (nope + rope_d) ** -0.5
    q_nope, q_rope = _queries(cfg, p, x, positions)
    ckv_new, kr_new = _latents(cfg, p, x, positions)

    if mode == "prefill":
        cache["ckv"][:, :S] = ckv_new
        cache["kr"][:, :S] = kr_new
        k_nope = (ckv_new @ p.w_uk).reshape(B, S, H, nope)
        v = (ckv_new @ p.w_uv).reshape(B, S, H, vdim)
        q_eff = torch.cat([q_nope, q_rope], dim=-1)
        k_eff = torch.cat([k_nope, kr_new[:, :, None, :].expand(
            B, S, H, rope_d)], dim=-1)
        out = causal_attend(q_eff, k_eff, v, scale=scale)
        return out.reshape(B, S, H * vdim) @ p.w_o
    if mode != "decode":
        raise NotImplementedError(f"mode {mode!r} is {_TODO}")

    cache["ckv"][:, cache_index:cache_index + S] = ckv_new
    cache["kr"][:, cache_index:cache_index + S] = kr_new
    ckv, kr = cache["ckv"], cache["kr"]
    Sc = ckv.shape[1]
    valid = torch.arange(Sc, device=x.device) <= cache_index
    rope_scores = torch.einsum("bqhd,bkd->bhqk", q_rope.float(), kr.float())
    if absorbed:
        q_lat = torch.einsum("bqhn,chn->bqhc", q_nope,
                             p.w_uk.reshape(cfg.kv_lora, H, nope))
        scores = torch.einsum("bqhc,bkc->bhqk", q_lat.float(), ckv.float())
        values = ckv
    else:
        k_nope = (ckv @ p.w_uk).reshape(B, Sc, H, nope)
        values = (ckv @ p.w_uv).reshape(B, Sc, H, vdim)
        scores = torch.einsum("bqhd,bkhd->bhqk", q_nope.float(),
                              k_nope.float())
    logits = ((scores + rope_scores) * scale).masked_fill(~valid, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(values.dtype)
    if absorbed:
        ctx = torch.einsum("bhqk,bkc->bqhc", probs, values)  # latent context
        out = torch.einsum("bqhc,chv->bqhv", ctx,
                           p.w_uv.reshape(cfg.kv_lora, H, vdim))
    else:
        out = torch.einsum("bhqk,bkhd->bqhd", probs, values)
    return out.reshape(B, S, H * vdim) @ p.w_o
