"""Decoder assembly: blocks, the repeating layer pattern, caches.

Counterpart of ``repro/models/transformer.py``.  Layer layout is the
reference's: ``first_dense`` head layers, then floor((L - first_dense)/P)
repetitions of the ``layer_pattern``, then the remainder layers from the
pattern prefix.  Where the reference stacks the repeated layers and
runs one ``lax.scan`` over them, the port keeps one ``Block`` per layer
in an ``nn.ModuleList`` and runs a Python loop.

Block kinds and their caches (the reference's layout):
    attn        {"k", "v"}: (B, C, Hk, Dh)
    attn_local  {"k", "v"}: (B, window, Hk, Dh), a rolling buffer
    mla         {"ckv": (B, C, kv_lora), "kr": (B, C, qk_rope_dim)}
    mamba       {"conv": (B, k-1, d_inner), "h": (B, d_inner, n) fp32}
    rglru       {"conv": (B, k-1, w), "h": (B, w) fp32}
stacked over the repeats in ``{"head": [...], "body": {"pos{p}": ...},
"tail": [...]}``.  The port updates the cache in place: prefill writes
slots [0, S) of an attention or latent cache, the last min(S, window)
positions p of a rolling cache at slots p % window, and the final state
of a recurrent cache; decode writes slot ``cache_index`` (``cache_index %
window`` when rolling) or advances the state, and both return the same
dict.  That keeps one cache of ``prompt_len + new_tokens`` slots for a
whole request, where the reference builds new arrays each step.

``"attn"`` and ``"attn_local"`` blocks (with qk-norm and a local RoPE
theta where the config sets them), ``"mla"`` blocks (``mla.py``, naive
or absorbed decode) and ``"rglru"`` blocks, each with a dense or an MoE
FFN (``moe.py``; the ``first_dense`` head layers keep the dense
``d_ff`` one), and ``"mamba"`` blocks (no FFN), text inputs and the
``prefill`` and ``decode`` modes are ported.  The MoE aux loss belongs
to training and is not summed.  Softcapping, M-RoPE, the vlm and audio
modalities and the ``train`` mode raise ``NotImplementedError``
(ROADMAP.md queue 1, item 10).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from .config import ArchConfig
from .layers import (MLP, Attention, _TODO, apply_rope, causal_attend,
                     decode_attend, frozen, init_attention, init_mlp,
                     local_attend_chunked, mlp, rmsnorm)
from .mla import MLA, init_mla, mla_attention
from .moe import MoE, init_moe, moe_ffn
from .rglru import RGLRU, init_rglru, rglru_mixer
from .ssm import Mamba, init_mamba, mamba_mixer

Tensor = torch.Tensor
Cache = dict

KINDS = ("attn", "attn_local", "mla", "mamba", "rglru")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what of ``cfg`` the port does not run yet."""
    for kind in cfg.layer_pattern:
        if kind not in KINDS:
            raise NotImplementedError(f"{cfg.name}: {kind!r} blocks are "
                                      f"{_TODO}")
    if cfg.modality != "text":
        raise NotImplementedError(f"{cfg.name}: the {cfg.modality!r} "
                                  f"modality is {_TODO}")
    if cfg.attn_logit_softcap or cfg.mrope_sections:
        raise NotImplementedError(f"{cfg.name}: softcap and M-RoPE are "
                                  f"{_TODO}")


# ------------------------------------------------------------------ blocks

class Block(nn.Module):
    """Pre-norm residual block: ln1, attn, ln2, ffn (``attn`` and
    ``attn_local`` with an ``Attention``, ``mla`` with an ``MLA``; the
    ffn an ``MLP`` or an ``MoE``)."""

    def __init__(self, ln1: Tensor, attn: Union[Attention, MLA], ln2: Tensor,
                 ffn: Union[MLP, MoE]):
        super().__init__()
        self.ln1 = frozen(ln1)
        self.attn = attn
        self.ln2 = frozen(ln2)
        self.ffn = ffn


class RGLRUBlock(nn.Module):
    """Pre-norm residual recurrent block: ln1, mixer, ln2, ffn (unlike
    a mamba block it has an FFN)."""

    def __init__(self, ln1: Tensor, mixer: RGLRU, ln2: Tensor,
                 ffn: Union[MLP, MoE]):
        super().__init__()
        self.ln1 = frozen(ln1)
        self.mixer = mixer
        self.ln2 = frozen(ln2)
        self.ffn = ffn


class MambaBlock(nn.Module):
    """Pre-norm residual mamba block: ln1, mixer (no ln2, no FFN)."""

    def __init__(self, ln1: Tensor, mixer: Mamba):
        super().__init__()
        self.ln1 = frozen(ln1)
        self.mixer = mixer


def init_block(generator: torch.Generator, cfg: ArchConfig, kind: str,
               use_moe: bool, dense_ff: Optional[int] = None,
               device=None) -> Union[Block, MambaBlock, RGLRUBlock]:
    if kind not in KINDS:
        raise NotImplementedError(f"{kind!r} blocks are {_TODO}")
    dtype, d = cfg.act_dtype, cfg.d_model
    ones = torch.ones(d, dtype=dtype, device=device)
    if kind == "mamba":  # no FFN, as in the reference
        return MambaBlock(ones, init_mamba(generator, cfg, dtype, device))
    init_mixer = {"rglru": init_rglru, "mla": init_mla}.get(kind,
                                                            init_attention)
    mixer = init_mixer(generator, cfg, dtype, device)
    ffn = (init_moe(generator, cfg, dtype, device) if use_moe else
           init_mlp(generator, d, dense_ff or cfg.d_ff, dtype, device))
    return (RGLRUBlock if kind == "rglru" else Block)(ones, mixer,
                                                      ones.clone(), ffn)


def _attn_apply(cfg: ArchConfig, kind: str, p: Block, x: Tensor,
                positions: Tensor, mode: str, cache: Cache,
                cache_index: Union[int, Tensor]) -> Tensor:
    """Attention sublayer; writes this layer's k and v into ``cache``
    (a rolling window-sized buffer for ``attn_local``)."""
    B, S, _ = x.shape
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    ap = p.attn
    local = kind == "attn_local"
    theta = (cfg.rope_theta_local
             if local and cfg.rope_theta_local else cfg.rope_theta)
    q = (x @ ap.wq).reshape(B, S, H, Dh)
    k = (x @ ap.wk).reshape(B, S, Hk, Dh)
    v = (x @ ap.wv).reshape(B, S, Hk, Dh)
    if cfg.qk_norm:
        q = rmsnorm(q, ap.q_norm)
        k = rmsnorm(k, ap.k_norm)
    q = apply_rope(q, positions, theta, cfg.rope_fraction)
    k = apply_rope(k, positions, theta, cfg.rope_fraction)
    if mode == "prefill" and local:
        W = cfg.window
        out = local_attend_chunked(q, k, v, W)
        # the rolling cache holds the last W positions p at slot p % W;
        # with S < W the other slots are zero, as in the reference
        take = min(S, W)
        slots = torch.arange(S - take, S, device=x.device) % W
        for name, t in (("k", k), ("v", v)):
            if take < W:
                cache[name].zero_()
            cache[name].index_copy_(1, slots,
                                    t[:, S - take:].to(cache[name].dtype))
    elif mode == "prefill":
        out = causal_attend(q, k, v)
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    elif mode == "decode":
        slot = cache_index % cfg.window if local else cache_index
        cache["k"][:, slot:slot + S] = k
        cache["v"][:, slot:slot + S] = v
        out = decode_attend(q, cache["k"], cache["v"], cache_index,
                            window=cfg.window if local else 0,
                            rolling=local)
    else:
        raise NotImplementedError(f"mode {mode!r} is {_TODO}")
    return out.reshape(B, S, H * Dh) @ ap.wo


def apply_block(cfg: ArchConfig, kind: str, use_moe: bool,
                p: Union[Block, MambaBlock, RGLRUBlock], x: Tensor,
                positions: Tensor, mode: str, cache: Cache,
                cache_index: Union[int, Tensor],
                mla_absorbed: bool = False) -> Tensor:
    """Pre-norm residual block. Returns the new x (the MoE aux loss,
    which the reference also returns, belongs to training)."""
    if kind not in KINDS:
        raise NotImplementedError(f"{kind!r} blocks are {_TODO}")
    h = rmsnorm(x, p.ln1)
    if kind == "mamba":
        return x + mamba_mixer(cfg, p.mixer, h, mode, cache)
    if kind == "rglru":
        x = x + rglru_mixer(cfg, p.mixer, h, mode, cache)
    elif kind == "mla":
        x = x + mla_attention(cfg, p.attn, h, positions, mode, cache,
                              cache_index, absorbed=mla_absorbed)
    else:
        x = x + _attn_apply(cfg, kind, p, h, positions, mode, cache,
                            cache_index)
    h = rmsnorm(x, p.ln2)
    return x + (moe_ffn(cfg, p.ffn, h)[0] if use_moe else
                mlp(p.ffn, h, cfg.act))


# ----------------------------------------------------------- decoder stack

def _layer_plan(cfg: ArchConfig):
    """(head_kinds, n_body, pattern, tail_kinds)."""
    P = len(cfg.layer_pattern)
    fd = cfg.first_dense
    L_rest = cfg.n_layers - fd
    n_body = L_rest // P
    tail = cfg.layer_pattern[:L_rest % P]
    head = tuple(cfg.layer_pattern[i % P] for i in range(fd))
    return head, n_body, cfg.layer_pattern, tail


def _uses_moe(cfg: ArchConfig) -> bool:
    return cfg.n_experts > 0


class Decoder(nn.Module):
    """Blocks in layer order: ``head``, ``body`` (repeat r, pattern
    position p at index r * P + p), ``tail``; then ``final_norm``."""

    def __init__(self, head: list, body: list, tail: list,
                 final_norm: Tensor):
        super().__init__()
        self.head = nn.ModuleList(head)
        self.body = nn.ModuleList(body)
        self.tail = nn.ModuleList(tail)
        self.final_norm = frozen(final_norm)


def init_decoder(cfg: ArchConfig, generator: torch.Generator,
                 device=None) -> Decoder:
    """The ``first_dense`` head layers take the dense ``d_ff`` FFN (
    DeepSeek's dense lead-in); body and tail layers an MoE where
    ``cfg.n_experts > 0``."""
    check_supported(cfg)
    head, n_body, pattern, tail = _layer_plan(cfg)
    moe = _uses_moe(cfg)
    return Decoder(
        [init_block(generator, cfg, kind, False, cfg.d_ff, device)
         for kind in head],
        [init_block(generator, cfg, kind, moe, cfg.d_ff, device)
         for _ in range(n_body) for kind in pattern],
        [init_block(generator, cfg, kind, moe, cfg.d_ff, device)
         for kind in tail],
        torch.ones(cfg.d_model, dtype=cfg.act_dtype, device=device))


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, device=None) -> Cache:
    """Zero-filled cache matching the decoder layout."""
    check_supported(cfg)
    dtype = dtype or cfg.act_dtype
    head, n_body, pattern, tail = _layer_plan(cfg)

    def zeros(kind, *lead):
        if kind in ("mamba", "rglru"):
            k, w, state = ((cfg.ssm_conv, cfg.ssm_d_inner, (cfg.ssm_state,))
                           if kind == "mamba" else
                           (cfg.ssm_conv or 4, cfg.lru_width_, ()))
            return {"conv": torch.zeros(lead + (batch, k - 1, w),
                                        dtype=dtype, device=device),
                    "h": torch.zeros(lead + (batch, w) + state,
                                     dtype=torch.float32, device=device)}
        if kind == "mla":
            return {n: torch.zeros(lead + (batch, max_len, w), dtype=dtype,
                                   device=device)
                    for n, w in (("ckv", cfg.kv_lora),
                                 ("kr", cfg.qk_rope_dim))}
        # a rolling buffer is window-sized whatever max_len is (prefill
        # fills slot p % window even when max_len < window)
        slots = cfg.window if kind == "attn_local" else max_len
        shape = lead + (batch, slots, cfg.n_kv_heads, cfg.head_dim_)
        return {n: torch.zeros(shape, dtype=dtype, device=device)
                for n in ("k", "v")}

    return {"head": [zeros(kind) for kind in head],
            "body": {f"pos{i}": zeros(kind, n_body)
                     for i, kind in enumerate(pattern)},
            "tail": [zeros(kind) for kind in tail]}


def apply_decoder(cfg: ArchConfig, dec: Decoder, x: Tensor,
                  positions: Tensor, mode: str, cache: Optional[Cache] = None,
                  cache_index: Union[int, Tensor] = 0,
                  mla_absorbed: bool = False) -> Tuple[Tensor, Cache]:
    """Returns (hidden (B,S,d), cache).  ``prefill`` without a cache
    allocates one of S slots, as the reference returns; ``decode`` needs
    the cache.  ``mla_absorbed`` picks the absorbed decode of ``mla``
    blocks."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r} is {_TODO}")
    head, n_body, pattern, tail = _layer_plan(cfg)
    if cache is None:
        if mode == "decode":
            raise ValueError("decode needs the cache that prefill filled")
        cache = init_cache(cfg, x.shape[0], x.shape[1], x.dtype, x.device)

    moe = _uses_moe(cfg)

    def run(kind, use_moe, block, c, x):
        return apply_block(cfg, kind, use_moe, block, x, positions, mode, c,
                           cache_index, mla_absorbed)

    for i, kind in enumerate(head):  # dense FFN even in MoE configs
        x = run(kind, False, dec.head[i], cache["head"][i], x)
    P = len(pattern)
    for r in range(n_body):
        for p, kind in enumerate(pattern):
            c = {n: t[r] for n, t in cache["body"][f"pos{p}"].items()}
            x = run(kind, moe, dec.body[r * P + p], c, x)
    for i, kind in enumerate(tail):
        x = run(kind, moe, dec.tail[i], cache["tail"][i], x)
    return rmsnorm(x, dec.final_norm), cache
