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
``d_ff`` one), and ``"mamba"`` blocks (no FFN), every modality (the
vlm's M-RoPE positions (B, 3, S) reach RoPE in every attention path)
and the ``train``, ``prefill`` and ``decode`` modes are ported.  The
``train`` mode allocates no cache; global attention there is the differentiable
q-chunked ``layers.causal_attend_chunked`` (the flash kernel has no
backward), and with ``cfg.remat`` (the default) each repeat of the
layer pattern runs under ``torch.utils.checkpoint`` (non-reentrant), as
the reference wraps its scan step in ``jax.checkpoint``: only the
repeat's input is kept, and its blocks run again in the backward pass.
Head and tail layers are not rematerialised, as in the reference.  The
MoE aux loss is summed over head, body and tail in every mode.
``cfg.attn_logit_softcap`` reaches every ``attn`` and ``attn_local``
attention path in every mode (the flash kernel's softcapped instance in
a global prefill), as the reference's ``_attn_apply`` passes it;
``mla`` blocks ignore it, as the reference's ``mla_attention`` does.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .config import ArchConfig
from .layers import (MLP, Attention, apply_rope, causal_attend,
                     causal_attend_chunked, decode_attend, frozen,
                     init_attention, init_mlp, kv_heads_for, linear,
                     local_attend_chunked, mlp, rmsnorm, write_slots)
from .mla import MLA, init_mla, mla_attention
from .moe import MoE, init_moe, moe_ffn
from .rglru import RGLRU, init_rglru, rglru_mixer
from .shard_ctx import constrain, relayout, view_as
from .ssm import Mamba, init_mamba, mamba_mixer

Tensor = torch.Tensor
Cache = dict

KINDS = ("attn", "attn_local", "mla", "mamba", "rglru")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a block kind or modality the zoo does not
    have, as the reference does."""
    for kind in cfg.layer_pattern:
        if kind not in KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
    if cfg.modality not in ("text", "vlm", "audio"):
        raise ValueError(f"{cfg.name}: unknown modality {cfg.modality!r}")


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
        raise ValueError(f"unknown block kind {kind!r}")
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
    """Attention sublayer; in prefill and decode it writes this layer's
    k and v into ``cache`` (a rolling window-sized buffer for
    ``attn_local``); train keeps no cache."""
    B, S, _ = x.shape
    H, Hk, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    ap = p.attn
    local = kind == "attn_local"
    cap = cfg.attn_logit_softcap
    theta = (cfg.rope_theta_local
             if local and cfg.rope_theta_local else cfg.rope_theta)
    q = view_as(linear(x, ap.wq), (B, S, H, Dh), "act_bthd")
    k = view_as(linear(x, ap.wk), (B, S, Hk, Dh), "kv_cache")
    v = view_as(linear(x, ap.wv), (B, S, Hk, Dh), "kv_cache")
    if cfg.qk_norm:
        q = rmsnorm(q, ap.q_norm)
        k = rmsnorm(k, ap.k_norm)
    q = apply_rope(q, positions, theta, cfg.rope_fraction,
                   cfg.mrope_sections)
    k = apply_rope(k, positions, theta, cfg.rope_fraction,
                   cfg.mrope_sections)
    q = constrain(q, "act_bthd")
    if mode in ("train", "prefill"):
        ka, va = kv_heads_for(q, k), kv_heads_for(q, v)
    if mode == "train":
        out = (local_attend_chunked(q, ka, va, cfg.window, softcap=cap)
               if local else causal_attend_chunked(q, ka, va, softcap=cap))
    elif mode == "prefill" and local:
        W = cfg.window
        out = local_attend_chunked(q, ka, va, W, softcap=cap)
        # the rolling cache holds the last W positions p at slot p % W;
        # with S < W the other slots are zero, as in the reference
        take = min(S, W)
        for name, t in (("k", k), ("v", v)):
            if take < W:
                cache[name].zero_()
            write_slots(cache[name], t[:, S - take:].to(cache[name].dtype),
                        (S - take) % W)
    elif mode == "prefill":
        out = causal_attend(q, ka, va, softcap=cap)
        write_slots(cache["k"], constrain(k, "kv_cache"), 0)
        write_slots(cache["v"], constrain(v, "kv_cache"), 0)
    elif mode == "decode":
        slot = cache_index % cfg.window if local else cache_index
        write_slots(cache["k"], k, slot)
        write_slots(cache["v"], v, slot)
        out = decode_attend(
            q, kv_heads_for(q, constrain(cache["k"], "kv_cache")),
            kv_heads_for(q, constrain(cache["v"], "kv_cache")), cache_index,
            window=cfg.window if local else 0, rolling=local, softcap=cap)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return linear(out.reshape(B, S, H * Dh), ap.wo)


def apply_block(cfg: ArchConfig, kind: str, use_moe: bool,
                p: Union[Block, MambaBlock, RGLRUBlock], x: Tensor,
                positions: Tensor, mode: str, cache: Optional[Cache],
                cache_index: Union[int, Tensor],
                mla_absorbed: bool = False
                ) -> Tuple[Tensor, Optional[Tensor]]:
    """Pre-norm residual block. Returns (x, the MoE aux loss, or None
    for a block without an MoE FFN)."""
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    h = rmsnorm(x, p.ln1)
    if kind == "mamba":
        return constrain(x + mamba_mixer(cfg, p.mixer, h, mode, cache),
                         "act_btd"), None
    if kind == "rglru":
        x = x + rglru_mixer(cfg, p.mixer, h, mode, cache)
    elif kind == "mla":
        x = x + mla_attention(cfg, p.attn, h, positions, mode, cache,
                              cache_index, absorbed=mla_absorbed)
    else:
        x = x + _attn_apply(cfg, kind, p, h, positions, mode, cache,
                            cache_index)
    # on a mesh the residual is laid out as a block's output (its sum
    # with a row-parallel output reduced), before the norm reads it
    x = relayout(x, "act_btd")
    h = rmsnorm(x, p.ln2)
    if use_moe:
        f, aux = moe_ffn(cfg, p.ffn, h)
        return constrain(x + f, "act_btd"), aux
    return constrain(x + mlp(p.ffn, h, cfg.act), "act_btd"), None


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
                  mla_absorbed: bool = False
                  ) -> Tuple[Tensor, Optional[Cache], Tensor]:
    """Returns (hidden (B,S,d), cache, the MoE aux loss summed over
    layers as a 0-d fp32 tensor).  ``train`` takes and returns no cache;
    ``prefill`` without a cache allocates one of S slots, as the
    reference returns; ``decode`` needs the cache.  ``mla_absorbed``
    picks the absorbed decode of ``mla`` blocks."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    head, n_body, pattern, tail = _layer_plan(cfg)
    train = mode == "train"
    if train:
        if cache is not None:
            raise ValueError("the train mode keeps no cache")
    elif cache is None:
        if mode == "decode":
            raise ValueError("decode needs the cache that prefill filled")
        cache = init_cache(cfg, x.shape[0], x.shape[1], x.dtype, x.device)

    moe = _uses_moe(cfg)
    P = len(pattern)
    # the input laid out as every block's output is: split by batch.  A
    # vocab-parallel table whose d is ZeRO-split over data gives an
    # embedding split over d there; DTensor carries that through the
    # first block (the norm, the projections' partial sums) into a
    # backward pass whose attention-output gradient arrives Partial over
    # data and is gathered whole (one site more than the reference has)
    x = constrain(x, "act_btd")

    def run(kind, use_moe, block, c, x):
        return apply_block(cfg, kind, use_moe, block, x, positions, mode, c,
                           cache_index, mla_absorbed)

    def repeat(x, r):
        """Repeat r of the pattern: (x, its summed aux loss or None)."""
        aux = None
        for p, kind in enumerate(pattern):
            c = (None if train else
                 {n: t[r] for n, t in cache["body"][f"pos{p}"].items()})
            x, a = run(kind, moe, dec.body[r * P + p], c, x)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    auxs = []
    for i, kind in enumerate(head):  # dense FFN even in MoE configs
        x, a = run(kind, False, dec.head[i],
                   None if train else cache["head"][i], x)
        auxs.append(a)
    for r in range(n_body):
        if train and cfg.remat:
            x, a = checkpoint(repeat, x, r, use_reentrant=False)
        else:
            x, a = repeat(x, r)
        auxs.append(a)
    for i, kind in enumerate(tail):
        x, a = run(kind, moe, dec.tail[i],
                   None if train else cache["tail"][i], x)
        auxs.append(a)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in auxs:
        if a is not None:
            aux_total = aux_total + a
    return rmsnorm(x, dec.final_norm), (None if train else cache), aux_total
