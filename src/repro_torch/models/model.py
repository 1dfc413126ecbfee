"""Model-level API for text decoders: embeddings, the LM head, and the
prefill / decode step functions the serving driver calls.

Counterpart of ``repro/models/model.py`` for the text modality and the
serving path (attention, sliding-window attention, mamba and RG-LRU
decoders).  The model is an ``nn.Module`` (``Model``) holding the
decoder, the embedding table and the LM head, with no gradients
tracked; the steps run under ``torch.no_grad``.  Training, the FEEL
integration and the vlm/audio modalities are not ported yet
(ROADMAP.md queue 1, item 10).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .config import ArchConfig
from . import rglru, ssm
from .layers import MLP, Attention, _TODO, frozen, init_dense
from .transformer import (Block, Cache, Decoder, MambaBlock, RGLRUBlock,
                          _layer_plan, apply_decoder, check_supported,
                          init_cache, init_decoder)

Tensor = torch.Tensor


class Model(nn.Module):
    """decoder, embed (vocab, d) and lm_head (d, vocab; absent when the
    embeddings are tied)."""

    def __init__(self, decoder: Decoder, embed: Tensor,
                 lm_head: Optional[Tensor] = None):
        super().__init__()
        self.decoder = decoder
        self.embed = frozen(embed)
        self.lm_head = None if lm_head is None else frozen(lm_head)


# ---------------------------------------------------------------- params

def init_model(cfg: ArchConfig, generator: torch.Generator,
               device=None) -> Model:
    """Random weights with the reference's distributions, drawn on
    ``device`` (the generator's device) tensor by tensor, so full-size
    weights never pass through the host."""
    check_supported(cfg)
    dtype = cfg.act_dtype
    decoder = init_decoder(cfg, generator, device)
    embed = (torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                         device=device, dtype=torch.float32)
             * cfg.d_model ** -0.5).to(dtype)
    lm_head = (None if cfg.tie_embeddings else
               init_dense(generator, cfg.d_model, cfg.vocab, dtype, device))
    return Model(decoder, embed, lm_head)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _tensor(a, dtype: torch.dtype, device) -> Tensor:
    # via float32: exact for the bf16 and fp32 arrays of the reference
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(
        device=device, dtype=dtype)


def params_from_numpy(cfg: ArchConfig, tree: Mapping,
                      device=None) -> Model:
    """The reference's ``init_model`` pytree (as numpy arrays) -> the
    port's ``Model``.

    Dense weights keep the reference's (d_in, d_out) layout (the port
    applies them as ``x @ w``), so nothing is transposed.  The scan axis
    of ``tree["decoder"]["body"]["pos{p}"]`` is unstacked into one
    ``Block`` per layer, repeat r and pattern position p at
    ``decoder.body[r * P + p]``.  Values are carried exactly, in
    ``cfg.act_dtype``, except the mixers' float32 leaves
    (``ssm.FP32_LEAVES``, ``rglru.FP32_LEAVES``), which stay float32 as
    in the reference.
    """
    check_supported(cfg)
    dtype = cfg.act_dtype

    def t(a, dt=dtype):
        return _tensor(a, dt, device)

    def mixer(cls, fp32, m):
        return cls(**{n: t(m[n], torch.float32 if n in fp32 else dtype)
                      for n in cls.LEAVES})

    def block(kind, p):
        if kind == "mamba":
            return MambaBlock(t(p["ln1"]), mixer(ssm.Mamba, ssm.FP32_LEAVES,
                                                 p["mixer"]))
        f = p["ffn"]
        ffn = MLP(t(f["w_gate"]), t(f["w_up"]), t(f["w_down"]))
        if kind == "rglru":
            return RGLRUBlock(t(p["ln1"]), mixer(rglru.RGLRU,
                                                 rglru.FP32_LEAVES,
                                                 p["mixer"]),
                              t(p["ln2"]), ffn)
        a = p["attn"]
        norms = [t(a["q_norm"]), t(a["k_norm"])] if cfg.qk_norm else []
        return Block(t(p["ln1"]),
                     Attention(t(a["wq"]), t(a["wk"]), t(a["wv"]),
                               t(a["wo"]), *norms),
                     t(p["ln2"]), ffn)

    dec = tree["decoder"]
    head, n_body, pattern, tail = _layer_plan(cfg)
    body = []
    for r in range(n_body):
        for p, kind in enumerate(pattern):
            stacked = dec["body"][f"pos{p}"]
            body.append(block(kind, _index(stacked, r)))
    decoder = Decoder([block(k, p) for k, p in zip(head, dec["head"])], body,
                      [block(k, p) for k, p in zip(tail, dec["tail"])],
                      t(dec["final_norm"]))
    return Model(decoder, t(tree["embed"]),
                 None if cfg.tie_embeddings else t(tree["lm_head"]))


def _index(tree, r: int):
    """Slice r of every leaf of a nested dict of stacked arrays."""
    if isinstance(tree, Mapping):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


# ------------------------------------------------------------ embeddings

def embed_input(cfg: ArchConfig, model: Model,
                batch: Dict[str, Tensor]) -> Tensor:
    if cfg.modality != "text":
        raise NotImplementedError(f"the {cfg.modality!r} modality is {_TODO}")
    return model.embed[batch["tokens"]].to(cfg.act_dtype)


def _positions(cfg: ArchConfig, B: int, S: int, offset: int = 0,
               device=None) -> Tensor:
    pos = offset + torch.arange(S, device=device)
    return pos[None, :].expand(B, S)


def unembed(cfg: ArchConfig, model: Model, hidden: Tensor) -> Tensor:
    """Logits in fp32.  The untied head multiplies in the activation
    dtype and casts afterwards, as the reference does (greedy ties
    depend on it)."""
    if cfg.tie_embeddings:
        return hidden.float() @ model.embed.float().T
    return (hidden @ model.lm_head).float()


# ------------------------------------------------------------ step fns

def make_prefill_step(cfg: ArchConfig) -> Callable:
    """prefill_step(model, batch, cache=None) -> (last-position logits
    (B, 1, V), cache).  With a cache (of at least S slots) prefill fills
    its slots [0, S) in place; without one it returns a new S-slot
    cache, as the reference does."""

    @torch.no_grad()
    def prefill_step(model: Model, batch: Dict[str, Tensor],
                     cache: Optional[Cache] = None) -> Tuple[Tensor, Cache]:
        x = embed_input(cfg, model, batch)
        B, S = x.shape[:2]
        pos = _positions(cfg, B, S, device=x.device)
        hidden, cache = apply_decoder(cfg, model.decoder, x, pos,
                                      mode="prefill", cache=cache)
        return unembed(cfg, model, hidden[:, -1:]), cache

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """decode_step(model, cache, batch) -> (logits (B, 1, V), cache): one
    new token per sequence at position ``batch["cache_index"]`` (an int),
    written into the cache in place."""

    @torch.no_grad()
    def decode_step(model: Model, cache: Cache,
                    batch: Dict[str, Tensor]) -> Tuple[Tensor, Cache]:
        x = embed_input(cfg, model, batch)
        idx = int(batch["cache_index"])
        pos = _positions(cfg, x.shape[0], 1, offset=idx, device=x.device)
        hidden, cache = apply_decoder(cfg, model.decoder, x, pos,
                                      mode="decode", cache=cache,
                                      cache_index=idx)
        return unembed(cfg, model, hidden), cache

    return decode_step


make_cache = init_cache  # re-export with the model-level name
