"""Shared neural-net layers: RMSNorm, 1-D RoPE, gated MLP, and GQA
attention with the global causal (prefill), sliding-window (prefill) and
cached-decode (full or rolling) paths.

Counterpart of ``repro/models/layers.py`` for what the port's serving
path runs.  Parameters live in ``nn.Module`` containers whose attribute
names are the reference's dict keys; dense weights keep the reference's
(d_in, d_out) layout and are applied as ``x @ w``.  The apply functions
are plain tensor functions that take those modules, as the reference's
take dict pytrees.

Global prefill attention goes through the hand-written flash-attention
kernel (``kernels.ops.flash_attention_bhsd``), the route the reference
keeps for hot paths on its chip.  Sliding-window prefill
(``local_attend_chunked``) and decode attention stay plain torch, as the
reference computes them with einsums outside any kernel (its Pallas
flash kernel takes no window).  Logit softcapping and M-RoPE are not
ported yet (ROADMAP.md queue 1, item 10) and raise.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .config import ArchConfig

Tensor = torch.Tensor

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
_TODO = "not ported yet (ROADMAP.md queue 1, item 10)"


def frozen(t: Tensor) -> nn.Parameter:
    """A parameter of the inference port: no gradient is tracked."""
    return nn.Parameter(t, requires_grad=False)


# ------------------------------------------------------------------ norms

def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """Computed in fp32 and cast back to the input dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def init_normal(generator: torch.Generator, shape: Tuple[int, ...],
                std: float, dtype: torch.dtype, device=None) -> Tensor:
    """N(0, std^2) draws in fp32, cast to ``dtype``.  A tensor of more
    than 2^28 values is drawn in blocks of leading rows of at most that
    many (1 GiB of fp32), so a full-size matrix never has an fp32 copy
    of itself on the card (command-r's untied head would take 7.8 GiB);
    a smaller one is one draw."""
    out = torch.empty(shape, dtype=dtype, device=device)
    row = math.prod(shape[1:])
    step = max(1, (1 << 28) // max(row, 1))
    for i in range(0, shape[0], step):
        n = min(step, shape[0] - i)
        out[i:i + n] = torch.randn((n,) + tuple(shape[1:]),
                                   generator=generator, device=device,
                                   dtype=torch.float32).mul_(std)
    return out


def init_dense(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device=None) -> Tensor:
    """(d_in, d_out) normal draws scaled by d_in^-0.5, drawn in fp32."""
    return init_normal(generator, (d_in, d_out), d_in ** -0.5, dtype, device)


# ------------------------------------------------------------------- rope

def _rope_cos_sin(positions: Tensor, n_pairs: int, theta: float,
                  mrope_sections: Tuple[int, ...] = ()
                  ) -> Tuple[Tensor, Tensor]:
    """cos/sin tables for positions (B, S): (B, S, n_pairs) float32.

    The frequencies theta^(-i/n_pairs) are raised in float64 and rounded
    to float32, so every device gets the same table; the angles and
    their cos/sin are float32, as in the reference."""
    if positions.dim() != 2 or mrope_sections:
        raise NotImplementedError(f"M-RoPE is {_TODO}")
    expo = -torch.arange(n_pairs, dtype=torch.float32,
                         device=positions.device) / n_pairs
    freqs = torch.pow(float(theta), expo.double()).float()
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, positions: Tensor, theta: float,
               fraction: float = 1.0,
               mrope_sections: Tuple[int, ...] = ()) -> Tensor:
    """x: (B, S, H, Dh). Rotates the first ``fraction * Dh`` dims, the
    first half of them against the second half (rotate-half pairing)."""
    d = x.shape[-1]
    d_rot = int(d * fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    n_pairs = d_rot // 2
    cos, sin = _rope_cos_sin(positions, n_pairs, theta, mrope_sections)
    cos = cos[:, :, None, :]  # (B, S, 1, n_pairs)
    sin = sin[:, :, None, :]
    x1f = x[..., :n_pairs].float()
    x2f = x[..., n_pairs:d_rot].float()
    out = torch.cat([x1f * cos - x2f * sin,
                     x2f * cos + x1f * sin], dim=-1).to(x.dtype)
    return torch.cat([out, x[..., d_rot:]], dim=-1) if d - d_rot else out


# ------------------------------------------------------------------- mlp

class MLP(nn.Module):
    """Gated MLP weights: w_gate, w_up (d, f) and w_down (f, d)."""

    def __init__(self, w_gate: Tensor, w_up: Tensor, w_down: Tensor):
        super().__init__()
        self.w_gate = frozen(w_gate)
        self.w_up = frozen(w_up)
        self.w_down = frozen(w_down)


def init_mlp(generator: torch.Generator, d: int, f: int,
             dtype: torch.dtype, device=None) -> MLP:
    return MLP(init_dense(generator, d, f, dtype, device),
               init_dense(generator, d, f, dtype, device),
               init_dense(generator, f, d, dtype, device))


def mlp(p: MLP, x: Tensor, act: str = "silu") -> Tensor:
    a = F.silu(x @ p.w_gate) if act == "silu" else F.gelu(
        x @ p.w_gate, approximate="tanh")
    return (a * (x @ p.w_up)) @ p.w_down


# -------------------------------------------------------------- attention

class Attention(nn.Module):
    """GQA projection weights: wq (d, H*Dh), wk and wv (d, Hk*Dh),
    wo (H*Dh, d); with ``cfg.qk_norm`` also the RMSNorm scales q_norm
    and k_norm (Dh,)."""

    def __init__(self, wq: Tensor, wk: Tensor, wv: Tensor, wo: Tensor,
                 q_norm: Optional[Tensor] = None,
                 k_norm: Optional[Tensor] = None):
        super().__init__()
        self.wq = frozen(wq)
        self.wk = frozen(wk)
        self.wv = frozen(wv)
        self.wo = frozen(wo)
        if q_norm is not None:
            self.q_norm = frozen(q_norm)
            self.k_norm = frozen(k_norm)


def init_attention(generator: torch.Generator, cfg: ArchConfig,
                   dtype: torch.dtype, device=None) -> Attention:
    d, H, Hk, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    norms = ([torch.ones(Dh, dtype=dtype, device=device) for _ in range(2)]
             if cfg.qk_norm else [])
    return Attention(init_dense(generator, d, H * Dh, dtype, device),
                     init_dense(generator, d, Hk * Dh, dtype, device),
                     init_dense(generator, d, Hk * Dh, dtype, device),
                     init_dense(generator, H * Dh, d, dtype, device),
                     *norms)


def _gqa_split(q: Tensor, n_kv: int) -> Tensor:
    """(B, S, H, Dh) -> (B, S, Hk, G, Dh): query head h is group member
    h % G of kv head h // G."""
    B, S, H, Dh = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, Dh)


def _softmax_attend(q: Tensor, k: Tensor, v: Tensor, mask: Tensor,
                    scale: float) -> Tensor:
    """q: (B,Sq,Hk,G,Dh), k: (B,Sk,Hk,Dh), v: (B,Sk,Hk,Dv);
    mask broadcastable to (B,Hk,G,Sq,Sk). Returns (B,Sq,Hk*G,Dv).

    Logits and softmax in fp32; the probabilities are cast to v's dtype
    before the product with v, as the reference does."""
    B, Sq, Hk, G, _ = q.shape
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hk * G, v.shape[-1])


def causal_attend(q: Tensor, k: Tensor, v: Tensor, q_offset: int = 0,
                  window: int = 0, scale: Optional[float] = None,
                  softcap: float = 0.0) -> Tensor:
    """Causal GQA attention over a whole sequence, through the flash
    kernel.  q: (B,S,H,Dh); k: (B,S,Hk,Dh); v: (B,S,Hk,Dv) with Dv <= Dh
    (MLA's prefill hands a narrower v); positions 0..S-1.

    The kernel reads the kv heads in place: q head h reads kv head
    h // (H / Hk), as ``_gqa_split`` groups them.  It takes no window:
    sliding-window layers go through ``local_attend_chunked``."""
    if window:
        raise NotImplementedError("the flash kernel takes no window: "
                                  "use local_attend_chunked")
    if softcap:
        raise NotImplementedError(f"softcapped attention is {_TODO}")
    if q_offset or k.shape[1] != q.shape[1]:
        raise NotImplementedError("causal_attend runs a prefill from "
                                  "position 0 (queries and keys alike)")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return ops.flash_attention_bhsd(q, k, v, causal=True, scale=scale)


def local_attend_chunked(q: Tensor, k: Tensor, v: Tensor, window: int,
                         scale: Optional[float] = None,
                         softcap: float = 0.0) -> Tensor:
    """Sliding-window causal GQA attention in O(S * window) memory.
    q: (B,S,H,Dh); k/v: (B,S,Hk,·); positions 0..S-1; query t sees keys
    (t - window, t].

    The sequence is cut into window-sized chunks (zero-padded at the
    end); chunk i attends to chunks (i-1, i) under the banded (W, 2W)
    mask, and chunk 0 also masks its (zero) previous chunk.  Logits and
    softmax in fp32, the probabilities cast to v's dtype before the
    product with v, as the reference does."""
    if softcap:
        raise NotImplementedError(f"softcapped attention is {_TODO}")
    B, S, H, Dh = q.shape
    Hk, Dv = k.shape[2], v.shape[-1]
    scale = Dh ** -0.5 if scale is None else scale
    W = window
    n = -(-S // W)
    pad = n * W - S

    def padded(x):
        return F.pad(x, (0, 0, 0, 0, 0, pad))

    qc = padded(q).reshape(B, n, W, Hk, H // Hk, Dh)
    kc = padded(k).reshape(B, n, W, Hk, Dh)
    vc = padded(v).reshape(B, n, W, Hk, Dv)
    # keys for chunk i: chunks (i-1, i)
    k2 = torch.cat([F.pad(kc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :n], kc], dim=2)
    v2 = torch.cat([F.pad(vc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :n], vc], dim=2)
    del kc, vc

    qpos = torch.arange(W, device=q.device)[:, None]
    # key positions relative to the chunk's start
    kpos = torch.arange(2 * W, device=q.device)[None, :] - W
    band = (kpos <= qpos) & (kpos > qpos - W)                 # (W, 2W)
    masks = band.expand(n, W, 2 * W).clone()
    masks[0] &= kpos >= 0     # chunk 0 must not see the (zero) chunk -1

    # scaled and masked in place: one (B, n, Hk, G, W, 2W) fp32 plane
    logits = torch.einsum("bnqhgd,bnkhd->bnhgqk", qc.float(),
                          k2.float()).mul_(scale)
    del qc, k2
    logits.masked_fill_(~masks[None, :, None, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    del logits
    out = torch.einsum("bnhgqk,bnkhd->bnqhgd", probs, v2)
    return out.reshape(B, n * W, H, Dv)[:, :S]


def decode_attend(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                  cache_index: Union[int, Tensor], window: int = 0,
                  rolling: bool = False, scale: Optional[float] = None,
                  softcap: float = 0.0) -> Tensor:
    """Single-token GQA decode attention over a (possibly rolling) cache.

    q: (B, 1, H, Dh); caches: (B, C, Hk, ·) (not head-repeated).
    ``cache_index``: the new token's position i.  A plain cache holds
    position t at slot t: slots after i are masked.  A rolling cache
    (local attention) holds position i - ((i - t) mod C) at slot t after
    token i was written at slot i % C: slots of negative positions are
    masked.  ``window > 0`` also masks positions at or before
    i - window."""
    if softcap:
        raise NotImplementedError(f"softcapped decode attention is {_TODO}")
    Hk, C = k_cache.shape[2], k_cache.shape[1]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    slots = torch.arange(C, device=q.device)
    if rolling:
        pos = cache_index - torch.remainder(cache_index - slots, C)
        valid = pos >= 0
        if window > 0:
            valid &= pos > cache_index - window
    else:
        valid = slots <= cache_index
        if window > 0:
            valid &= slots > cache_index - window
    return _softmax_attend(_gqa_split(q, Hk), k_cache, v_cache,
                           valid[None, None, None, None, :], scale)
