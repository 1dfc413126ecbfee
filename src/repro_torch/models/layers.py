"""Shared neural-net layers: RMSNorm, RoPE (1-D and M-RoPE), gated MLP,
and GQA attention with the global causal (prefill and train),
sliding-window (prefill and train) and cached-decode (full or rolling)
paths.

Counterpart of ``repro/models/layers.py`` for what the port's serving
and training paths run.  Parameters live in ``nn.Module`` containers
whose attribute names are the reference's dict keys; dense weights keep
the reference's (d_in, d_out) layout and are applied as ``x @ w``.  The
apply functions are plain tensor functions that take those modules, as
the reference's take dict pytrees.  Serving's parameters are frozen
(``frozen``); the train driver turns their gradients on.

Global prefill attention goes through the hand-written flash-attention
kernel (``kernels.ops.flash_attention_bhsd``), the route the reference
keeps for hot paths on its chip; ``causal_attend`` takes the reference's
whole signature (a query offset, keys longer than the queries, a scale,
a softcap and a window: a windowed call takes the plain q-chunked path).
Global attention in train mode (``causal_attend_chunked``) is the
reference's q-chunked jnp ``causal_attend`` in plain torch, which
autograd differentiates: the flash kernel has no backward, and the
reference's train path never reaches its Pallas kernel either.
Sliding-window attention (``local_attend_chunked``, prefill and train)
and decode attention stay plain torch, as the reference computes them
with einsums outside any kernel (its Pallas flash kernel takes no
window).  Every path takes the reference's logit softcapping: a logit s
(after the scale) becomes softcap * tanh(s / softcap) before the mask.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import local, ops
from ..kernels.flash_attention import check_offset
from .config import ArchConfig
from .shard_ctx import relayout, replicated

Tensor = torch.Tensor

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def frozen(t: Tensor) -> nn.Parameter:
    """A parameter with no gradient tracked, as serving holds it; the
    train driver turns gradients on (``model.trainable``)."""
    return nn.Parameter(t, requires_grad=False)


def linear(x: Tensor, w: Tensor) -> Tensor:
    """x (..., d_in) @ w (d_in, d_out) as one 2-D GEMM over the flattened
    leading dims: what ``x @ w`` folds to for a contiguous x.  ``@`` on a
    3-D DTensor decides between that and a batched GEMM by the DTensor's
    own strides, which for a size-1 dim (a decode step) need not be a
    contiguous tensor's, and the batched GEMM rounds otherwise; on a mesh
    the GEMM runs partitioned (``matmul``), on each rank's shards."""
    if local.is_dtensor(x):
        return _partitioned(_linear, x, w)
    return _linear(x, w)


def _linear(x: Tensor, w: Tensor) -> Tensor:
    return (x.reshape(-1, x.shape[-1]) @ w).view(*x.shape[:-1], w.shape[-1])


def matmul(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` for an activation x (..., d_in) and a weight w (d_in,
    d_out).  On a mesh it runs as one GEMM on each rank's shards: per
    mesh dim, where x's rows are split, w is read whole; where x's
    features or w's rows are split, the contraction is (a partial sum
    out); where w's output features are split, x is read whole.  Folding
    x's leading dims into rows, as DTensor's own rule for ``@`` does,
    cannot split a dim that is split inside another (a cache split by
    sequence within its batch split)."""
    if local.is_dtensor(x):
        return _partitioned(torch.matmul, x, w)
    return x @ w


def _partitioned(fn, x: Tensor, w: Tensor) -> Tensor:
    """``fn(x, w)`` (a GEMM of x's last dim with w's first) on each
    rank's shards, as ``matmul`` lays them out; the gradients' placements
    follow (w read whole by split rows: a partial sum)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, last = x.device_mesh, x.ndim - 1
    w = local.on_mesh(w, mesh)
    R = Replicate()
    xp, wp, op, xg, wg = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if isinstance(px, Shard) and px.dim < last:      # rows
            row = (px, R, Shard(px.dim), px, Partial())
        elif (isinstance(px, Shard) or isinstance(pw, Shard)
              and pw.dim == 0):                          # contraction
            row = (Shard(last), Shard(0), Partial(), Shard(last), Shard(0))
        elif isinstance(pw, Shard):                      # output features
            row = (R, pw, Shard(last), Partial(), pw)
        else:
            row = (R, R, R, R, R)
        for acc, pl in zip((xp, wp, op, xg, wg), row):
            acc.append(pl)
    return local.call_local(fn, (x, w), (xp, wp), op, mesh,
                            grad_placements=(xg, wg))


# ------------------------------------------------------------------ norms

def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """Computed in fp32 and cast back to the input dtype.  On a mesh each
    row is read whole (an MLA latent is split over "model"), and so is
    the scale (a stacked body's norm is split over "model" by the
    rules): the norm runs on each rank's rows."""
    xf = relayout(x, "rows").float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * replicated(scale).float()).to(x.dtype)


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


def write_slots(cache: Tensor, new: Tensor, start: int) -> None:
    """Write ``new`` (B, n, ...) into slots ``start``..``start + n - 1`` of
    ``cache`` (B, C, ...), in place, the slots wrapping modulo C (a
    rolling buffer's last positions).  On a mesh each rank writes the
    slots that fall in its own shard of the cache, from the new slots
    laid out as the cache is with their slot dim whole: no rank gathers
    the cache."""
    start, n, C = int(start), new.shape[1], cache.shape[1]
    out, lo_c, hi_c = cache, 0, C
    if local.is_dtensor(cache):
        from torch.distributed.tensor import Replicate, Shard
        mesh = cache.device_mesh
        whole = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in cache.placements]
        new = local.on_mesh(new, mesh).redistribute(mesh, whole).to_local()
        lo_c, n_c = local.local_range(cache, 1)
        out, hi_c = cache.to_local(), lo_c + n_c
    # slot t holds new[:, t - first]: the slots from ``start`` up to C,
    # then from 0 where they wrap
    for first in (start, start - C):
        lo, hi = max(first, lo_c), min(first + n, hi_c)
        if lo < hi:
            out[:, lo - lo_c:hi - lo_c] = new[:, lo - first:hi - first]


def embedding(table: Tensor, ids: Tensor) -> Tensor:
    """``table[ids]``: rows of a (V, d) table for integer ids (B, S).  On
    a mesh it is the lookup of a vocab-parallel table, partitioned: per
    mesh dim, where the ids' batch is split, each rank looks up its own
    sequences (the table read whole there); where the vocabulary is, its
    own rows, the others 0 (a partial sum out); where d is, its own
    features."""
    if not local.is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    ids = local.on_mesh(ids, mesh)
    R = Replicate()
    tp, ip, op, tg = [], [], [], []
    for pt, pi in zip(table.placements, ids.placements):
        if isinstance(pi, Shard) and pi.dim == 0:        # sequences
            row = (R, pi, Shard(0), Partial())
        elif isinstance(pt, Shard) and pt.dim == 0:      # vocabulary
            row = (pt, R, Partial(), pt)
        elif isinstance(pt, Shard):                      # features
            row = (pt, R, Shard(ids.ndim), pt)
        else:
            row = (R, R, R, R)
        for acc, pl in zip((tp, ip, op, tg), row):
            acc.append(pl)
    v0, n = local.local_range(table, 0, tp)
    if n == table.shape[0]:
        def lookup(t, i):
            return t[i]
    else:
        def lookup(t, i):
            mine = (i >= v0) & (i < v0 + n)
            return t[(i - v0).clamp(0, n - 1)].masked_fill(~mine[..., None],
                                                           0)
    return local.call_local(lookup, (table, ids), (tp, ip), op, mesh,
                            grad_placements=(tg, ip))


def _batch_heads(q: Tensor, *others: Tensor) -> list:
    """q's placements kept where they split its batch, or its heads when
    q's and every 4-D operand's heads divide there; ``Replicate()``
    elsewhere."""
    B = q.shape[0]
    heads = [q.shape[2]] + [t.shape[2] for t in others if t.ndim == 4]
    return local.keep_shards(
        q, (0, 2), lambda dim, n: (B % n == 0 if dim == 0 else
                                   all(h % n == 0 for h in heads)))


def on_batch_heads(fn, q: Tensor, *others: Tensor) -> Tensor:
    """``fn(q, *others)``: attention with q (B, Sq, H, .) and operands
    (B, Sk, Hk, .) or (B, Sk, .).  On a mesh it runs on each rank's
    shards: its sequences where q's batch is split, its heads where q's
    and every 4-D operand's heads are split alike and divide, every
    position whole; the output (B, Sq, H, .) is split as q then is."""
    if not local.is_dtensor(q):
        return fn(q, *others)
    from torch.distributed.tensor import Replicate, Shard
    pq = _batch_heads(q, *others)
    batch = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
             for pl in pq]
    pls = tuple(pq if t.ndim == 4 else batch for t in others)
    return local.call_local(fn, (q,) + others, (pq,) + pls, pq,
                            q.device_mesh)


def _row_dims(q: Tensor, *others: Tensor) -> list:
    """The mesh dims (of more than one rank) where attention with q
    would run whole on every rank, q's batch and heads split on none of
    them (``_batch_heads``: 24 heads over 16 ranks), when q's rows
    divide into two blocks per rank across them; else []."""
    from torch.distributed.tensor import Replicate
    mesh = q.device_mesh
    dims = [m for m, p in enumerate(_batch_heads(q, *others))
            if isinstance(p, Replicate) and mesh.size(m) > 1]
    n = math.prod(mesh.size(m) for m in dims)
    return dims if dims and q.shape[1] % (2 * n) == 0 else []


def _on_query_rows(fn, q: Tensor, k: Tensor, v: Tensor, q_offset: int,
                   dims: list) -> Tensor:
    """``fn(q, k, v, q_offset)``, causal attention, on DTensors, split by
    q's rows over the mesh dims ``dims`` (``_row_dims``) and as
    ``on_batch_heads`` over the others.  Of 2n blocks of rows, the i-th
    of the n ranks across ``dims`` takes blocks i and 2n - 1 - i, so
    every rank does the same causal work; each attends against every
    key, and its output holds its rows and zeros elsewhere: a partial
    sum over ``dims``, as are the gradients of q, k and v."""
    from torch.distributed.tensor import Partial
    mesh = q.device_mesh
    pq = _batch_heads(q, k, v)
    i, n = 0, 1
    for m in dims:
        i, n = i * mesh.size(m) + mesh.get_local_rank(m), n * mesh.size(m)
    c = q.shape[1] // (2 * n)
    first, second = i * c, (2 * n - 1 - i) * c
    part = [Partial() if m in dims else p for m, p in enumerate(pq)]

    def own_rows(q, k, v):
        a = fn(q[:, first:first + c], k, v, q_offset + first)
        b = fn(q[:, second:second + c], k, v, q_offset + second)
        zeros = a.new_zeros(a.shape[0], q.shape[1], a.shape[2], a.shape[3])
        return torch.cat([zeros[:, :first], a, zeros[:, first + c:second],
                          b, zeros[:, second + c:]], dim=1)

    return local.call_local(own_rows, (q, k, v), (pq, pq, pq), part, mesh,
                            grad_placements=(part, part, part))


# ------------------------------------------------------------------- rope

def _rope_cos_sin(positions: Tensor, n_pairs: int, theta: float,
                  mrope_sections: Tuple[int, ...] = ()
                  ) -> Tuple[Tensor, Tensor]:
    """cos/sin tables for positions (B, S), or (B, 3, S) for M-RoPE:
    (B, S, n_pairs) float32.

    The frequencies theta^(-i/n_pairs) are raised in float64 and rounded
    to float32, so every device gets the same table; the angles and
    their cos/sin are float32, as in the reference.  Under M-RoPE
    (Qwen2-VL) pair i takes its position from the (temporal, height,
    width) row of the section it belongs to: the first
    ``mrope_sections[0]`` pairs from row 0, the next
    ``mrope_sections[1]`` from row 1, the rest from row 2."""
    expo = -torch.arange(n_pairs, dtype=torch.float32,
                         device=positions.device) / n_pairs
    freqs = torch.pow(float(theta), expo.double()).float()
    if positions.dim() == 2:
        pos = positions[..., None]
    elif positions.dim() == 3 and positions.shape[1] == len(
            mrope_sections) and sum(mrope_sections) == n_pairs:
        # row r repeated over its section's pairs: views and one copy, no
        # index tensor from the host (a decode step would wait for it)
        pos = torch.cat([positions[:, r, None, :].expand(-1, n, -1)
                         for r, n in enumerate(mrope_sections)],
                        dim=1).transpose(1, 2)  # (B, S, n_pairs)
    else:
        raise ValueError(f"M-RoPE takes (B, {len(mrope_sections)}, S) "
                         f"positions and sections {mrope_sections} summing "
                         f"to {n_pairs} pairs, got positions of shape "
                         f"{tuple(positions.shape)}")
    ang = pos.float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, positions: Tensor, theta: float,
               fraction: float = 1.0,
               mrope_sections: Tuple[int, ...] = ()) -> Tensor:
    """x: (B, S, H, Dh); positions (B, S), or (B, 3, S) with
    ``mrope_sections`` for M-RoPE.  Rotates the first ``fraction * Dh``
    dims, the first half of them against the second half (rotate-half
    pairing)."""
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
    a = F.silu(linear(x, p.w_gate)) if act == "silu" else F.gelu(
        linear(x, p.w_gate), approximate="tanh")
    return linear(a * linear(x, p.w_up), p.w_down)


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


def kv_heads_for(q: Tensor, kv: Tensor) -> Tensor:
    """kv (B, Sk, Hk, D) for attention with q (B, Sq, H, Dh).  On a mesh
    where q's heads are split over a mesh dim and kv's fewer heads are
    not (gemma3: H = 16 over 16 ranks, Hk = 8), the grouped view of q
    cannot be taken shard by shard: kv's heads are then repeated to q's,
    query head h taking kv head h // (H / Hk) as ``_gqa_split`` pairs
    them, and split as q's are, each rank forming only its own; the
    attention then runs head by head on every rank.  Anything else
    (plain tensors among it) comes back as it is."""
    if not local.is_dtensor(q) or q.shape[2] == kv.shape[2]:
        return kv
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    split = [m for m, p in enumerate(q.placements)
             if isinstance(p, Shard) and p.dim == 2]
    if not split or any(kv.placements[m] == q.placements[m] for m in split):
        return kv
    group = q.shape[2] // kv.shape[2]
    h0, n = local.local_range(q, 2)
    whole = [Replicate() if m in split else p
             for m, p in enumerate(kv.placements)]
    out = [q.placements[m] if m in split else p for m, p in enumerate(whole)]

    def own_heads(t):
        idx = torch.div(torch.arange(h0, h0 + n, device=t.device), group,
                        rounding_mode="floor")
        return t.index_select(2, idx)

    return local.call_local(own_heads, (kv,), (whole,), out, mesh)


def _gqa_split(q: Tensor, n_kv: int) -> Tensor:
    """(B, S, H, Dh) -> (B, S, Hk, G, Dh): query head h is group member
    h % G of kv head h // G."""
    B, S, H, Dh = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, Dh)


def _softmax_attend(q: Tensor, k: Tensor, v: Tensor, mask: Tensor,
                    scale: float, softcap: float = 0.0) -> Tensor:
    """q: (B,Sq,Hk,G,Dh), k: (B,Sk,Hk,Dh), v: (B,Sk,Hk,Dv);
    mask broadcastable to (B,Hk,G,Sq,Sk). Returns (B,Sq,Hk*G,Dv).

    Logits and softmax in fp32, softcapped (``softcap > 0``) after the
    scale and before the mask; the probabilities are cast to v's dtype
    before the product with v, as the reference does."""
    B, Sq, Hk, G, _ = q.shape
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hk * G, v.shape[-1])


def causal_attend(q: Tensor, k: Tensor, v: Tensor,
                  q_offset: Union[int, Tensor] = 0, window: int = 0,
                  scale: Optional[float] = None, softcap: float = 0.0,
                  q_chunk: int = 1024) -> Tensor:
    """Causal (optionally windowed) GQA attention, the reference's
    ``causal_attend``.  q: (B,Sq,H,Dh); k: (B,Sk,Hk,Dh); v: (B,Sk,Hk,Dv)
    with Dv <= Dh (MLA's prefill hands a narrower v).  Query positions
    are ``q_offset + arange(Sq)``, key positions ``arange(Sk)``: a
    chunk of a prefill at ``q_offset`` against the keys so far.
    ``q_offset`` is an int or a 0-d integer tensor, read to the host
    once (the kernel's grid depends on it); a negative one raises
    ``ValueError`` (rows that see no key).  ``softcap > 0`` caps the
    logits before the mask; ``window > 0`` limits a query to the last
    ``window`` keys.

    Without a window it runs the flash kernel, which reads the kv heads
    in place: q head h reads kv head h // (H / Hk), as ``_gqa_split``
    groups them.  The kernel takes no window, as the reference's Pallas
    kernel takes none: a windowed call runs ``causal_attend_chunked``
    with the reference's banded mask, ``q_chunk`` queries at a time
    (sliding-window layers of the zoo go through
    ``local_attend_chunked``)."""
    q_offset = int(q_offset)
    check_offset(q_offset)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if window > 0:
        return causal_attend_chunked(q, k, v, scale, softcap, q_chunk,
                                     q_offset=q_offset, window=window)
    dims = _row_dims(q, k, v) if local.is_dtensor(q) else []
    if dims:
        return _on_query_rows(
            lambda q, k, v, off: ops.flash_attention_bhsd(
                q, k, v, causal=True, scale=scale, softcap=softcap,
                q_offset=off), q, k, v, q_offset, dims)
    return ops.flash_attention_bhsd(q, k, v, causal=True, scale=scale,
                                    softcap=softcap, q_offset=q_offset)


def causal_attend_chunked(q: Tensor, k: Tensor, v: Tensor,
                          scale: Optional[float] = None, softcap: float = 0.0,
                          q_chunk: int = 1024, q_offset: int = 0,
                          window: int = 0) -> Tensor:
    """Causal GQA attention in plain torch, with q-chunking: the train
    mode's global attention (the reference's jnp ``causal_attend``),
    which autograd differentiates, and ``causal_attend``'s windowed
    route.  q: (B,Sq,H,Dh); k: (B,Sk,Hk,Dh); v: (B,Sk,Hk,Dv) (MLA hands
    a narrower v); query positions ``q_offset + arange(Sq)``, key
    positions ``arange(Sk)``; ``window > 0`` also masks keys at or
    before a query's position minus ``window``.  Queries go in chunks of
    ``q_chunk`` against every key, so a chunk's fp32 logits are (B, Hk,
    G, q_chunk, Sk), as in the reference."""
    if local.is_dtensor(q):
        def attend(q, k, v, off=q_offset):
            return causal_attend_chunked(q, k, v, scale, softcap, q_chunk,
                                         off, window)
        dims = _row_dims(q, k, v)
        return (_on_query_rows(attend, q, k, v, q_offset, dims) if dims
                else on_batch_heads(attend, q, k, v))
    S, Hk = q.shape[1], k.shape[2]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qg = _gqa_split(q, Hk)
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    outs = []
    for s0 in range(0, S, q_chunk):
        qpos = torch.arange(q_offset + s0, q_offset + min(s0 + q_chunk, S),
                            device=q.device)[:, None]
        mask = qpos >= kpos
        if window > 0:
            mask &= kpos > qpos - window
        outs.append(_softmax_attend(qg[:, s0:s0 + q_chunk], k, v, mask,
                                    scale, softcap))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def local_attend_chunked(q: Tensor, k: Tensor, v: Tensor, window: int,
                         scale: Optional[float] = None,
                         softcap: float = 0.0) -> Tensor:
    """Sliding-window causal GQA attention in O(S * window) memory.
    q: (B,S,H,Dh); k/v: (B,S,Hk,·); positions 0..S-1; query t sees keys
    (t - window, t].

    The sequence is cut into window-sized chunks (zero-padded at the
    end); chunk i attends to chunks (i-1, i) under the banded (W, 2W)
    mask, and chunk 0 also masks its (zero) previous chunk.  Logits and
    softmax in fp32, softcapped (``softcap > 0``) after the scale and
    before the mask, the probabilities cast to v's dtype before the
    product with v, as the reference does.  The in-place scale, softcap
    and mask act on the logits GEMM's output, which no backward reads
    (the softmax saves its own output), so autograd runs through it in
    the train mode.  The softcap's tanh runs in place too, but its
    backward reads its output: under autograd the cap's product is then
    a new plane, so the train mode keeps one more (B, n, Hk, G, W, 2W)
    plane per layer, and serving none."""
    if local.is_dtensor(q):
        return on_batch_heads(lambda q, k, v: local_attend_chunked(
            q, k, v, window, scale, softcap), q, k, v)
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

    # scaled, capped and masked in place: one (B, n, Hk, G, W, 2W) fp32
    # plane (two under autograd with a softcap, see above)
    logits = torch.einsum("bnqhgd,bnkhd->bnhgqk", qc.float(),
                          k2.float()).mul_(scale)
    del qc, k2
    if softcap > 0:
        logits = logits.div_(softcap).tanh_()
        logits = (logits * softcap if logits.requires_grad
                  else logits.mul_(softcap))
    logits.masked_fill_(~masks[None, :, None, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    del logits
    out = torch.einsum("bnhgqk,bnkhd->bnqhgd", probs, v2)
    return out.reshape(B, n * W, H, Dv)[:, :S]


def _decode_valid(slots: Tensor, cache_index: Union[int, Tensor], C: int,
                  window: int, rolling: bool) -> Tensor:
    """Which of the cache ``slots`` (of C) a decode at position
    ``cache_index`` reads (``decode_attend``'s mask)."""
    if rolling:
        pos = cache_index - torch.remainder(cache_index - slots, C)
        valid = pos >= 0
        if window > 0:
            valid &= pos > cache_index - window
    else:
        valid = slots <= cache_index
        if window > 0:
            valid &= slots > cache_index - window
    return valid


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
    i - window.  ``softcap > 0`` caps the logits before the mask."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if local.is_dtensor(q):
        return _decode_on_mesh(q, k_cache, v_cache, cache_index, window,
                               rolling, scale, softcap)
    Hk, C = k_cache.shape[2], k_cache.shape[1]
    valid = _decode_valid(torch.arange(C, device=q.device), cache_index, C,
                          window, rolling)
    return _softmax_attend(_gqa_split(q, Hk), k_cache, v_cache,
                           valid[None, None, None, None, :], scale, softcap)


def _decode_on_mesh(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                    cache_index: Union[int, Tensor], window: int,
                    rolling: bool, scale: float, softcap: float) -> Tensor:
    """``decode_attend`` on DTensors, by ``on_batch_heads``.  Where the
    cache's slots are split (a batch too small to split holds a
    sequence-split cache: long_500k), and where q's batch and heads
    cannot split (24 heads over 16 ranks) and the slots divide, each
    rank attends over its own slots, and the ranks' partial softmaxes
    are merged across the split (each one's max, sum and weighted
    values, rescaled to the global max), as an SPMD partitioner reduces
    a softmax over a split dim: no rank gathers the cache, and none
    attends over another's slots."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, C = q.device_mesh, k_cache.shape[1]
    pq = _batch_heads(q, k_cache, v_cache)
    split = [m for m, p in enumerate(k_cache.placements)
             if isinstance(p, Shard) and p.dim == 1]
    whole = [m for m, p in enumerate(pq) if m not in split
             and isinstance(p, Replicate) and mesh.size(m) > 1]
    if C % math.prod(mesh.size(m) for m in split + whole) == 0:
        split += whole
    if not split:
        return on_batch_heads(lambda q, k, v: decode_attend(
            q, k, v, cache_index, window, rolling, scale, softcap),
            q, k_cache, v_cache)
    pq = [Replicate() if m in split else p for m, p in enumerate(pq)]
    pkv = [Shard(1) if m in split else p for m, p in enumerate(pq)]
    first, _ = local.local_range(k_cache, 1, pkv)
    # each shard's partial results, stacked on a new leading dim
    stacked = [Shard(0) if m in split else Shard(p.dim + 1)
               if isinstance(p, Shard) else p for m, p in enumerate(pq)]

    def partial(q, k, v):
        B, Sq, H, _ = q.shape
        valid = _decode_valid(torch.arange(first, first + k.shape[1],
                                           device=q.device),
                              cache_index, C, window, rolling)
        logits = torch.einsum("bqhgd,bkhd->bhgqk",
                              _gqa_split(q, k.shape[2]).float(),
                              k.float()) * scale
        if softcap > 0:
            logits = softcap * torch.tanh(logits / softcap)
        logits = logits.masked_fill(~valid, _NEG_INF)
        top = logits.amax(-1, keepdim=True)
        probs = torch.exp(logits - top)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)

        def per_head(t):    # (B, Hk, G, Sq, 1) -> (1, B, Sq, H, 1)
            return t.permute(0, 3, 1, 2, 4).reshape(1, B, Sq, H, 1)
        return (out.float().reshape(1, B, Sq, H, v.shape[-1]),
                per_head(probs.sum(-1, keepdim=True)), per_head(top))

    out, total, top = local.call_local(
        partial, (q, k_cache, v_cache), (pq, pkv, pkv),
        (stacked, stacked, stacked), mesh)
    w = torch.exp(top - top.amax(0))
    out = (out * w).sum(0) / (total * w).sum(0)
    return out.to(v_cache.dtype).redistribute(mesh, pq)
