"""Mamba-1 selective SSM mixer (Falcon-Mamba-7B architecture).

Counterpart of ``repro/models/ssm.py``.  The recurrence
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
is diagonal per (channel, state).  Prefill materialises dA = exp(dt A)
and dBx = dt B x over the (B, S, d_inner, n) plane in fp32, as the
reference does, and runs the recurrence through the hand-written scan
kernel (``kernels.ops.lru_scan``, with the (d_inner, n) plane flattened
into channels) where the reference runs ``jax.lax.associative_scan``;
the two compute the same h.  The ``train`` mode builds the same planes
out of place (prefill's in-place ``exp_`` and ``mul_`` would overwrite
what autograd saves) and runs the recurrence through the same scan,
whose backward pass is the scan's backward kernel, walked backwards in
time; it keeps no cache.  Decode is the
single-step recurrence on the carried (conv_state, ssm_state) in eager
torch, and launches no kernel of the port.

Cache layout: {"conv": (B, k-1, d_inner) in the activation dtype,
"h": (B, d_inner, n) fp32}.  The mixer writes both in place
(``copy_``), so the views of a stacked cache that ``apply_decoder``
hands each layer are updated.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import local, ops
from .config import ArchConfig
from .layers import frozen, init_dense, matmul
from .shard_ctx import constrain, relayout, view_as

Tensor = torch.Tensor

#: the mixer's leaves that stay float32 whatever the activation dtype
#: (the reference's ``init_mamba`` keeps them so).
FP32_LEAVES = ("dt_bias", "A_log", "D")


class Mamba(nn.Module):
    """Mixer weights under the reference's names: in_proj (d, 2 di),
    conv_w (k, di), conv_b (di,), x_proj (di, dtr + 2n), dt_proj
    (dtr, di), and out_proj (di, d) in the activation dtype; dt_bias
    (di,), A_log (di, n) and D (di,) in float32."""

    LEAVES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
              "dt_bias", "A_log", "D", "out_proj")

    def __init__(self, **leaves: Tensor):
        super().__init__()
        for name in self.LEAVES:
            setattr(self, name, frozen(leaves[name]))


def init_mamba(generator: torch.Generator, cfg: ArchConfig,
               dtype: torch.dtype, device=None) -> Mamba:
    """The reference's distributions, drawn on ``device`` from
    ``generator``: dense weights N(0, 1/d_in); conv_w N(0, 1/k); dt_bias
    the inverse softplus of a log-uniform draw in [1e-3, 1e-1];
    A_log = log(1..n) in every channel; D = 1."""
    d, di, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    dtr, k = cfg.ssm_dt_rank_, cfg.ssm_conv
    f32 = torch.float32
    conv_w = torch.randn((k, di), generator=generator, device=device,
                         dtype=f32) * (1.0 / k ** 0.5)
    log_dt = torch.empty(di, device=device, dtype=f32).uniform_(
        math.log(1e-3), math.log(1e-1), generator=generator)
    a = torch.arange(1, n + 1, dtype=f32, device=device)
    return Mamba(
        in_proj=init_dense(generator, d, 2 * di, dtype, device),
        conv_w=conv_w.to(dtype),
        conv_b=torch.zeros(di, dtype=dtype, device=device),
        x_proj=init_dense(generator, di, dtr + 2 * n, dtype, device),
        dt_proj=init_dense(generator, dtr, di, dtype, device),
        dt_bias=torch.log(torch.expm1(torch.exp(log_dt))),
        A_log=torch.log(a).expand(di, n).contiguous(),
        D=torch.ones(di, dtype=f32, device=device),
        out_proj=init_dense(generator, di, d, dtype, device))


def _ssm_params(cfg: ArchConfig, p: Mamba, s: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """dt (B,S,di), Bmat (B,S,n), Cmat (B,S,n) in fp32 from conv output
    s."""
    dtr, n = cfg.ssm_dt_rank_, cfg.ssm_state
    # on a mesh the narrow projection is reduced whole before its split,
    # so that dt's projection splits its output over "model"
    dt_raw, Bmat, Cmat = relayout(matmul(s, p.x_proj), "rows").split(
        [dtr, n, n], dim=-1)
    dt = F.softplus(matmul(dt_raw.float(), p.dt_proj.float()) + p.dt_bias)
    return dt, Bmat.float(), Cmat.float()


def causal_conv(p: nn.Module, x: Tensor, k: int) -> Tensor:
    """Depthwise causal conv along seq: x (B, S, C) with the weights
    ``p.conv_w`` (k, C) and ``p.conv_b`` (C,) of a mixer (Mamba or
    RG-LRU), summed tap by tap (j = 0..k-1) in the input dtype as the
    reference sums.  On a mesh it runs on each rank's sequences and
    channels (``on_channels``), every position whole."""
    if local.is_dtensor(x):
        return on_channels(lambda x, w, b: _causal_conv(x, w, b, k), x,
                           p.conv_w, p.conv_b)
    return _causal_conv(x, p.conv_w, p.conv_b, k)


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, k: int) -> Tensor:
    S = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = 0
    for j in range(k):
        out = out + pad[:, j:j + S, :] * w[j]
    return out + b


def on_channels(fn, x: Tensor, *per_channel: Tensor) -> Tensor:
    """``fn(x, *per_channel)`` for x (B, S, C) and tensors whose last dim
    is the channel, on each rank's shards: its sequences where x's batch
    is split, its channels where they are, every position whole; the
    output (B, ., C) split as x then is (a per-channel tensor's gradient
    a partial sum where the sequences are split)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = x.ndim - 1
    xp = [pl if isinstance(pl, Shard) and pl.dim in (0, last)
          else Replicate() for pl in x.placements]

    def split(t, where_batch):
        return [Shard(t.ndim - 1) if isinstance(pl, Shard) and pl.dim
                else where_batch if isinstance(pl, Shard) else Replicate()
                for pl in xp]

    ins = (xp,) + tuple(split(t, Replicate()) for t in per_channel)
    grads = (xp,) + tuple(split(t, Partial()) for t in per_channel)
    return local.call_local(fn, (x,) + per_channel, ins, xp, x.device_mesh,
                            grad_placements=grads)


def write_conv_tail(cache_conv: Tensor, xs: Tensor, k: int) -> None:
    """The last k-1 inputs of a prefill (zero-left-padded when S < k-1)
    into the conv cache (B, k-1, C), in place; on a mesh formed on each
    rank's sequences and channels."""
    def tail(x):
        xp = F.pad(x, (0, 0, max(k - 1 - x.shape[1], 0), 0))
        return xp[:, xp.shape[1] - (k - 1):, :]
    if local.is_dtensor(xs):
        new = on_channels(tail, xs).redistribute(cache_conv.device_mesh,
                                                 cache_conv.placements)
        cache_conv.copy_(new)
        return
    cache_conv.copy_(tail(xs))


def _states_out(h: Tensor, Cmat: Tensor) -> Tensor:
    """sum_n h (B, S, di, n) * C (B, S, n) -> (B, S, di); on a mesh on
    each rank's sequences and channels."""
    def out(h, c):
        return torch.einsum("bsdn,bsn->bsd", h, c)
    if not local.is_dtensor(h):
        return out(h, Cmat)
    from torch.distributed.tensor import Replicate, Shard
    hp = local.keep_shards(h, (0, 2), lambda dim, n: True)
    cp = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
          for pl in hp]
    return local.call_local(out, (h, Cmat), (hp, cp), hp, h.device_mesh)


def mamba_mixer(cfg: ArchConfig, p: Mamba, x: Tensor, mode: str,
                cache: Optional[dict]) -> Tensor:
    """x (B, S, d) -> y (B, S, d).  ``train`` keeps no cache (pass None);
    ``prefill`` writes the last k-1 inputs (zero-left-padded when
    S < k-1) and the final state into ``cache``; ``decode`` (S = 1)
    advances both by one step."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    B, S, _ = x.shape
    di, n, k = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_conv
    A = -torch.exp(p.A_log)  # (di, n)
    xs, z = matmul(x, p.in_proj).chunk(2, dim=-1)
    xs = constrain(xs, "act_btf")

    if mode == "train":
        s = F.silu(causal_conv(p, xs, k))
        dt, Bmat, Cmat = _ssm_params(cfg, p, s)
        sf = s.float()
        dA = torch.exp(dt[..., None] * A)                     # (B,S,di,n)
        dBx = dt[..., None] * Bmat[:, :, None, :] * sf[..., None]
        h = ops.lru_scan(dA.reshape(B, S, di * n), dBx.reshape(B, S, di * n))
        y = _states_out(view_as(h, (B, S, di, n), None), Cmat) + p.D * sf
    elif mode == "prefill":
        s = F.silu(causal_conv(p, xs, k))
        dt, Bmat, Cmat = _ssm_params(cfg, p, s)
        sf = s.float()
        # (B, S, di, n) fp32 planes, in the reference's order of products;
        # exp_ and mul_ in place are exact and save one plane each
        dA = (dt[..., None] * A).exp_()
        dBx = (dt[..., None] * Bmat[:, :, None, :]).mul_(sf[..., None])
        h = view_as(ops.lru_scan(dA.view(B, S, di * n),
                                 dBx.view(B, S, di * n)), (B, S, di, n),
                    None)
        del dA, dBx
        y = _states_out(h, Cmat) + p.D * sf
        write_conv_tail(cache["conv"], xs, k)
        cache["h"].copy_(h[:, -1])
    else:
        conv_buf = torch.cat([cache["conv"], xs.to(cache["conv"].dtype)],
                             dim=1)
        conv_out = (torch.einsum("bkd,kd->bd", conv_buf, p.conv_w)
                    + p.conv_b)[:, None, :]
        s = F.silu(conv_out)
        dt, Bmat, Cmat = _ssm_params(cfg, p, s)
        sf = s.float()
        dA = torch.exp(dt[:, 0, :, None] * A)                 # (B, di, n)
        dBx = dt[:, 0, :, None] * Bmat[:, 0, None, :] * sf[:, 0, :, None]
        h1 = dA * cache["h"] + dBx
        y = (torch.einsum("bdn,bn->bd", h1, Cmat[:, 0])
             + p.D * sf[:, 0])[:, None, :]
        cache["conv"].copy_(conv_buf[:, 1:, :])
        cache["h"].copy_(h1)

    return matmul(y.to(x.dtype) * F.silu(z), p.out_proj)
