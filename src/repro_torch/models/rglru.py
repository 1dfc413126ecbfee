"""RG-LRU recurrent mixer (RecurrentGemma / Griffin).

Counterpart of ``repro/models/rglru.py``:

    r_t = sigmoid(W_r x_t)                      (recurrence gate)
    i_t = sigmoid(W_i x_t)                      (input gate)
    log a_t = -c * softplus(Lambda) * r_t       (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block is the Griffin recurrent block: two linear branches, a short
causal conv on the recurrent branch, the RG-LRU, a GeLU-gated merge and
the output projection.  Prefill runs the diagonal recurrence over
(B, S, w) fp32 through the hand-written scan kernel
(``kernels.ops.lru_scan``) where the reference runs
``jax.lax.associative_scan``, as the Mamba mixer does (``ssm.py``);
the ``train`` mode runs it through the same scan, whose backward pass
is the scan's backward kernel, walked backwards in time, and keeps no
cache; decode is the
single-step recurrence in eager torch and launches no kernel of the
port.

Cache: {"conv": (B, k-1, w) in the activation dtype, "h": (B, w) fp32},
written in place (``copy_``) as ``ssm.mamba_mixer`` writes its own.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .config import ArchConfig
from .layers import frozen, init_dense, matmul
from .ssm import causal_conv, write_conv_tail
from .shard_ctx import constrain

Tensor = torch.Tensor

_C = 8.0

#: the mixer's leaves that stay float32 whatever the activation dtype
#: (the reference's ``init_rglru`` keeps ``lam`` so).
FP32_LEAVES = ("lam",)


class RGLRU(nn.Module):
    """Mixer weights under the reference's names: w_x, w_y (d, w),
    conv_w (k, w), conv_b (w,), w_r, w_i (w, w) and w_out (w, d) in the
    activation dtype; lam (w,) in float32."""

    LEAVES = ("w_x", "w_y", "conv_w", "conv_b", "w_r", "w_i", "lam",
              "w_out")

    def __init__(self, **leaves: Tensor):
        super().__init__()
        for name in self.LEAVES:
            setattr(self, name, frozen(leaves[name]))


def init_rglru(generator: torch.Generator, cfg: ArchConfig,
               dtype: torch.dtype, device=None) -> RGLRU:
    """The reference's distributions, drawn on ``device`` from
    ``generator``: dense weights N(0, 1/d_in); conv_w N(0, 1/k); conv_b
    zero; Lambda such that a^c = u, u uniform in (0.9, 0.999) (the
    standard Griffin init)."""
    d, w, k = cfg.d_model, cfg.lru_width_, cfg.ssm_conv or 4
    f32 = torch.float32
    conv_w = torch.randn((k, w), generator=generator, device=device,
                         dtype=f32) * (1.0 / k ** 0.5)
    u = torch.empty(w, device=device, dtype=f32).uniform_(
        0.9, 0.999, generator=generator)
    return RGLRU(
        w_x=init_dense(generator, d, w, dtype, device),
        w_y=init_dense(generator, d, w, dtype, device),
        conv_w=conv_w.to(dtype),
        conv_b=torch.zeros(w, dtype=dtype, device=device),
        w_r=init_dense(generator, w, w, dtype, device),
        w_i=init_dense(generator, w, w, dtype, device),
        lam=torch.log(torch.expm1(-torch.log(u ** (1.0 / _C)))),
        w_out=init_dense(generator, w, d, dtype, device))


def _gates(p: RGLRU, s: Tensor) -> Tuple[Tensor, Tensor]:
    """(a, sqrt(1 - a^2) * i) in fp32 from the conv output ``s``; the
    reference's clamp of 1 - exp(2 log a) at 1e-12 is kept as written."""
    r = torch.sigmoid(matmul(s, p.w_r).float())
    i = torch.sigmoid(matmul(s, p.w_i).float())
    log_a = -_C * F.softplus(p.lam) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, mult * i


def rglru_mixer(cfg: ArchConfig, p: RGLRU, x: Tensor, mode: str,
                cache: Optional[dict]) -> Tensor:
    """x (B, S, d) -> y (B, S, d).  ``train`` keeps no cache (pass
    None); ``prefill`` writes the last k-1 inputs of the recurrent
    branch (zero-left-padded when S < k-1) and the final state into
    ``cache``; ``decode`` (S = 1) advances both by one step."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    S = x.shape[1]
    k = cfg.ssm_conv or 4
    xs = matmul(x, p.w_x)
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(matmul(x, p.w_y).float(), approximate="tanh")
    xs = constrain(xs, "act_btf")

    if mode in ("train", "prefill"):
        conv = causal_conv(p, xs, k)
        a, bx_scale = _gates(p, conv)
        bx = bx_scale * conv.float()
        h = ops.lru_scan(a, bx)                       # (B, S, w) fp32
        del a, bx
        if mode == "prefill":
            write_conv_tail(cache["conv"], xs, k)
            cache["h"].copy_(h[:, -1])
    else:
        conv_buf = torch.cat([cache["conv"], xs.to(cache["conv"].dtype)],
                             dim=1)
        conv = (torch.einsum("bkw,kw->bw", conv_buf, p.conv_w)
                + p.conv_b)[:, None, :]
        a, bx_scale = _gates(p, conv)
        h1 = a[:, 0] * cache["h"] + (bx_scale * conv.float())[:, 0]
        h = h1[:, None, :]
        cache["conv"].copy_(conv_buf[:, 1:, :])
        cache["h"].copy_(h1)

    return matmul((h * gate).to(x.dtype), p.w_out)
