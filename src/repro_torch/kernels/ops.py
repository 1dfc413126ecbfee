"""Public wrappers around the port's hand-written kernels.

Counterpart of ``repro/kernels/ops.py``: the row-norm sigma kernel,
flash attention and the linear-recurrence scan.  Same signatures as the
reference, minus its ``interpret`` flag and block sizes: the device of
the inputs decides, CUDA tensors launch the CUDA kernel and CPU tensors
take its plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention
from .gradnorm import gradnorm_sigma, rownorm2
from .lru_scan import lru_scan

__all__ = ["flash_attention_bhsd", "rownorm2", "gradnorm_sigma",
           "lru_scan", "sigma_from_head"]


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q,k,v: (B, S, H, d) MHA layout -> (B, S, H, d).

    GQA callers broadcast kv heads first (the kernel is head-merged).
    The (B, S, H, d) -> (B*H, S, d) fold copies into the contiguous
    layout the kernel takes (a reshape alone is a strided view when
    B == 1)."""
    B, S, H, d = q.shape

    def fold(x):
        return x.movedim(2, 1).contiguous().view(B * H, S, d)

    out = flash_attention(fold(q), fold(k), fold(v), causal=causal,
                          scale=scale)
    return out.reshape(B, H, S, d).movedim(1, 2)


def sigma_from_head(h: torch.Tensor, logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Exact last-layer sigma from features + logits (fused path).

    h: (N, d) penultimate features; logits: (N, V); labels: (N,).
    """
    p = torch.softmax(logits.float(), dim=-1)
    y = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).float()
    return gradnorm_sigma(h, p - y)
