"""Public wrappers around the port's hand-written kernels.

Counterpart of ``repro/kernels/ops.py``: the row-norm sigma kernel,
flash attention and the linear-recurrence scan.  Same signatures as the
reference, minus its ``interpret`` flag and block sizes: the device of
the inputs decides, CUDA tensors launch the CUDA kernel and CPU tensors
take its plain version.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_bhsd
from .gradnorm import gradnorm_sigma, rownorm2
from .lru_scan import lru_scan

__all__ = ["flash_attention_bhsd", "rownorm2", "gradnorm_sigma",
           "lru_scan", "sigma_from_head"]


def sigma_from_head(h: torch.Tensor, logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Exact last-layer sigma from features + logits (fused path).

    h: (N, d) penultimate features; logits: (N, V); labels: (N,).
    """
    p = torch.softmax(logits.float(), dim=-1)
    y = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).float()
    return gradnorm_sigma(h, p - y)
