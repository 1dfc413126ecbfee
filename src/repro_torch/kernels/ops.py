"""Public wrappers around the port's hand-written kernels.

Counterpart of ``repro/kernels/ops.py`` for the kernels ported so far
(the row-norm sigma kernel; flash attention and the LRU scan are still
to be ported).  Same signatures as the reference, minus its
``interpret`` flag: the device of the inputs decides, CUDA tensors
launch the CUDA kernel and CPU tensors take its plain version.
"""
from __future__ import annotations

import torch

from .gradnorm import gradnorm_sigma, rownorm2

__all__ = ["rownorm2", "gradnorm_sigma", "sigma_from_head"]


def sigma_from_head(h: torch.Tensor, logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Exact last-layer sigma from features + logits (fused path).

    h: (N, d) penultimate features; logits: (N, V); labels: (N,).
    """
    p = torch.softmax(logits.float(), dim=-1)
    y = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).float()
    return gradnorm_sigma(h, p - y)
