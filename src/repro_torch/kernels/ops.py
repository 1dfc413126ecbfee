"""Public wrappers around the port's hand-written kernels.

Counterpart of ``repro/kernels/ops.py``: the row-norm sigma kernel,
flash attention and the linear-recurrence scan.  Same signatures as the
reference, minus its ``interpret`` flag and block sizes: the device of
the inputs decides, CUDA tensors launch the CUDA kernel and CPU tensors
take its plain version.  ``lru_scan_autograd`` is the scan with its
gradient (``lru_scan.LRUScan``), whose backward pass runs the same
kernel backwards in time.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_bhsd
from .gradnorm import gradnorm_sigma, rownorm2
from .lru_scan import lru_scan, lru_scan_autograd

__all__ = ["flash_attention_bhsd", "rownorm2", "gradnorm_sigma",
           "lru_scan", "lru_scan_autograd", "sigma_from_head"]


def sigma_from_head(h: torch.Tensor, logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Exact last-layer sigma from features + logits (fused path).

    h: (N, d) penultimate features; logits: (N, V); labels: (N,).
    p - y is formed in place on the fp32 softmax, 1 taken off at each
    row's label, so besides the logits only that (N, V) fp32 plane is
    allocated (no (N, V) one-hot); its values are those of p - one_hot.
    """
    p = torch.softmax(logits.float(), dim=-1)
    rows = torch.arange(p.shape[0], device=p.device)
    p[rows, labels.long()] -= 1.0
    return gradnorm_sigma(h, p)
