"""Public wrappers around the port's hand-written kernels.

Counterpart of ``repro/kernels/ops.py``: the row-norm sigma kernel,
flash attention and the linear-recurrence scan.  Same signatures as the
reference, minus its ``interpret`` flag and block sizes: the device of
the inputs decides, CUDA tensors launch the CUDA kernel and CPU tensors
take its plain version.  Each kernel is a ``torch.library`` custom op
(``repro_torch::flash_attention``, ``::rownorm2``, ``::gradnorm_sigma``,
``::lru_scan``) with a fake implementation and a FLOP formula, so fake
tensors and the FLOP counter trace it, and on DTensors each wrapper runs
its op on the local shards (``local.py``).  The scan carries its
gradient (the op's registered autograd runs the same kernel backwards
in time), for the mixers' train mode.
"""
from __future__ import annotations

import torch

from . import local
from .flash_attention import flash_attention_bhsd
from .gradnorm import gradnorm_sigma, rownorm2
from .lru_scan import lru_scan

__all__ = ["flash_attention_bhsd", "rownorm2", "gradnorm_sigma",
           "lru_scan", "sigma_from_head", "softmax_rows"]


def softmax_rows(logits: torch.Tensor) -> torch.Tensor:
    """The fp32 softmax over the last dim.  On the CPU it is taken as
    exp(x - logsumexp(x)), a new plane (the difference) exponentiated in
    place: torch's CPU softmax sums a long row in fp32 with an error that
    grows with its length (5.9e-5 relative at 262144 columns, gemma3-12b's
    vocabulary, where its logsumexp stays near 3e-6), and p - y cancels
    that into sigma.  On CUDA the fused softmax is accurate and makes one
    pass over the plane where that form makes several, so it stays (the
    dry run's fake CPU tensors count the CPU's form)."""
    logits = logits.float()
    if logits.device.type != "cpu":
        return torch.softmax(logits, dim=-1)
    return torch.sub(logits, torch.logsumexp(logits, -1, keepdim=True)).exp_()


def sigma_from_head(h: torch.Tensor, logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Exact last-layer sigma from features + logits (fused path).

    h: (N, d) penultimate features; logits: (N, V); labels: (N,).
    p - y is formed in place on the fp32 softmax (``softmax_rows``), 1
    taken off at each row's label, so besides the logits only that (N,
    V) fp32 plane is allocated (no (N, V) one-hot); its values are those
    of p - one_hot.
    On DTensors the whole function runs on each shard's rows, split over
    every mesh dimension they divide: the rows' full vocabulary is then
    local to one rank.
    """
    if local.is_dtensor(logits):
        mesh = logits.device_mesh
        pl = local.rows_over_mesh(logits, logits.shape[0])
        h, labels = local.on_mesh(h, mesh), local.on_mesh(labels, mesh)
        return local.call_local(_sigma_from_head, (h, logits, labels),
                                (pl, pl, pl), pl, mesh)
    return _sigma_from_head(h, logits, labels)


def _sigma_from_head(h: torch.Tensor, logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    p = softmax_rows(logits)
    rows = torch.arange(p.shape[0], device=p.device)
    p[rows, labels.long()] -= 1.0
    return gradnorm_sigma(h, p)
