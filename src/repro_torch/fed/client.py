"""Device-side computation (paper §II-B).

Counterpart of ``repro/fed/client.py``:

* ``per_sample_sigma`` — sigma_{k,j} = ||g_{k,j}||^2 of the output layer
  ("last_layer"): for a linear head with CE loss,
  ||g_j||^2 = ||p_j - y_j||^2 * (||h_j||^2 + 1), in plain tensor ops;
* ``batched_sigma`` — the same score for all devices in one flat
  forward pass, scored by the CUDA row-norm kernel
  (``kernels.gradnorm.gradnorm_sigma``);
* ``local_gradient`` — eq. (4): the gradient of the loss averaged over
  the *selected* samples, one weighted-loss backward per device (the
  reference vmaps a per-sample loss; the weighted sum is the same
  function).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..device import full_fp32
from ..kernels import gradnorm as gradnorm_mod
from ..models.cnn import CNN


def _head_residuals(model: CNN, images: torch.Tensor,
                    labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(features h, logit residuals p - y) of the linear head."""
    h, logits = model.features(images)
    p = torch.softmax(logits, dim=-1)
    y = F.one_hot(labels.long(), logits.shape[-1]).to(p.dtype)
    return h, p - y


@torch.no_grad()
def per_sample_sigma(model: CNN, images: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """"last_layer" sigma for each sample: (B,)."""
    with full_fp32():
        h, d = _head_residuals(model, images, labels)
    return torch.sum(d * d, dim=-1) * (torch.sum(h * h, dim=-1) + 1.0)


@torch.no_grad()
def batched_sigma(model: CNN, images: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """All-device "last_layer" sigma in one fused pass: (K, D̂).

    Flattens the (K, D̂, ...) round batch into one (K*D̂, ...) forward
    pass and scores it with the fused row-norm kernel.
    """
    K, D = labels.shape[:2]
    flat = images.reshape((K * D,) + tuple(images.shape[2:]))
    with full_fp32():
        h, d = _head_residuals(model, flat, labels.reshape(-1))
    return gradnorm_mod.gradnorm_sigma(h, d).reshape(K, D)


def local_gradient(model: CNN, images: torch.Tensor, labels: torch.Tensor,
                   delta: torch.Tensor) -> Dict[str, torch.Tensor]:
    """eq. (4): grad of (sum_j delta_j l_j) / (sum_j delta_j)."""
    names, params = zip(*model.named_parameters())
    with full_fp32():
        losses = F.cross_entropy(model(images), labels.long(),
                                 reduction="none")
        loss = torch.sum(delta * losses) / torch.clamp(torch.sum(delta),
                                                       min=1e-9)
        grads = torch.autograd.grad(loss, params)
    return dict(zip(names, grads))


def local_gradients(model: CNN, images: torch.Tensor, labels: torch.Tensor,
                    delta: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every device's eq. (4) gradient, stacked on a leading K axis."""
    per_device = [local_gradient(model, images[k], labels[k], delta[k])
                  for k in range(labels.shape[0])]
    return {name: torch.stack([g[name] for g in per_device])
            for name in per_device[0]}
