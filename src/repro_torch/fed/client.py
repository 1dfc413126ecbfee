"""Device-side computation (paper §II-B).

Counterpart of ``repro/fed/client.py``:

* ``per_sample_sigma`` — sigma_{k,j} = ||g_{k,j}||^2 for every sample.
  Two methods:
    - "last_layer": the output layer's gradient norm; for a linear head
      with CE loss, ||g_j||^2 = ||p_j - y_j||^2 * (||h_j||^2 + 1), in
      plain tensor ops;
    - "full": the literal paper quantity over every parameter, one
      gradient per sample (``torch.func.vmap`` of ``grad`` over
      ``functional_call``);
* ``batched_sigma`` — the same score for all devices in one flat
  forward pass, scored by the CUDA row-norm kernel
  (``kernels.gradnorm.gradnorm_sigma``);
* ``local_gradient`` — eq. (4): the gradient of the loss averaged over
  the *selected* samples, one weighted-loss backward per device (the
  reference vmaps a per-sample loss; the weighted sum is the same
  function);
* ``local_deltas`` — the FedAvg variant (paper footnote 4): each device
  runs ``steps`` SGD steps on its eq.-(4) loss from the round's params
  w and uploads the pseudo-gradient (w - w') / lr, aggregated like a
  gradient.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call, grad, vmap

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


def per_sample_sigma(model: CNN, images: torch.Tensor, labels: torch.Tensor,
                     method: str = "last_layer") -> torch.Tensor:
    """sigma for each sample: (B,)."""
    if method == "last_layer":
        with torch.no_grad(), full_fp32():
            h, d = _head_residuals(model, images, labels)
        return gradnorm_mod.gradnorm_sigma_plain(h, d)
    if method == "full":
        params = {n: p.detach() for n, p in model.named_parameters()}

        def loss(p, img, lab):
            logits = functional_call(model, p, (img[None],))
            return F.cross_entropy(logits, lab[None].long())

        def one(img, lab):
            g = grad(loss)(params, img, lab)
            return sum(torch.sum(torch.square(x)) for x in g.values())

        with full_fp32():
            return vmap(one)(images, labels).detach()
    raise ValueError(f"unknown sigma method: {method}")


@torch.no_grad()
def _flat_head_sigma(model: CNN, images: torch.Tensor, labels: torch.Tensor,
                     score) -> torch.Tensor:
    """(K, D̂) "last_layer" sigma from one flat (K*D̂, ...) forward pass,
    scored by ``score(h, p - y)``."""
    K, D = labels.shape[:2]
    flat = images.reshape((K * D,) + tuple(images.shape[2:]))
    with full_fp32():
        h, d = _head_residuals(model, flat, labels.reshape(-1))
    return score(h, d).reshape(K, D)


def device_sigma(model: CNN, images: torch.Tensor, labels: torch.Tensor,
                 method: str = "last_layer") -> torch.Tensor:
    """(K, D̂) sigma, ``per_sample_sigma`` of each device's samples:
    "last_layer" in one flat pass scored by the kernel's plain version;
    "full" a device at a time, which bounds the per-sample gradients'
    memory to one device's."""
    if method == "last_layer":
        return _flat_head_sigma(model, images, labels,
                                gradnorm_mod.gradnorm_sigma_plain)
    return torch.stack([per_sample_sigma(model, images[k], labels[k],
                                         method=method)
                        for k in range(labels.shape[0])])


def batched_sigma(model: CNN, images: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """All-device "last_layer" sigma in one fused pass: (K, D̂).

    Flattens the (K, D̂, ...) round batch into one (K*D̂, ...) forward
    pass and scores it with the fused row-norm kernel.
    """
    return _flat_head_sigma(model, images, labels,
                            gradnorm_mod.gradnorm_sigma)


def _weighted_loss(logits: torch.Tensor, labels: torch.Tensor,
                   delta: torch.Tensor) -> torch.Tensor:
    """eq. (4)'s loss (sum_j delta_j l_j) / (sum_j delta_j)."""
    losses = F.cross_entropy(logits, labels.long(), reduction="none")
    return torch.sum(delta * losses) / torch.clamp(torch.sum(delta),
                                                   min=1e-9)


def local_gradient(model: CNN, images: torch.Tensor, labels: torch.Tensor,
                   delta: torch.Tensor) -> Dict[str, torch.Tensor]:
    """eq. (4): grad of (sum_j delta_j l_j) / (sum_j delta_j)."""
    names, params = zip(*model.named_parameters())
    with full_fp32():
        grads = torch.autograd.grad(
            _weighted_loss(model(images), labels, delta), params)
    return dict(zip(names, grads))


def local_gradients(model: CNN, images: torch.Tensor, labels: torch.Tensor,
                    delta: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every device's eq. (4) gradient, stacked on a leading K axis."""
    return _stack([local_gradient(model, images[k], labels[k], delta[k])
                   for k in range(labels.shape[0])])


def local_delta(model: CNN, images: torch.Tensor, labels: torch.Tensor,
                delta: torch.Tensor, lr: float,
                steps: int) -> Dict[str, torch.Tensor]:
    """FedAvg on one device: ``steps`` SGD steps w <- w - lr * g on the
    eq.-(4) loss from the model's params w, then the pseudo-gradient
    (w - w') / lr.  The model's own parameters are not touched."""
    w = {n: p.detach() for n, p in model.named_parameters()}
    p = w
    for _ in range(steps):
        leaves = {n: t.detach().requires_grad_(True) for n, t in p.items()}
        with full_fp32():
            grads = torch.autograd.grad(
                _weighted_loss(functional_call(model, leaves, (images,)),
                               labels, delta), tuple(leaves.values()))
        p = {n: t.detach() - lr * g
             for (n, t), g in zip(leaves.items(), grads)}
    return {n: (w[n] - p[n]) / lr for n in w}


def local_deltas(model: CNN, images: torch.Tensor, labels: torch.Tensor,
                 delta: torch.Tensor, lr: float,
                 steps: int) -> Dict[str, torch.Tensor]:
    """Every device's FedAvg pseudo-gradient, stacked on a leading K
    axis."""
    return _stack([local_delta(model, images[k], labels[k], delta[k], lr,
                               steps) for k in range(labels.shape[0])])


def _stack(per_device) -> Dict[str, torch.Tensor]:
    return {name: torch.stack([g[name] for g in per_device])
            for name in per_device[0]}
