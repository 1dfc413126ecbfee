"""The paper's CNN (§VI-A): two 5x5 conv layers (10, 20 channels), each
followed by 2x2 max-pooling, then three fully-connected layers (ReLU
on the first two).

Counterpart of ``repro/models/cnn.py`` as an ``nn.Module``.  The
reference is NHWC with HWIO kernels and flattens the pooled map in
(h, w, c) order before ``fc1``; this module is NCHW and flattens in
(c, h, w) order, so ``params_from_numpy`` permutes the rows of the
reference's ``fc1`` weight to carry weights across, and
``params_to_numpy`` (checkpoints in the reference's layout) back.  "SAME" padding of
a 5x5 kernel is ``padding=2``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import full_fp32
from ..optim.optimizers import Layout


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    side: int = 28
    num_classes: int = 10
    conv_channels: Tuple[int, int] = (10, 20)
    fc_dims: Tuple[int, int] = (120, 84)

    @property
    def feature_dim(self) -> int:
        s = self.side // 4  # two 2x2 pools
        return s * s * self.conv_channels[1]


class CNN(nn.Module):
    """The §VI-A CNN; ``features`` also returns the penultimate layer."""

    def __init__(self, cfg: CNNConfig = CNNConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c1, c2 = cfg.conv_channels
        f1, f2 = cfg.fc_dims
        self.cfg = cfg
        self.conv1 = nn.Conv2d(1, c1, 5, padding=2)
        self.conv2 = nn.Conv2d(c1, c2, 5, padding=2)
        self.fc1 = nn.Linear(cfg.feature_dim, f1)
        self.fc2 = nn.Linear(f1, f2)
        self.out = nn.Linear(f2, cfg.num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """He-normal (truncated at 2 std, fan-in) weights and zero biases,
        the reference's initializer; the draws come from ``generator``."""
        for layer in (self.conv1, self.conv2, self.fc1, self.fc2, self.out):
            w = layer.weight
            fan_in = w[0].numel()
            # 0.8796... is the std of a unit normal truncated to [-2, 2]
            std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            layer.bias.zero_()

    def features(self, images: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(penultimate features h, logits). images: (B, side, side)."""
        x = images[:, None]
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = x.flatten(1)
        x = F.relu(self.fc1(x))
        h = F.relu(self.fc2(x))
        return h, self.out(h)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.features(images)[1]


def loss_fn(model: CNN, images: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy."""
    return F.cross_entropy(model(images), labels.long())


@torch.no_grad()
def accuracy(model: CNN, images: torch.Tensor, labels: torch.Tensor,
             batch: int = 512) -> float:
    correct = 0
    n = images.shape[0]
    with full_fp32():
        for i in range(0, n, batch):
            pred = torch.argmax(model(images[i:i + batch]), dim=-1)
            correct += int(torch.sum(pred == labels[i:i + batch]))
    return correct / n


#: this module's parameter suffixes -> the reference's leaf names
_LEAF = {"weight": "w", "bias": "b"}
_PARAM = {v: k for k, v in _LEAF.items()}


def nest(named: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """{"conv1.weight": x} -> {"conv1": {"w": x}}: this module's names
    as the reference's params pytree keys them (values untouched)."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, value in named.items():
        layer, leaf = name.split(".")
        out.setdefault(layer, {})[_LEAF[leaf]] = value
    return out


def unnest(tree: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """The inverse of ``nest``."""
    return {f"{layer}.{_PARAM[leaf]}": value
            for layer, leaves in tree.items()
            for leaf, value in leaves.items()}


def _layout(c: int, s: int) -> Layout:
    """(to the reference's layout, back) per weight, for a CNN whose
    second conv has ``c`` channels on an ``s`` x ``s`` pooled map."""
    def conv_to(w):
        return w.permute(2, 3, 1, 0)  # OIHW -> HWIO

    def conv_from(w):
        return w.permute(3, 2, 0, 1)

    def dense_to(w):
        return w.t()  # (out, in) -> (in, out)

    def fc1_to(w):
        # (out, in) -> (in, out), the rows (c, h, w) -> (h, w, c)
        return w.t().reshape(c, s, s, -1).permute(1, 2, 0, 3).reshape(
            s * s * c, -1)

    def fc1_from(w):
        return w.reshape(s, s, c, -1).permute(2, 0, 1, 3).reshape(
            c * s * s, -1).t()

    lay = {f"{n}.weight": (conv_to, conv_from) for n in ("conv1", "conv2")}
    lay["fc1.weight"] = (fc1_to, fc1_from)
    for n in ("fc2", "out"):
        lay[f"{n}.weight"] = (dense_to, dense_to)
    return lay


def reference_layout(params: Dict[str, torch.Tensor]) -> Layout:
    """Per weight of this module's named tensors, the pair of maps (to the
    reference's layout, back): conv kernels OIHW <-> HWIO, dense kernels
    (out, in) <-> (in, out), and the rows of ``fc1``'s kernel (c, h, w)
    <-> the reference's (h, w, c).  Every map is a permutation, so the
    values are exact; ``optim.adafactor(layout=...)`` factors each leaf
    under it, so its moments are the reference's."""
    c = params["conv2.weight"].shape[0]
    return _layout(c, math.isqrt(params["fc1.weight"].shape[1] // c))


def params_from_numpy(params_np: Dict[str, Dict[str, np.ndarray]]
                      ) -> Dict[str, torch.Tensor]:
    """The reference's params pytree (as numpy arrays) -> this module's
    ``state_dict``, through ``reference_layout``'s maps back: the rows
    of the reference's ``fc1`` weight are ordered (h, w, c), the NHWC
    flatten, and are reordered to (c, h, w), this module's NCHW flatten,
    so both compute the same function.
    """
    c = np.asarray(params_np["conv2"]["w"]).shape[3]
    s = math.isqrt(np.asarray(params_np["fc1"]["w"]).shape[0] // c)
    lay = _layout(c, s)
    sd = {}
    for name, x in unnest(params_np).items():
        t = torch.from_numpy(np.array(x, dtype=np.float32, order="C"))
        sd[name] = lay[name][1](t).contiguous() if name in lay else t
    return sd


def params_to_numpy(params: Dict[str, torch.Tensor]
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """This module's named tensors (its parameters, or optimizer state
    keyed like them) -> the reference's params pytree as float32 numpy
    arrays: the inverse of ``params_from_numpy``."""
    lay = reference_layout(params)
    out = {}
    for name, t in params.items():
        t = t.detach()
        if name in lay:
            t = lay[name][0](t)
        out[name] = np.array(t.cpu().numpy(), order="C")  # a copy
    return nest(out)
