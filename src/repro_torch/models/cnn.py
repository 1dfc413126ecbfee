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
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import full_fp32


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


def params_from_numpy(params_np: Dict[str, Dict[str, np.ndarray]]
                      ) -> Dict[str, torch.Tensor]:
    """The reference's params pytree (as numpy arrays) -> this module's
    ``state_dict``.

    Conv kernels go HWIO -> OIHW and dense kernels (in, out) -> (out, in).
    The rows of the reference's ``fc1`` weight are ordered (h, w, c), the
    NHWC flatten; they are reordered to (c, h, w), this module's NCHW
    flatten, so both compute the same function.
    """
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))

    sd = {}
    for name in ("conv1", "conv2"):
        sd[f"{name}.weight"] = t(np.transpose(params_np[name]["w"],
                                              (3, 2, 0, 1)))
        sd[f"{name}.bias"] = t(params_np[name]["b"])
    w1 = np.asarray(params_np["fc1"]["w"])
    c = np.asarray(params_np["conv2"]["w"]).shape[3]
    s = math.isqrt(w1.shape[0] // c)
    w1 = w1.reshape(s, s, c, -1).transpose(2, 0, 1, 3).reshape(w1.shape)
    sd["fc1.weight"] = t(w1.T)
    sd["fc1.bias"] = t(params_np["fc1"]["b"])
    for name in ("fc2", "out"):
        sd[f"{name}.weight"] = t(np.asarray(params_np[name]["w"]).T)
        sd[f"{name}.bias"] = t(params_np[name]["b"])
    return sd


def params_to_numpy(params: Dict[str, torch.Tensor]
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """This module's named tensors (its parameters, or Adam moments keyed
    like them) -> the reference's params pytree as float32 numpy arrays:
    the inverse of ``params_from_numpy``.

    Conv kernels go OIHW -> HWIO, dense kernels (out, in) -> (in, out),
    and the rows of ``fc1``'s kernel from (c, h, w) back to the
    reference's (h, w, c) order.  Every map is a permutation, so the
    values are exact.
    """
    def a(name):
        return params[name].detach().cpu().numpy()

    out = {}
    for name in ("conv1", "conv2"):
        out[name] = {"w": np.ascontiguousarray(
            np.transpose(a(f"{name}.weight"), (2, 3, 1, 0))),
            "b": a(f"{name}.bias").copy()}
    w1 = a("fc1.weight").T
    c = params["conv2.weight"].shape[0]
    s = math.isqrt(w1.shape[0] // c)
    w1 = w1.reshape(c, s, s, -1).transpose(1, 2, 0, 3).reshape(w1.shape)
    out["fc1"] = {"w": np.ascontiguousarray(w1), "b": a("fc1.bias").copy()}
    for name in ("fc2", "out"):
        out[name] = {"w": np.ascontiguousarray(a(f"{name}.weight").T),
                     "b": a(f"{name}.bias").copy()}
    return out
