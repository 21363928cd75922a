"""VGG for CIFAR (``ewdml_tpu/models/vgg.py``).

Feature configs A/B/D/E, optional BatchNorm with Flax semantics, classifier
dropout -> 512 -> relu -> dropout -> 512 -> relu -> num_classes, Kaiming
fan-out normal conv init (``vgg.py:31``). Layers are named after the config
index as in Flax (``conv0, bn0, conv2, ...``) so the converter maps them by
name. Inputs are NHWC, as in the JAX package.

``vgg11_s2d`` puts the space-to-depth reshape in front of ``conv0`` and
drops the first max-pool (``ewdml_tpu/models/vgg.py:54-57,94-102``); the
layers keep their config-index names, so the names shift as in Flax.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ewdml_tpu_torch.models.layers import (BatchNorm, Dropout, flatten_hwc,
                                           lecun_normal_dense_,
                                           space_to_depth, variance_scaling_)

CFG = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Module):
    def __init__(self, cfg: Sequence = tuple(CFG["A"]), batch_norm: bool = True,
                 num_classes: int = 10, in_channels: int = 3,
                 input_hw: int = 32, seed: int = 0,
                 space_to_depth: bool = False):
        super().__init__()
        self.cfg = tuple(cfg)
        self.batch_norm = batch_norm
        self.space_to_depth = space_to_depth
        g = torch.Generator().manual_seed(seed)
        c, hw = in_channels, input_hw
        if space_to_depth:
            c, hw = 4 * c, hw // 2
        for i, v in enumerate(self.cfg):
            if v == "M":
                hw //= 2
                continue
            conv = nn.Conv2d(c, v, 3, padding=1)
            # Flax variance_scaling(2.0, "fan_out", "normal"), HWIO fans.
            variance_scaling_(conv.weight, 2.0, "fan_out", "normal",
                              9 * c, 9 * v, g)
            nn.init.zeros_(conv.bias)
            setattr(self, f"conv{i}", conv)
            if batch_norm:
                setattr(self, f"bn{i}", BatchNorm(v))
            c = v
        self.drop1 = Dropout(0.5)
        self.fc1 = nn.Linear(c * hw * hw, 512)
        self.drop2 = Dropout(0.5)
        self.fc2 = nn.Linear(512, 512)
        self.fc3 = nn.Linear(512, num_classes)
        for fc in (self.fc1, self.fc2, self.fc3):
            lecun_normal_dense_(fc, g)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.space_to_depth:
            x = space_to_depth(x)
        x = x.permute(0, 3, 1, 2)
        for i, v in enumerate(self.cfg):
            if v == "M":
                x = F.max_pool2d(x, 2)
                continue
            x = getattr(self, f"conv{i}")(x)
            if self.batch_norm:
                x = getattr(self, f"bn{i}")(x, train)
            x = F.relu(x)
        x = self.drop1(flatten_hwc(x), train, generator)
        x = F.relu(self.fc1(x))
        x = self.drop2(x, train, generator)
        x = F.relu(self.fc2(x))
        return self.fc3(x).float()


def vgg11(num_classes=10, **kw):
    """Plain VGG11 (config A)."""
    return VGG(cfg=tuple(CFG["A"]), batch_norm=False, num_classes=num_classes, **kw)


def vgg11_bn(num_classes=10, **kw):
    """VGG11 + BN: the network the reference trains as ``VGG11``."""
    return VGG(cfg=tuple(CFG["A"]), batch_norm=True, num_classes=num_classes, **kw)


def vgg11_s2d(num_classes=10, **kw):
    """VGG11-BN with the space-to-depth stem (a documented deviation from
    the reference, as in the JAX package): the first max-pool is dropped,
    since the reshape already halves the spatial dims."""
    cfg_a = list(CFG["A"])
    cfg_a.remove("M")  # the first "M"
    return VGG(cfg=tuple(cfg_a), batch_norm=True, num_classes=num_classes,
               space_to_depth=True, **kw)


def vgg13_bn(num_classes=10, **kw):
    return VGG(cfg=tuple(CFG["B"]), batch_norm=True, num_classes=num_classes, **kw)


def vgg16_bn(num_classes=10, **kw):
    return VGG(cfg=tuple(CFG["D"]), batch_norm=True, num_classes=num_classes, **kw)


def vgg19_bn(num_classes=10, **kw):
    return VGG(cfg=tuple(CFG["E"]), batch_norm=True, num_classes=num_classes, **kw)
