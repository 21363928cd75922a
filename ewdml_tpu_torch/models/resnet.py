"""CIFAR ResNet family (``ewdml_tpu/models/resnet.py``).

3x3 stem with no pool, stages of 64, 128, 256, 512 planes at strides 1, 2,
2, 2, :class:`BasicBlock` (18/34) or :class:`Bottleneck` with expansion 4
(50/101/152), a projection shortcut (1x1 conv + BN) where the block changes
the shape, a 4x4 average pool and a linear head. Modules carry the Flax
names (``conv1``, ``bn1``, ``layer{s}_{i}``, ``linear``; inside a block
``conv1..3``, ``bn1..3``, ``shortcut_conv``, ``shortcut_bn``) so the
converter maps them by name. Convolutions have no bias and Kaiming fan-out
normal init on HWIO fans (``resnet.py:18``); BatchNorm has Flax semantics.
Inputs are NHWC, as in the JAX package.

The space-to-depth stem (``ResNet50s2d``) folds each 2x2 pixel block into
channels in the JAX order, so ``conv1``'s HWIO in-channel index is
``(dy, dx, c)``, and the stage strides become 1, 1, 2, 2.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ewdml_tpu_torch.models.layers import (BatchNorm, flatten_hwc,
                                           lecun_normal_dense_,
                                           space_to_depth, variance_scaling_)


def _conv(cin: int, cout: int, k: int, stride: int, g) -> nn.Conv2d:
    # A 1x1 conv under Flax's SAME padding pads nothing at any stride; a
    # 3x3 one is built with padding=1 as in Flax.
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
    variance_scaling_(conv.weight, 2.0, "fan_out", "normal",
                      k * k * cin, k * k * cout, g)
    return conv


class _Block(nn.Module):
    """What both blocks share: the projection shortcut, built exactly when
    the JAX block builds it (the stride or the channel count changes)."""

    def _shortcut(self, in_planes: int, planes: int, stride: int, g) -> None:
        out = planes * self.expansion
        self.has_shortcut = stride != 1 or in_planes != out
        if self.has_shortcut:
            self.shortcut_conv = _conv(in_planes, out, 1, stride, g)
            self.shortcut_bn = BatchNorm(out)

    def _residual(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.has_shortcut:
            return self.shortcut_bn(self.shortcut_conv(x), train)
        return x


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride, generator)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, generator)
        self.bn2 = BatchNorm(planes)
        self._shortcut(in_planes, planes, stride, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        return F.relu(out + self._residual(x, train))


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 1, 1, generator)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, generator)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, planes * self.expansion, 1, 1, generator)
        self.bn3 = BatchNorm(planes * self.expansion)
        self._shortcut(in_planes, planes, stride, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        return F.relu(out + self._residual(x, train))


class ResNet(nn.Module):
    def __init__(self, block=BasicBlock,
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 10, in_channels: int = 3,
                 input_hw: int = 32, seed: int = 0,
                 space_to_depth: bool = False):
        super().__init__()
        self.space_to_depth = space_to_depth
        g = torch.Generator().manual_seed(seed)
        c, hw = in_channels, input_hw
        if space_to_depth:
            c, hw = 4 * c, hw // 2
        self.conv1 = _conv(c, 64, 3, 1, g)
        self.bn1 = BatchNorm(64)
        strides = (1, 1, 2, 2) if space_to_depth else (1, 2, 2, 2)
        in_planes = 64
        self.blocks = []  # the blocks' names, in forward order
        for stage, (planes, stride) in enumerate(zip((64, 128, 256, 512),
                                                     strides)):
            for i in range(num_blocks[stage]):
                s = stride if i == 0 else 1
                blk = block(in_planes, planes, s, g)
                name = f"layer{stage + 1}_{i}"
                setattr(self, name, blk)
                self.blocks.append(name)
                in_planes = planes * block.expansion
                hw = (hw - 1) // s + 1
        hw = (hw - 4) // 4 + 1  # the 4x4 average pool, VALID
        self.linear = nn.Linear(in_planes * hw * hw, num_classes)
        lecun_normal_dense_(self.linear, g)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del generator  # no dropout in ResNet
        if self.space_to_depth:
            x = space_to_depth(x)
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x), train))
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = F.avg_pool2d(x, 4)
        return self.linear(flatten_hwc(x)).float()


def ResNet18(num_classes=10, **kw):
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, **kw)


def ResNet34(num_classes=10, **kw):
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes, **kw)


def ResNet50(num_classes=10, **kw):
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, **kw)


def ResNet50s2d(num_classes=10, **kw):
    """ResNet50 with the space-to-depth stem (a documented deviation from
    the reference, as in the JAX package)."""
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, space_to_depth=True,
                  **kw)


def ResNet101(num_classes=10, **kw):
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes, **kw)


def ResNet152(num_classes=10, **kw):
    return ResNet(Bottleneck, (3, 8, 36, 3), num_classes, **kw)
