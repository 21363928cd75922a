"""LeNet for MNIST (``ewdml_tpu/models/lenet.py``).

conv(1->20, 5x5, VALID) -> maxpool2 -> relu -> conv(20->50, 5x5, VALID) ->
maxpool2 -> relu -> flatten(4*4*50, in Flax's h, w, c order) -> fc500 ->
fc10, with the reference's quirks kept: relu after pooling, no activation
between fc1 and fc2. Inputs are NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ewdml_tpu_torch.models.layers import (flatten_hwc, lecun_normal_conv_,
                                           lecun_normal_dense_)


class LeNet(nn.Module):
    def __init__(self, num_classes: int = 10, seed: int = 0):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 20, 5)
        self.conv2 = nn.Conv2d(20, 50, 5)
        self.fc1 = nn.Linear(4 * 4 * 50, 500)
        self.fc2 = nn.Linear(500, num_classes)
        g = torch.Generator().manual_seed(seed)
        for conv in (self.conv1, self.conv2):
            lecun_normal_conv_(conv, g)
        for fc in (self.fc1, self.fc2):
            lecun_normal_dense_(fc, g)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del train, generator  # no dropout or BN in LeNet
        x = x.permute(0, 3, 1, 2)
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = F.relu(F.max_pool2d(self.conv2(x), 2))
        x = self.fc1(flatten_hwc(x))
        return self.fc2(x).float()
