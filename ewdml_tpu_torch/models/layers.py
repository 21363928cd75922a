"""Layers with the JAX package's (Flax's) semantics where PyTorch's differ.

- :class:`BatchNorm`: Flax ``nn.BatchNorm`` statistics. The batch variance
  is the biased ``E[x^2] - E[x]^2`` (clipped at zero) for both the
  normalization and the running average, and the running stats move as
  ``momentum * running + (1 - momentum) * batch`` with ``momentum = 0.9``.
  ``torch.nn.BatchNorm2d`` keeps an unbiased running variance instead.
  Statistics are taken in at least float32 (float32 under autocast,
  float64 in a float64 model), as Flax does.
- :class:`Dropout`: draws its mask from an explicit ``torch.Generator``
  (the per-rank dropout stream of the train step), and keeps
  ``x / keep`` where the draw is below ``keep``, as Flax does.
- Initializers: Flax's ``variance_scaling`` family.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))   # Flax 'scale'
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        shape = (1, -1, 1, 1)
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = (xf * xf).mean(dim=(0, 2, 3))
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout in train mode needs a torch.Generator "
                             "(the step's per-rank dropout stream)")
        keep = 1.0 - self.rate
        draw = torch.rand(x.shape, generator=generator, device=x.device)
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))


def variance_scaling_(t: torch.Tensor, scale: float, mode: str,
                      distribution: str, fan_in: int, fan_out: int,
                      generator: torch.Generator) -> torch.Tensor:
    """Flax/JAX ``variance_scaling`` on a tensor (fans given explicitly,
    since the Flax layout of the kernel is not the PyTorch one)."""
    n = {"fan_in": fan_in, "fan_out": fan_out,
         "fan_avg": (fan_in + fan_out) / 2}[mode]
    std = math.sqrt(scale / n)
    with torch.no_grad():
        if distribution == "normal":
            return t.normal_(0.0, std, generator=generator)
        if distribution == "truncated_normal":
            std = std / 0.87962566103423978  # stddev of N(0,1) cut at +-2
            return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                         generator=generator)
    raise ValueError(f"unknown distribution {distribution!r}")


def lecun_normal_conv_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    o, i, kh, kw = conv.weight.shape
    variance_scaling_(conv.weight, 1.0, "fan_in", "truncated_normal",
                      i * kh * kw, o * kh * kw, generator)
    nn.init.zeros_(conv.bias)


def lecun_normal_dense_(fc: nn.Linear, generator: torch.Generator) -> None:
    o, i = fc.weight.shape
    variance_scaling_(fc.weight, 1.0, "fan_in", "truncated_normal", i, o,
                      generator)
    nn.init.zeros_(fc.bias)


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten NCHW activations in Flax's NHWC (h, w, c) order, so a Dense
    kernel converted from Flax applies unchanged."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """Fold each 2x2 pixel block of NHWC ``x`` into channels in the JAX
    package's order (``[b, h, w, c] -> [b, h/2, w/2, 4c]``, the channel
    index ``(dy, dx, c)``)."""
    b, h, w, c = x.shape
    return (x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, h // 2, w // 2, 4 * c))
