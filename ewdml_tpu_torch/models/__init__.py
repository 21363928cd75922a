"""Model factory (``ewdml_tpu/models/__init__.py``): LeNet, the ResNet
family and the VGG-BN family by their ``--network`` names, every key of
the JAX package's factory."""

from __future__ import annotations

from ewdml_tpu_torch.models.lenet import LeNet
from ewdml_tpu_torch.models.resnet import (BasicBlock, Bottleneck, ResNet,
                                           ResNet18, ResNet34, ResNet50,
                                           ResNet50s2d, ResNet101, ResNet152)
from ewdml_tpu_torch.models.vgg import (VGG, vgg11, vgg11_bn, vgg11_s2d,
                                        vgg13_bn, vgg16_bn, vgg19_bn)

__all__ = ["LeNet", "BasicBlock", "Bottleneck", "ResNet", "ResNet18",
           "ResNet34", "ResNet50", "ResNet50s2d", "ResNet101", "ResNet152",
           "VGG", "vgg11", "vgg11_bn", "vgg11_s2d", "vgg13_bn", "vgg16_bn",
           "vgg19_bn", "build_model", "input_shape_for", "num_classes_for"]

_FACTORY = {
    "lenet": lambda n, **kw: LeNet(num_classes=n, **kw),
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": ResNet50,
    "resnet50s2d": ResNet50s2d,  # space-to-depth stem (documented deviation)
    "resnet101": ResNet101,
    "resnet152": ResNet152,
    "vgg11": vgg11_bn,  # util.py:14 builds the BN variant for "VGG11"
    "vgg11_bn": vgg11_bn,
    "vgg11s2d": vgg11_s2d,  # space-to-depth stem (documented deviation)
    "vgg13": vgg13_bn,
    "vgg16": vgg16_bn,
    "vgg19": vgg19_bn,
}


def build_model(network: str, num_classes: int = 10, dataset: str = "cifar10",
                seed: int = 0):
    """``build_model`` (reference ``util.py:7-18``); ``seed`` drives the
    Flax-style initializers, ``dataset`` sets the input geometry (height
    and channels) of the VGG and ResNet families."""
    key = network.lower().replace("-", "")
    if key not in _FACTORY:
        raise ValueError(
            f"unknown network {network!r}; choose from {sorted(_FACTORY)}")
    if key == "lenet":
        return _FACTORY[key](num_classes, seed=seed)
    h, _, c = input_shape_for(dataset)
    return _FACTORY[key](num_classes, in_channels=c, input_hw=h, seed=seed)


def input_shape_for(dataset: str):
    """(H, W, C) for each supported dataset (reference ``util.py:20-106``)."""
    d = dataset.lower()
    if d in ("mnist", "mnist10k"):
        return (28, 28, 1)
    if d in ("mnist32", "mnist10k32"):
        return (32, 32, 1)
    if d in ("cifar10", "cifar100", "svhn"):
        return (32, 32, 3)
    raise ValueError(f"unknown dataset {dataset!r}")


def num_classes_for(dataset: str) -> int:
    return 100 if dataset.lower() == "cifar100" else 10
