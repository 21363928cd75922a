"""The JAX package's parameter layout, and conversion to and from it.

Compression is not layout-invariant: bucket boundaries follow the leaf
order, block-top-1 columns, blockwise norms and the murmur stream follow
the flat element order. So the trainer hands the compressor its gradients
as the JAX tree would hold them:

- leaves in ``jax.tree.flatten`` order: the keys of every level of the
  nested tree sorted as strings (``bn0 < bn10 < ... < conv0 < ... < fc1``;
  ``layer3_1 < layer3_10 < layer3_2``), then ``bias`` before
  ``kernel``/``scale``. A leaf's Flax path is its PyTorch module path with
  every ``.`` a ``/`` (``layer1_0.conv1.weight`` -> ``layer1_0/conv1/kernel``);
- elements in Flax layout: conv kernels HWIO (PyTorch keeps OIHW), Dense
  kernels ``[in, out]`` (PyTorch keeps ``[out, in]``).

:func:`leaf_specs` names that order once per model; :func:`to_jax` and
:func:`from_jax` move one tensor between the layouts. :func:`flax_to_torch`
turns Flax ``params``/``batch_stats`` (numpy) into the model's state dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    name: str        # Flax path, e.g. "conv0/kernel", "layer1_0/bn1/scale"
    torch_name: str  # state-dict key, e.g. "conv0.weight"
    kind: str        # "conv" | "dense" | "vector"
    jax_shape: tuple


def _kind(module) -> str:
    if isinstance(module, torch.nn.Conv2d):
        return "conv"
    if isinstance(module, torch.nn.Linear):
        return "dense"
    return "vector"


def leaf_specs(model: torch.nn.Module) -> list:
    """The model's trainable leaves in the JAX tree's flatten order."""
    specs = []
    modules = dict(model.named_modules())
    for tname, p in model.named_parameters():
        layer, attr = tname.rsplit(".", 1)
        kind = _kind(modules[layer])
        if attr == "bias":
            leaf = "bias"
        else:
            leaf = "kernel" if kind in ("conv", "dense") else "scale"
        shape = tuple(p.shape)
        if kind == "conv" and attr == "weight":
            o, i, kh, kw = shape
            shape = (kh, kw, i, o)
        elif kind == "dense" and attr == "weight":
            shape = (shape[1], shape[0])
        specs.append(LeafSpec(_flax_path(layer, leaf), tname,
                              kind if attr == "weight" else "vector", shape))
    return sorted(specs, key=lambda s: tuple(s.name.split("/")))


def _flax_path(module_path: str, leaf: str) -> str:
    return "/".join(module_path.split(".") + [leaf])


def _stat_paths(model: torch.nn.Module) -> list:
    """``(buffer name, Flax batch_stats path)`` of every BatchNorm
    statistic, e.g. ``("layer1_0.bn1.running_mean", "layer1_0/bn1/mean")``."""
    out = []
    for name, _ in model.named_buffers():
        layer, attr = name.rsplit(".", 1)
        flax_attr = {"running_mean": "mean", "running_var": "var"}[attr]
        out.append((name, _flax_path(layer, flax_attr)))
    return out


def to_jax(t: torch.Tensor, kind: str) -> torch.Tensor:
    """PyTorch layout -> Flax layout (a view where possible)."""
    if kind == "conv":
        return t.permute(2, 3, 1, 0)   # OIHW -> HWIO
    if kind == "dense":
        return t.t()                   # [out, in] -> [in, out]
    return t


def from_jax(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Flax layout -> PyTorch layout (a view where possible)."""
    if kind == "conv":
        return t.permute(3, 2, 0, 1)   # HWIO -> OIHW
    if kind == "dense":
        return t.t()
    return t


def _get(tree: dict, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _put(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[leaf] = value


def flax_to_torch(model: torch.nn.Module, params: dict,
                  batch_stats: dict | None = None) -> dict:
    """State dict for ``model`` from Flax ``params`` (and ``batch_stats``,
    where the model has BatchNorm), given as nested dicts of numpy arrays."""
    sd = {}
    for spec in leaf_specs(model):
        arr = torch.from_numpy(np.array(_get(params, spec.name), np.float32))
        sd[spec.torch_name] = from_jax(arr, spec.kind).contiguous()
    for name, path in _stat_paths(model):
        arr = np.array(_get(batch_stats or {}, path), np.float32)
        sd[name] = torch.from_numpy(arr)
    return sd


def torch_to_flax(model: torch.nn.Module) -> tuple:
    """``(params, batch_stats)`` as nested dicts of numpy arrays in Flax
    layout (the inverse of :func:`flax_to_torch`)."""
    sd = model.state_dict()
    params: dict = {}
    for spec in leaf_specs(model):
        t = to_jax(sd[spec.torch_name].detach().cpu(), spec.kind)
        _put(params, spec.name, t.contiguous().numpy())
    stats: dict = {}
    for name, path in _stat_paths(model):
        _put(stats, path, sd[name].detach().cpu().numpy())
    return params, stats
