"""One-buffer transfer of a tree of tensors (``ewdml_tpu/utils/transfer.py``).

A pull or a push moves ONE contiguous uint8 buffer: the tree's leaves,
each as its little-endian bytes, concatenated in leaf order. The layout is
the JAX package's byte for byte, so a buffer packed by one package unpacks
in the other:

- a tree is a tensor, a list of trees or a payload dataclass, whose tensor
  fields are its leaves in declaration order (the ``flax.struct``
  payloads' pytree fields);
- a parameter tree is the list of parameters in the JAX tree's leaf order
  (``models/convert.leaf_specs``), each in Flax layout.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class LeafSpec(NamedTuple):
    dtype: str
    shape: tuple
    nbytes: int


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in leaf order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if dataclasses.is_dataclass(tree):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)
                if isinstance(getattr(tree, f.name), torch.Tensor)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_unflatten(template, leaves: list):
    """``template`` with its tensors replaced, in leaf order, by
    ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, list):
            return [build(x) for x in t]
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{
                f.name: next(it) for f in dataclasses.fields(t)
                if isinstance(getattr(t, f.name), torch.Tensor)})
        raise TypeError(f"not a tree of tensors: {type(t).__name__}")

    return build(template)


def specs_of(tree) -> list:
    return [LeafSpec(_dtype_name(t.dtype), tuple(t.shape),
                     t.numel() * t.element_size())
            for t in tree_leaves(tree)]


def _to_bytes(t: torch.Tensor) -> torch.Tensor:
    """Any tensor as a flat uint8 view of its bytes (a copy only when it is
    not contiguous)."""
    flat = t.contiguous().reshape(-1)
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def make_device_packer():
    """``tree -> uint8[total]`` on the tree's device: leaf order x leaf
    bytes. Pair with :func:`make_device_unpacker` built from the same
    structure."""

    def pack(tree) -> torch.Tensor:
        return torch.cat([_to_bytes(t) for t in tree_leaves(tree)])

    return pack


def make_device_unpacker(template_tree):
    """``uint8[total] -> tree`` shaped like ``template_tree``. A leaf whose
    bytes do not start at a multiple of its item size is copied before it
    is reinterpreted."""
    specs = specs_of(template_tree)

    def unpack(buf: torch.Tensor):
        out, off = [], 0
        for spec in specs:
            chunk = buf[off:off + spec.nbytes]
            dtype = getattr(torch, spec.dtype)
            if dtype != torch.uint8:
                if chunk.storage_offset() % dtype.itemsize:
                    chunk = chunk.clone()
                chunk = chunk.view(dtype)
            out.append(chunk.reshape(spec.shape))
            off += spec.nbytes
        return tree_unflatten(template_tree, out)

    return unpack
