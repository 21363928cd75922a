"""Strided block-top-k sparsification + QSGD (``ewdml_tpu/ops/blocktopk.py``).

View the flat bucket as a (blk_pad, nb) matrix (column c holds elements
``c, c + nb, c + 2nb, ...``) and keep the largest-|g| element of every
column: ``nb`` (about k = n * ratio) winners, found in one streaming pass
(``ops/kernels.block_top1``), dense by construction, shipped as a row offset
per column plus QSGD levels. Geometry and wire are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ewdml_tpu_torch.ops import kernels, packing, qsgd
from ewdml_tpu_torch.ops.bytes import numel, tensor_nbytes

_LANES = 128
_SUBLANES = 8


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def geometry(n: int, ratio: float) -> tuple:
    """``(nb, blk, blk_pad)`` for an n-element tensor at keep-ratio ``ratio``."""
    k = max(1, int(n * ratio))
    nb = min(round_up(k, _LANES), round_up(n, _LANES))
    blk = -(-n // nb)
    return nb, blk, round_up(blk, _SUBLANES)


def loc_dtype(blk_pad: int):
    """Narrowest unsigned dtype holding a row offset in [0, blk_pad - 1]."""
    if blk_pad <= 256:
        return torch.uint8
    if blk_pad <= 65536:
        return torch.uint16
    return torch.int32


@dataclasses.dataclass
class BlockTopKQSGDPayload:
    """Per-column winner row offsets + QSGD levels + norm(s)."""

    locs: torch.Tensor    # uint8/uint16/int32 [nb]
    levels: torch.Tensor  # int8/int16 [nb], or packed uint8
    norm: torch.Tensor    # f32 0-d, or f32 [nblocks]
    shape: tuple
    s: int
    nb: int
    blk_pad: int
    packed: bool = False
    block: Optional[int] = None

    @property
    def numel(self) -> int:
        return numel(self.shape)

    @property
    def indices(self) -> torch.Tensor:
        """Global flat indices: element (r, c) of the view is ``r * nb + c``."""
        return (self.locs.to(torch.int32) * self.nb
                + torch.arange(self.nb, dtype=torch.int32,
                               device=self.locs.device))

    @property
    def wire_bytes(self) -> int:
        return (tensor_nbytes(self.locs) + tensor_nbytes(self.levels)
                + 4 * self.norm.numel())


def select(flat: torch.Tensor, nb: int, blk_pad: int):
    """Strided block-top-1 over a flat f32 vector: ``(vals, locs)`` of the
    per-column winners of the (blk_pad, nb) view."""
    n = flat.numel()
    padded = torch.zeros(blk_pad * nb, dtype=torch.float32, device=flat.device)
    padded[:n] = flat
    x2 = padded.reshape(blk_pad, nb)
    impl = kernels.active_for(n, flat.device)
    if impl == "kernel":
        return kernels.block_top1(x2)
    if impl == "plain":
        return kernels.block_top1_ref(x2)
    return kernels.column_top1(x2)


def compress(key, g: torch.Tensor, ratio: float, s: int = 127,
             block: Optional[int] = None) -> BlockTopKQSGDPayload:
    """One winner per strided column, then QSGD on the winners."""
    flat = g.to(torch.float32).reshape(-1)
    nb, _, blk_pad = geometry(flat.numel(), ratio)
    vals, locs = select(flat, nb, blk_pad)
    q = qsgd.compress(key, vals, s, block=block)
    return BlockTopKQSGDPayload(
        locs=locs.to(loc_dtype(blk_pad)), levels=q.levels, norm=q.norm,
        shape=tuple(g.shape), s=s, nb=nb, blk_pad=blk_pad, packed=q.packed,
        block=block)


def dequant_values(p: BlockTopKQSGDPayload) -> torch.Tensor:
    """The nb dequantized winner values (no dense materialization)."""
    lv = qsgd.levels_as_float(p.levels, p.s, p.nb, p.packed)
    return qsgd.scale_levels(lv, p.norm, p.s, p.block, p.nb)


def expand(vals: torch.Tensor, locs: torch.Tensor, nb: int, blk_pad: int,
           numel_: int, shape) -> torch.Tensor:
    """One-hot expansion of per-column winners to dense (no scatter)."""
    rows = torch.arange(blk_pad, dtype=torch.int32, device=vals.device)[:, None]
    dense = torch.where(rows == locs.to(torch.int32)[None, :], vals[None, :],
                        torch.zeros((), dtype=vals.dtype, device=vals.device))
    return dense.reshape(-1)[:numel_].reshape(shape)


def decompress(p: BlockTopKQSGDPayload) -> torch.Tensor:
    return expand(dequant_values(p), p.locs, p.nb, p.blk_pad, p.numel, p.shape)


def wire_bytes_for(shape, ratio: float, s: int,
                   block: Optional[int] = None) -> int:
    """Analytic payload size, mirroring :func:`compress` exactly."""
    n = numel(shape)
    nb, _, blk_pad = geometry(n, ratio)
    norms = 1 if block is None else -(-nb // block)
    level_b = (packing.packed_nbytes(nb, s) if packing.width_for(s) < 8
               else nb * qsgd.level_dtype(s).itemsize)
    loc_b = loc_dtype(blk_pad).itemsize
    return nb * loc_b + level_b + 4 * norms
