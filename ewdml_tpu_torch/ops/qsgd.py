"""QSGD stochastic gradient quantization (``ewdml_tpu/ops/qsgd.py:1-161``).

Per-tensor (or per-block) L2 norm, stochastically rounded magnitude levels
in ``[0, s]``, sign restored on decode: ``decompress = norm / s * levels``.
Levels travel in the narrowest integer dtype that holds ``[-s, s]``.

The random stream follows the JAX package: the fused kernel's murmur stream
where ``ops/kernels.active_for`` selects the kernel path, ``jax.random``'s
threefry ``uniform`` (``utils/prng.uniform``) elsewhere. The shared-scale
(homomorphic) half of the JAX module is a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ewdml_tpu_torch.ops import kernels, packing
from ewdml_tpu_torch.ops.bytes import numel, tensor_nbytes
from ewdml_tpu_torch.utils import prng


def level_dtype(s: int):
    """Narrowest signed integer dtype holding levels in [-s, s]."""
    if s <= 127:
        return torch.int8
    if s <= 32767:
        return torch.int16
    return torch.int32


@dataclasses.dataclass
class QSGDPayload:
    """Wire format: integer levels + f32 norm(s). ``levels`` is flat (or
    bit-packed uint8 for ``s`` under 8 bits); ``norm`` is a 0-d f32 tensor
    (per tensor) or f32 ``[nblocks]`` (blockwise)."""

    levels: torch.Tensor
    norm: torch.Tensor
    shape: tuple
    s: int
    packed: bool = False
    block: Optional[int] = None

    @property
    def wire_bytes(self) -> int:
        return tensor_nbytes(self.levels) + 4 * self.norm.numel()


def _rows(flat: torch.Tensor, block: Optional[int]) -> torch.Tensor:
    """``[nb, block]`` zero-padded view (``[1, n]`` per tensor)."""
    n = flat.numel()
    if block is None:
        return flat.reshape(1, n)
    nb = -(-n // block)
    rows = torch.zeros(nb * block, dtype=torch.float32, device=flat.device)
    rows[:n] = flat
    return rows.reshape(nb, block)


def compress(key, g: torch.Tensor, s: int = 127, norm_kind: str = "l2",
             block: Optional[int] = None) -> QSGDPayload:
    """Quantize ``g`` to stochastically rounded levels (``qsgd.py:72``)."""
    flat = g.to(torch.float32).reshape(-1)
    n = flat.numel()
    rows = _rows(flat, block)
    if norm_kind == "linf":
        norm = rows.abs().amax(dim=1)
    elif norm_kind == "l2":
        norm = torch.linalg.vector_norm(rows, dim=1)
    else:
        raise ValueError(f"unknown norm_kind {norm_kind!r}")
    impl = kernels.active_for(n, flat.device)
    if impl is not None and s <= 127 and (
            block is None or kernels.blockwise_supported(block)):
        quantize = (kernels.qsgd_quantize if impl == "kernel"
                    else kernels.qsgd_quantize_ref)
        levels = quantize(flat, norm[0] if block is None else norm,
                          prng.seed_from_key(key), s,
                          block=block).to(torch.int32)
    else:
        u = prng.uniform(key, rows.shape, device=flat.device)
        norm_el = norm[:, None].expand_as(rows)
        levels = kernels.quantize_levels(rows, norm_el, u, s).to(
            torch.int32).reshape(-1)[:n]
    norm = norm[0] if block is None else norm
    shape = tuple(g.shape)
    if packing.width_for(s) < 8:
        return QSGDPayload(levels=packing.pack(levels, s), norm=norm,
                           shape=shape, s=s, packed=True, block=block)
    return QSGDPayload(levels=levels.to(level_dtype(s)), norm=norm,
                       shape=shape, s=s, block=block)


def levels_as_float(levels: torch.Tensor, s: int, n: int,
                    packed: bool) -> torch.Tensor:
    """Decode (possibly bit-packed) signed levels to f32."""
    if packed:
        return packing.unpack(levels, s, n).to(torch.float32)
    return levels.to(torch.float32)


def scale_levels(lv: torch.Tensor, norm: torch.Tensor, s: int,
                 block: Optional[int], n: int) -> torch.Tensor:
    """``norm / s * levels`` with blockwise norm expansion."""
    if block is None:
        return norm / s * lv
    nb = norm.numel()
    rows = torch.zeros(nb * block, dtype=torch.float32, device=lv.device)
    rows[:n] = lv
    return (rows.reshape(nb, block) * (norm[:, None] / s)).reshape(-1)[:n]


def decompress(p: QSGDPayload) -> torch.Tensor:
    """``norm / s * levels``, reshaped (``qsgd.py:154``)."""
    n = numel(p.shape)
    lv = levels_as_float(p.levels, p.s, n, p.packed)
    return scale_levels(lv, p.norm, p.s, p.block, n).reshape(p.shape)


class QSGDCompressor:
    """Class-shaped API of the reference's ``QSGDCompressor``."""

    def __init__(self, quantum_num: int = 127, norm_kind: str = "l2",
                 block: Optional[int] = None):
        self.quantum_num = quantum_num
        self.norm_kind = norm_kind
        self.block = block

    def compress(self, key, tensor: torch.Tensor) -> QSGDPayload:
        return compress(key, tensor, self.quantum_num, self.norm_kind,
                        self.block)

    def decompress(self, payload: QSGDPayload) -> torch.Tensor:
        return decompress(payload)

    def wire_bytes(self, shape) -> int:
        n = numel(shape)
        norms = 1 if self.block is None else -(-n // self.block)
        if packing.width_for(self.quantum_num) < 8:
            return packing.packed_nbytes(n, self.quantum_num) + 4 * norms
        return n * level_dtype(self.quantum_num).itemsize + 4 * norms
