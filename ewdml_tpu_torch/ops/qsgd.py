"""QSGD stochastic gradient quantization (``ewdml_tpu/ops/qsgd.py``).

Per-tensor (or per-block) L2 norm, stochastically rounded magnitude levels
in ``[0, s]``, sign restored on decode: ``decompress = norm / s * levels``.
Levels travel in the narrowest integer dtype that holds ``[-s, s]``.

The random stream follows the JAX package: the fused kernel's murmur stream
where ``ops/kernels.active_for`` selects the kernel path, ``jax.random``'s
threefry ``uniform`` (``utils/prng.uniform``) elsewhere.

The shared-scale (homomorphic) half (``qsgd.py:163-360``): every worker
quantizes against one scale contract, negotiated once from a template
gradient, so the server sums the int8 levels of K payloads exactly in an
int32 accumulator and dequantizes once per round (``ops/homomorphic.py``,
``--server-agg homomorphic``).
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


def l2_norms(rows: torch.Tensor) -> torch.Tensor:
    """The f32 L2 norm of each row, summed in f64 and rounded once.

    The two packages sum an f32 norm in different orders, and PyTorch's
    CPU reduction drifts far more than XLA's: over the 200 000 winners of a
    Top-k relay at ratio 0.5 it was 8.6e-5 relative off, and every relayed
    value carries its norm (ROADMAP Queue 3 item 6). Summed in f64, the
    norm is within an ulp of ``jnp.linalg.norm`` on every device."""
    return torch.linalg.vector_norm(rows, dim=1,
                                    dtype=torch.float64).to(torch.float32)


def compress(key, g: torch.Tensor, s: int = 127, norm_kind: str = "l2",
             block: Optional[int] = None) -> QSGDPayload:
    """Quantize ``g`` to stochastically rounded levels (``qsgd.py:72``)."""
    flat = g.to(torch.float32).reshape(-1)
    n = flat.numel()
    rows = _rows(flat, block)
    if norm_kind == "linf":
        norm = rows.abs().amax(dim=1)
    elif norm_kind == "l2":
        norm = l2_norms(rows)
    else:
        raise ValueError(f"unknown norm_kind {norm_kind!r}")
    impl = kernels.active_for(n, flat.device)
    if impl is not None and s <= 127 and (
            block is None or kernels.blockwise_supported(block)):
        quantize = (kernels.qsgd_quantize if impl == "kernel"
                    else kernels.qsgd_quantize_ref)
        levels = quantize(flat, norm[0] if block is None else norm,
                          prng.seed_tensor(key, flat.device), s,
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


# -- shared-scale (tensor-homomorphic) encode mode ----------------------------

#: int32 is the widened accumulator of the homomorphic sum; per-worker levels
#: are clipped to [-s, s], so a K-way sum is bounded by K * s.
ACC_DTYPE_MAX = 2**31 - 1


def max_world_for(s: int) -> int:
    """Largest W-way homomorphic sum the int32 accumulator admits at level
    budget ``s``."""
    return ACC_DTYPE_MAX // max(1, int(s))


def check_sum_budget(s: int, world: int) -> None:
    """Raise unless a ``world``-way sum of clipped levels fits int32."""
    if world > max_world_for(s):
        raise ValueError(
            f"homomorphic sum of {world} workers at s={s} can reach "
            f"{world * s}, overflowing the int32 accumulator; the level "
            f"budget admits at most {max_world_for(s)} workers")


def shared_scales(g: torch.Tensor, s: int, block: Optional[int] = None,
                  headroom: float = 2.0) -> torch.Tensor:
    """The per-block scale contract from a template gradient:
    ``headroom * ||g_block|| / s``; a zero block takes the leaf's largest
    scale (or ``1/s`` for an all-zero leaf). f32 [1] or [nblocks]; the
    norms are :func:`l2_norms`."""
    flat = g.to(torch.float32).reshape(-1)
    scale = l2_norms(_rows(flat, block)) * kernels.f32_scalar(headroom / s)
    fallback = torch.maximum(scale.max(),
                             kernels.f32_scalar(1.0 / s).to(flat.device))
    return torch.where(scale > 0.0, scale, fallback)


def shared_levels(key, x: torch.Tensor, scale: torch.Tensor,
                  s: int) -> torch.Tensor:
    """Stochastically rounded signed int8 levels of ``x`` against an
    elementwise ``scale``, clipped to [-s, s]; the random draw is
    ``jax.random.uniform``'s threefry stream for ``key``."""
    level_float = x.abs() / scale
    previous = torch.floor(level_float)
    u = prng.uniform(key, x.shape, device=x.device)
    level = previous + (u < (level_float - previous)).to(torch.float32)
    level = torch.minimum(level, kernels.f32_scalar(float(s)))
    return (torch.sign(x) * level).to(torch.int8)


def shared_wire_bytes(n: int) -> int:
    """Wire bytes of the shared-scale dense payload: int8 levels only."""
    return n


@dataclasses.dataclass
class SharedScaleQSGDPayload:
    """Homomorphic wire format: int8 levels only (the scale is contract
    state both endpoints hold)."""

    levels: torch.Tensor  # int8 [n]
    shape: tuple
    s: int
    block: Optional[int] = None

    @property
    def wire_bytes(self) -> int:
        return tensor_nbytes(self.levels)


def expand_scales(scales: torch.Tensor, block: Optional[int],
                  n: int) -> torch.Tensor:
    """Elementwise view of a [nb] (or [1]) scale vector over a flat [n]."""
    scales = scales.to(torch.float32).reshape(-1)
    if block is None or scales.numel() == 1:
        return scales[0].expand(n)
    idx = torch.arange(n, dtype=torch.int64, device=scales.device) // block
    return scales[idx]


def scales_at(scales: torch.Tensor, indices: torch.Tensor,
              block: Optional[int]) -> torch.Tensor:
    """The scale vector at sparse dense-flat ``indices``."""
    sc = scales.to(torch.float32).reshape(-1)
    if block is None or sc.numel() == 1:
        return sc[0].expand(indices.shape)
    return sc[indices.long() // block]


def compress_shared(key, g: torch.Tensor, scales: torch.Tensor, s: int = 127,
                    block: Optional[int] = None) -> SharedScaleQSGDPayload:
    """Quantize ``g`` against the negotiated ``scales``."""
    if s > 127:
        raise ValueError(
            f"shared-scale wire is int8 (s <= 127), got s={s}: the level "
            "budget must leave the widened accumulator its W-way headroom")
    flat = g.to(torch.float32).reshape(-1)
    sc = expand_scales(scales, block, flat.numel())
    return SharedScaleQSGDPayload(levels=shared_levels(key, flat, sc, s),
                                  shape=tuple(g.shape), s=s, block=block)


def decompress_shared(p: SharedScaleQSGDPayload,
                      scales: torch.Tensor) -> torch.Tensor:
    """``scale * levels``, the per-payload decode."""
    n = numel(p.shape)
    lv = p.levels.to(torch.float32)
    return (expand_scales(scales, p.block, n) * lv).reshape(p.shape)


class SharedScaleQSGD:
    """One leaf's shared-scale QSGD, bound to that leaf's scales."""

    def __init__(self, scales: torch.Tensor, quantum_num: int = 127,
                 block: Optional[int] = None):
        self.scales = scales.to(torch.float32).reshape(-1)
        self.quantum_num = quantum_num
        self.block = block

    def compress(self, key, tensor: torch.Tensor):
        return compress_shared(key, tensor, self.scales, self.quantum_num,
                               self.block)

    def decompress(self, payload: SharedScaleQSGDPayload) -> torch.Tensor:
        return decompress_shared(payload, self.scales)

    def homomorphic_sum(self, payloads, k: Optional[int] = None,
                        out=None) -> tuple:
        """The integer half of :meth:`homomorphic_mean`: ``(acc, k)``, the
        exact int32 sum [n] of K same-contract payloads' levels (one
        widened accumulate, the kernel on CUDA above ``MIN_ELEMS``; into
        ``out`` where given) and the divisor of its decode. ``k``
        overrides the divisor when the payloads are weighted partial sums
        (an aggregation tree's int16 pseudo-pushes, each worth ``weight``
        leaves). A non-int8 stack sums with ``torch.sum``, as the JAX
        package sums it with ``jnp.sum`` outside its int8-only kernel
        (``qsgd.py:348-352``): integer addition is exact, so the tree's
        accumulator equals the flat one's."""
        k_div = len(payloads) if k is None else int(k)
        check_sum_budget(self.quantum_num, k_div)
        stack = torch.stack([p.levels for p in payloads])
        if stack.dtype == torch.int8:
            return kernels.accumulate(stack, out), k_div
        return torch.sum(stack, dim=0, dtype=torch.int32, out=out), k_div

    def homomorphic_mean(self, payloads, k: Optional[int] = None):
        """Integer-domain mean of K same-contract payloads: the sum of
        :meth:`homomorphic_sum` and one dequantize (``kernels.decode_sum``;
        ``ops/homomorphic.homomorphic_mean`` decodes every leaf of an
        apply in one set instead)."""
        acc, k_div = self.homomorphic_sum(payloads, k)
        return kernels.decode_sum(acc, self.scales.to(acc.device), k_div,
                                  block=self.block).reshape(payloads[0].shape)

    def wire_bytes(self, shape) -> int:
        return shared_wire_bytes(numel(shape))


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
