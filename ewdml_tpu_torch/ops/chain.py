"""Stacked Top-k -> QSGD compression, the reference's Method 5
(``ewdml_tpu/ops/chain.py:1-299``; :func:`reconfigure` is the adaptive
controller's config-keyed cache).

Sparsify, then quantize the k surviving values: the wire carries
(indices int32, levels int8, norm f32). Big fused buckets at sparse ratios
take the strided block selection instead (``ops/blocktopk.py``).

The shared-scale (homomorphic) half (``chain.py:85-200``) quantizes each
winner against its dense block's negotiated scale, so the server
scatter-adds K workers' int8 levels into one int32 accumulator and decodes
the sum once per round.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ewdml_tpu_torch.ops import blocktopk, kernels, packing, qsgd, topk
from ewdml_tpu_torch.ops.bytes import numel, tensor_nbytes


@dataclasses.dataclass
class TopKQSGDPayload:
    indices: torch.Tensor  # int32 [k]
    levels: torch.Tensor   # int8/int16 [k], or packed uint8
    norm: torch.Tensor     # f32 0-d, or f32 [nblocks]
    shape: tuple
    s: int
    packed: bool = False
    block: Optional[int] = None

    @property
    def numel(self) -> int:
        return numel(self.shape)

    @property
    def wire_bytes(self) -> int:
        return (self.indices.numel() * 4 + tensor_nbytes(self.levels)
                + 4 * self.norm.numel())


def compress(key, g: torch.Tensor, ratio: float, s: int = 127, exact=None,
             block=None):
    """A :class:`TopKQSGDPayload`, or a ``BlockTopKQSGDPayload`` when the
    selection resolves to 'block' (``topk.resolve_mode``)."""
    if topk.resolve_mode(exact, g.numel(), ratio) == "block":
        return blocktopk.compress(key, g, ratio, s, block=block)
    sparse = topk.compress(g, ratio, exact)
    quant = qsgd.compress(key, sparse.values, s, block=block)
    return TopKQSGDPayload(indices=sparse.indices, levels=quant.levels,
                           norm=quant.norm, shape=tuple(g.shape), s=s,
                           packed=quant.packed, block=block)


def dequant_values(p: TopKQSGDPayload) -> torch.Tensor:
    """The k dequantized values, without scattering to dense."""
    k = p.indices.numel()
    lv = qsgd.levels_as_float(p.levels, p.s, k, p.packed)
    return qsgd.scale_levels(lv, p.norm, p.s, p.block, k)


def decompress(p: TopKQSGDPayload) -> torch.Tensor:
    values = dequant_values(p)
    dense = torch.zeros(p.numel, dtype=torch.float32, device=values.device)
    dense[p.indices.long()] = values
    return dense.reshape(p.shape)


# -- shared-scale (tensor-homomorphic) Top-k mode ------------------------------

@dataclasses.dataclass
class SharedScaleTopKQSGDPayload:
    """Homomorphic sparse wire: (int32 dense indices, int8 levels) on the
    negotiated grid; no per-push norm."""

    indices: torch.Tensor  # int32 [k]
    levels: torch.Tensor   # int8 [k]
    shape: tuple
    s: int
    block: Optional[int] = None

    @property
    def numel(self) -> int:
        return numel(self.shape)

    @property
    def wire_bytes(self) -> int:
        return self.indices.numel() * 4 + self.levels.numel()


def shared_wire_bytes(n: int, ratio: float) -> int:
    """Wire bytes of the shared-scale Top-k payload over ``n`` elements:
    an int32 index and an int8 level per winner."""
    return topk.static_k(n, ratio) * 5


def nonblock_exact(exact, numel: int, ratio: float) -> bool:
    """Selection for the shared-scale stack: the block wire has no
    homomorphic accumulate, so 'block' resolves to approx."""
    return topk.resolve_mode(exact, numel, ratio) == "exact"


def compress_shared(key, g: torch.Tensor, scales: torch.Tensor,
                    ratio: float, s: int = 127, exact=None,
                    block: Optional[int] = None) -> SharedScaleTopKQSGDPayload:
    """Top-k select, then quantize each winner against its dense block's
    negotiated scale (``qsgd.shared_levels``)."""
    if s > 127:
        raise ValueError(f"shared-scale wire is int8 (s <= 127), got s={s}")
    n = g.numel()
    sparse = topk.compress(g, ratio, nonblock_exact(exact, n, ratio))
    per_value = qsgd.scales_at(scales, sparse.indices, block)
    levels = qsgd.shared_levels(key, sparse.values, per_value, s)
    return SharedScaleTopKQSGDPayload(indices=sparse.indices, levels=levels,
                                      shape=tuple(g.shape), s=s, block=block)


def decompress_shared(p: SharedScaleTopKQSGDPayload,
                      scales: torch.Tensor) -> torch.Tensor:
    """Scatter ``scale * level`` into dense zeros."""
    per_value = qsgd.scales_at(scales, p.indices, p.block)
    dense = torch.zeros(p.numel, dtype=torch.float32, device=p.levels.device)
    dense[p.indices.long()] = per_value * p.levels.to(torch.float32)
    return dense.reshape(p.shape)


class SharedScaleTopKQSGD:
    """One leaf's shared-scale Method-5 stack."""

    def __init__(self, scales: torch.Tensor, compress_ratio: float = 0.5,
                 quantum_num: int = 127, exact=None,
                 block: Optional[int] = None):
        self.scales = scales.to(torch.float32).reshape(-1)
        self.compress_ratio = compress_ratio
        self.quantum_num = quantum_num
        self.exact = exact
        self.block = block

    def compress(self, key, tensor: torch.Tensor):
        return compress_shared(key, tensor, self.scales, self.compress_ratio,
                               self.quantum_num, self.exact, self.block)

    def decompress(self, payload: SharedScaleTopKQSGDPayload) -> torch.Tensor:
        return decompress_shared(payload, self.scales)

    def homomorphic_sum(self, payloads, out=None) -> tuple:
        """The integer half of :meth:`homomorphic_mean`: ``(acc, k)``, the
        K sparse payloads' levels scatter-added (``index_add_``) into a
        dense int32 [n] (``out``, zeroed first, where given), and the
        divisor K."""
        k = len(payloads)
        qsgd.check_sum_budget(self.quantum_num, k)
        if out is None:
            acc = torch.zeros(numel(payloads[0].shape), dtype=torch.int32,
                              device=payloads[0].levels.device)
        else:
            acc = out.zero_()
        for p in payloads:
            acc.index_add_(0, p.indices.long(), p.levels.to(torch.int32))
        return acc, k

    def homomorphic_mean(self, payloads) -> torch.Tensor:
        """K sparse payloads -> one dense mean: the scatter-add of
        :meth:`homomorphic_sum`, then the round's one dequantize
        (``kernels.decode_sum``)."""
        acc, k = self.homomorphic_sum(payloads)
        return kernels.decode_sum(acc, self.scales.to(acc.device), k,
                                  block=self.block).reshape(payloads[0].shape)

    def wire_bytes(self, shape) -> int:
        return shared_wire_bytes(numel(shape), self.compress_ratio)


# The reconfigure cache (``chain.py:202-251``): the adaptive controller
# flips the same few (fraction, s) rungs on and off across a run; one
# instance per config is returned, never a fresh one per decision. The
# hit and miss counts are observable.
_RECONFIG_CACHE: dict = {}
_RECONFIG_STATS = {"hits": 0, "misses": 0}


def reconfigure(base=None, *, bits: Optional[int] = None,
                s: Optional[int] = None, fraction: Optional[float] = None,
                exact=None, block: Optional[int] = None):
    """Config-keyed :class:`TopKQSGDCompressor` factory: knobs not given
    default from ``base`` (an instance, or the class for its defaults).
    ``bits`` is sugar for ``s = 2^(bits-1) - 1`` (8 -> 127, the int8 wire;
    4 -> 7, the packed 4-bit wire)."""
    if bits is not None:
        if s is not None:
            raise ValueError("pass bits or s, not both")
        s = (1 << (max(2, int(bits)) - 1)) - 1
    inst = base if isinstance(base, TopKQSGDCompressor) else None
    ratio = float(inst.compress_ratio if inst and fraction is None
                  else (0.5 if fraction is None else fraction))
    s = int(inst.quantum_num if inst and s is None
            else (127 if s is None else s))
    if inst is not None:
        exact = inst.exact if exact is None else exact
        block = inst.block if block is None else block
    key = (round(ratio, 9), s, exact, block)
    comp = _RECONFIG_CACHE.get(key)
    if comp is not None:
        _RECONFIG_STATS["hits"] += 1
        return comp
    _RECONFIG_STATS["misses"] += 1
    comp = _RECONFIG_CACHE[key] = TopKQSGDCompressor(
        ratio, s, exact=exact, block=block)
    return comp


def reconfigure_cache_stats() -> dict:
    return dict(_RECONFIG_STATS)


def reconfigure_cache_clear() -> None:
    _RECONFIG_CACHE.clear()
    _RECONFIG_STATS.update(hits=0, misses=0)


class TopKQSGDCompressor:
    """Method-5 stack; s=127 is the int8 wire."""

    def __init__(self, compress_ratio: float = 0.5, quantum_num: int = 127,
                 exact=None, block: Optional[int] = None):
        self.compress_ratio = compress_ratio
        self.quantum_num = quantum_num
        self.exact = exact
        self.block = block

    def compress(self, key, tensor: torch.Tensor):
        return compress(key, tensor, self.compress_ratio, self.quantum_num,
                        self.exact, self.block)

    def decompress(self, payload) -> torch.Tensor:
        if isinstance(payload, blocktopk.BlockTopKQSGDPayload):
            return blocktopk.decompress(payload)
        return decompress(payload)

    def wire_bytes(self, shape) -> int:
        n = numel(shape)
        if topk.resolve_mode(self.exact, n, self.compress_ratio) == "block":
            return blocktopk.wire_bytes_for(shape, self.compress_ratio,
                                            self.quantum_num, self.block)
        k = topk.static_k(n, self.compress_ratio)
        norms = 1 if self.block is None else -(-k // self.block)
        if packing.width_for(self.quantum_num) < 8:
            return (k * 4 + packing.packed_nbytes(k, self.quantum_num)
                    + 4 * norms)
        itemsize = qsgd.level_dtype(self.quantum_num).itemsize
        return k * (4 + itemsize) + 4 * norms
