"""Top-k gradient sparsification (``ewdml_tpu/ops/topk.py``).

Keep the k largest-magnitude entries of the flat tensor, ship (values,
int32 indices), scatter into zeros on decode. Winners come in
``lax.top_k``'s order: descending magnitude, the lower index first on ties
(a stable descending sort; ``torch.topk`` promises no tie order). The order
matters: it is the order in which the Method-5 stack quantizes the values.

``approx`` mode uses the same exact selection. On the CPU, where the JAX
package is the port's reference, ``lax.approx_max_k`` returns exactly
``lax.top_k``'s winners in ``lax.top_k``'s order.
"""

from __future__ import annotations

import dataclasses

import torch

from ewdml_tpu_torch.ops.bytes import numel


def static_k(numel: int, ratio: float) -> int:
    return max(1, int(numel * ratio))


# Auto exact/approx crossover and the auto block-selection gate
# (topk.py:34, :42).
EXACT_MAX_ELEMS = 1 << 18
BLOCK_MAX_RATIO = 0.125


def resolve_exact(exact, numel: int) -> bool:
    if exact == "block":  # plain TopK has no block wire; nearest is approx
        return False
    return numel <= EXACT_MAX_ELEMS if exact is None else bool(exact)


def resolve_mode(exact, numel: int, ratio: float) -> str:
    """``'exact'`` | ``'approx'`` | ``'block'`` for the Top-k->QSGD stack."""
    if exact is None:
        if numel <= EXACT_MAX_ELEMS:
            return "exact"
        return "block" if ratio <= BLOCK_MAX_RATIO else "approx"
    if exact == "block":
        return "block"
    return "exact" if exact else "approx"


def top_k_indices(a: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of ``a`` in ``lax.top_k`` order."""
    return torch.sort(a, descending=True, stable=True).indices[:k]


@dataclasses.dataclass
class TopKPayload:
    values: torch.Tensor   # f32 [k]
    indices: torch.Tensor  # int32 [k]
    shape: tuple

    @property
    def numel(self) -> int:
        return numel(self.shape)

    @property
    def wire_bytes(self) -> int:
        return self.values.numel() * 4 + self.indices.numel() * 4


def compress(g: torch.Tensor, ratio: float, exact=None) -> TopKPayload:
    """Keep the k largest |g| entries (reference ``TopK.py:5-11``)."""
    flat = g.to(torch.float32).reshape(-1)
    k = static_k(flat.numel(), ratio)
    idx = top_k_indices(flat.abs(), k)
    return TopKPayload(values=flat[idx], indices=idx.to(torch.int32),
                       shape=tuple(g.shape))


def decompress(p: TopKPayload) -> torch.Tensor:
    dense = torch.zeros(p.numel, dtype=p.values.dtype, device=p.values.device)
    dense[p.indices.long()] = p.values
    return dense.reshape(p.shape)


class TopKCompressor:
    """Class-shaped API of the reference's ``TopKCompressor``."""

    def __init__(self, compress_ratio: float, exact=None):
        self.compress_ratio = compress_ratio
        self.exact = exact

    def compress(self, key, tensor: torch.Tensor) -> TopKPayload:
        del key  # deterministic transform
        return compress(tensor, self.compress_ratio, self.exact)

    def decompress(self, payload: TopKPayload) -> torch.Tensor:
        return decompress(payload)

    def wire_bytes(self, shape) -> int:
        return static_k(numel(shape), self.compress_ratio) * 8
