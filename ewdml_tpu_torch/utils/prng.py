"""Bit-exact port of the JAX package's key chain (``ewdml_tpu/utils/prng.py``).

A key is a pair of uint32 words held as Python ints, exactly the
``jax.random.key_data`` of a threefry2x32 key. ``fold_in`` and the
``uniform`` draw reproduce ``jax.random`` bit for bit under
``jax_threefry_partitionable=True`` (the default since jax 0.5), so a port
run and a JAX run with the same seed quantize with the same random bits.

The threefry rounds run as uint32 arithmetic on int64 tensors (every
intermediate is masked back to 32 bits), on whatever device the draw is for.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int) -> tuple:
    """``jax.random.key(seed)`` for a 32-bit seed: words ``(0, seed)``."""
    return (0, int(seed) & _MASK)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block cipher (20 rounds), as jax's ``threefry2x32_p``.

    Works on Python ints or int64 tensors holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def fold_in(k: tuple, data: int) -> tuple:
    """``jax.random.fold_in``: threefry of the counter pair ``(0, data)``."""
    return threefry2x32(k[0], k[1], 0, int(data) & _MASK)


def step_key(base: tuple, step: int) -> tuple:
    """Key for one training step."""
    return fold_in(base, step)


def layer_key(k: tuple, layer_idx: int) -> tuple:
    """Key for one parameter tensor (or fused bucket) within a step."""
    return fold_in(k, layer_idx)


def rank_key(k: tuple, rank: int) -> tuple:
    """Per-rank key: fold in the worker's position on the data axis."""
    return fold_in(k, rank)


def seed_from_key(k: tuple) -> int:
    """The kernels' int32 murmur seed: the last word of the key data,
    reinterpreted as signed (``pallas_kernels.seed_from_key``)."""
    w = k[1] & _MASK
    return w - (1 << 32) if w >= (1 << 31) else w


def random_bits(k: tuple, n: int, device) -> torch.Tensor:
    """``jax.random.bits(k, (n,), uint32)`` under the partitionable layout:
    element i is ``y0 ^ y1`` of threefry(k, (i >> 32, i & mask)). Returned as
    int64 holding uint32 values."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k[0], k[1], idx >> 32, idx & _MASK)
    return y0 ^ y1


def uniform(k: tuple, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32)`` in [0, 1): the top 23 bits
    become the mantissa of a float in [1, 2), minus one (exact)."""
    n = 1
    for d in shape:
        n *= int(d)
    bits = random_bits(k, n, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return f.reshape(tuple(shape))
