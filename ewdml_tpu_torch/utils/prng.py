"""Bit-exact port of the JAX package's key chain (``ewdml_tpu/utils/prng.py``).

A key is a pair of uint32 words held as Python ints, exactly the
``jax.random.key_data`` of a threefry2x32 key. ``fold_in`` and the
``uniform`` draw reproduce ``jax.random`` bit for bit under
``jax_threefry_partitionable=True`` (the default since jax 0.5), so a port
run and a JAX run with the same seed quantize with the same random bits.

The draws (:func:`random_bits`, :func:`uniform` and what builds on them)
run on CUDA as one launch of a hand-written kernel
(``ops/kernels.random_bits``, ``kernels/random.cu``); on the CPU, and under
``--pallas off`` or ``interpret``, the threefry rounds run as uint32
arithmetic on int64 tensors (every intermediate masked back to 32 bits).

A :class:`Key` is a key of a step bound to a :class:`~ewdml_tpu_torch.utils.
keytable.KeyTable`: it remembers how it derives from its step, and the
draws it feeds read its words (or its murmur seed) from the table's device
buffer instead of taking them as host constants, so a CUDA graph that
captured the draws replays them for any later step.
"""

from __future__ import annotations

import numpy as np
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


class Key(tuple):
    """The words ``(k0, k1)`` of a key, with ``table`` (the
    :class:`~ewdml_tpu_torch.utils.keytable.KeyTable` it is bound to) and
    ``path`` (how the table derives it again for another step)."""

    def __new__(cls, words, table, path):
        k = super().__new__(cls, (int(words[0]), int(words[1])))
        k.table, k.path = table, path
        return k


def fold_in(k: tuple, data: int) -> tuple:
    """``jax.random.fold_in``: threefry of the counter pair ``(0, data)``."""
    data = int(data) & _MASK
    words = threefry2x32(k[0], k[1], 0, data)
    if isinstance(k, Key):
        return Key(words, k.table, k.path + (data,))
    return words


def fold_path(k: tuple, path) -> tuple:
    """``k`` folded with each word of ``path`` in turn (``()``: ``k``)."""
    for data in path:
        k = fold_in(k, data)
    return k


def split(k: tuple, num: int = 2) -> tuple:
    """``jax.random.split`` (partitionable): key i is threefry of the
    counter pair ``(0, i)``, which is ``fold_in(k, i)``."""
    return tuple(fold_in(k, i) for i in range(num))


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


def seed_tensor(k: tuple, device) -> torch.Tensor:
    """The murmur seed of ``k`` (:func:`seed_from_key`) as an int32 ``[1]``
    tensor on ``device``, the kernels' seed argument: a slot of the key
    table for a :class:`Key`, else a tensor filled on the device (no
    host-to-device copy)."""
    if isinstance(k, Key):
        return k.table.seed(k)
    return torch.full((1,), seed_from_key(k), dtype=torch.int32, device=device)


def packed_key(k: tuple) -> int:
    """The words of ``k`` as one int64 (``k0 << 32 | k1``, two's
    complement), the form the stochastic-round kernel reads."""
    v = ((int(k[0]) & _MASK) << 32) | (int(k[1]) & _MASK)
    return v - (1 << 64) if v >= (1 << 63) else v


def key_tensor(k: tuple, device) -> torch.Tensor:
    """:func:`packed_key` of ``k`` as an int64 ``[1]`` tensor on
    ``device``: a slot of the key table for a :class:`Key`, else a tensor
    filled on the device (no host-to-device copy)."""
    if isinstance(k, Key):
        return k.table.packed(k)
    return torch.full((1,), packed_key(k), dtype=torch.int64, device=device)


def key_words(k: tuple):
    """The two words a draw takes: Python ints, or for a :class:`Key` 0-d
    int64 tensors read from the key table."""
    if isinstance(k, Key):
        return k.table.words(k)
    return k[0], k[1]


def generator(k: tuple, device) -> torch.Generator:
    """The ``torch.Generator`` of a dropout stream, seeded from both words
    of ``k`` (for a :class:`Key`, the table's, reseeded before each replay)."""
    if isinstance(k, Key):
        return k.table.generator(k)
    gen = torch.Generator(device=device)
    gen.manual_seed((k[0] << 32) | k[1])
    return gen


def random_bits(k: tuple, n: int, device) -> torch.Tensor:
    """``jax.random.bits(k, (n,), uint32)`` under the partitionable layout:
    element i is ``y0 ^ y1`` of threefry(k, (i >> 32, i & mask)). Returned as
    int64 holding uint32 values."""
    from ewdml_tpu_torch.ops import kernels

    return kernels.threefry_draw(k, n, device)


def uniform(k: tuple, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32)`` in [0, 1): the top 23 bits
    become the mantissa of a float in [1, 2), minus one (exact)."""
    from ewdml_tpu_torch.ops import kernels

    return kernels.threefry_draw(k, _numel(shape), device,
                                 uniform=True).reshape(tuple(shape))


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def permutation(k: tuple, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: ``ceil(3 ln n / ln(2^32 - 1))``
    rounds, each a split, 32 random bits per element and a stable sort of
    the elements by their bits (``lax.sort_key_val``; ties among the bits
    keep their order, so stability decides the result). int64 ``[n]``."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(random_bits(sub, n, device), stable=True).indices
        x = x.index_select(0, order)
    return x


def randint(k: tuple, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32): two 32-bit
    draws from a split, combined modulo the span in uint32 arithmetic as
    jax does (``hi % span * (2^32 % span) + lo % span``, then mod span);
    ``minval`` where ``maxval <= minval``."""
    lo32, hi32 = -(1 << 31), (1 << 31) - 1
    if not (lo32 <= minval <= hi32 and lo32 <= maxval <= hi32):
        raise ValueError("randint takes int32 bounds")
    k1, k2 = split(k)
    n = _numel(shape)
    hi, lo = random_bits(k1, n, device), random_bits(k2, n, device)
    span = max(1, maxval - minval)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = (((hi % span) * mult) & _MASK) + lo % span
    off = (off & _MASK) % span
    return (off + minval).to(torch.int32).reshape(tuple(shape))


def bernoulli(k: tuple, p: float, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)``: ``uniform < p`` in float32."""
    return uniform(k, shape, device) < float(np.float32(p))
