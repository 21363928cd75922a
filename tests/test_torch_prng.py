"""The port's key chain against ``jax.random`` (threefry2x32, partitionable).

Oracle: bit. Every murmur seed and every threefry uniform of the port
derives from these words, so they must equal jax's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.ops import pallas_kernels
from ewdml_tpu.utils import prng as jprng
from ewdml_tpu_torch.utils import prng

torch.set_num_threads(2)

GRID = [(seed, step, layer, rank)
        for seed in (0, 42, 2**31 - 1)
        for step in (0, 1, 19, 123457)
        for layer in (0, 7, 37)
        for rank in (0, 3)]


def _words(k) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


def test_partitionable_threefry_is_the_reference_layout():
    # The port reproduces the partitionable layout only; a jax that draws
    # with the other layout would make every uniform comparison below moot.
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_key_words(seed):
    assert prng.key(seed) == _words(jax.random.key(seed))


def test_fold_in_chain_over_grid():
    for seed, step, layer, rank in GRID:
        jk = jprng.layer_key(jax.random.fold_in(
            jprng.step_key(jax.random.key(seed), step), rank), layer)
        tk = prng.layer_key(prng.rank_key(
            prng.step_key(prng.key(seed), step), rank), layer)
        assert tk == _words(jk), (seed, step, layer, rank)


def test_seed_from_key_over_grid():
    for seed, step, layer, rank in GRID:
        jk = jax.random.fold_in(jax.random.fold_in(
            jax.random.key(seed), step), layer * 4 + rank)
        tk = prng.fold_in(prng.fold_in(prng.key(seed), step), layer * 4 + rank)
        assert prng.seed_from_key(tk) == int(pallas_kernels.seed_from_key(jk))


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7), (2, 4096), (1, 10007)])
def test_uniform_bits_equal(shape):
    for seed, step in ((0, 0), (42, 5), (7, 123457)):
        jk = jax.random.fold_in(jax.random.key(seed), step)
        tk = prng.fold_in(prng.key(seed), step)
        ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
        tu = prng.uniform(tk, shape).numpy()
        assert tu.shape == ju.shape
        assert np.array_equal(tu.view(np.uint32), ju.view(np.uint32))
