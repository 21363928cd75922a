"""The server-apply kernels' plain versions against the Pallas kernels.

``ewdml_tpu_torch.ops.kernels.int_accumulate_ref`` / ``acc_decode_ref``
(what the CUDA kernels are held to on the card) against
``ewdml_tpu.ops.pallas_kernels.int_accumulate`` / ``acc_decode`` run with
``interpret=True`` on the CPU, on the shapes of ``tests/test_homomorphic.py``
plus k = 3 (where 1/k is inexact in f32) and blocks of 8192.

Oracle: bit. The accumulate is exact integer arithmetic, and the decode is
one f32 product per element in the kernel's order
(``f32(acc) * (scale[b] * f32(1/k))``), so nothing may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu_torch.ops import kernels

torch.set_num_threads(2)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("world,n", [(2, 4096), (5, 9000), (8, 130),
                                     (4, 3 * 8192 + 17),
                                     # the CUDA kernel's K = 1 body and its
                                     # runtime body (K > 8)
                                     (1, 12290), (9, 8200), (16, 4099)])
def test_int_accumulate_bit_equal(world, n):
    rng = np.random.RandomState(world * 1000 + n)
    lv = rng.randint(-127, 128, size=(world, n)).astype(np.int8)
    ref = np.asarray(pk.int_accumulate(jnp.asarray(lv), interpret=True))
    ours = kernels.int_accumulate_ref(torch.from_numpy(lv))
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), ref)
    assert np.array_equal(ref, lv.astype(np.int64).sum(0))
    # The wrapper takes the plain version for a CPU tensor, and so does the
    # dispatcher on the CPU.
    assert np.array_equal(kernels.int_accumulate(torch.from_numpy(lv)).numpy(),
                          ref)
    assert np.array_equal(kernels.accumulate(torch.from_numpy(lv)).numpy(), ref)


@pytest.mark.parametrize("k", [4, 3])
@pytest.mark.parametrize("n,block", [(9000, 4096), (9000, None),
                                     (3 * 8192 + 17, 8192),
                                     (2 * 4096, 4096)])
def test_acc_decode_bit_equal(k, n, block):
    rng = np.random.RandomState(n + k)
    acc = rng.randint(-500, 500, size=(n,)).astype(np.int32)
    nb = 1 if block is None else -(-n // block)
    scales = np.abs(rng.randn(nb)).astype(np.float32) * 1e-3
    kw = {} if block is None else {"block": block}
    ref = pk.acc_decode(jnp.asarray(acc), jnp.asarray(scales), k,
                        interpret=True, **kw)
    twin = pk.acc_decode(jnp.asarray(acc), jnp.asarray(scales), k, **kw)
    assert np.array_equal(_bits(ref), _bits(twin))
    ours = kernels.acc_decode_ref(torch.from_numpy(acc),
                                  torch.from_numpy(scales), k, block=block)
    assert ours.dtype == torch.float32
    assert np.array_equal(_bits(ours.numpy()), _bits(ref))
    disp = kernels.decode_sum(torch.from_numpy(acc), torch.from_numpy(scales),
                              k, block=block)
    assert np.array_equal(_bits(disp.numpy()), _bits(ref))


def test_acc_decode_odd_block_takes_the_plain_version():
    """A block that is not a multiple of 4096 has no kernel (the JAX twin
    serves on every device); the port's dispatcher takes the plain
    version, and the result is the JAX twin's."""
    rng = np.random.RandomState(3)
    n, block, k = 5000, 1000, 3
    acc = rng.randint(-300, 300, size=(n,)).astype(np.int32)
    scales = np.abs(rng.randn(5)).astype(np.float32)
    twin = pk.acc_decode(jnp.asarray(acc), jnp.asarray(scales), k,
                         block=block)
    ours = kernels.decode_sum(torch.from_numpy(acc), torch.from_numpy(scales),
                              k, block=block)
    assert np.array_equal(_bits(ours.numpy()), _bits(twin))


def test_inverse_k_rounds_once_to_f32():
    """k = 3: the factor is scale * f32(1/3), not scale / 3."""
    acc = torch.tensor([3, 1, -7], dtype=torch.int32)
    scale = torch.tensor([0.1], dtype=torch.float32)
    out = kernels.acc_decode_ref(acc, scale, 3)
    factor = np.float32(0.1) * np.float32(1.0 / 3.0)
    want = np.array([3, 1, -7], np.float32) * factor
    assert np.array_equal(_bits(out.numpy()), _bits(want))


def test_argument_checks():
    with pytest.raises(ValueError, match="int8"):
        kernels.int_accumulate_ref(torch.zeros(2, 4, dtype=torch.int16))
    with pytest.raises(ValueError, match="int32"):
        kernels.acc_decode_ref(torch.zeros(4), torch.ones(1), 2)
    with pytest.raises(ValueError, match="does not match"):
        kernels.acc_decode_ref(torch.zeros(9000, dtype=torch.int32),
                               torch.ones(2), 2, block=4096)
