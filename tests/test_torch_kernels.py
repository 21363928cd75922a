"""The port's kernels: the plain versions against the Pallas kernels in
interpret mode on the CPU (the CUDA kernels against the plain versions are
in ``test_torch_cuda.py``, which needs a GPU).

Oracles:
- quantize: bit, given the same x, norm(s), seed and s;
- block_top1: bit (pure selection), ties planted;
- dequant_mean: tolerance. The plain version and the CUDA kernel sum in the
  TPU kernel's written order with no FMA; XLA:CPU, which runs the Pallas
  interpreter, contracts the multiply-adds into FMAs. The two orders differ
  by at most one rounding per worker step, so
  |port - jax| <= W * 2^-23 * sum_w |norm_w * lv_w| / (s * W).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu_torch.ops import kernels

torch.set_num_threads(2)
EPS = 2.0 ** -23


@pytest.fixture(autouse=True)
def _restore_modes():
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


def _norms(x: np.ndarray, block):
    if block is None:
        return np.float32(np.linalg.norm(x))
    nb = -(-x.size // block)
    pad = np.zeros(nb * block, np.float32)
    pad[:x.size] = x
    return np.linalg.norm(pad.reshape(nb, block), axis=1).astype(np.float32)


@pytest.mark.parametrize("n,block,s", [
    (1000, None, 127), (4097, None, 127), (12345, None, 1),
    (9000, 4096, 127), (8192, 4096, 1), (8193, 8192, 127),
    (3 * 16384 + 6, 16384, 127), (2 * 4096 + 2, None, 127),
])
def test_quantize_plain_matches_pallas(n, block, s):
    rng = np.random.RandomState(n + s)
    x = (rng.randn(n) * rng.choice([1e-3, 1.0, 50.0], size=n)).astype(np.float32)
    norm = _norms(x, block)
    for seed in (0, -12345, 2**31 - 1):
        lj = np.asarray(pk.qsgd_quantize(jnp.asarray(x), jnp.asarray(norm),
                                         jnp.int32(seed), s, block=block,
                                         interpret=True))
        lt = kernels.qsgd_quantize_ref(torch.from_numpy(x),
                                       torch.as_tensor(norm), seed, s,
                                       block=block)
        assert lt.dtype == torch.int8
        assert np.array_equal(lt.numpy(), lj), (n, block, s, seed)


@pytest.mark.parametrize("block", [None, 4096])
def test_quantize_zero_norm_gives_zero_levels(block):
    x = np.zeros(5000, np.float32)
    norm = _norms(x, block)
    lj = np.asarray(pk.qsgd_quantize(jnp.asarray(x), jnp.asarray(norm),
                                     jnp.int32(3), 127, block=block,
                                     interpret=True))
    lt = kernels.qsgd_quantize_ref(torch.from_numpy(x), torch.as_tensor(norm),
                                   3, 127, block=block).numpy()
    assert not lt.any() and np.array_equal(lt, lj)


def test_quantize_wrapper_on_cpu_is_the_plain_version():
    x = torch.randn(3000)
    norm = torch.linalg.vector_norm(x)
    before = dict(kernels.LAUNCHES)
    a = kernels.qsgd_quantize(x, norm, 11, 127)
    assert torch.equal(a, kernels.qsgd_quantize_ref(x, norm, 11, 127))
    assert kernels.LAUNCHES == before  # no kernel launched on the CPU


def test_quantize_rejects_bad_args():
    x = torch.randn(64)
    with pytest.raises(ValueError):
        kernels.qsgd_quantize(x, torch.tensor(1.0), 0, 200)
    with pytest.raises(ValueError):
        kernels.qsgd_quantize(x, torch.ones(1), 0, 127, block=100)
    with pytest.raises(ValueError):
        kernels.qsgd_quantize(torch.randn(9000), torch.ones(1), 0, 127,
                              block=4096)  # needs ceil(9000/4096) = 3 norms


def _dequant_bound(lv, norms, s, block):
    world, n = lv.shape
    nm = norms.reshape(world, -1).astype(np.float64)
    idx = np.arange(n) // block if block else np.zeros(n, int)
    mag = sum(np.abs(nm[w][idx] * lv[w]) for w in range(world))
    return world * EPS * mag / (s * world) + 1e-45


@pytest.mark.parametrize("world,block,n", [
    (1, None, 5000), (4, None, 5000), (1, 4096, 9000), (4, 4096, 9000),
    (4, None, 4093),
    # The row counts the CUDA kernel's templates split on (1, 8, and 9
    # through the runtime body), on rows of n % 16 = 2 and 8.
    (1, None, 12290), (8, None, 12290), (9, 4096, 12290),
    (1, 4096, 8200), (8, 4096, 8200), (9, None, 8200),
])
def test_dequant_mean_plain_matches_pallas(world, block, n):
    rng = np.random.RandomState(world * 7 + n)
    lv = rng.randint(-127, 128, size=(world, n)).astype(np.int8)
    shape = (world,) if block is None else (world, -(-n // block))
    norms = (rng.rand(*shape) * 3).astype(np.float32)
    oj = np.asarray(pk.dequant_mean(jnp.asarray(lv), jnp.asarray(norms), 127,
                                    block=block, interpret=True))
    ot = kernels.dequant_mean_ref(torch.from_numpy(lv), torch.from_numpy(norms),
                                  127, block=block).numpy()
    bound = _dequant_bound(lv, norms, 127, block)
    assert np.all(np.abs(ot.astype(np.float64) - oj) <= bound)
    if world == 1:  # one product, one scale: no order to differ in
        assert np.array_equal(ot, oj)


def test_dequant_mean_rejects_non_int8():
    with pytest.raises(ValueError):
        kernels.dequant_mean(torch.zeros(2, 8, dtype=torch.int16),
                             torch.ones(2), 127)


@pytest.mark.parametrize("r,c,apart", [
    (8, 128, None), (104, 256, None), (16, 1024, None),
    (104, 384, (3, 97)), (1000, 256, (3, 997)),
], ids=["8-128", "104-256", "16-1024", "104-384-apart", "1000-256-apart"])
def test_block_top1_plain_matches_pallas_with_ties(r, c, apart):
    rng = np.random.RandomState(r * c)
    # Half-integers: many ties in |x|, including +-equal pairs and zeros.
    x2 = (np.round(rng.randn(r, c) * 2) / 2).astype(np.float32)
    x2[:, 0] = 1.5
    x2[2, 0] = -1.5          # tie at the max: the first row must win
    x2[:, 1] = 0.0
    x2[5, 1] = -0.0          # an all-zero column with a -0
    if apart is not None:    # ties in rows far apart (the CUDA kernel's
        a, b = apart         # row slices): +-v, equal v, and a lone max
        x2[:, 2:5] = 0.5
        x2[a, 2], x2[b, 2] = -7.0, 7.0
        x2[a, 3], x2[b, 3] = 7.0, 7.0
        x2[b, 4] = -7.0
    vj, lj = pk.block_top1(jnp.asarray(x2), interpret=True)
    vt, lt = kernels.block_top1_ref(torch.from_numpy(x2))
    assert lt.dtype == torch.int32
    assert np.array_equal(lt.numpy(), np.asarray(lj))
    assert np.array_equal(vt.numpy().view(np.uint32),
                          np.asarray(vj).view(np.uint32))
    assert int(lt[0]) == 0 and float(vt[0]) == 1.5
    if apart is not None:
        assert lt[2:5].tolist() == [a, a, b]
        assert vt[2:5].tolist() == [-7.0, 7.0, -7.0]


def test_block_top1_rejects_bad_geometry():
    with pytest.raises(ValueError):
        kernels.block_top1(torch.zeros(8, 100))
    with pytest.raises(ValueError):
        kernels.block_top1(torch.zeros(7, 128))


def test_dispatch_modes():
    kernels.configure("auto")
    assert kernels.active_for(1 << 20, "cpu") is None
    assert kernels.active_for(8, "cuda") is None  # below MIN_ELEMS
    assert kernels.active_for(kernels.MIN_ELEMS, "cuda") == "kernel"
    kernels.configure("interpret")
    assert kernels.active_for(8, "cpu") == "plain"
    assert kernels.active_for(8, "cuda") == "plain"
    kernels.configure("off")
    assert kernels.active_for(1 << 20, "cuda") is None
    kernels.configure("on")
    assert kernels.active_for(8, "cuda") == "kernel"
    with pytest.raises(RuntimeError):
        kernels.active_for(8, "cpu")
    with pytest.raises(ValueError):
        kernels.configure("fast")
