"""The ring kernels' plain versions against the Pallas kernels on the CPU:
``chunk_encode`` and ``dequant_acc_requant`` under ``interpret=True`` and
through their XLA twins (``interpret=None`` off the TPU), plus
``decode_blocks``. The CUDA kernels against the plain versions are in
``test_torch_cuda.py``, which needs a GPU.

Oracles:
- norms: tolerance, relative 2^-21 (4 ulps). The port sums a block's
  squares in the CUDA kernel's fixed order (``kernels.block_norms_ref``);
  XLA:CPU reduces in its own order. Measured: at most 1 ulp apart.
- chunk_encode levels: bit, given the JAX norms (``encode_blocks_ref``),
  and bit on the port's own norms where those equal the JAX norms.
- dequant_acc_requant levels: bounded flips. XLA:CPU may contract the
  twin's ``local + c * lv`` into an FMA, so an accumulated element can
  differ by an ulp and its level by one where the uniform sits at the
  fraction: |d| <= 1 on at most 0.1% of the elements. Measured: none.
- decode_blocks: bit (two correctly rounded products on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu_torch.ops import kernels

torch.set_num_threads(2)
NORM_RTOL = 2.0 ** -21
N = 3 * 4096 + 100   # three whole blocks and a tail


@pytest.fixture(autouse=True)
def _restore_modes():
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


def _x(seed: int, n: int = N) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (rng.randn(n) * rng.choice([1e-3, 1.0, 50.0], size=n)).astype(
        np.float32)


def _close_norms(nt: torch.Tensor, nj) -> None:
    nj = np.asarray(nj, np.float64)
    assert nt.dtype == torch.float32 and nt.shape == nj.shape
    np.testing.assert_allclose(nt.numpy().astype(np.float64), nj,
                               rtol=NORM_RTOL, atol=0)


@pytest.mark.parametrize("interpret", [True, None])
@pytest.mark.parametrize("n,block,seed", [(N, 4096, -77), (N, 4096, 0),
                                          (4097, 4096, 2**31 - 1),
                                          (20000, 8192, 5),
                                          (2 * 16384 + 100, 16384, 11),
                                          (2 * 12288 + 100, 12288, -3)])
def test_chunk_encode_plain_matches_pallas(interpret, n, block, seed):
    x = _x(seed & 0xFF, n)
    lj, nj = pk.chunk_encode(jnp.asarray(x), jnp.int32(seed), 127,
                             block=block, interpret=interpret)
    lj, nj = np.asarray(lj), np.array(nj)
    lt, nt = kernels.chunk_encode_ref(torch.from_numpy(x), seed, 127,
                                      block=block)
    _close_norms(nt, nj)
    given = kernels.encode_blocks_ref(torch.from_numpy(x), torch.from_numpy(nj),
                                      seed, 127, block=block)
    assert given.dtype == torch.int8 and np.array_equal(given.numpy(), lj)
    if np.array_equal(nt.numpy(), nj):
        assert np.array_equal(lt.numpy(), lj)


def test_chunk_encode_zero_block_and_tail():
    x = _x(3)
    x[4096:8192] = 0.0           # a whole zero block: norm 0, levels 0
    lt, nt = kernels.chunk_encode_ref(torch.from_numpy(x), 9, 127)
    lj, nj = pk.chunk_encode(jnp.asarray(x), jnp.int32(9), 127, interpret=True)
    assert float(nt[1]) == 0.0 and not lt[4096:8192].any()
    assert lt.numel() == N and nt.numel() == 4
    assert np.array_equal(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("interpret", [True, None])
@pytest.mark.parametrize("scale,n,block", [
    pytest.param(scale, n, block,
                 id=f"{scale}" if n == N else f"{scale}-{n}-{block}")
    for n, block in ((N, 4096), (4096, 4096), (2 * 16384 + 100, 16384),
                     (2 * 12288 + 100, 12288))
    for scale in (1.0, 0.25)])
def test_dequant_acc_requant_plain_matches_pallas(interpret, scale, n, block):
    rng = np.random.RandomState(int(scale * 8) + (interpret is None)
                                + (n if n != N else 0))
    lv = rng.randint(-127, 128, size=n).astype(np.int8)
    nm = (rng.rand(-(-n // block)) * 3).astype(np.float32)
    local = (rng.randn(n) * 0.02).astype(np.float32)
    oj, onj = pk.dequant_acc_requant(jnp.asarray(lv), jnp.asarray(nm),
                                     jnp.asarray(local), jnp.int32(-5), 127,
                                     block=block, scale=scale,
                                     interpret=interpret)
    ot, ont = kernels.dequant_acc_requant_ref(
        torch.from_numpy(lv), torch.from_numpy(nm), torch.from_numpy(local),
        -5, 127, block=block, scale=scale)
    _close_norms(ont, onj)
    d = np.abs(ot.numpy().astype(np.int32) - np.asarray(oj).astype(np.int32))
    assert d.max() <= 1
    assert (d != 0).sum() <= 1e-3 * n


def test_dequant_acc_requant_rejects_bad_args():
    lv, nm, loc = torch.zeros(5000, dtype=torch.int8), torch.ones(2), torch.zeros(5000)
    with pytest.raises(ValueError):
        kernels.dequant_acc_requant(lv.to(torch.int16), nm, loc, 0)
    with pytest.raises(ValueError):
        kernels.dequant_acc_requant(lv[:4999], nm, loc, 0)
    with pytest.raises(ValueError):
        kernels.dequant_acc_requant(lv, torch.ones(3), loc, 0)
    with pytest.raises(ValueError):
        kernels.chunk_encode(loc, 0, 200)
    with pytest.raises(ValueError):
        kernels.chunk_encode(loc, 0, 127, block=1000)


def test_decode_blocks_is_exact():
    rng = np.random.RandomState(11)
    lv = rng.randint(-128, 128, size=N).astype(np.int8)
    nm = (rng.rand(4) * 5).astype(np.float32)
    dj = np.asarray(pk.decode_blocks(jnp.asarray(lv), jnp.asarray(nm), 127))
    dt = kernels.decode_blocks(torch.from_numpy(lv), torch.from_numpy(nm), 127)
    assert dt.dtype == torch.float32
    assert np.array_equal(dt.numpy().view(np.uint32), dj.view(np.uint32))


def test_ring_wrappers_on_cpu_are_the_plain_versions():
    x = torch.from_numpy(_x(4))
    before = dict(kernels.LAUNCHES)
    lv, nm = kernels.chunk_encode(x, 3)
    ref = kernels.chunk_encode_ref(x, 3)
    assert torch.equal(lv, ref[0]) and torch.equal(nm, ref[1])
    out = kernels.dequant_acc_requant(lv, nm, x, 4, scale=0.5)
    ref = kernels.dequant_acc_requant_ref(lv, nm, x, 4, scale=0.5)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert kernels.LAUNCHES == before  # no kernel launched on the CPU


def test_ring_dispatch_has_no_size_gate():
    kernels.configure("auto")
    assert kernels.ring_hops("cpu")[0] is kernels.chunk_encode_ref
    assert kernels.ring_hops("cuda")[0] is kernels.chunk_encode  # any size
    for mode in ("off", "interpret"):
        kernels.configure(mode)
        assert kernels.ring_hops("cuda")[1] is kernels.dequant_acc_requant_ref
    kernels.configure("on")
    assert kernels.ring_hops("cuda")[1] is kernels.dequant_acc_requant
