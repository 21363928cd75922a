"""The port's compressors against the JAX package's.

- ``wire_bytes``: exact, for every compressor on the LeNet and VGG11-BN leaf
  shapes and on VGG11-BN's fused 8 MB buckets.
- compress -> decompress round trips for qsgd (per tensor and blockwise),
  topk, topk_qsgd and the block path, under ``interpret`` (the kernels'
  murmur stream) and ``off`` (jax.random's threefry stream, which the port
  reproduces bit for bit). Oracles: selections (indices, block locations)
  bit; norms tolerance (rtol 2e-6: the f32 sum of squares runs in another
  order); levels bit wherever the two norms are bit-equal, and otherwise at
  most 0.1% of them off by one level (a norm one ulp apart moves the
  stochastic threshold of the elements whose draw lands in between).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.ops import blocktopk as jblock
from ewdml_tpu.ops import make_compressor as jmake
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu_torch.ops import blocktopk as tblock
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.ops import make_compressor as tmake
from ewdml_tpu_torch.utils import prng

torch.set_num_threads(2)

LENET_SHAPES = [(20,), (5, 5, 1, 20), (50,), (5, 5, 20, 50), (500,),
                (800, 500), (10,), (500, 10)]
VGG_BUCKETS = [7808, 2359296, 512, 2359296, 959616, 1180160, 2359296, 530442]

COMPRESSORS = [
    ("none", {}), ("qsgd", {}), ("qsgd", dict(qsgd_block=4096)),
    ("qsgd", dict(quantum_num=7)), ("qsgd", dict(quantum_num=128)),
    ("terngrad", {}), ("topk", dict(topk_ratio=0.01)),
    ("topk_qsgd", dict(topk_ratio=0.5)), ("topk_qsgd", dict(topk_ratio=0.01)),
    ("topk_qsgd", dict(topk_ratio=0.01, topk_exact="block")),
    ("topk_qsgd", dict(topk_ratio=0.01, qsgd_block=4096)),
]


@pytest.fixture(autouse=True)
def _restore_modes():
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


def _vgg_shapes():
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs
    return [s.jax_shape for s in leaf_specs(build_model("VGG11"))]


@pytest.mark.parametrize("name,kw", COMPRESSORS)
def test_wire_bytes_equal(name, kw):
    jc, tc = jmake(name, **kw), tmake(name, **kw)
    shapes = LENET_SHAPES + _vgg_shapes() + [(n,) for n in VGG_BUCKETS]
    for shape in shapes:
        assert int(tc.wire_bytes(shape)) == int(jc.wire_bytes(shape)), shape


def test_vgg_leaf_order_and_buckets():
    """The port enumerates VGG11-BN's 38 leaves in the JAX tree's order and
    fuses them into the same 8 MB buckets."""
    from ewdml_tpu.models import build_model as jbuild
    from ewdml_tpu.parallel.collectives import bucket_groups as jgroups
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs
    from ewdml_tpu_torch.parallel.collectives import bucket_groups

    specs = leaf_specs(build_model("VGG11"))
    variables = jax.eval_shape(
        lambda: jbuild("VGG11").init(jax.random.key(0),
                                     jnp.zeros((1, 32, 32, 3)), train=False))
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    jnames = ["/".join(p.key for p in path) for path, _ in flat]
    assert [s.name for s in specs] == jnames
    assert [s.jax_shape for s in specs] == [tuple(l.shape) for _, l in flat]
    sizes = [int(np.prod(s.jax_shape)) for s in specs]
    groups = bucket_groups(sizes, 8 << 20)
    assert groups == jgroups(sizes, 8 << 20)
    assert [sum(sizes[i] for i in g) for g in groups] == VGG_BUCKETS


def _check_norms_and_levels(jn, tn, jl, tl):
    jn, tn = np.asarray(jn, np.float64), tn.numpy().astype(np.float64)
    np.testing.assert_allclose(tn, jn, rtol=2e-6, atol=0)
    jl, tl = np.asarray(jl).astype(np.int64), tl.numpy().astype(np.int64)
    if np.array_equal(jn, tn):
        assert np.array_equal(tl, jl)
    else:
        diff = np.abs(tl - jl)
        assert diff.max(initial=0) <= 1
        assert (diff != 0).sum() <= 1e-3 * jl.size + 1


@pytest.mark.parametrize("mode", ["interpret", "off"])
@pytest.mark.parametrize("n,block", [(5000, None), (20000, None), (9000, 4096)])
def test_qsgd_round_trip(mode, n, block):
    pk.configure(mode)
    kernels.configure(mode)
    rng = np.random.RandomState(n)
    x = rng.randn(n).astype(np.float32)
    jc, tc = jmake("qsgd", qsgd_block=block), tmake("qsgd", qsgd_block=block)
    jp = jc.compress(jax.random.fold_in(jax.random.key(9), 4), jnp.asarray(x))
    tp = tc.compress(prng.fold_in(prng.key(9), 4), torch.from_numpy(x))
    assert tp.levels.dtype == torch.int8 and tp.wire_bytes == jp.wire_bytes
    _check_norms_and_levels(jp.norm, tp.norm, jp.levels, tp.levels)
    np.testing.assert_allclose(tc.decompress(tp).numpy(),
                               np.asarray(jc.decompress(jp)),
                               rtol=0, atol=float(np.max(jp.norm)) / 127 * 1.0001)


@pytest.mark.parametrize("ratio", [0.01, 0.3])
def test_topk_round_trip_with_ties(ratio):
    rng = np.random.RandomState(1)
    x = (np.round(rng.randn(7000) * 4) / 4).astype(np.float32)  # many ties
    jc, tc = jmake("topk", topk_ratio=ratio), tmake("topk", topk_ratio=ratio)
    jp = jc.compress(None, jnp.asarray(x))
    tp = tc.compress(None, torch.from_numpy(x))
    assert np.array_equal(tp.indices.numpy(), np.asarray(jp.indices))
    assert np.array_equal(tp.values.numpy(), np.asarray(jp.values))
    assert np.array_equal(tc.decompress(tp).numpy(),
                          np.asarray(jc.decompress(jp)))


def test_topk_approx_mode_is_exact_on_the_reference():
    """Above 2^18 elements auto mode resolves to approx_max_k, which the
    JAX package's CPU backend runs exactly (same winners, same order)."""
    rng = np.random.RandomState(2)
    x = rng.randn(300000).astype(np.float32)
    jc, tc = jmake("topk", topk_ratio=0.2), tmake("topk", topk_ratio=0.2)
    jp = jc.compress(None, jnp.asarray(x))
    tp = tc.compress(None, torch.from_numpy(x))
    assert np.array_equal(tp.indices.numpy(), np.asarray(jp.indices))


@pytest.mark.parametrize("mode", ["interpret", "off"])
@pytest.mark.parametrize("n,ratio,exact", [
    (20000, 0.5, None), (300000, 0.01, None), (40000, 0.01, "block"),
])
def test_topk_qsgd_round_trip(mode, n, ratio, exact):
    pk.configure(mode)
    kernels.configure(mode)
    rng = np.random.RandomState(n)
    x = rng.randn(n).astype(np.float32)
    jc = jmake("topk_qsgd", topk_ratio=ratio, topk_exact=exact)
    tc = tmake("topk_qsgd", topk_ratio=ratio, topk_exact=exact)
    jp = jc.compress(jax.random.fold_in(jax.random.key(1), 2), jnp.asarray(x))
    tp = tc.compress(prng.fold_in(prng.key(1), 2), torch.from_numpy(x))
    assert type(tp).__name__ == type(jp).__name__
    assert tp.wire_bytes == jp.wire_bytes
    if isinstance(tp, tblock.BlockTopKQSGDPayload):
        assert isinstance(jp, jblock.BlockTopKQSGDPayload)
        assert (tp.nb, tp.blk_pad) == (jp.nb, jp.blk_pad)
        assert np.array_equal(tp.locs.numpy(), np.asarray(jp.locs))
    else:
        assert np.array_equal(tp.indices.numpy(), np.asarray(jp.indices))
    _check_norms_and_levels(jp.norm, tp.norm, jp.levels, tp.levels)
    np.testing.assert_allclose(tc.decompress(tp).numpy(),
                               np.asarray(jc.decompress(jp)),
                               rtol=0, atol=float(np.max(jp.norm)) / 127 * 1.0001)


def test_block_select_keeps_xla_sign_of_zero_off_the_kernel_path():
    """Off the kernel path the winner is taken as it is (-0 stays -0, as in
    blocktopk._select_xla); the kernel path turns it into +0."""
    x = torch.zeros(128 * 8)
    x[0] = -0.0  # row 0 of an all-zero column: the first-row winner
    kernels.configure("off")
    vals, _ = tblock.select(x, 128, 8)
    assert torch.signbit(vals[0])
    kernels.configure("interpret")
    vals, _ = tblock.select(x, 128, 8)
    assert not torch.signbit(vals[0])
