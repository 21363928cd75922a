"""The shared-scale halves of ``ops/qsgd.py`` and ``ops/chain.py`` and the
flat half of ``ops/homomorphic.py``: the port against the JAX package.

Oracles, per test:
- ``shared_scales``: tolerance. The block norms are f32 reductions summed in
  different orders (``jnp.linalg.norm`` vs ``torch.linalg.vector_norm``), so
  each scale agrees within 4 f32 ulps (|d| <= 2^-21 |scale|).
- levels: bit. Given the JAX scales and the same key, the port's threefry
  draw is ``jax.random.uniform``'s stream bit for bit, and the rest is
  elementwise f32 arithmetic in the same order.
- ``homomorphic_mean`` of K = 3 same payloads: bit (an exact integer sum and
  one f32 product per element in the same order).
- wire bytes and the rejection matrices: equal.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.core.config import TrainConfig as JConfig
from ewdml_tpu.core.config import validate_server_agg as j_validate
from ewdml_tpu.ops import chain as jchain
from ewdml_tpu.ops import homomorphic as jhom
from ewdml_tpu.ops import qsgd as jqsgd
from ewdml_tpu.ops.chain import TopKQSGDCompressor as JTopKQSGD
from ewdml_tpu.ops.qsgd import QSGDCompressor as JQSGD
from ewdml_tpu.ops.topk import TopKCompressor as JTopK
from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.core.config import validate_server_agg
from ewdml_tpu_torch.ops import chain, homomorphic, qsgd
from ewdml_tpu_torch.ops.chain import TopKQSGDCompressor
from ewdml_tpu_torch.ops.qsgd import QSGDCompressor
from ewdml_tpu_torch.ops.topk import TopKCompressor
from ewdml_tpu_torch.utils import prng

torch.set_num_threads(2)


def _grad(n, seed, scale=0.05, zero_block=False):
    g = (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)
    if zero_block:
        g[4096:8192] = 0.0
    return g


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("n,block", [(9000, None), (9000, 4096),
                                     (3 * 4096 + 5, 4096), (300_000, None)])
def test_shared_scales_within_f32_reduction(n, block):
    g = _grad(n, 1, zero_block=n > 8192)
    a = np.asarray(jqsgd.shared_scales(jnp.asarray(g), 127, block))
    b = qsgd.shared_scales(torch.from_numpy(g), 127, block).numpy()
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    np.testing.assert_allclose(b, a, rtol=2.0 ** -21, atol=0)
    # The zero-block fallback picks the leaf's largest scale in both.
    if block is not None and n > 8192:
        assert b[1] == b.max() and a[1] == a.max()
    z = qsgd.shared_scales(torch.zeros(64), 127).numpy()
    assert np.array_equal(_bits(z), _bits(jqsgd.shared_scales(
        jnp.zeros((64,)), 127)))


@pytest.mark.parametrize("n,block", [(9000, None), (9000, 4096),
                                     (300_000, None), (300_000, 4096)])
def test_dense_levels_bit_equal_given_jax_scales(n, block):
    g = _grad(n, 2)
    # A copy: jnp.asarray may share g's memory on the CPU, and the scales,
    # dispatched asynchronously, could then read the entry set below. The
    # copy from g is asynchronous too, so wait for the scales before g
    # changes.
    sc = jax.block_until_ready(jqsgd.shared_scales(jnp.array(g), 127, block))
    g[7] = 100.0  # far beyond headroom x template: clips at s
    for seed in (0, 11, 2**31 - 1):
        jp = jqsgd.compress_shared(jax.random.key(seed), jnp.asarray(g), sc,
                                   127, block)
        tp = qsgd.compress_shared(prng.key(seed), torch.from_numpy(g),
                                  _t(sc), 127, block)
        assert tp.levels.dtype == torch.int8
        assert np.array_equal(tp.levels.numpy(), np.asarray(jp.levels))
        assert tp.wire_bytes == jp.wire_bytes
        assert int(tp.levels[7]) == 127
        dec_j = np.asarray(jqsgd.decompress_shared(jp, sc))
        dec_t = qsgd.decompress_shared(tp, _t(sc)).numpy()
        assert np.array_equal(_bits(dec_t), _bits(dec_j))


@pytest.mark.parametrize("n,ratio,block", [(9000, 0.1, None),
                                           (9000, 0.1, 4096),
                                           (300_000, 0.01, None),
                                           (300_000, 0.01, 4096)])
def test_topk_levels_bit_equal_given_jax_scales(n, ratio, block):
    g = _grad(n, 3)
    sc = jqsgd.shared_scales(jnp.asarray(g), 127, block)
    key = prng.fold_in(prng.key(4), 9)
    jkey = jax.random.fold_in(jax.random.key(4), 9)
    jp = jchain.compress_shared(jkey, jnp.asarray(g), sc, ratio, 127,
                                block=block)
    tp = chain.compress_shared(key, torch.from_numpy(g), _t(sc), ratio, 127,
                               block=block)
    assert np.array_equal(tp.indices.numpy(), np.asarray(jp.indices))
    assert np.array_equal(tp.levels.numpy(), np.asarray(jp.levels))
    assert tp.wire_bytes == jp.wire_bytes
    dec_j = np.asarray(jchain.decompress_shared(jp, sc))
    dec_t = chain.decompress_shared(tp, _t(sc)).numpy()
    assert np.array_equal(_bits(dec_t), _bits(dec_j))


@pytest.mark.parametrize("kind,n,block", [("qsgd", 9000, None),
                                          ("qsgd", 300_000, 4096),
                                          ("qsgd", 3 * 8192 + 17, 8192),
                                          ("topk", 9000, None),
                                          ("topk", 300_000, 4096)])
def test_homomorphic_mean_bit_equal(kind, n, block):
    """K = 3 payloads of the same contract, built by the JAX encoder, through
    both packages' one-decode means."""
    g = _grad(n, 5)
    sc = jqsgd.shared_scales(jnp.asarray(g), 127, block)
    if kind == "qsgd":
        jsub = jqsgd.SharedScaleQSGD(sc, 127, block)
        tsub = qsgd.SharedScaleQSGD(_t(sc), 127, block)
    else:
        jsub = jchain.SharedScaleTopKQSGD(sc, 0.05, 127, block=block)
        tsub = chain.SharedScaleTopKQSGD(_t(sc), 0.05, 127, block=block)
    jps = [jsub.compress(jax.random.key(30 + w), jnp.asarray(g * (1 + w / 4)))
           for w in range(3)]
    if kind == "qsgd":
        tps = [qsgd.SharedScaleQSGDPayload(_t(p.levels), p.shape, p.s,
                                           p.block) for p in jps]
    else:
        tps = [chain.SharedScaleTopKQSGDPayload(_t(p.indices), _t(p.levels),
                                                p.shape, p.s, p.block)
               for p in jps]
    a = np.asarray(jsub.homomorphic_mean(jps))
    b = tsub.homomorphic_mean(tps).numpy()
    assert np.array_equal(_bits(b), _bits(a))


def test_compressor_contract_and_checksum():
    """``make_homomorphic`` over a leaf list (the port) and a leaf tree (JAX):
    per-leaf twins of the same kind and block; scales within the
    ``shared_scales`` tolerance; given the JAX scales, the same checksum."""
    leaves = [_grad(5000, 6), _grad(300_000, 7), _grad(9000, 8)]
    tree = {"a": jnp.asarray(leaves[0]), "b": jnp.asarray(leaves[1]),
            "c": jnp.asarray(leaves[2])}
    for jbase, tbase in ((JQSGD(127, block=4096), QSGDCompressor(127, block=4096)),
                         (JTopKQSGD(0.01, 127), TopKQSGDCompressor(0.01, 127))):
        jc = jhom.make_homomorphic(jbase, tree)
        tc = homomorphic.make_homomorphic(
            tbase, [torch.from_numpy(x) for x in leaves])
        for i in range(3):
            js, ts = jc.for_leaf(i), tc.for_leaf(i)
            assert type(js).__name__ == type(ts).__name__
            assert js.block == ts.block
            np.testing.assert_allclose(ts.scales.numpy(),
                                       np.asarray(js.scales),
                                       rtol=2.0 ** -21, atol=0)
            ts.scales = _t(js.scales)
            n = leaves[i].size
            assert tc.wire_bytes((n,), unit=i) == jc.wire_bytes((n,), unit=i)
        assert tc.contract_checksum() == jc.contract_checksum()
        crc = 0
        for i in range(3):
            crc = zlib.crc32(np.asarray(jc.for_leaf(i).scales).tobytes(), crc)
        assert tc.contract_checksum() == crc


@pytest.mark.parametrize("n", [1, 5000, 300_000, 2_359_296])
def test_wire_pricing_equal(n):
    for jsub, tsub in ((JQSGD(127), QSGDCompressor(127)),
                       (JQSGD(127, block=4096), QSGDCompressor(127, block=4096)),
                       (JTopKQSGD(0.01, 127), TopKQSGDCompressor(0.01, 127)),
                       (JTopKQSGD(0.5, 127), TopKQSGDCompressor(0.5, 127))):
        assert homomorphic.priced_wire_bytes(tsub, n) == \
            jhom.priced_wire_bytes(jsub, n)
    assert qsgd.shared_wire_bytes(n) == jqsgd.shared_wire_bytes(n)
    assert chain.shared_wire_bytes(n, 0.01) == jchain.shared_wire_bytes(n, 0.01)
    assert qsgd.max_world_for(127) == jqsgd.max_world_for(127)


def _err(fn, *args):
    try:
        fn(*args)
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("kw", [
    dict(server_agg="homomorphic", compress_grad="none"),
    dict(server_agg="homomorphic", compress_grad="qsgd", quantum_num=128),
    dict(server_agg="homomorphic", compress_grad="topk"),
    dict(server_agg="homomorphic", compress_grad="terngrad"),
    dict(server_agg="homomorphic", compress_grad="qsgd", ps_down="delta"),
    dict(server_agg="homomorphic", compress_grad="qsgd",
         lossy_weights_down=True),
    dict(server_agg="nope"),
    dict(),
    dict(server_agg="homomorphic", compress_grad="qsgd"),
    dict(server_agg="homomorphic", compress_grad="topk_qsgd"),
])
def test_validate_server_agg_matrix(kw):
    a = _err(j_validate, JConfig(**kw))
    b = _err(validate_server_agg, TrainConfig(**kw))
    assert a == b
    assert (a is None) == (kw.get("server_agg", "decode") == "decode"
                           or kw.get("compress_grad") in ("qsgd",
                                                          "topk_qsgd")
                           and len(kw) == 2)


def test_leaf_shared_rejections():
    x = np.zeros(8, np.float32)
    cases = [(None, None), (JTopK(0.5), TopKCompressor(0.5)),
             (JQSGD(1, norm_kind="linf"), QSGDCompressor(1, norm_kind="linf"))]
    for jc, tc in cases:
        a = _err(jhom.make_homomorphic, jc, {"a": jnp.asarray(x)})
        b = _err(homomorphic.make_homomorphic, tc, [torch.from_numpy(x)])
        assert a is not None and a == b
    assert _err(jhom.priced_wire_bytes, JTopK(0.5), 8) == \
        _err(homomorphic.priced_wire_bytes, TopKCompressor(0.5), 8)
    with pytest.raises(ValueError, match="overflow"):
        qsgd.check_sum_budget(127, qsgd.max_world_for(127) + 1)
    with pytest.raises(ValueError, match="int8"):
        qsgd.compress_shared(prng.key(0), torch.zeros(4), torch.ones(1), 128)
