"""The decode set (``ops/kernels.DecodeSet``, ``kernels/decode.cu``):
one launch decodes every quantized leaf of a homomorphic apply.

- ``decode_sum_set_ref`` leaf for leaf against the Pallas ``acc_decode``
  run with ``interpret=True`` (per tensor, blockwise 4096 and 8192, k in
  {1, 3, 4, 6, 26}, leaf sizes 1, 3, 4 095, 4 097 and 2^17 + 1); 449
  leaves split across two launches against the JAX package's XLA twin of
  the kernel. Oracle: bit (one f32 product per element, in the kernel's
  order).
- The descriptor packing and the tile map: a host model of the kernel
  (its binary search over the first tiles, its tile of 4096, its factor
  per tile) walks the packed descriptors and must cover every element of
  every leaf once and give ``decode_sum_set_ref``'s values. Oracle: exact
  (integer reckoning) and bit.
- ``homomorphic.homomorphic_mean`` through the set against the JAX
  package's on a mixed adaptive plan (dense, Top-k QSGD, QSGD leaves) and
  on weighted int16 tree sums at k = 6, given the same scales and
  payloads. Oracle: bit.
- The CPU dispatch (``DecodeSet.decode``, what the apply calls): every
  mode takes the plain version and launches nothing. Oracle: bit.
- ``kernels.DecodeSet``, the layout the apply packs once: its arenas'
  16-byte views, its plain decode, and the apply's cache of it (one a
  divisor, packed again when a leaf's scales change). Oracle: exact and
  bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.adapt import plan as jplan
from ewdml_tpu.ops import homomorphic as jhom
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu.ops import qsgd as jqsgd
from ewdml_tpu_torch.adapt import plan
from ewdml_tpu_torch.ops import chain, homomorphic, kernels, none, qsgd

torch.set_num_threads(2)

SIZES = (1, 3, 4095, 4097, (1 << 17) + 1)
TILE = kernels.DECODE_TILE


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _leaf(rng, n, k, block):
    acc = rng.integers(-127 * k, 127 * k + 1, n).astype(np.int32)
    nb = 1 if block is None else -(-n // block)
    scales = (rng.random(nb).astype(np.float32) * np.float32(1e-3)
              + np.float32(1e-6))
    return acc, scales


def _items(leaves, k, block):
    return [(torch.from_numpy(a), torch.from_numpy(s), k, block)
            for a, s in leaves]


@pytest.mark.parametrize("block", [None, 4096, 8192])
@pytest.mark.parametrize("k", [1, 3, 4, 6, 26])
def test_set_ref_is_the_pallas_kernel(k, block):
    """Oracle: bit, against ``pallas_kernels.acc_decode(interpret=True)``
    leaf by leaf."""
    rng = np.random.default_rng(k * 100 + (block or 0))
    leaves = [_leaf(rng, n, k, block) for n in SIZES]
    got = kernels.decode_sum_set_ref(_items(leaves, k, block))
    assert len(got) == len(SIZES)
    for (acc, scales), ours in zip(leaves, got):
        want = pk.acc_decode(jnp.asarray(acc), jnp.asarray(scales), k,
                             block=block, interpret=True)
        assert ours.dtype == torch.float32 and ours.shape == (acc.size,)
        assert np.array_equal(_bits(ours.numpy()), _bits(want))
    # The wrapper takes the plain version on the CPU.
    for a, b in zip(kernels.acc_decode_set(_items(leaves, k, block)), got):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_449_leaves_split_across_two_launches():
    """Oracle: bit, against the JAX package's XLA twin of the kernel
    (``pallas_kernels.acc_decode`` on the CPU); the packing: exact."""
    rng = np.random.default_rng(449)
    sizes = [1 + (i * 7) % 13 for i in range(449)]
    leaves = [_leaf(rng, n, 6, None) for n in sizes]
    got = kernels.decode_sum_set_ref(_items(leaves, 6, None))
    for (acc, scales), ours in zip(leaves, got):
        want = pk.acc_decode(jnp.asarray(acc), jnp.asarray(scales), 6)
        assert np.array_equal(_bits(ours.numpy()), _bits(want))
    descs = kernels.decode_descriptors(
        [(16 * i, 0, 0, n, None, 1.0) for i, n in enumerate(sizes)])
    assert [len(d) for d in descs] == [448, 1]
    assert descs[1]["first_tile"][0] == 0 and descs[1]["acc"][0] == 16 * 448
    assert kernels.decode_set_launches(449) == 2
    assert kernels.decode_set_launches(448) == 1
    assert kernels.decode_set_launches(0) == 0


def test_empty_sets():
    """Oracle: exact. No leaf, or only empty leaves, packs no launch."""
    assert kernels.decode_sum_set_ref([]) == []
    assert kernels.acc_decode_set([]) == []
    assert kernels.decode_descriptors([(0, 0, 0, 0, None, 1.0)] * 3) == []
    empty = torch.zeros(0, dtype=torch.int32)
    out = kernels.acc_decode_set([(empty, torch.ones(1), 3, None)])
    assert len(out) == 1 and out[0].shape == (0,)
    dset = kernels.DecodeSet([], "cpu")
    assert dset.total == 0 and dset.decode(dset.acc_arena()) == []


def test_descriptor_layout_is_the_c_struct():
    """Oracle: exact. ``DecodeLeaf`` in ``decode.cu``: three 8-byte
    pointers, then n, first_tile, tiles_per_block and inv_k."""
    d = kernels.DECODE_LEAF
    assert d.itemsize == 40
    assert [d.fields[f][1] for f in d.names] == [0, 8, 16, 24, 28, 32, 36]
    # 448 descriptors and the set's two counts fit CUDA's 32 KB of
    # parameters (32 764 bytes).
    assert 8 + kernels.DECODE_MAX_LEAVES * d.itemsize <= 32764


def _kernel_model(descs, arrays):
    """What ``acc_decode_set_kernel`` computes, tile by tile, from the
    packed descriptors: ``arrays[acc_ptr] = (acc, scales)``. Returns
    ``{acc_ptr: out}`` and how often each element was written."""
    outs, writes = {}, {}
    for desc in descs:
        last = desc[-1]
        tiles = int(last["first_tile"]) + -(-int(last["n"]) // TILE)
        for t in range(tiles):
            lo, hi = 0, len(desc)
            while hi - lo > 1:   # the kernel's search over the first tiles
                mid = (lo + hi) >> 1
                if desc[mid]["first_tile"] <= t:
                    lo = mid
                else:
                    hi = mid
            L = desc[lo]
            acc, scales = arrays[int(L["acc"])]
            tile = t - int(L["first_tile"])
            tpb = int(L["tiles_per_block"])
            factor = scales[tile // tpb if tpb else 0] * L["inv_k"]
            assert factor.dtype == np.float32
            begin = tile * TILE
            end = min(int(L["n"]), begin + TILE)
            assert begin < end
            out = outs.setdefault(int(L["acc"]),
                                  np.zeros(acc.size, np.float32))
            out[begin:end] = acc[begin:end].astype(np.float32) * factor
            w = writes.setdefault(int(L["acc"]), np.zeros(acc.size, int))
            w[begin:end] += 1
    return outs, writes


@pytest.mark.parametrize("max_leaves", [448, 5])
def test_tile_map_covers_every_element_once(max_leaves):
    """Oracle: exact (coverage) and bit (values, against
    ``decode_sum_set_ref``)."""
    rng = np.random.default_rng(max_leaves)
    spec = [(1, None), (0, 4096), (4097, 4096), (3 * 8192 + 17, 8192),
            (9000, None), (4095, 4096), (8192, 8192), (2, 4096),
            (12 * 4096, 4096), (70_001, None), (3, None)]
    ks = [1, 3, 4, 6, 26, 5, 7, 2, 9, 11, 13]
    leaves, arrays, items = [], {}, []
    for i, ((n, block), k) in enumerate(zip(spec, ks)):
        acc, scales = _leaf(rng, n, k, block)
        ptr = 16 * (i + 1)
        arrays[ptr] = (acc, scales)
        leaves.append((ptr, 0, 0, n, block, kernels.f32_inverse(k)))
        items.append((torch.from_numpy(acc), torch.from_numpy(scales), k,
                      block))
    descs = kernels.decode_descriptors(leaves, max_leaves=max_leaves)
    assert sum(len(d) for d in descs) == 10          # the empty leaf: none
    assert [len(d) for d in descs] == (
        [10] if max_leaves == 448 else [5, 5])
    for d in descs:
        first = np.cumsum([0] + [-(-int(n) // TILE) for n in d["n"][:-1]])
        assert np.array_equal(d["first_tile"], first)
    outs, writes = _kernel_model(descs, arrays)
    want = kernels.decode_sum_set_ref(items)
    for (ptr, _, _, n, block, _), ref in zip(leaves, want):
        if n == 0:
            assert ptr not in outs
            continue
        assert np.all(writes[ptr] == 1)
        assert np.array_equal(_bits(outs[ptr]), _bits(ref.numpy()))


@pytest.mark.parametrize("mode", ["auto", "off", "interpret"])
def test_cpu_dispatch_launches_nothing(mode):
    """Oracle: bit. On the CPU every mode takes the plain version."""
    rng = np.random.default_rng(3)
    leaves = [_leaf(rng, n, 3, 4096) for n in (5, 9000)]
    dset = kernels.DecodeSet([(a.size, torch.from_numpy(s), 3, 4096)
                              for a, s in leaves], "cpu")
    acc = dset.acc_arena()
    for view, (a, _) in zip(dset.views(acc), leaves):
        view.copy_(torch.from_numpy(a))
    kernels.reset_launches()
    kernels.configure(mode)
    try:
        got = dset.decode(acc)
    finally:
        kernels.configure("auto")
    for a, b in zip(got, kernels.decode_sum_set_ref(_items(leaves, 3, 4096))):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert kernels.LAUNCHES["acc_decode"] == 0


def _to_torch(p):
    """A JAX payload as the port's payload of the same name."""
    cls = {"DensePayload": none.DensePayload,
           "SharedScaleQSGDPayload": qsgd.SharedScaleQSGDPayload,
           "SharedScaleTopKQSGDPayload": chain.SharedScaleTopKQSGDPayload,
           }[type(p).__name__]
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(p, f.name)
        kw[f.name] = (torch.from_numpy(np.array(v))
                      if isinstance(v, jax.Array) else v)
    return cls(**kw)


def test_mixed_plan_mean_is_the_jax_one():
    """Oracle: bit. K = 3 payloads of a mixed adaptive plan (4-bit QSGD,
    Top-k QSGD at 1%, 8-bit QSGD blockwise, dense), encoded by the JAX
    package, through both packages' homomorphic means."""
    rng = np.random.default_rng(2)
    shapes = [(5000,), (300_000,), (9000,), (400,)]
    grads = [rng.standard_normal(s).astype(np.float32) * 0.01
             for s in shapes]
    decisions = [("qsgd", 7, 0.0), ("topk_qsgd", 127, 0.01),
                 ("qsgd", 127, 0.0), ("dense", 0, 0.0)]
    jp = jplan.build_planned_compressor(jplan.Plan(1, 2, tuple(
        jplan.UnitDecision(u, f"l{u}", *d) for u, d in enumerate(decisions))),
        block=4096)
    tp = plan.build_planned_compressor(plan.Plan(1, 2, tuple(
        plan.UnitDecision(u, f"l{u}", *d) for u, d in enumerate(decisions))),
        block=4096)
    jc = jhom.make_homomorphic(jp, {f"l{u}": jnp.asarray(x)
                                    for u, x in enumerate(grads)})
    tc = homomorphic.make_homomorphic(tp, [torch.from_numpy(x)
                                           for x in grads])
    for i in range(len(grads)):
        js, ts = jc.for_leaf(i), tc.for_leaf(i)
        if hasattr(js, "scales"):
            ts.scales = torch.from_numpy(np.array(js.scales))
    jtrees = [{f"l{u}": jc.for_leaf(u).compress(
                   jax.random.key(10 * w + u), jnp.asarray(g * (1 + w / 3)))
               for u, g in enumerate(grads)} for w in range(3)]
    ttrees = [[_to_torch(t[f"l{u}"]) for u in range(len(grads))]
              for t in jtrees]
    want = jhom.homomorphic_mean(jc, jtrees)
    got = homomorphic.homomorphic_mean(tc, ttrees)
    assert len(got) == len(grads)
    for u, g in enumerate(got):
        w = np.asarray(want[f"l{u}"])
        assert tuple(g.shape) == w.shape == shapes[u]
        assert np.array_equal(_bits(g.numpy()), _bits(w)), u


class _Subs:
    """A homomorphic compressor reduced to what the mean reads."""

    def __init__(self, subs):
        self.subs = subs

    def for_leaf(self, i):
        return self.subs[i]


def test_tree_sums_at_k6_are_the_jax_mean():
    """Oracle: bit. Weighted int16 partial sums (weights 2, 3, 1) of six
    leaves' int8 levels on three leaves (per tensor, blockwise 4096 and
    8192) and a dense leaf, divided by the total weight 6."""
    rng = np.random.default_rng(6)
    spec = [(9000, None), (3 * 4096 + 77, 4096), (2 * 8192 + 5, 8192)]
    jsubs, tsubs, jparts, tparts = [], [], [[], [], []], [[], [], []]
    for n, block in spec:
        nb = 1 if block is None else -(-n // block)
        scales = (rng.random(nb).astype(np.float32) * np.float32(0.01)
                  + np.float32(1e-4))
        jsubs.append(jqsgd.SharedScaleQSGD(jnp.asarray(scales), 127, block))
        tsubs.append(qsgd.SharedScaleQSGD(torch.from_numpy(scales), 127,
                                          block))
        levels = rng.integers(-127, 128, (6, n)).astype(np.int32)
        for j, rows in enumerate((levels[:2], levels[2:5], levels[5:])):
            part = rows.sum(axis=0).astype(np.int16)
            jparts[j].append(jqsgd.SharedScaleQSGDPayload(
                jnp.asarray(part), (n,), 127, block))
            tparts[j].append(qsgd.SharedScaleQSGDPayload(
                torch.from_numpy(part), (n,), 127, block))
    dense = rng.standard_normal((3, 70)).astype(np.float32)
    from ewdml_tpu.ops import none as jnone
    jsubs.append(jnone.NoneCompressor())
    tsubs.append(none.NoneCompressor())
    for j in range(3):
        jparts[j].append(jnone.DensePayload(values=jnp.asarray(dense[j]),
                                            shape=(70,)))
        tparts[j].append(none.DensePayload(values=torch.from_numpy(dense[j]),
                                           shape=(70,)))
    want = jhom.homomorphic_mean(_Subs(jsubs), jparts, k=6)
    got = homomorphic.homomorphic_mean(_Subs(tsubs), tparts, k=6)
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g.numpy()), _bits(w))


def test_decode_set_layout_is_the_arena_of_16_byte_views():
    """Oracle: exact (the layout) and bit (its plain decode against
    ``decode_sum_set_ref`` on the same views)."""
    rng = np.random.default_rng(16)
    spec = [(5, None), (0, 4096), (4097, 4096), (3, None), (8, 8192)]
    leaves = [(n, torch.from_numpy(_leaf(rng, n, 3, b)[1]), 3, b)
              for n, b in spec]
    dset = kernels.DecodeSet(leaves, "cpu")
    assert dset.offsets == [0, 8, 8, 4108, 4112] and dset.total == 4120
    acc = dset.acc_arena()
    assert acc.dtype == torch.int32 and acc.shape == (4120,)
    acc.copy_(torch.from_numpy(rng.integers(-381, 382, 4120).astype(
        np.int32)))
    views = dset.views(acc)
    assert [v.numel() for v in views] == [n for n, _ in spec]
    assert [v.storage_offset() for v in views] == dset.offsets
    assert all(off % 4 == 0 for off in dset.offsets)
    want = kernels.decode_sum_set_ref(
        [(v, sc, k, b) for v, (_, sc, k, b) in zip(views, leaves)])
    for a, b in zip(dset.decode(acc), want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # The kernel takes blocks of 4096 only; the plain version any.
    kernels.DecodeSet([(9000, torch.ones(9), 3, 1000)], "cpu")
    with pytest.raises(ValueError, match="4096"):
        kernels._check_set_leaf(torch.ones(9), 9000, 1000, "cpu", True)


def test_homomorphic_mean_keeps_one_decode_set_a_contract():
    """Oracle: exact. The apply packs its decode set once per divisor and
    packs it again when a leaf's scales change."""
    rng = np.random.default_rng(5)
    scales = [torch.from_numpy(rng.random(1).astype(np.float32))
              for _ in range(3)]
    subs = _Subs([qsgd.SharedScaleQSGD(sc, 127, None) for sc in scales])
    trees = [[qsgd.SharedScaleQSGDPayload(
        torch.from_numpy(rng.integers(-127, 128, 70).astype(np.int8)),
        (70,), 127, None) for _ in range(3)] for _ in range(4)]
    first = homomorphic.homomorphic_mean(subs, trees)
    leaves = [(i, 70) for i in range(3)]
    dset = homomorphic.decode_set_for(subs, leaves, 4, torch.device("cpu"))
    assert homomorphic.decode_set_for(subs, leaves, 4,
                                      torch.device("cpu")) is dset
    assert homomorphic.decode_set_for(subs, leaves, 6,
                                      torch.device("cpu")) is not dset
    again = homomorphic.homomorphic_mean(subs, trees)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    subs.subs[1].scales = scales[1] * 2
    assert homomorphic.decode_set_for(subs, leaves, 4,
                                      torch.device("cpu")) is not dset
    doubled = homomorphic.homomorphic_mean(subs, trees)
    assert torch.equal(doubled[0], first[0])
    assert not torch.equal(doubled[1], first[1])
