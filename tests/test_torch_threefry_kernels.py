"""The host halves of the two threefry kernels (``kernels/precision.cu``,
``kernels/random.cu``) against the JAX package and the plain versions.

Oracles, all bit:

- The round kernel's index map, as the host twin repeats it (multiply-high
  and shift for the first element of each 8-element vector, a carry per
  further element), equals ``ops/kernels.jax_index`` at every element of
  every LeNet, VGG11-BN and ResNet50 leaf shape.
- The packed descriptors of a store set, walked as the kernel walks them
  (each block finds its leaf by a binary search over the first blocks,
  each thread takes its vectors, thread 0 the tail), cover every element
  of every leaf exactly once: the VGG11-BN and ResNet50 sets, and sets
  that spill into more launches.
- The grouped plain store (``core/precision.tree_store_round``) equals
  ``store_round`` leaf by leaf under the derived keys and the JAX
  package's ``stochastic_round`` per leaf, on the SGD, Adam and residual
  paths' keys.
- On the CPU the draws (``prng.random_bits``, ``uniform`` and what builds
  on them) and the store launch nothing, under every kernel mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.core import precision as jprec
from ewdml_tpu_torch.core import precision as tprec
from ewdml_tpu_torch.models import build_model
from ewdml_tpu_torch.models.convert import from_jax, leaf_specs, to_jax
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.train.trainer import RESIDUAL_TAG
from ewdml_tpu_torch.utils import prng
from ewdml_tpu_torch.utils.keytable import KeyTable

torch.set_num_threads(2)

NETWORKS = {"LeNet": "MNIST", "VGG11": "Cifar10", "ResNet50": "Cifar10"}


@functools.lru_cache(maxsize=None)
def _leaves(network: str) -> tuple:
    """``(kind, torch shape)`` of the network's leaves, in its JAX order."""
    model = build_model(network, 10, dataset=NETWORKS[network])
    named = dict(model.named_parameters())
    return tuple((s.kind, tuple(named[s.torch_name].shape))
                 for s in leaf_specs(model))


@pytest.mark.parametrize("network", list(NETWORKS))
def test_index_map_twin_is_the_jax_index(network):
    for kind, shape in sorted(set(_leaves(network))):
        lay = kernels.round_layout(shape, kind)
        got = kernels.round_index_twin(lay, torch.arange(lay.n))
        assert torch.equal(got, kernels.jax_index(shape, kind, "cpu")), \
            (network, kind, shape)


@pytest.mark.parametrize("kind,shape", [
    ("dense", (10, 5)), ("dense", (7, 3)), ("conv", (6, 2, 2, 2)),
    ("conv", (3, 5, 3, 1)), ("dense", (9, 4097)), ("conv", (1, 5, 3, 3))])
def test_index_map_twin_on_narrow_and_odd_leaves(kind, shape):
    """Innermost dims shorter than a vector take the kernel's carry chain;
    the others its one adjustment past the wrap."""
    lay = kernels.round_layout(shape, kind)
    got = kernels.round_index_twin(lay, torch.arange(lay.n))
    assert torch.equal(got, kernels.jax_index(shape, kind, "cpu"))


def test_index_map_collapses_to_at_most_three_dims():
    # A 3x3 conv keeps (o, i, kh * kw); a 1x1 conv and a dense kernel
    # (o, i); a vector and a conv with o = i = 1 are the identity.
    lay = kernels.round_layout((512, 256, 3, 3), "conv")
    assert (lay.d1, lay.d2, lay.s0, lay.s1, lay.s2) == (256, 9, 1, 512,
                                                       512 * 256)
    lay = kernels.round_layout((256, 64, 1, 1), "conv")
    assert (lay.permuted, lay.d1, lay.d2, lay.s1, lay.s2) == (
        True, 256, 64, 1, 256)
    assert kernels.round_layout((10, 512), "dense") == kernels.round_layout(
        (10, 512, 1, 1), "conv")
    assert not kernels.round_layout((4097,), "vector").permuted
    assert not kernels.round_layout((1, 1, 3, 3), "conv").permuted


@pytest.mark.parametrize("d", [1, 2, 3, 9, 49, 64, 500, 4608, 2**31 - 1])
def test_magic_division_is_exact_over_uint32(d):
    m, s = kernels._magic(d)
    assert 0 < m < 1 << 32
    rng = np.random.RandomState(d % 1000)
    ts = [0, 1, d - 1, d, d + 1, 2**31, 2**32 - 2, 2**32 - 1]
    ts += [int(t) for t in rng.randint(0, 2**32, 4000, dtype=np.uint64)]
    for t in ts:
        assert (((t * m) >> 32) + t) >> s == t // d, (d, t)


def _walk(descs, block_elems=kernels.ROUND_BLOCK_ELEMS, threads=256,
          vec=kernels.ROUND_VEC):
    """The elements each launch's blocks and threads take, as the kernel
    takes them: ``{(x_ptr, out_ptr): coverage count per element}``."""
    cover = {}
    for d in descs:
        count = len(d)
        last = d[count - 1]
        blocks = int(last["first_block"]) + -(-int(last["n"]) // block_elems)
        for b in range(blocks):
            lo, hi = 0, count
            while hi - lo > 1:
                mid = (lo + hi) >> 1
                if d[mid]["first_block"] <= b:
                    lo = mid
                else:
                    hi = mid
            leaf = d[lo]
            n = int(leaf["n"])
            c = cover.setdefault((int(leaf["x"]), int(leaf["out"]), n), [])
            begin = (b - int(leaf["first_block"])) * block_elems
            end = min(n, begin + block_elems)
            # Thread tid's vectors start at begin + vec * tid, then every
            # threads * vec elements.
            starts = (begin + vec * np.arange(threads)[None, :]
                      + threads * vec * np.arange(
                          -(-block_elems // (threads * vec)) + 1)[:, None])
            lanes = np.arange(vec)
            if leaf["meta"] & (1 << 25):   # aligned: vectors, then the tail
                vend = begin + ((end - begin) & ~(vec - 1))
                s = starts[starts < vend]
                c.append((s[:, None] + lanes).ravel())
                c.append(np.arange(vend, end))  # thread 0's scalar tail
            else:
                idx = (starts[starts < end][:, None] + lanes).ravel()
                c.append(idx[idx < end])
    return {(xp, op): np.bincount(np.concatenate(c), minlength=n)
            for (xp, op, n), c in cover.items()}


def _set(network: str, repeat: int = 1, unaligned: bool = False):
    """A store set over the network's leaves ``repeat`` times (a residual
    set spans the workers), with made-up 16-byte aligned pointers (or 4
    bytes off for every other leaf) and the residual path."""
    items, at = [], 1 << 20
    for r in range(repeat):
        for i, (kind, shape) in enumerate(_leaves(network)):
            lay = kernels.round_layout(shape, kind)
            off = 4 if unaligned and i % 2 else 0
            items.append((at + off, at + (1 << 40) + off, lay,
                          (RESIDUAL_TAG, r, i)))
            at += 16 * (lay.n + 64)
    return items


MAX = kernels.ROUND_MAX_LEAVES


@pytest.mark.parametrize("network,repeat,max_leaves,launches", [
    ("VGG11", 1, MAX, 1),        # a VGG11-BN optimizer set: one launch
    ("VGG11", 4, MAX, 1),        # its residual set at W = 4
    ("ResNet50", 1, MAX, 1),     # ResNet50's optimizer set
    ("ResNet50", 2, MAX, 1),     # Adam's two moments, one launch
    ("ResNet50", 4, MAX, 2),     # its residual set at W = 4 spills once
    ("LeNet", 1, 3, 3),          # spills at every third leaf
])
def test_descriptors_cover_every_element_once(network, repeat, max_leaves,
                                              launches):
    items = _set(network, repeat, unaligned=network == "LeNet")
    descs = kernels.round_descriptors(items, max_leaves)
    assert len(descs) == launches
    assert [len(d) for d in descs[:-1]] == [max_leaves] * (launches - 1)
    flat = np.concatenate(descs)
    assert flat.dtype.itemsize == 72 and len(flat) == len(items)
    for row, (xp, op, lay, path) in zip(flat, items):
        assert (int(row["x"]), int(row["out"]), int(row["n"])) == (
            xp, op, lay.n)
        assert (int(row["meta"]) >> 16) & 0xFF == len(path)
        assert list(row["path"]) == [w & 0xFFFFFFFF for w in path]
        assert bool(row["meta"] & (1 << 24)) == lay.permuted
        assert bool(row["meta"] & (1 << 25)) == (xp % 16 == 0)
    for d in descs:
        assert int(d[0]["first_block"]) == 0
    cover = _walk(descs)
    assert len(cover) == len(items)
    for xp, op, lay, _ in items:
        assert np.all(cover[(xp, op)] == 1), (network, xp)


def test_descriptors_skip_empty_leaves_and_refuse_long_paths():
    lay = kernels.round_layout((7,), "vector")
    empty = kernels.round_layout((0,), "vector")
    d = kernels.round_descriptors([(16, 32, empty, (1,)), (48, 64, lay, ())],
                                  4)
    assert len(d) == 1 and len(d[0]) == 1 and int(d[0][0]["x"]) == 48
    with pytest.raises(ValueError):
        kernels.round_descriptors([(16, 32, lay, (1, 2, 3, 4))], 4)


def _jax_key(words) -> jax.Array:
    return jax.random.wrap_key_data(jnp.array(words, jnp.uint32))


def _jax_fold(words, path):
    k = _jax_key(words)
    for w in path:
        k = jax.random.fold_in(k, w)
    return k


def _inputs(network: str, seed: int, repeat: int = 1):
    rng = np.random.RandomState(seed)
    xs, kinds = [], []
    for _ in range(repeat):
        for kind, shape in _leaves(network):
            x = (rng.randn(*shape) * rng.choice([1e-3, 1.0])).astype(
                np.float32)
            x.reshape(-1)[:3] = [np.inf, np.nan, -0.0][:x.size]
            xs.append(torch.from_numpy(x))
            kinds.append(kind)
    return xs, kinds


def _paths(path: str, leaves: int, workers: int = 2) -> list:
    if path == "sgd":
        return [(i,) for i in range(leaves)]
    if path == "adam":
        return ([(i, 0) for i in range(leaves)]
                + [(i, 1) for i in range(leaves)])
    return [(RESIDUAL_TAG, r, i) for r in range(workers)
            for i in range(leaves)]


@pytest.mark.parametrize("path", ["sgd", "adam", "residual"])
@pytest.mark.parametrize("words", [(0, 42), (0x9E3779B9, 0x7F4A7C15)])
def test_grouped_store_is_per_leaf_and_the_jax_one(path, words):
    n = len(_leaves("LeNet"))
    repeat = 1 if path == "sgd" else 2
    xs, kinds = _inputs("LeNet", words[1] % 97, repeat)
    if path == "residual":  # residuals are stored in the JAX layout
        xs = [to_jax(x, k).contiguous() for x, k in zip(xs, kinds)]
        kinds = ["vector"] * len(xs)
    paths = _paths(path, n)
    like = [torch.empty(0, dtype=torch.bfloat16)] * len(xs)
    outs = [torch.empty(x.shape, dtype=torch.bfloat16) for x in xs]
    got = tprec.tree_store_round(words, xs, like, kinds, outs=outs,
                                 paths=paths)
    assert all(g is o for g, o in zip(got, outs))
    for x, kind, p, g in zip(xs, kinds, paths, got):
        one = tprec.store_round(prng.fold_path(words, p), x, torch.bfloat16,
                                kind)
        assert torch.equal(g.view(torch.int16), one.view(torch.int16)), p
        want = np.asarray(jprec.stochastic_round(
            _jax_fold(words, p), jnp.array(to_jax(x, kind).numpy())),
            np.float32)
        mine = to_jax(g, kind).float().numpy()
        nan = np.isnan(want)
        assert np.array_equal(nan, np.isnan(mine)), p
        assert np.array_equal(mine[~nan].view(np.uint32),
                              want[~nan].view(np.uint32)), p


def test_grouped_store_reads_a_key_table_key():
    """Under a window the parent key is a key-table key; the leaves' keys
    fold from it as from the host words."""
    xs, kinds = _inputs("LeNet", 3)
    paths = _paths("sgd", len(xs))
    table = KeyTable(prng.key(11), "cpu", 4)
    tkey = table.step_key(6)
    hkey = prng.step_key(prng.key(11), 6)
    a = tprec.round_set(tkey, xs, paths, kinds)
    b = tprec.round_set(hkey, xs, paths, kinds)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))


def test_tree_store_round_keeps_f32_and_unkeyed_leaves_apart():
    xs, kinds = _inputs("LeNet", 5)
    like = [torch.empty(0, dtype=torch.float32 if i % 2 else torch.bfloat16)
            for i in range(len(xs))]
    got = tprec.tree_store_round((0, 9), xs, like, kinds)
    for i, (x, g) in enumerate(zip(xs, got)):
        want = tprec.store_round(None if i % 2 else prng.layer_key((0, 9), i),
                                 x, like[i].dtype, kinds[i])
        bits = torch.int32 if i % 2 else torch.int16
        assert g.dtype == like[i].dtype
        assert torch.equal(g.view(bits), want.view(bits))
    nearest = tprec.tree_store_round(None, xs, like, kinds)
    assert torch.equal(nearest[0].view(torch.int16),
                       xs[0].to(torch.bfloat16).view(torch.int16))


@pytest.mark.parametrize("mode", ["auto", "on", "interpret", "off"])
def test_draws_launch_nothing_on_the_cpu(mode):
    kernels.reset_launches()
    kernels.configure(mode)
    try:
        k = prng.key(3)
        table = KeyTable(prng.key(3), "cpu", 0)
        for key in (k, table.step_key(0)):
            bits = prng.random_bits(key, 4099, "cpu")
            assert torch.equal(bits, kernels.random_bits_ref(key, 4099,
                                                             "cpu"))
            u = prng.uniform(key, (7, 3))
            assert torch.equal(u.reshape(-1), kernels.random_bits_ref(
                key, 21, "cpu", uniform=True))
            prng.permutation(key, 500)
            prng.randint(key, (128,), 0, 9)
            prng.bernoulli(key, 0.5, (128,))
        if mode != "on":  # 'on' refuses the CPU store, as every wrapper
            xs, kinds = _inputs("LeNet", 1)
            like = [torch.empty(0, dtype=torch.bfloat16)] * len(xs)
            tprec.tree_store_round(k, xs, like, kinds)
    finally:
        kernels.configure("auto")
    assert kernels.LAUNCHES["random_bits"] == 0
    assert kernels.LAUNCHES["stochastic_round"] == 0


def test_the_cpu_wrappers_are_the_plain_versions():
    xs, kinds = _inputs("LeNet", 8)
    paths = _paths("adam", len(xs) // 2)[:len(xs)]
    a = kernels.stochastic_round_set((1, 2), xs, paths, kinds)
    b = kernels.stochastic_round_set_ref((1, 2), xs, paths, kinds)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))
    assert torch.equal(kernels.random_bits((5, 6), 33, "cpu", uniform=True),
                       prng.uniform((5, 6), (33,), "cpu"))
    x = from_jax(torch.randn(3, 3, 4, 8), "conv").contiguous()
    assert torch.equal(
        kernels.stochastic_round_bf16(x, (1, 2), "conv").view(torch.int16),
        kernels.stochastic_round_ref(x, (1, 2), "conv").view(torch.int16))
