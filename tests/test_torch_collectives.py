"""The port's all-gather collective against the JAX package's, leaf by leaf.

The same per-worker gradients (numpy, from a seed) go through
``ewdml_tpu.parallel.collectives.compressed_allreduce`` inside
``shard_map`` over 4 CPU devices and through the port's
``compressed_allreduce`` over a ``LocalWorld`` of 4, with the same key
words. Covered: per-layer QSGD (the ``dequant_mean`` call site) with the
relay and with K-of-N acceptance, the sparse top-k mean and relay, the
block-top-k mean and relay, and both fusions (one bucket, 8 MB-style
threshold buckets), under ``off`` (threefry); three of them under
``interpret`` (murmur) in ``test_torch_collectives_interpret.py``.

Oracle: tolerance plus bounded flips, per leaf: the averages agree within
2e-6 of the leaf's largest value except at elements where a stochastic
level flipped (a norm one ulp apart), and those are at most 1% of the
elements and at most one quantization step of the relayed or pushed norm
(bounded here by 4 * max|g| / s). The error-feedback "own" payloads are
compared the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ewdml_tpu.ops import make_compressor as jmake
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu.parallel import collectives as jcoll
from ewdml_tpu_torch.core.world import LocalWorld
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.ops import make_compressor as tmake
from ewdml_tpu_torch.parallel import collectives as tcoll
from ewdml_tpu_torch.utils import prng

torch.set_num_threads(2)
W = 4
SHAPES = [(20,), (5, 5, 3, 8), (3000,), (70, 90)]


@pytest.fixture(autouse=True)
def _restore_modes():
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


def _grads(seed, shapes):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(*s) * rng.choice([0.01, 1.0])).astype(np.float32)
             for s in shapes] for _ in range(W)]


def _jax_allreduce(grads, comp, step, kw):
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    stacked = [jnp.asarray(np.stack([g[i] for g in grads]))
               for i in range(len(grads[0]))]

    def body(*leaves):
        skey = jax.random.fold_in(jax.random.key(7), step)
        out = jcoll.compressed_allreduce(
            [l[0] for l in leaves], comp, skey, axis_name="data",
            relay_key=jax.random.fold_in(skey, 0x5EED), step=step,
            return_own_decompressed=True, **kw)
        avg, own = out
        return tuple(a[None] for a in avg), tuple(o[None] for o in own)

    specs = tuple(P("data") for _ in stacked)
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs,
                              out_specs=(specs, specs), check_vma=False))
    avg, own = f(*stacked)
    return ([np.asarray(a) for a in avg], [np.asarray(o) for o in own])


def _port_allreduce(grads, comp, step, kw):
    skey = prng.step_key(prng.key(7), step)
    avg, own = tcoll.compressed_allreduce(
        LocalWorld(W, "cpu"), [[torch.from_numpy(x) for x in g] for g in grads],
        comp, skey, relay_key=prng.fold_in(skey, 0x5EED), step=step,
        return_own_decompressed=True, **kw)
    return avg, own


def _close_with_flips(t, j, scale, s=127):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    tol = 2e-6 * max(np.abs(j).max(), 1e-30)
    diff = np.abs(t - j)
    assert diff.max() <= 4 * scale / s + tol
    assert (diff > tol).sum() <= 0.01 * diff.size + 1


CASES = [
    ("qsgd", {}, dict(relay=True)),
    ("qsgd", {}, dict(relay=False, num_aggregate=2)),
    ("qsgd", dict(qsgd_block=4096), dict(relay=True, num_aggregate=3)),
    ("topk_qsgd", dict(topk_ratio=0.05), dict(relay=True)),
    ("topk_qsgd", dict(topk_ratio=0.05), dict(relay=False, num_aggregate=2)),
    ("topk_qsgd", dict(topk_ratio=0.05, topk_exact="block"), dict(relay=True)),
    ("topk_qsgd", dict(topk_ratio=0.05, topk_exact="block"),
     dict(relay=False, num_aggregate=3)),
    ("qsgd", {}, dict(relay=True, fuse=True)),
    ("topk_qsgd", dict(topk_ratio=0.05), dict(relay=True, bucket_bytes=16384)),
]


def check_allreduce(mode, name, ckw, kw):
    pk.configure(mode)
    kernels.configure(mode)
    grads = _grads(len(str(kw)) + len(name), SHAPES)
    step = 5
    javg, jown = _jax_allreduce(grads, jmake(name, **ckw), step, kw)
    tavg, town = _port_allreduce(grads, tmake(name, **ckw), step, kw)
    for i, shape in enumerate(SHAPES):
        scale = max(np.abs(g[i]).max() for g in grads)
        assert tuple(tavg[i].shape) == shape
        # every rank of the JAX collective holds the same average
        assert all(np.array_equal(javg[i][0], javg[i][w]) for w in range(W))
        _close_with_flips(tavg[i].numpy(), javg[i][0], scale)
        for w in range(W):
            _close_with_flips(town[w][i].numpy(), jown[i][w], scale)


@pytest.mark.parametrize("name,ckw,kw", CASES)
def test_compressed_allreduce_matches(name, ckw, kw):
    check_allreduce("off", name, ckw, kw)


def test_dense_allreduce_mean_matches():
    grads = _grads(3, SHAPES)
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    stacked = [jnp.asarray(np.stack([g[i] for g in grads]))
               for i in range(len(SHAPES))]
    specs = tuple(P("data") for _ in stacked)
    f = jax.jit(jax.shard_map(
        lambda *ls: tuple(a[None] for a in jcoll.dense_allreduce_mean(
            [l[0] for l in ls], "data")),
        mesh=mesh, in_specs=specs, out_specs=specs, check_vma=False))
    javg = f(*stacked)
    tavg = tcoll.dense_allreduce_mean(
        LocalWorld(W, "cpu"), [[torch.from_numpy(x) for x in g] for g in grads])
    for i in range(len(SHAPES)):
        np.testing.assert_allclose(tavg[i].numpy(), np.asarray(javg[i])[0],
                                   rtol=1e-6, atol=1e-7)


def test_adopt_best_worker_takes_the_first_lowest_loss():
    # The selection stays on the device: new tensors holding worker 1's
    # values (the first of the two lowest losses), never worker 2's.
    params = [[torch.full((3,), float(w)), torch.full((2, 2), 10.0 + w)]
              for w in range(W)]
    best = tcoll.adopt_best_worker(params, torch.tensor([0.5, 0.2, 0.2, 0.9]))
    assert len(best) == 2
    assert torch.equal(best[0], params[1][0])
    assert torch.equal(best[1], params[1][1])


def test_take_payloads_takes_rows_in_order_without_an_index_tensor(
        monkeypatch):
    # K-of-N keeps origins (step + j) % W in that order; the rows are taken
    # with Python ints, so no index tensor is copied from the host (which a
    # CUDA graph could not hold).
    from ewdml_tpu_torch.ops.bytes import take_payloads
    from ewdml_tpu_torch.ops.qsgd import QSGDPayload

    levels = torch.arange(W * 6, dtype=torch.int8).reshape(W, 6)
    norms = torch.arange(W, dtype=torch.float32) + 0.5
    gathered = QSGDPayload(levels=levels, norm=norms, shape=(6,), s=127)

    def no_tensor(*a, **k):
        raise AssertionError("take_payloads built a tensor from the host")

    monkeypatch.setattr(torch, "tensor", no_tensor)
    got = take_payloads(gathered, [3, 0])
    assert torch.equal(got.levels, levels[[3, 0]])
    assert torch.equal(got.norm, norms[[3, 0]])
    assert (got.shape, got.s) == ((6,), 127)
