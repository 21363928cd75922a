"""The ring transports of the port against the JAX package's.

Collective level: the same per-worker gradients (numpy, from a seed; every
rank's chunks differ, so a wrong hop or chunk index shows) go through
``ewdml_tpu.parallel.collectives`` inside ``shard_map`` over 4 CPU devices
and through the port's collectives over a ``LocalWorld`` of 4, with the
same key words, under ``--pallas auto`` (on the CPU: the XLA twins of the
ring kernels on the JAX side, their plain versions in the port, threefry
for the compressors). Covered: ``fused_q_allreduce_mean``;
``_ring_rs_exchange`` on the fused branch (QSGD, blocks of 4096, with and
without the relay) and on the generic one (M5's top-k → QSGD, per-tensor
QSGD); the ``ppermute`` ring with the relay and with K-of-N.

Step level (here and in ``test_torch_slice_ring_*.py``): LeNet at full
width on the committed ``mnist10k``, W = 4, 3 steps from the JAX Trainer's
converted initial state, both packages under ``--pallas auto``; the
harness and the bounded-flip oracle are ``test_torch_slice.py``'s.

Oracles:
- collectives: tolerance plus bounded flips. Where an input of a
  stochastic rounding differs by an ulp (a norm summed in another order, an
  FMA in XLA's twin) a level can flip by one; a flip inside a ring moves
  the element by one quantization step of its block, and a later hop's
  norm moves with it. Per leaf: all but 1% of the elements within 2e-6 of
  the leaf's scale, and every element within 2 quantization steps of the
  largest possible block norm (the norm of sum_w |g_w|) per ring phase.
- steps: the oracle of ``test_torch_slice.py`` (bounded flips on the
  parameters), the wire plan's rows and ``per_rank_exchange_bytes`` equal
  to the JAX plan's, and the transport's counted ring bytes.
- validation: the same configurations raise in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ewdml_tpu.core.config import TrainConfig as JConfig
from ewdml_tpu.ops import make_compressor as jmake
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu.parallel import collectives as jcoll
from ewdml_tpu.train.loop import Trainer as JTrainer
from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.core.world import LocalWorld
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.ops import make_compressor as tmake
from ewdml_tpu_torch.parallel import collectives as tcoll
from ewdml_tpu_torch.train.loop import Trainer
from ewdml_tpu_torch.utils import prng
from test_torch_slice import BASE, check_with_flips, run_pair

torch.set_num_threads(2)
W = 4
SHAPES = [(20,), (5, 5, 3, 8), (3000,), (70, 90), (9000,)]


@pytest.fixture(autouse=True)
def _restore_modes():
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


def _grads(seed):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(*s) * rng.choice([0.01, 1.0])).astype(np.float32)
             for s in SHAPES] for _ in range(W)]


def _jax_exchange(grads, comp, step, kw):
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    stacked = [jnp.asarray(np.stack([g[i] for g in grads]))
               for i in range(len(SHAPES))]

    def body(*leaves):
        skey = jax.random.fold_in(jax.random.key(7), step)
        leaves = [l[0] for l in leaves]
        if comp is None:
            avg = jcoll.fused_q_allreduce_mean(leaves, skey, "data")
        else:
            avg = jcoll.compressed_allreduce(
                leaves, comp, skey, axis_name="data",
                relay_key=jax.random.fold_in(skey, 0x5EED), step=step, **kw)
        return tuple(a[None] for a in avg)

    specs = tuple(P("data") for _ in stacked)
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs,
                              out_specs=specs, check_vma=False))
    return [np.asarray(a) for a in f(*stacked)]


def _port_exchange(grads, comp, step, kw):
    world = LocalWorld(W, "cpu")
    tg = [[torch.from_numpy(x) for x in g] for g in grads]
    skey = prng.step_key(prng.key(7), step)
    if comp is None:
        return tcoll.fused_q_allreduce_mean(world, tg, skey), world
    return tcoll.compressed_allreduce(
        world, tg, comp, skey, relay_key=prng.fold_in(skey, 0x5EED),
        step=step, **kw), world


def _close_with_ring_flips(t, j, gs, s=127):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    tol = 2e-6 * max(np.abs(j).max(), 1e-30)
    diff = np.abs(t - j)
    top_norm = np.linalg.norm(sum(np.abs(g.astype(np.float64)) for g in gs))
    assert diff.max() <= 2 * 2 * top_norm / s + tol
    assert (diff > tol).sum() <= 0.01 * diff.size + 1


RING_CASES = [
    ("fused_q", None, {}, {}),
    ("ring_rs", "qsgd", dict(qsgd_block=4096), dict(relay=True)),
    ("ring_rs", "qsgd", dict(qsgd_block=4096), dict(relay=False)),
    ("ring_rs", "qsgd", {}, dict(relay=True)),
    ("ring_rs", "topk_qsgd", dict(topk_ratio=0.05), dict(relay=True)),
    ("ppermute", "qsgd", dict(qsgd_block=4096), dict(relay=True)),
    ("ppermute", "topk_qsgd", dict(topk_ratio=0.05),
     dict(relay=False, num_aggregate=3)),
]


@pytest.mark.parametrize("transport,name,ckw,kw", RING_CASES)
def test_ring_transports_match(transport, name, ckw, kw):
    grads = _grads(len(str(kw)) + len(transport) + len(ckw))
    step = 5
    if transport != "fused_q":
        kw = dict(kw, transport=transport)
    javg = _jax_exchange(grads, name and jmake(name, **ckw), step, kw)
    tavg, world = _port_exchange(grads, name and tmake(name, **ckw), step, kw)
    for i, shape in enumerate(SHAPES):
        assert tuple(tavg[i].shape) == shape
        # every rank of the JAX ring holds the same average
        assert all(np.array_equal(javg[i][0], javg[i][w]) for w in range(W))
        _close_with_ring_flips(tavg[i].numpy(), javg[i][0],
                               [g[i] for g in grads])
    assert world.ppermute_bytes > 0


def test_fused_q_ring_bytes_are_the_plan():
    from ewdml_tpu_torch.train.metrics import ring_hop_bytes

    grads = _grads(1)
    _, world = _port_exchange(grads, None, 0, {})
    n = sum(int(np.prod(s)) for s in SHAPES)
    assert world.ppermute_bytes == 2 * ring_hop_bytes(n, W)


def test_fused_q_at_one_worker_is_the_identity():
    g = [[torch.randn(10)]]
    assert tcoll.fused_q_allreduce_mean(LocalWorld(1, "cpu"), g, (0, 1)) is g[0]


@pytest.mark.parametrize("transport", ["fused_q", "ring_rs"])
def test_ring_chunk_indices(transport):
    """Rank r's gradient is 4^r * (c + 1) on ring chunk c: every (rank,
    chunk) pair has its own value, so each chunk's mean shows whether the
    ring summed the right chunks from every rank. Oracle: statistics, the
    mean of each 4096-element chunk within 2% (the quantization is
    unbiased; a wrong chunk or a missed rank moves a mean by over 20%)."""
    grads = [[np.repeat(np.float32(4 ** r) * np.arange(1, W + 1,
                                                       dtype=np.float32), 4096)]
             for r in range(W)]
    comp = None if transport == "fused_q" else tmake("qsgd", qsgd_block=4096)
    kw = {} if comp is None else dict(transport="ring_rs", relay=False)
    avg, _ = _port_exchange(grads, comp, 0, kw)
    want = np.mean([g[0] for g in grads], axis=0).reshape(W, 4096).mean(1)
    np.testing.assert_allclose(avg[0].numpy().reshape(W, 4096).mean(1), want,
                               rtol=0.02)


# -- validation: the same configurations raise in both packages ---------------

@pytest.mark.parametrize("kw,match", [
    (dict(method=3, collective="fused_q", num_aggregate=2), "fused_q"),
    (dict(method=4, gather_type="ring_rs", error_feedback=True), "ring_rs"),
    (dict(method=4, gather_type="ring_rs", num_aggregate=3), "ring_rs"),
])
def test_ring_validation_matrix(tmp_path, kw, match):
    cfg = dict(BASE, pallas="auto", **kw)
    with pytest.raises(ValueError, match=match):
        JTrainer(JConfig(train_dir=str(tmp_path) + "/", **cfg))
    with pytest.raises(ValueError, match=match):
        Trainer(TrainConfig(platform="cpu", **cfg))


@pytest.mark.parametrize("kw", [
    dict(collective="fused_q", compress_grad="qsgd"),
    dict(collective="fused_q", method=3, precision_policy="bf16_wire"),
    dict(collective="allreduce"),
])
def test_collective_validation_matches(kw):
    from ewdml_tpu.core.config import validate_collective as jvalidate
    from ewdml_tpu_torch.core.config import validate_collective

    with pytest.raises(ValueError) as je:
        jvalidate(JConfig(**kw))
    with pytest.raises(ValueError) as te:
        validate_collective(TrainConfig(**kw))
    assert str(te.value) == str(je.value)


# -- the step: M1 and M3 over the fused_q ring ---------------------------------

@pytest.fixture
def ring_calls(monkeypatch):
    """Counts of the port's plain ring-kernel versions reached by the step."""
    calls = {"chunk_encode": 0, "dequant_acc_requant": 0}

    def spy(name):
        fn = getattr(kernels, name + "_ref")

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(kernels, name + "_ref", wrapped)

    for name in calls:
        spy(name)
    return calls


def check_ring_wire(pair):
    jt, tt = pair.jt, pair.tt
    assert tt.wire.transport == jt.wire.transport
    assert tt.wire.per_layer_up == jt.wire.per_layer_up
    assert tt.wire.per_layer_down == jt.wire.per_layer_down
    assert tt.wire.per_step_bytes == jt.wire.per_step_bytes
    assert tt.wire.per_rank_exchange_bytes == jt.wire.per_rank_exchange_bytes
    assert tt.wire.dense_bytes == jt.wire.dense_bytes


@pytest.mark.parametrize("method", [1, 3])
def test_fused_q_methods_match(tmp_path, ring_calls, method):
    pair = run_pair(tmp_path, method=method, collective="fused_q",
                    pallas="auto")
    check_ring_wire(pair)
    assert pair.tt.wire.transport == "fused_q"
    # The two ring phases ship exactly the planned hop bytes every step.
    assert pair.tt.world.ppermute_bytes == \
        3 * pair.tt.wire.per_rank_exchange_bytes
    # Per step one encode per rank and W - 1 hops per rank.
    assert ring_calls == {"chunk_encode": 3 * W,
                          "dequant_acc_requant": 3 * W * (W - 1)}
    check_with_flips(pair)
    assert abs(pair.tres.final_loss - pair.jres.final_loss) <= \
        1e-3 * abs(pair.jres.final_loss)
