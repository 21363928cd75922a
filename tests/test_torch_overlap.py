"""``--overlap bucket`` (``parallel/overlap.py``) against the JAX package's.

- The planner (``plan_buckets``) and the predictor
  (``predict_overlap_frac``) on random trees: equal (pure host
  arithmetic).
- ``bucketed_exchange``: the same per-worker gradients (numpy, from a seed)
  through ``ewdml_tpu.parallel.overlap.bucketed_exchange`` inside
  ``shard_map`` over 4 CPU devices and through the port's over a
  ``LocalWorld`` of 4, with the same key words, under ``--pallas auto``
  (threefry for the compressors, the rings' XLA twins and plain versions):
  dense f32 and bf16-wire means bit-equal up to f32 rounding (2e-6 of the
  leaf's scale), the ``fused_q`` ring per bucket and the compressed gather
  (fused buckets, the relay, K-of-N, error feedback's ``return_own``) with
  the bounded-flip oracles of ``test_torch_collectives.py`` and
  ``test_torch_slice_ring.py``.
- The wire plan under overlap: byte-equal, its per-bucket bytes summing to
  ``per_step_bytes``.
- The step: the JAX Trainer and the port's on LeNet / ``mnist10k``, W = 4
  (``test_torch_slice.py``'s harness), in ``test_torch_slice.py`` and
  ``test_torch_slice_qsgd.py``.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ewdml_tpu.ops import make_compressor as jmake
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu.parallel import overlap as jovl
from ewdml_tpu_torch.core.world import LocalWorld
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.ops import make_compressor as tmake
from ewdml_tpu_torch.parallel import overlap as tovl
from ewdml_tpu_torch.utils import prng
from test_torch_collectives import _close_with_flips
from test_torch_precision import _plans
from test_torch_slice_ring import _close_with_ring_flips

torch.set_num_threads(2)
W = 4
SHAPES = [(20,), (5, 5, 3, 8), (3000,), (70, 90), (9000,), (4, 4, 8, 16)]


@pytest.fixture(autouse=True)
def _restore_modes():
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


@pytest.mark.parametrize("seed", range(8))
def test_plan_buckets_is_the_jax_one(seed):
    rnd = random.Random(seed)
    for _ in range(25):
        n = rnd.randint(1, 60)
        sizes = [4 * rnd.choice([1, rnd.randint(1, 10**6)]) for _ in range(n)]
        nb = rnd.choice([0, 0, 1, 2, 3, 4, 9])
        j, t = jovl.plan_buckets(sizes, nb), tovl.plan_buckets(sizes, nb)
        assert (t.buckets, t.bucket_bytes) == (j.buckets, j.bucket_bytes)
        assert t.leaf_to_bucket() == j.leaf_to_bucket()
        wire = [rnd.random() * b for b in t.bucket_bytes]
        for frac in (None, 0.0, 0.3, 0.9, 1.5):
            assert tovl.predict_overlap_frac(wire, t.bucket_bytes, frac) == \
                jovl.predict_overlap_frac(wire, j.bucket_bytes, frac)
    with pytest.raises(ValueError):
        tovl.plan_buckets([])


def test_bucket_keys_are_the_jax_ones():
    skey = jax.random.fold_in(jax.random.key(3), 9)
    base = jax.random.fold_in(jax.random.fold_in(skey, jovl.OVERLAP_TAG),
                              jovl.OVERLAP_TAG)
    for b in range(5):
        want = tuple(int(v) for v in jax.random.key_data(
            jax.random.fold_in(base, b)))
        words = tuple(int(v) for v in jax.random.key_data(skey))
        assert tovl.bucket_key(words, b) == want


def _grads(seed):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(*s) * rng.choice([0.01, 1.0])).astype(np.float32)
             for s in SHAPES] for _ in range(W)]


def _jax_bucketed(grads, kw, step):
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    stacked = [jnp.asarray(np.stack([g[i] for g in grads]))
               for i in range(len(SHAPES))]
    own = kw.get("return_own", False)

    def body(*leaves):
        skey = jax.random.fold_in(jax.random.key(7), step)
        out = jovl.bucketed_exchange([l[0] for l in leaves], skey, "data",
                                     step=step, **kw)
        if own:
            avg, mine = out
            return tuple(a[None] for a in avg), tuple(o[None] for o in mine)
        return tuple(a[None] for a in out)

    specs = tuple(P("data") for _ in stacked)
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs,
                              out_specs=(specs, specs) if own else specs,
                              check_vma=False))
    out = f(*stacked)
    if own:
        return [np.asarray(a) for a in out[0]], [np.asarray(o) for o in out[1]]
    return [np.asarray(a) for a in out], None


def _port_bucketed(grads, kw, step):
    skey = prng.step_key(prng.key(7), step)
    out = tovl.bucketed_exchange(
        LocalWorld(W, "cpu"), [[torch.from_numpy(x) for x in g] for g in grads],
        skey, step=step, **kw)
    return out if kw.get("return_own") else (out, None)


CASES = {
    "dense": ({}, {}),
    "dense_bf16": (dict(wire_dtype=jnp.bfloat16),
                   dict(wire_dtype=torch.bfloat16)),
    "fused_q": (dict(fused_q=True), dict(fused_q=True)),
    "qsgd_relay_own": (dict(compressor="qsgd", relay=True, return_own=True),
                       None),
    "qsgd_fused_kofn": (dict(compressor="qsgd", fuse=True, num_aggregate=3,
                             return_own=True), None),
    "topk_qsgd_fused_relay": (dict(compressor=("topk_qsgd",
                                               dict(topk_ratio=0.05)),
                                   fuse=True, relay=True), None),
}


@pytest.mark.parametrize("n_buckets", [0, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_bucketed_exchange_is_the_jax_one(case, n_buckets):
    jkw, tkw = CASES[case]
    jkw, tkw = dict(jkw), dict(tkw if tkw is not None else jkw)
    comp = jkw.get("compressor")
    if comp is not None:
        name, ckw = comp if isinstance(comp, tuple) else (comp, {})
        jkw["compressor"], tkw["compressor"] = (jmake(name, **ckw),
                                                tmake(name, **ckw))
    grads = _grads(len(case) + n_buckets)
    step = 6
    javg, jown = _jax_bucketed(grads, dict(jkw, n_buckets=n_buckets), step)
    tavg, town = _port_bucketed(grads, dict(tkw, n_buckets=n_buckets), step)
    for i, shape in enumerate(SHAPES):
        assert tuple(tavg[i].shape) == shape
        gs = [g[i] for g in grads]
        scale = max(np.abs(g).max() for g in gs)
        if comp is None and not jkw.get("fused_q"):
            np.testing.assert_allclose(tavg[i].numpy(), javg[i][0], rtol=0,
                                       atol=2e-6 * scale)
        elif comp is None:
            _close_with_ring_flips(tavg[i].numpy(), javg[i][0], gs)
        else:
            _close_with_flips(tavg[i].numpy(), javg[i][0], scale)
            if jown is not None:
                for w in range(W):
                    _close_with_flips(town[w][i].numpy(), jown[i][w], scale)


def test_bucketed_exchange_own_needs_a_compressor():
    with pytest.raises(ValueError, match="compressor"):
        tovl.bucketed_exchange(LocalWorld(2, "cpu"), [[torch.zeros(3)]] * 2,
                               (0, 1), return_own=True)


@pytest.mark.parametrize("net", ["LeNet", "VGG11"])
@pytest.mark.parametrize("kw", [
    dict(method=1), dict(method=1, overlap_buckets=4),
    dict(method=1, precision_policy="bf16_wire"),
    dict(method=3, collective="fused_q"),
    dict(method=3, collective="fused_q", overlap_buckets=4),
    dict(method=4, error_feedback=True), dict(method=4, overlap_buckets=4),
    dict(method=5, overlap_buckets=3), dict(method=2, overlap_buckets=2),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_wire_plan_under_overlap_is_the_jax_one(net, kw, monkeypatch):
    from ewdml_tpu.obs import registry as oreg

    # The JAX plan falls back to the process-global gauge adapt.comm_frac
    # when passed None, and another JAX test in this process may have set
    # it: hold it unset so the None case compares the two packages.
    monkeypatch.setattr(oreg.gauge("adapt.comm_frac"), "value", None)
    j, t = _plans(dict(kw, overlap="bucket"), net)
    for f in ("per_layer_up", "per_layer_down", "per_step_bytes",
              "per_step_bytes_total", "wire_dtype", "transport", "overlap",
              "per_bucket_up", "per_bucket_down", "per_bucket_grad_bytes",
              "per_bucket_bytes", "per_rank_exchange_bytes"):
        assert getattr(t, f) == getattr(j, f), f
    assert sum(t.per_bucket_bytes.values()) == t.per_step_bytes
    for frac in (None, 0.2, 0.6):
        assert t.predicted_overlap_frac(frac) == j.predicted_overlap_frac(frac)
    assert t.overlap == "bucket"


def test_overlap_validation_is_the_jax_one():
    from ewdml_tpu.core.config import TrainConfig as JConfig
    from ewdml_tpu.core.config import validate_overlap as jval
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.core.config import validate_overlap as tval

    grid = [dict(overlap="bucket"), dict(overlap="sideways"),
            dict(overlap="bucket", overlap_buckets=-1),
            dict(overlap="bucket", mode="async"),
            dict(overlap="bucket", num_slices=2),
            dict(overlap="bucket", adapt="variance"),
            dict(overlap="bucket", method=4, gather_type="ring"),
            dict(overlap="bucket", method=4, gather_type="ring_rs"),
            dict(overlap="bucket", method=3, gather_type="ring"),
            dict(overlap="off", mode="async")]
    for kw in grid:
        outcomes = []
        for cfg_cls, val in ((JConfig, jval), (TrainConfig, tval)):
            try:
                val(cfg_cls(**kw))
                outcomes.append(None)
            except ValueError as e:
                outcomes.append(str(e).split()[0:3])
        assert (outcomes[0] is None) == (outcomes[1] is None), kw


@pytest.mark.parametrize("net", ["VGG11", "ResNet18", "ResNet50"])
def test_buckets_complete_in_plan_order(net):
    """exact: on the networks the card runs under ``--overlap bucket``,
    the backward completes the planner's buckets in the plan's order at
    the auto count and at 2 to 4 buckets (the auto count's range), so that
    issuing them in plan order (``StreamSchedule``, which every process of
    a cluster must do) holds back no bucket whose leaves are all produced.
    (At an explicit 6 or 8 buckets VGG11 and ResNet18 complete one bucket
    early, which then waits for the one before it.)"""
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs
    from ewdml_tpu_torch.ops.bytes import numel
    from ewdml_tpu_torch.train.state import leaf_params

    torch.manual_seed(0)
    model = build_model(net, dataset="mnist10k32", seed=0)
    specs = leaf_specs(model)
    order = []
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, i=i: order.append(i))
        for i, p in enumerate(leaf_params(model, specs))]
    x = torch.randn(2, 32, 32, 1)
    logits = model(x, train=True, generator=torch.Generator().manual_seed(0))
    torch.nn.functional.cross_entropy(logits, torch.tensor([1, 7])).backward()
    for h in hooks:
        h.remove()
    assert sorted(order) == list(range(len(specs)))
    at = {i: k for k, i in enumerate(order)}
    for n in (0, 2, 3, 4):
        plan = tovl.plan_buckets([4 * numel(s.jax_shape) for s in specs], n)
        done = [max(at[i] for i in idxs) for idxs in plan.buckets]
        assert done == sorted(done), (net, n, done)
