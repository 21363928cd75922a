"""The whole slice: the port's trainer against the JAX package's Trainer.

LeNet at full width on the committed real ``mnist10k`` split, W = 4
workers, the same batches, the initial state converted from the JAX
Trainer's; 3 steps per method, both packages under ``--pallas interpret``
(the kernels' murmur stream everywhere). This file holds the harness and
the dense methods M1/M3; ``test_torch_slice_*.py`` hold the compressed ones
(in separate files, so that the test workers run them in parallel).

On the JAX side the three Pallas kernels run as vectorized jnp twins of
their bodies instead of the element-by-element interpreter (which takes
minutes on LeNet's 400k-element fc1); the twins are held bit-equal to
``interpret=True`` below (quantize, block_top1) or within the dequant_mean
bound of ``test_torch_kernels.py``.

Oracles:
- ``wire_per_step`` and the per-layer wire rows: exact.
- dense methods: tolerance, |dp| <= 1e-5 * max|p| per leaf (gradients agree
  to f32 rounding; XLA contracts the SGD update into FMAs, PyTorch does
  not).
- compressed methods: tolerance plus bounded flips. A stochastic level (or
  a block/top-k winner) can flip where an input differs by an ulp, and a
  flip moves one element by one quantization step, which can be as large
  as the leaf's largest update (and under the M4 relay it rescales the
  whole leaf's relayed norm). Per worker and leaf, with d the difference
  of the final params and m the reference's own move from the initial
  params: ||d||_2 <= 2e-2 ||m||_2 and max|d| <= max|m|, each plus the dense
  tolerance. (Measured: ||d||/||m|| <= 7.5e-3 under M4, <= 2e-6 under
  M5/M5+EF/M6, where no winner or level flipped.)
- the port's plain twins of the three kernels were reached (kernel stream).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.core.config import TrainConfig as JConfig
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu.train.loop import Trainer as JTrainer
from ewdml_tpu.train.state import worker_slice
from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.data import datasets
from ewdml_tpu_torch.models.convert import torch_to_flax
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

STEPS = 3
W = 4
BASE = dict(network="LeNet", dataset="mnist10k", batch_size=8, lr=0.01,
            max_steps=STEPS, epochs=100, eval_freq=0, log_every=1000,
            bf16_compute=False, num_workers=W, pallas="interpret", seed=42)


@pytest.fixture(autouse=True)
def _restore_modes():
    # The trainers under test set the process-wide kernel modes.
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


# -- vectorized twins of the Pallas kernel bodies (JAX side) -------------------

def quantize_twin(x, norm, seed, s, *, block=None, interpret=False):
    del interpret
    flat = x.astype(jnp.float32).ravel()
    n = flat.size
    u = pk._uniform_hash(jnp.asarray(seed, jnp.int32), jnp.uint32(0),
                         (1, n)).reshape(-1)
    norms = jnp.asarray(norm, jnp.float32).reshape(-1)
    nel = norms[0] if block is None else norms[jnp.arange(n) // block]
    safe = jnp.where(nel == 0.0, 1.0, nel)
    level_float = (s / safe) * jnp.abs(flat)
    previous = jnp.floor(level_float)
    level = previous + (u < (level_float - previous)).astype(jnp.float32)
    return (jnp.sign(flat) * level).astype(jnp.int8)


def dequant_twin(levels, norms, s, *, block=None, interpret=False):
    del interpret
    world, n = levels.shape
    nm = jnp.asarray(norms, jnp.float32).reshape(world, -1)
    idx = jnp.zeros((n,), jnp.int32) if block is None else jnp.arange(n) // block
    acc = jnp.zeros((n,), jnp.float32)
    for w in range(world):
        acc = acc + nm[w][idx] * levels[w].astype(jnp.float32)
    return acc * (1.0 / (s * world))


def block_top1_twin(x2, *, interpret=False, lane_chunk=None):
    del interpret, lane_chunk
    a = jnp.abs(x2)
    mx = jnp.max(a, axis=0)
    rows = jax.lax.broadcasted_iota(jnp.int32, a.shape, 0)
    loc = jnp.min(jnp.where(a == mx[None, :], rows, a.shape[0]), axis=0)
    vals = jnp.sum(jnp.where(rows == loc[None, :], x2, 0.0), axis=0)
    return vals, loc


@pytest.fixture
def jax_twins(monkeypatch):
    monkeypatch.setattr(pk, "qsgd_quantize", quantize_twin)
    monkeypatch.setattr(pk, "dequant_mean", dequant_twin)
    monkeypatch.setattr(pk, "block_top1", block_top1_twin)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the port's plain kernel versions reached by the step."""
    calls = {"qsgd_quantize": 0, "dequant_mean": 0, "block_top1": 0}

    def spy(name):
        fn = getattr(kernels, name + "_ref")

        @functools.wraps(fn)
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(kernels, name + "_ref", wrapped)

    for name in calls:
        spy(name)
    return calls


@dataclasses.dataclass
class Pair:
    jt: object       # the JAX Trainer
    tt: object       # the port's Trainer
    jres: object
    tres: object
    jparams: list    # per worker, Flax layout, numpy
    tparams: list
    init: dict       # the shared initial params


def run_pair(tmp_path, after_preset=None, **kw) -> Pair:
    """Train the JAX Trainer and the port's Trainer from the same initial
    state on the same batches. ``after_preset`` fields are set after the
    method preset has run (a preset overrides the fields it names)."""
    cfg = dict(BASE, **kw)
    jcfg = JConfig(train_dir=str(tmp_path) + "/", **cfg)
    tcfg = TrainConfig(platform="cpu", **cfg)
    for k, v in (after_preset or {}).items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    jt = JTrainer(jcfg)
    w0 = worker_slice(jt.state)
    init = jax.tree.map(np.asarray, w0.params)
    tt = Trainer(tcfg)
    tt.load_flax_state(init, jax.tree.map(np.asarray, w0.batch_stats))
    jres = jt.train()
    tres = tt.train()
    jparams = [jax.tree.map(lambda x, w=w: np.asarray(x[w]), jt.state.worker.params)
               for w in range(tcfg.num_workers)]
    tparams = [torch_to_flax(ws.model)[0] for ws in tt.state.workers]
    return Pair(jt, tt, jres, tres, jparams, tparams, init)


def check_wire(pair: Pair):
    jt, tt = pair.jt, pair.tt
    assert tt.wire.per_layer_up == jt.wire.per_layer_up
    assert tt.wire.per_layer_down == jt.wire.per_layer_down
    assert tt.wire.per_step_bytes == jt.wire.per_step_bytes
    assert tt.wire.per_step_bytes_total == jt.wire.per_step_bytes_total


def _leaves(params):
    return {"/".join(p.key for p in path): np.asarray(v, np.float64)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def check_dense(pair: Pair):
    for w in range(len(pair.jparams)):
        jl, tl = _leaves(pair.jparams[w]), _leaves(pair.tparams[w])
        assert list(jl) == list(tl)
        for name in jl:
            tol = 1e-5 * np.abs(jl[name]).max()
            np.testing.assert_allclose(tl[name], jl[name], rtol=0, atol=tol,
                                       err_msg=f"worker {w} {name}")


def check_with_flips(pair: Pair) -> None:
    """The compressed-method oracle of the module docstring."""
    init_l = _leaves(pair.init)
    for w in range(len(pair.jparams)):
        jl, tl = _leaves(pair.jparams[w]), _leaves(pair.tparams[w])
        assert list(jl) == list(tl)
        for name in jl:
            d = tl[name] - jl[name]
            m = jl[name] - init_l[name]
            tol = 1e-5 * np.abs(jl[name]).max()
            assert np.linalg.norm(d) <= 2e-2 * np.linalg.norm(m) \
                + tol * np.sqrt(d.size), (w, name)
            assert np.abs(d).max() <= np.abs(m).max() + tol, (w, name)


def test_quantize_twin_is_the_pallas_kernel():
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(9000).astype(np.float32))
    for block in (None, 4096):
        if block is None:
            norm = jnp.linalg.norm(x)
        else:
            norm = jnp.linalg.norm(jnp.zeros(3 * 4096).at[:9000].set(x)
                                   .reshape(3, 4096), axis=1)
        a = pk.qsgd_quantize(x, norm, jnp.int32(-9), 127, block=block,
                             interpret=True)
        b = jax.jit(functools.partial(quantize_twin, s=127, block=block))(
            x, norm, jnp.int32(-9))
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_block_top1_twin_is_the_pallas_kernel():
    rng = np.random.RandomState(6)
    x2 = jnp.asarray((np.round(rng.randn(104, 256) * 2) / 2).astype(np.float32))
    va, la = pk.block_top1(x2, interpret=True)
    vb, lb = jax.jit(block_top1_twin)(x2)
    assert np.array_equal(np.asarray(la), np.asarray(lb))
    assert np.array_equal(np.asarray(va).view(np.uint32),
                          np.asarray(vb).view(np.uint32))


def test_mnist10k_is_real():
    assert datasets.load("mnist10k", train=True).source == "real"


@pytest.mark.parametrize("method", [1, 3])
def test_dense_methods_match(tmp_path, method):
    pair = run_pair(tmp_path, method=method)
    check_wire(pair)
    check_dense(pair)
    assert abs(pair.tres.final_loss - pair.jres.final_loss) <= \
        1e-5 * abs(pair.jres.final_loss)


@pytest.mark.parametrize("kw", [
    dict(method=1, precision_policy="bf16_wire"),
    dict(method=1, overlap="bucket", overlap_buckets=3),
], ids=["m1_bf16_wire", "m1_overlap"])
def test_dense_policy_and_overlap_runs_match(tmp_path, kw):
    """2 steps. ``--overlap bucket``: the dense oracle. ``bf16_wire``: the
    bounded-flip oracle, since a gradient element that differs by an f32
    ulp between the packages can cast to the other bf16 neighbour (measured:
    5 of LeNet's 25 000 conv2 elements, each by lr * one bf16 ulp / W)."""
    pair = run_pair(tmp_path, max_steps=2, **kw)
    check_wire(pair)
    if kw.get("precision_policy"):
        check_with_flips(pair)
    else:
        check_dense(pair)
    assert pair.tt.wire.per_bucket_bytes == pair.jt.wire.per_bucket_bytes
    assert abs(pair.tres.final_loss - pair.jres.final_loss) <= \
        1e-5 * abs(pair.jres.final_loss)
