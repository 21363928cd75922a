"""The slice on ResNet: the port's transport units, wire plan, Trainer and
async parameter server against the JAX package's.

- Fusion units and wire plan on ResNet50's 161 leaves (W = 4), under M1-M6,
  M3 ``--collective fused_q`` and M2/M4 ``--gather-type ring_rs
  --qsgd-block 4096``. Oracle: bit (equal sizes, rows and totals).
- Slice parity: a small Bottleneck ResNet (``ResNet(Bottleneck, (1, 1, 1,
  1))``, 53 leaves, so fusion ``auto`` buckets it) on the committed real
  ``mnist10k`` split (28x28x1), W = 2, batch 4, 2 steps, through the port's
  Trainer and the JAX Trainer from the same Flax state on the same
  batches, both under ``--pallas interpret`` (the kernels' murmur stream on
  the int32 seeds both packages share), under M1, M2 and M5 (1%). Oracles:
  the wire plan exact; the loss of the last step (a function of the
  parameters after step 1) within 1e-3; M1 after one step held to
  ``tests/test_torch_slice.py``'s bounded-flips oracle (||d|| <= 2e-2 ||m||
  a leaf; measured 1.1e-2); after two steps, per worker, the whole model's
  ||d|| <= 0.5 ||m|| and every moved leaf's move within 60 degrees of the
  reference's (cosine >= 0.5). Measured after two steps: ||d|| / ||m|| =
  0.076 (M1), 0.21 (M2), 0.28 (M5), the least cosine 0.99, 0.92, 0.63.
  Why not the per-leaf oracles after two steps: this run is chaotic. BatchNorm
  over a few values a channel at batch 4 amplifies tiny differences of
  step 1's parameters into step 2's gradients: in the port alone, a
  relative perturbation of the initial parameters of 1e-7 moves the
  parameters after two M1 steps by 1.6e-2 of their move (median leaf; 2.4e-2
  the largest) and one of 1e-6 by 8.3e-2 (1.4e-1). The JAX reference's float32
  gradients on XLA:CPU differ from float64 ones by up to 2.2e-2 a leaf on
  this network and batch (the port's by 4e-6; ``tests/test_torch_resnet.py``
  holds the two functions equal in float64), which is the size of such a
  perturbation. Under M2 and M5 a per-bucket norm or a top-k winner turns
  such a difference into a flip of a whole quantization step or winner.
- The async parameter server on the small ResNet: ``--server-agg
  homomorphic`` QSGD, W = K = 2, ``--fusion none`` (one payload per leaf,
  the BatchNorm statistics local). Oracle: exact pushes, updates, one
  decode a round, and the bytes up equal to the wire plan's frames.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ewdml_tpu.models as jmodels
import ewdml_tpu_torch.models as tmodels
from ewdml_tpu.core.config import from_args as jfrom_args
from ewdml_tpu.core.config import resolved_unit_sizes as jresolved_unit_sizes
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu.train.metrics import wire_plan as jwire_plan
from ewdml_tpu_torch import native
from ewdml_tpu_torch.cli import run_async
from ewdml_tpu_torch.core.config import from_args, resolved_unit_sizes
from ewdml_tpu_torch.models import build_model
from ewdml_tpu_torch.models.convert import leaf_specs
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.train.metrics import wire_plan
from test_torch_slice import (_leaves, check_wire, check_with_flips,  # noqa: F401
                              jax_twins, plain_calls, run_pair)

torch.set_num_threads(2)

PLAN_RUNS = {
    "M1": ["--method", "1"],
    "M2": ["--method", "2"],
    "M3": ["--method", "3"],
    "M4": ["--method", "4"],
    "M5": ["--method", "5"],
    "M6": ["--method", "6"],
    "M3 fused_q": ["--method", "3", "--collective", "fused_q"],
    "M2 ring_rs": ["--method", "2", "--gather-type", "ring_rs",
                   "--qsgd-block", "4096"],
    "M4 ring_rs": ["--method", "4", "--gather-type", "ring_rs",
                   "--qsgd-block", "4096"],
}


@pytest.fixture(autouse=True)
def _restore_modes():
    # The trainers under test set the process-wide kernel modes.
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


@pytest.fixture
def small_resnet(monkeypatch):
    """``--network resnet_small``: ResNet(Bottleneck, (1, 1, 1, 1)) in both
    packages' factories."""
    monkeypatch.setitem(
        jmodels._FACTORY, "resnet_small",
        lambda n, d: jmodels.ResNet(jmodels.Bottleneck, (1, 1, 1, 1), n, d))
    monkeypatch.setitem(
        tmodels._FACTORY, "resnet_small",
        lambda n, **kw: tmodels.ResNet(tmodels.Bottleneck, (1, 1, 1, 1), n,
                                       **kw))
    return "resnet_small"


@pytest.mark.parametrize("run", list(PLAN_RUNS))
def test_resnet50_units_and_wire_plan_equal_jax(run):
    """Bit: ResNet50's transport units and wire-plan rows equal the JAX
    package's."""
    argv = ["--network", "ResNet50", "--dataset", "Cifar10",
            "--num-workers", "4", "--topk-ratio", "0.01", *PLAN_RUNS[run]]
    jcfg, tcfg = jfrom_args(argv), from_args(argv)
    specs = leaf_specs(build_model("ResNet50", 10, dataset="Cifar10"))
    sizes = [math.prod(s.jax_shape) for s in specs]
    units = resolved_unit_sizes(tcfg, sizes)
    assert units == jresolved_unit_sizes(jcfg, sizes)
    assert len(specs) == 161 and sum(sizes) == 23_520_842
    assert sum(units) == sum(sizes)
    if tcfg.compression_enabled:  # fusion 'auto' resolves to 'bucket'
        assert len(units) == 14
        assert min(units) >= 1_048_576 and max(units) == 2_359_296
        assert 1_069_066 in units  # 2 mod 4: rows 1, 3 of [4, n] on 2 bytes
    else:
        assert units == sizes
    jparams = jax.eval_shape(lambda: jmodels.init_variables(
        jmodels.build_model("ResNet50", 10), jax.random.key(0),
        jnp.zeros((2, 32, 32, 3))))["params"]
    jp = jwire_plan(jcfg, jparams, world=4)
    tp = wire_plan(tcfg, [(s.name, s.jax_shape) for s in specs], world=4)
    assert tp.per_layer_up == jp.per_layer_up
    assert tp.per_layer_down == jp.per_layer_down
    assert tp.per_step_bytes == jp.per_step_bytes
    assert tp.per_step_bytes_total == jp.per_step_bytes_total
    assert (tp.transport, tp.adopt_bytes, tp.dense_bytes) == \
        (jp.transport, jp.adopt_bytes, jp.dense_bytes)


def check_moves(pair) -> None:
    """The two-step oracle of the module docstring."""
    init = _leaves(pair.init)
    for w in range(len(pair.jparams)):
        jl, tl = _leaves(pair.jparams[w]), _leaves(pair.tparams[w])
        assert list(jl) == list(tl)
        d2 = m2 = 0.0
        for name in jl:
            m, t = jl[name] - init[name], tl[name] - init[name]
            d2 += float(np.sum((t - m) ** 2))
            m2 += float(np.sum(m ** 2))
            if np.abs(m).max() > 0:
                cos = np.dot(t.ravel(), m.ravel()) / (
                    np.linalg.norm(t) * np.linalg.norm(m))
                assert cos >= 0.5, (w, name, cos)
        assert np.sqrt(d2) <= 0.5 * np.sqrt(m2), (w, np.sqrt(d2 / m2))


@pytest.mark.parametrize("method,steps,kw", [
    (1, 1, {}),
    (1, 2, {}),
    (2, 2, {}),
    (5, 2, dict(topk_ratio=0.01)),
])
def test_small_resnet_slice_matches(tmp_path, small_resnet, jax_twins,
                                    plain_calls, method, steps, kw):
    """Tolerance: the oracles of the module docstring, one step or two."""
    pair = run_pair(tmp_path, network=small_resnet, num_workers=2,
                    batch_size=4, max_steps=steps, method=method, **kw)
    check_wire(pair)
    if steps == 1:
        check_with_flips(pair)
    else:
        check_moves(pair)
    assert len(pair.tt.specs) == 53
    units = len(pair.tt.wire.per_layer_up)
    if method == 2:
        # Per step: every bucket quantized by each of the 2 workers and
        # decoded once.
        assert units == 6
        assert plain_calls["qsgd_quantize"] == steps * 2 * units
        assert plain_calls["dequant_mean"] == steps * units
    if method == 5:
        assert plain_calls["block_top1"] > 0
    assert abs(pair.tres.final_loss - pair.jres.final_loss) <= \
        1e-3 * abs(pair.jres.final_loss)


def test_small_resnet_async_homomorphic(tmp_path, small_resnet):
    """Exact: the counters and the bytes up against the wire plan."""
    argv = ["--mode", "async", "--platform", "cpu", "--network", small_resnet,
            "--dataset", "mnist10k", "--num-workers", "2",
            "--num-aggregate", "2", "--max-steps", "4", "--batch-size", "4",
            "--compress-grad", "qsgd", "--server-agg", "homomorphic",
            "--fusion", "none", "--train-dir", str(tmp_path) + "/"]
    cfg = from_args(argv)
    params, stats = run_async(cfg)
    specs = leaf_specs(build_model(small_resnet, 10, dataset="mnist10k"))
    assert len(params) == len(specs) == 53
    assert [tuple(p.shape) for p in params] == [s.jax_shape for s in specs]
    assert all(bool(torch.isfinite(p).all()) for p in params)
    assert (stats.pushes, stats.updates, stats.apply_rounds) == (4, 2, 2)
    assert stats.decode_count == stats.apply_rounds
    plan = wire_plan(cfg, [(s.name, s.jax_shape) for s in specs], world=2)
    assert len(plan.per_layer_up) == 53
    frame = native.encoded_arrays_size([np.empty(plan.up_bytes, np.uint8)])
    assert stats.bytes_up == stats.pushes * frame
    losses = [l for _, l in stats.loss_history]
    assert len(losses) == 4 and all(map(math.isfinite, losses))
