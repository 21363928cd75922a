"""The slice as a whole: the port's ``run_async_ps`` (``--mode async``)
against the JAX package's.

W = 1, K = 1, LeNet at full width on the committed real ``mnist10k`` split,
3 steps, ``--server-agg homomorphic`` QSGD, from the JAX initial state on
the same batches. One worker makes the run deterministic in both packages;
with W > 1 the threads decide which pushes share a round, so no bit oracle
exists there and W = 4 is held to the K-of-N invariants instead.

Oracle: bounded flips (``tests/test_torch_slice.py``). The gradients agree
to f32 rounding and the scale contracts within the ``shared_scales``
tolerance, so a stochastic level can flip by one step where an input
differs by an ulp. Per leaf, with d the difference of the final params and
m the reference's own move: ||d|| <= 2e-2 ||m|| and max|d| <= max|m|, each
plus 1e-5 of the leaf's scale. The counters are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.data import datasets as jdatasets
from ewdml_tpu.data import loader as jloader
from ewdml_tpu.models import build_model as jbuild
from ewdml_tpu.models import init_variables
from ewdml_tpu.ops import make_compressor as jmake_compressor
from ewdml_tpu.optim import SGD as JSGD
from ewdml_tpu.parallel.ps import run_async_ps as j_run_async_ps
from ewdml_tpu_torch.cli import main
from ewdml_tpu_torch.data import datasets, loader
from ewdml_tpu_torch.models import build_model
from ewdml_tpu_torch.models.convert import flax_to_torch, leaf_specs
from ewdml_tpu_torch.ops import kernels, make_compressor
from ewdml_tpu_torch.optim import SGD
from ewdml_tpu_torch.parallel.ps import run_async_ps

torch.set_num_threads(2)

SEED = 42
BATCH = 8


def _factories():
    jds = jdatasets.load("mnist10k", train=True, seed=SEED)
    tds = datasets.load("mnist10k", train=True, seed=SEED)
    assert tds.source == "real"
    return (lambda i: jloader.global_batches(jds, BATCH, 1, seed=SEED + i,
                                             feed="f32"),
            lambda i: loader.global_batches(tds, BATCH, 1, seed=SEED + i,
                                            feed="f32"))


def test_homomorphic_w1_matches_reference():
    jf, tf = _factories()
    jmodel = jbuild("LeNet", 10)
    sample = np.zeros((2, 28, 28, 1), np.float32)
    init = jax.tree.map(np.asarray, init_variables(
        jmodel, jax.random.key(SEED), jnp.asarray(sample))["params"])
    jparams, jstats = j_run_async_ps(
        jmodel, JSGD(0.01, momentum=0.9), jf, num_workers=1,
        steps_per_worker=3, compressor=jmake_compressor("qsgd", 127),
        num_aggregate=1, server_agg="homomorphic", sample_input=sample,
        seed=SEED)
    model = build_model("LeNet", 10, dataset="mnist10k")
    model.load_state_dict(flax_to_torch(model, init))
    tparams, tstats = run_async_ps(
        model, SGD(0.01, momentum=0.9), tf, num_workers=1,
        steps_per_worker=3, compressor=make_compressor("qsgd", 127),
        num_aggregate=1, server_agg="homomorphic", seed=SEED, device="cpu")
    for field in ("pushes", "updates", "decode_count", "apply_rounds",
                  "bytes_up", "bytes_down", "dropped_stale"):
        assert getattr(tstats, field) == getattr(jstats, field), field
    assert tstats.pushes == tstats.updates == tstats.decode_count == 3
    moved = 0
    for spec, tp in zip(leaf_specs(model), tparams):
        layer, leaf = spec.name.split("/")
        j = np.asarray(jparams[layer][leaf], np.float64)
        t = tp.numpy().astype(np.float64)
        m = j - np.asarray(init[layer][leaf], np.float64)
        d = t - j
        tol = 1e-5 * np.abs(j).max()
        assert np.linalg.norm(d) <= 2e-2 * np.linalg.norm(m) \
            + tol * np.sqrt(d.size), spec.name
        assert np.abs(d).max() <= np.abs(m).max() + tol, spec.name
        moved += np.abs(m).max() > 0
    assert moved == len(tparams)
    jl = [l for _, l in jstats.loss_history]
    tl = [l for _, l in tstats.loss_history]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


def test_k_of_n_accept_w4(monkeypatch):
    """W = 4, K = 2 under homomorphic aggregation: K-of-N batching holds and
    every round pays exactly one dequantize."""
    _, tf = _factories()
    calls = {"acc": 0}
    ref = kernels.acc_decode_ref

    def spy(*a, **k):
        calls["acc"] += 1
        return ref(*a, **k)

    monkeypatch.setattr(kernels, "acc_decode_ref", spy)
    _, stats = run_async_ps(
        build_model("LeNet", 10, dataset="mnist10k"), SGD(0.01), tf,
        num_workers=4, steps_per_worker=4,
        compressor=make_compressor("qsgd", 127), num_aggregate=2,
        server_agg="homomorphic", device="cpu")
    assert stats.pushes == 16
    assert stats.updates == 8
    assert stats.apply_rounds == 8
    assert stats.decode_count == 8
    # One decode per quantized leaf and round, plus the warm apply.
    assert calls["acc"] == 8 * (8 + 1)
    assert sum(stats.staleness_hist.values()) == 16


def test_cli_async_done_line(capsys, tmp_path):
    rc = main(["--mode", "async", "--platform", "cpu", "--network", "LeNet",
               "--dataset", "mnist10k", "--num-workers", "4",
               "--num-aggregate", "2", "--max-steps", "8", "--batch-size", "8",
               "--compress-grad", "topk_qsgd", "--topk-ratio", "0.05",
               "--server-agg", "homomorphic",
               "--train-dir", str(tmp_path) + "/"])
    assert rc == 0
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if l.startswith("async done:")]
    assert len(line) == 1, out
    assert "pushes=8 updates=4 stale_dropped=0" in line[0]


def test_cli_async_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """Without ``--platform cpu`` the async run is a CUDA run: with no GPU
    it raises, and never continues on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        main(["--mode", "async", "--network", "LeNet", "--dataset",
              "mnist10k", "--num-workers", "2", "--max-steps", "2",
              "--compress-grad", "qsgd", "--server-agg", "homomorphic",
              "--train-dir", str(tmp_path) + "/"])


@pytest.mark.parametrize("compress", [None, "qsgd"], ids=["dense", "qsgd"])
def test_bf16_frames_and_adam_w1_match_reference(compress):
    """W = 1, K = 1, 2 steps under ``--precision-policy bf16_wire_state``
    with Adam (bf16 moments, rounded under ``fold_in(key(seed ^ 0x0917),
    version)``): dense bf16 push frames (half the f32 bytes) or QSGD under
    ``decode``. The bounded-flip oracle of the module docstring; the frames'
    bytes equal."""
    from ewdml_tpu.optim import Adam as JAdam
    from ewdml_tpu_torch.optim import Adam

    jf, tf = _factories()
    jmodel = jbuild("LeNet", 10)
    sample = np.zeros((2, 28, 28, 1), np.float32)
    init = jax.tree.map(np.asarray, init_variables(
        jmodel, jax.random.key(SEED), jnp.asarray(sample))["params"])
    jparams, jstats = j_run_async_ps(
        jmodel, JAdam(1e-3, state_dtype=jnp.bfloat16), jf, num_workers=1,
        steps_per_worker=2,
        compressor=compress and jmake_compressor(compress, 127),
        num_aggregate=1, sample_input=sample, seed=SEED,
        precision="bf16_wire_state")
    model = build_model("LeNet", 10, dataset="mnist10k")
    model.load_state_dict(flax_to_torch(model, init))
    tparams, tstats = run_async_ps(
        model, Adam(1e-3, state_dtype=torch.bfloat16), tf, num_workers=1,
        steps_per_worker=2,
        compressor=compress and make_compressor(compress, 127),
        num_aggregate=1, seed=SEED, device="cpu",
        precision="bf16_wire_state")
    for field in ("pushes", "updates", "bytes_up", "bytes_down"):
        assert getattr(tstats, field) == getattr(jstats, field), field
    if compress is None:
        n = sum(p.numel() for p in tparams)
        assert tstats.bytes_up < 2 * (2 * n + 4096)  # bf16 frames
    for spec, tp in zip(leaf_specs(model), tparams):
        layer, leaf = spec.name.split("/")
        j = np.asarray(jparams[layer][leaf], np.float64)
        t = tp.numpy().astype(np.float64)
        m = j - np.asarray(init[layer][leaf], np.float64)
        d = t - j
        tol = 1e-5 * np.abs(j).max()
        assert np.linalg.norm(d) <= 2e-2 * np.linalg.norm(m) \
            + tol * np.sqrt(d.size), spec.name
        assert np.abs(d).max() <= np.abs(m).max() + tol, spec.name
