"""The adaptive sync trainer (``--adapt variance|replay``) against the JAX
package's, on the CPU.

One JAX recording is shared by the module: LeNet on the committed
``mnist10k`` split, W = 2, Method 5 at the paper's 1% ratio (fc1 takes the
strided block selection), ``--adapt variance --adapt-every 2`` for 4 steps,
``--pallas interpret`` with the vectorized kernel twins of
``test_torch_slice.py``. The comm/comp ratio both trainers decide on is
held at 0.4 (the JAX one reads it from a process-global gauge, held with
``monkeypatch``; the port's is passed in).

Oracles, per test:
- the port's ``AdaptRuntime`` fed the JAX run's moment samples writes the
  JAX ledger: bit (lines equal apart from ``latency_ms``);
- the port replaying the JAX-recorded ledger: the same applied plan
  sequence (bit), parameters within the compressed-method tolerance of
  ``test_torch_slice.py`` (as ``test_torch_slice_topk.py`` holds them),
  and the wire plan after the last switch equal to the JAX trainer's;
- the port's step moments against the JAX step's: tolerance, per leaf
  ``|d(mean g)| <= 1e-3 sqrt(mean g^2)`` (the mean can be near 0: its
  scale is the gradient's RMS) and ``|d(mean g^2)| <= 1e-3 mean g^2``
  (the gradients agree to f32 rounding, the parameters to the flips
  tolerance);
- ``--adapt off`` and a variance run that reaches no decision: bit-equal
  to the non-adaptive port step;
- a resumed run adopts the journaled plan at the restored step: exact.
"""

import json

import jax
import numpy as np
import pytest
import torch

from ewdml_tpu.adapt import runtime as jruntime
from ewdml_tpu.core.config import TrainConfig as JConfig
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu.train.loop import Trainer as JTrainer
from ewdml_tpu.train.state import worker_slice
from ewdml_tpu_torch.adapt import ledger, runtime
from ewdml_tpu_torch.adapt.plan import unit_names_and_sizes
from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.models import build_model
from ewdml_tpu_torch.models.convert import leaf_specs, torch_to_flax
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.train.loop import Trainer
from test_torch_slice import (Pair, block_top1_twin, check_with_flips,
                              dequant_twin, quantize_twin)

torch.set_num_threads(2)

STEPS, EVERY, COMM_FRAC = 4, 2, 0.4
BASE = dict(network="LeNet", dataset="mnist10k", batch_size=8, lr=0.01,
            max_steps=STEPS, epochs=100, eval_freq=0, log_every=1000,
            bf16_compute=False, num_workers=2, pallas="interpret", seed=42,
            method=5, topk_ratio=0.01, adapt_every=EVERY)


@pytest.fixture(autouse=True)
def _restore_modes():
    # The port's Trainer under BASE sets the process-wide kernel mode to
    # 'interpret'; later tests on this worker expect 'auto'.
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


def _strip(line: str) -> dict:
    rec = json.loads(line)
    rec.pop("latency_ms", None)
    return rec


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """The JAX trainer's adaptive run: its initial state, final
    parameters, applied plans, ledger and moment samples."""
    root = tmp_path_factory.mktemp("jax_adapt")
    samples = []
    on_window = jruntime.AdaptRuntime.on_window

    def recorded(self, step, moments):
        samples.append((step, np.array(moments)))
        return on_window(self, step, moments)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pk, "qsgd_quantize", quantize_twin)
        mp.setattr(pk, "dequant_mean", dequant_twin)
        mp.setattr(pk, "block_top1", block_top1_twin)
        mp.setattr(jruntime, "live_comm_frac", lambda: COMM_FRAC)
        mp.setattr(JTrainer, "_adapt_comm_frac", lambda self, *a: None)
        mp.setattr(jruntime.AdaptRuntime, "on_window", recorded)
        jt = JTrainer(JConfig(adapt="variance", train_dir=str(root) + "/",
                              **BASE))
        w0 = worker_slice(jt.state)
        init = jax.tree.map(np.asarray, w0.params)
        stats = jax.tree.map(np.asarray, w0.batch_stats)
        jres = jt.train()
        pk.configure("auto")
    kernels.configure("auto")
    jparams = [jax.tree.map(lambda x, w=w: np.asarray(x[w]),
                            jt.state.worker.params)
               for w in range(BASE["num_workers"])]
    return dict(jt=jt, jres=jres, init=init, stats=stats, jparams=jparams,
                samples=samples, applied=list(jt._adapt.applied),
                ledger=jt._adapt.ledger_path)


def test_runtime_fed_jax_samples_writes_the_jax_ledger(recording, tmp_path):
    jt = recording["jt"]
    tt_cfg = TrainConfig(platform="cpu", adapt="variance",
                         train_dir=str(tmp_path) + "/", **BASE)
    names, sizes = unit_names_and_sizes(
        leaf_specs(build_model("LeNet", dataset="mnist10k")))
    assert (names, sizes) == (jt._adapt.names, jt._adapt.sizes)
    rt = runtime.AdaptRuntime(tt_cfg, names, sizes)
    for step, m in recording["samples"]:
        rt.on_window(step, m, comm_frac=COMM_FRAC)
    rt.close()
    jl = open(recording["ledger"]).read().splitlines()
    tl = open(rt.ledger_path).read().splitlines()
    assert len(tl) == len(jl) == 2 + STEPS // EVERY
    assert [_strip(x) for x in tl] == [_strip(x) for x in jl]
    assert any(d.get("switched") for d in map(json.loads, jl[1:]))


def _replay(recording, tmp_path, monkeypatch, **kw):
    cfg = TrainConfig(platform="cpu", adapt="replay",
                      adapt_ledger=recording["ledger"],
                      train_dir=str(tmp_path) + "/", **dict(BASE, **kw))
    tt = Trainer(cfg)
    tt.load_flax_state(recording["init"], recording["stats"])
    samples = []
    on_window = runtime.AdaptRuntime.on_window

    def recorded(self, step, moments, comm_frac=None):
        samples.append((step, np.array(moments)))
        return on_window(self, step, moments, comm_frac)

    monkeypatch.setattr(runtime.AdaptRuntime, "on_window", recorded)
    tres = tt.train()
    return tt, tres, samples


def test_port_replays_a_jax_ledger(recording, tmp_path, monkeypatch):
    tt, tres, samples = _replay(recording, tmp_path, monkeypatch)
    jt = recording["jt"]
    assert [(s, p.key(), p.version) for s, p in tt._adapt.applied] == \
        [(s, p.key(), p.version) for s, p in recording["applied"]]
    assert len(tt._adapt.applied) >= 2    # at least one switch replayed
    tparams = [torch_to_flax(ws.model)[0] for ws in tt.state.workers]
    check_with_flips(Pair(jt, tt, recording["jres"], tres,
                          recording["jparams"], tparams, recording["init"]))
    assert tt.wire.per_layer_up == jt.wire.per_layer_up
    assert tt.wire.per_step_bytes == jt.wire.per_step_bytes
    # The step moments, sample by sample.
    assert [s for s, _ in samples] == [s for s, _ in recording["samples"]]
    for (_, t), (_, j) in zip(samples, recording["samples"]):
        assert t.shape == j.shape == (8, 2)
        rms = np.sqrt(j[:, 1])
        assert np.all(np.abs(t[:, 0] - j[:, 0]) <= 1e-3 * rms)
        assert np.all(np.abs(t[:, 1] - j[:, 1]) <= 1e-3 * j[:, 1])


def _port_params(tt):
    return [p.detach().clone() for ws in tt.state.workers
            for p in ws.model.parameters()]


def test_adapt_off_is_the_non_adaptive_step(tmp_path):
    runs = {}
    kw = dict(BASE, pallas="auto", max_steps=3)
    for name, extra in (("default", {}), ("off", dict(adapt="off")),
                        ("undecided", dict(adapt="variance",
                                           adapt_every=1000))):
        cfg = TrainConfig(platform="cpu", train_dir=str(tmp_path / name) + "/",
                          **dict(kw, **extra))
        tt = Trainer(cfg)
        tt.train()
        runs[name] = (_port_params(tt), tt.wire.per_layer_up)
    for name in ("off", "undecided"):
        assert runs[name][1] == runs["default"][1]
        for a, b in zip(runs[name][0], runs["default"][0]):
            assert torch.equal(a, b), name


def test_resume_adopts_the_journaled_plan(tmp_path, monkeypatch):
    monkeypatch.setattr(Trainer, "_adapt_comm_frac",
                        lambda self, *a: COMM_FRAC)
    kw = dict(BASE, pallas="auto", eval_freq=4, max_steps=4)
    # (decisions at steps 2 and 4, the checkpoint at 4)
    cfg = TrainConfig(platform="cpu", adapt="variance",
                      train_dir=str(tmp_path) + "/", **kw)
    first = Trainer(cfg)
    first.train()
    in_force = first._adapt.plan
    assert in_force.version >= 1     # a switch before the checkpoint
    second = Trainer(TrainConfig(platform="cpu", adapt="variance",
                                 train_dir=str(tmp_path) + "/",
                                 **dict(kw, max_steps=6)))
    assert second._adapt.plan.version == 0
    assert second.maybe_restore() and second.state.step == 4
    second.train()
    adopted = second._adapt.applied[1]
    assert adopted[0] == 4 and adopted[1].key() == in_force.key()
    assert adopted[1].version == in_force.version
    rows = ledger.read_decisions(second._adapt.ledger_path)
    assert any(r["trigger"] == "resume" and r["step"] == 4 for r in rows)
