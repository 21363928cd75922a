"""Checkpoints and resume in the port (``train/checkpoint.py``,
``Trainer.maybe_restore``), against the JAX package's.

Oracles:
- bit (interop): a JAX ``Trainer``'s checkpoint (LeNet ``mnist10k``,
  W = 4, M4 with error feedback, 3 steps, ``eval_freq`` 3: a full blob)
  restored by the port equals the JAX state after conversion, every
  parameter, momentum buffer, flag and residual of every worker; a port
  checkpoint restored by ``ewdml_tpu.train.checkpoint.restore`` against
  the JAX template equals the port's state.
- same behaviour as ``ewdml_tpu/train/checkpoint.py:54-140`` (parity): the
  port's ``restore`` and the JAX package's on the same blob and template
  return equal trees, or both raise: a missing field, an extra field, a
  wrong shape, a wrong dtype, the f32 <-> bf16 pair on the optimizer state,
  full into one worker, collapsed into a stacked template.
- bit (the port alone, ``--feed device``): a run stopped at a save,
  restored in a fresh ``Trainer`` and carried on equals the uninterrupted
  run, every parameter, momentum buffer, residual and metrics row: per
  step, at ``--scan-window 4`` (the save snapped to a window's end; the
  counterpart of ``tests/test_scan_window.py:159``), and Method 6 saved in
  a local phase with the workers' states different (per step, and at
  K = 2 where the save lands mid sync period).
- the residual reset: a collapsed blob restored onto W = 4 workers with
  error feedback zeroes the residuals, a full blob keeps them.
- tolerance (resume parity): the port and the JAX package each run 2
  steps, save, restore in a new trainer and run 2 more on the streaming
  feed (re-seeded with ``seed + 2``); the final parameters agree within the
  M4 oracle of ``tests/test_torch_slice_qsgd.py`` (bounded flips).
"""

import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from ewdml_tpu.core.config import TrainConfig as JConfig
from ewdml_tpu.models import LeNet as JLeNet
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu.train import checkpoint as jckpt
from ewdml_tpu.train.loop import Trainer as JTrainer
from ewdml_tpu.train.state import worker_slice
from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.models.convert import torch_to_flax
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.train import checkpoint
from ewdml_tpu_torch.train.loop import Trainer
from ewdml_tpu_torch.train.state import state_tree
from test_torch_msgpack import MODELS, jax_worker_state, to_torch
from test_torch_slice import BASE, Pair, check_with_flips, jax_twins  # noqa: F401

torch.set_num_threads(2)

W = 4


@pytest.fixture(autouse=True)
def _restore_modes():
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


def _tree_np(tree):
    """A torch tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


# -- interop ------------------------------------------------------------------

INTEROP = dict(network="LeNet", dataset="mnist10k", batch_size=8, lr=0.01,
               max_steps=3, eval_freq=3, epochs=100, log_every=1000,
               bf16_compute=False, num_workers=W, method=4,
               error_feedback=True, seed=42)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jt = JTrainer(JConfig(train_dir=str(tmp_path) + "/", **INTEROP))
    jt.train()
    path = jckpt.latest_path(str(tmp_path))
    assert checkpoint.peek_step(path) == 3
    tt = Trainer(TrainConfig(platform="cpu", train_dir=str(tmp_path) + "/",
                             **INTEROP))
    assert tt.maybe_restore() and tt.state.step == 3
    want = flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, jt.state.worker))
    got = _tree_np(state_tree(tt.state.workers, tt.specs, stacked=True))
    _assert_trees_equal(got, want)
    # The residuals were restored, not reset (a full blob at W = 4).
    assert any(np.abs(leaf).max() > 0 for leaf in
               jax.tree.leaves(want["residual"]))


def test_port_checkpoint_restores_in_jax(tmp_path):
    cfg = dict(INTEROP, max_steps=2, eval_freq=2)
    tt = Trainer(TrainConfig(platform="cpu", train_dir=str(tmp_path) + "/",
                             **cfg))
    tt.train()
    jt = JTrainer(JConfig(train_dir=str(tmp_path) + "/", **cfg))
    template = jax.tree.map(np.asarray, jt.state.worker)
    restored, step, world = jckpt.restore(jckpt.latest_path(str(tmp_path)),
                                          template)
    assert (step, world) == (2, W)
    _assert_trees_equal(
        flax.serialization.to_state_dict(jax.tree.map(np.asarray, restored)),
        _tree_np(state_tree(tt.state.workers, tt.specs, stacked=True)))
    assert jt.maybe_restore() and int(np.asarray(jt.state.step)) == 2


# -- the restore rules, against the JAX package's restore ---------------------

def _lenet_state(full: bool, seed: int = 0):
    return jax_worker_state(MODELS["lenet"][0](), MODELS["lenet"][2], full,
                            seed)


def _without(ws, field):
    return ws.replace(**{field: {}})


def _rules():
    """(blob state, blob world, template state) per case."""
    seven = jax_worker_state(JLeNet(num_classes=7), MODELS["lenet"][2],
                             False, 1)
    one, full = _lenet_state(False, 1), _lenet_state(True, 2)
    f64 = one.replace(params=jax.tree.map(
        lambda a: a.astype(np.float64), one.params))
    bf16_opt = one.replace(opt_state=one.opt_state._replace(
        momentum_buf=jax.tree.map(lambda a: np.asarray(a, jax.numpy.bfloat16),
                                  one.opt_state.momentum_buf)))
    return {
        "missing_field": (_without(one, "residual"), 0, _lenet_state(False)),
        "extra_field": (one, 0, _without(_lenet_state(False), "residual")),
        "wrong_shape": (seven, 0, _lenet_state(False)),
        "wrong_dtype": (f64, 0, _lenet_state(False)),
        "bf16_opt_state": (bf16_opt, 0, _lenet_state(False)),
        "full_to_one_worker": (full, 3, _lenet_state(False)),
        "collapsed_to_stacked": (one, 0, _lenet_state(True)),
    }


RULES = ["missing_field", "extra_field", "wrong_shape", "wrong_dtype",
         "bf16_opt_state", "full_to_one_worker", "collapsed_to_stacked"]


@pytest.mark.parametrize("case", RULES)
def test_restore_rules_match_jax(tmp_path, case):
    blob, world, template = _rules()[case]
    path = jckpt.save(str(tmp_path), blob, step=5, world=world)
    port_template = to_torch(flax.serialization.to_state_dict(template))
    if case in ("wrong_shape", "wrong_dtype"):
        with pytest.raises(ValueError, match="checkpoint field"):
            jckpt.restore(path, template)
        with pytest.raises(ValueError, match="checkpoint field"):
            checkpoint.restore(path, port_template)
        return
    jws, jstep, jworld = jckpt.restore(path, template)
    tree, step, tworld = checkpoint.restore(path, port_template)
    assert (step, tworld) == (jstep, jworld) == (5, world)
    _assert_trees_equal(
        _tree_np(tree),
        flax.serialization.to_state_dict(jax.tree.map(np.asarray, jws)))
    if case == "missing_field":  # the template's own leaves, kept
        assert tree["residual"]["conv1"]["kernel"] is \
            port_template["residual"]["conv1"]["kernel"]
    if case == "bf16_opt_state":
        assert tree["opt_state"]["momentum_buf"]["fc1"]["kernel"].dtype == \
            torch.float32


@pytest.mark.parametrize("blob_world", [0, W], ids=["collapsed", "full"])
def test_residual_reset_on_a_collapsed_blob(tmp_path, blob_world):
    """W = 4 workers with error feedback: a blob of one worker's view
    restarts the residuals at zero; a full blob restores them."""
    cfg = TrainConfig(platform="cpu", train_dir=str(tmp_path) + "/",
                      **dict(INTEROP, dataset="MNIST", synthetic_data=True,
                             synthetic_size=64))
    src = Trainer(cfg)
    with torch.no_grad():
        for w, ws in enumerate(src.state.workers):
            for res in ws.residual:
                res.fill_(w + 1.0)
    checkpoint.save(cfg.train_dir,
                    state_tree(src.state.workers, src.specs,
                               stacked=blob_world > 0),
                    step=4, world=blob_world)
    t = Trainer(cfg)
    assert t.maybe_restore() and t.state.step == 4
    for w, ws in enumerate(t.state.workers):
        want = 0.0 if blob_world == 0 else w + 1.0
        assert all(torch.all(r == want) for r in ws.residual)
        for p, q in zip(ws.model.parameters(),
                        src.state.workers[0].model.parameters()):
            assert torch.equal(p, q)


# -- resume in the port alone (bit) -------------------------------------------

def _dcfg(tmp_path, name, **kw):
    base = dict(network="LeNet", dataset="MNIST", batch_size=4, lr=0.01,
                synthetic_data=True, synthetic_size=64, epochs=1000,
                log_every=1000, bf16_compute=False, feed="device",
                num_workers=W, platform="cpu",
                train_dir=str(tmp_path / name) + "/")
    base.update(kw)
    sync_every = base.pop("sync_every", None)
    cfg = TrainConfig(**base)
    if sync_every:
        cfg.sync_every = sync_every   # after the Method 6 preset
    return cfg


def _state(t) -> list:
    out = []
    for ws in t.state.workers:
        out += list(ws.model.state_dict().values())
        out += list(ws.opt_state.momentum_buf) + list(ws.residual)
    return out


RESUME = {
    # (config, interrupted at, total)
    "per_step": (dict(method=4, scan_window=1, eval_freq=4), 4, 8),
    # eval_freq 5 snaps to the window's end at 8.
    "window": (dict(method=4, topk_ratio=0.1, scan_window=4, eval_freq=5),
               8, 12),
    "m6_local_phase": (dict(method=6, topk_ratio=0.1, sync_every=4,
                            scan_window=1, eval_freq=5), 5, 8),
    "m6_mid_window": (dict(method=6, topk_ratio=0.1, sync_every=4,
                           scan_window=2, eval_freq=6), 6, 10),
}


@pytest.mark.parametrize("case", sorted(RESUME))
def test_resume_equals_the_uninterrupted_run(tmp_path, case):
    kw, stop, total = RESUME[case]
    full = Trainer(_dcfg(tmp_path, "full", max_steps=total, **kw))
    fres = full.train()
    first = Trainer(_dcfg(tmp_path, "resumed", max_steps=stop, **kw))
    r1 = first.train()
    saved = _tree_np(state_tree(first.state.workers, first.specs,
                                stacked=True))
    t2 = Trainer(_dcfg(tmp_path, "resumed", max_steps=total, **kw))
    assert t2.maybe_restore() and t2.state.step == stop
    path = checkpoint.latest_path(t2.cfg.train_dir)
    _, _, world = checkpoint.restore(path, {})
    divergent = kw["method"] == 6
    assert world == (W if divergent else 0)
    # The restored tensors are the saved ones.
    _assert_trees_equal(_tree_np(state_tree(t2.state.workers, t2.specs,
                                            stacked=True)), saved)
    if divergent:  # the blob really held different workers
        leaf = saved["params"]["conv1"]["kernel"]
        assert not all(np.array_equal(leaf[0], leaf[r]) for r in range(1, W))
    r2 = t2.train()
    for a, b in zip(_state(full), _state(t2)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(np.concatenate([r1.rows, r2.rows]),
                                  fres.rows)


def test_restored_step_at_target_does_nothing(tmp_path):
    cfg = _dcfg(tmp_path, "d", method=3, scan_window=1, eval_freq=2,
                max_steps=4)
    Trainer(cfg).train()
    path = checkpoint.latest_path(cfg.train_dir)
    mtime = os.path.getmtime(path)
    t = Trainer(cfg)
    assert t.maybe_restore()
    res = t.train()
    assert res.steps == 4 and res.rows is None
    assert os.path.getmtime(path) == mtime


# -- resume parity with the JAX package (tolerance) ---------------------------

def test_resume_matches_the_jax_resume(tmp_path, jax_twins):
    cfg = dict(BASE, method=4, max_steps=2, eval_freq=2)
    jdir, tdir = str(tmp_path / "j") + "/", str(tmp_path / "t") + "/"
    jt = JTrainer(JConfig(train_dir=jdir, **cfg))
    w0 = worker_slice(jt.state)
    init = jax.tree.map(np.asarray, w0.params)
    jt.train()
    tt = Trainer(TrainConfig(platform="cpu", train_dir=tdir, **cfg))
    tt.load_flax_state(init, jax.tree.map(np.asarray, w0.batch_stats))
    tt.train()
    cfg["max_steps"] = 4
    jt2 = JTrainer(JConfig(train_dir=jdir, **cfg))
    tt2 = Trainer(TrainConfig(platform="cpu", train_dir=tdir, **cfg))
    assert jt2.maybe_restore() and tt2.maybe_restore()
    assert int(np.asarray(jt2.state.step)) == tt2.state.step == 2
    jres, tres = jt2.train(), tt2.train()
    jparams = [jax.tree.map(lambda x, w=w: np.asarray(x[w]),
                            jt2.state.worker.params) for w in range(W)]
    tparams = [torch_to_flax(ws.model)[0] for ws in tt2.state.workers]
    check_with_flips(Pair(jt2, tt2, jres, tres, jparams, tparams, init))


# -- Adam and the precision policy -------------------------------------------

POLICY = dict(INTEROP, optimizer="adam", lr=1e-3,
              precision_policy="bf16_wire_state", pallas="off")


def test_jax_adam_bf16_checkpoint_restores_in_the_port(tmp_path):
    """A JAX run under Adam and ``bf16_wire_state`` (bf16 moments and
    residuals, an int32 count) restores bit for bit in the port, and the
    port's save of it is the JAX file's bytes."""
    cfg = dict(POLICY, max_steps=2, eval_freq=2)
    jt = JTrainer(JConfig(train_dir=str(tmp_path) + "/", **cfg))
    jt.train()
    path = jckpt.latest_path(str(tmp_path))
    tt = Trainer(TrainConfig(platform="cpu", train_dir=str(tmp_path) + "/",
                             **cfg))
    assert tt.maybe_restore() and tt.state.step == 2
    ws = tt.state.workers[0]
    assert ws.opt_state.mu[0].dtype == torch.bfloat16
    assert ws.residual[0].dtype == torch.bfloat16
    want = flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, jt.state.worker))
    got = state_tree(tt.state.workers, tt.specs, stacked=True)
    assert checkpoint.save(str(tmp_path / "port"), got, 2, world=W)
    with open(path, "rb") as a, \
            open(str(tmp_path / "port" / "model_step_"), "rb") as b:
        assert a.read() == b.read()
    assert int(want["opt_state"]["count"][0]) == 2


def test_a_policy_change_casts_the_state_on_restore(tmp_path, caplog):
    """A checkpoint saved under f32 restores into a ``bf16_wire_state`` run:
    ``opt_state/`` and ``residual/`` leaves cast to bf16 (to nearest, as
    the JAX package casts them), the parameters stay f32."""
    cfg = dict(POLICY, max_steps=2, eval_freq=2, precision_policy="f32")
    f32 = Trainer(TrainConfig(platform="cpu", train_dir=str(tmp_path) + "/",
                              **cfg))
    f32.train()
    bf = Trainer(TrainConfig(platform="cpu", train_dir=str(tmp_path) + "/",
                             **dict(cfg, precision_policy="bf16_wire_state")))
    assert bf.maybe_restore()
    for a, b in zip(f32.state.workers, bf.state.workers):
        assert torch.equal(a.opt_state.mu[0].to(torch.bfloat16),
                           b.opt_state.mu[0])
        assert torch.equal(a.residual[3].to(torch.bfloat16), b.residual[3])
        for p, q in zip(a.model.parameters(), b.model.parameters()):
            assert q.dtype == torch.float32 and torch.equal(p, q)
    assert "precision-policy changed" in caplog.text


def test_bf16_params_are_still_a_hard_error(tmp_path):
    """The weights stay f32 under every policy: a blob whose parameters are
    bf16 is a wrong train_dir, not a policy change."""
    jws = _lenet_state(False)
    jws = jws.replace(params=jax.tree.map(
        lambda a: np.asarray(jax.numpy.asarray(a, jax.numpy.bfloat16)),
        jws.params))
    path = str(tmp_path / "model_step_")
    with open(path, "wb") as f:
        f.write(flax.serialization.to_bytes(
            {"step": 1, "world": 0, "worker": jws}))
    tt = Trainer(TrainConfig(platform="cpu", train_dir=str(tmp_path) + "/",
                             **dict(INTEROP,
                                    precision_policy="bf16_wire_state")))
    with pytest.raises(ValueError, match="params"):
        tt.maybe_restore()
