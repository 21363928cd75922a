"""The multi-process world: the sync trainer across OS processes.

The port's counterpart of ``tests/test_launcher.py``. Each cluster is P
subprocesses of ``python -m ewdml_tpu_torch.cli --platform cpu``, joined by
``parallel/launcher.py`` through a ``file://`` rendezvous under the test's
directory (``EWDML_INIT_METHOD``, ``RANK``, ``WORLD_SIZE``), each with a
wall timeout; the emulated run is the same command in one process (a
``LocalWorld`` of W workers). Every child runs on one intra-op thread: a
multi-threaded CPU conv backward sums in a varying order.

Oracles:
- bit: the coordinator's checkpoint against the emulated run's, byte for
  byte (every process gathers the same bytes and reduces them in the same
  order); a resume continues byte-equal; the world's gathers, broadcast
  and staged bytes (``gather_bytes`` against ``wire_plan``'s rows) in a
  two-process child; the rank layout and the refusals, the ``--adapt``
  one word for word against the JAX package's.
- tolerance plus bounded flips (``test_torch_slice.py``): the two-process
  M4 run against the JAX ``Trainer`` on 4 CPU devices from the same
  initial state, its final loss within 1e-3 relative.
"""

import os
import subprocess
import sys
import uuid

import jax
import numpy as np
import pytest
import torch

from ewdml_tpu.core.config import TrainConfig as JConfig
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu.train import checkpoint as jckpt
from ewdml_tpu.train.loop import Trainer as JTrainer
from ewdml_tpu.train.state import worker_slice
from ewdml_tpu_torch.core import config as tconfig
from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.core.world import process_layout
from ewdml_tpu_torch.models.convert import torch_to_flax
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.parallel import launcher
from ewdml_tpu_torch.train import trainer as ttrainer
from ewdml_tpu_torch.train.loop import Trainer
from test_torch_slice import (BASE as SLICE_BASE, Pair, check_with_flips,  # noqa: F401
                              jax_twins)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
CKPT = "model_step_"
LENET = ["--platform", "cpu", "--network", "LeNet", "--dataset", "mnist10k",
         "--batch-size", "8", "--no-bf16", "--log-every", "1000"]
# The launcher's and torchrun's variables never leak in from the shell.
_DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
             "LOCAL_RANK", "LOCAL_WORLD_SIZE", launcher.INIT_METHOD_ENV,
             launcher.BACKEND_ENV)


@pytest.fixture(autouse=True)
def _restore_modes():
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _DIST_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)
    return env


def _finish(procs, what: str) -> list:
    """Every child's output; each must exit 0 within the wall timeout."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{what} process {r}:\n{out[-3000:]}"
    return outs


def _spawn(argv, env, script=None):
    cmd = ([sys.executable, "-c", script] if script else
           [sys.executable, "-m", "ewdml_tpu_torch.cli"])
    return subprocess.Popen(cmd + list(argv), env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _cluster(tmp_path, nprocs: int, argv, script=None) -> list:
    """P processes of one cluster, started (not waited for)."""
    rdzv = tmp_path / f"rdzv_{uuid.uuid4().hex}"
    return [_spawn(argv, _env(RANK=str(r), WORLD_SIZE=str(nprocs),
                              EWDML_INIT_METHOD=f"file://{rdzv}"), script)
            for r in range(nprocs)]


def _train_dir(tmp_path, name: str) -> str:
    return str(tmp_path / name) + "/"


def _blob(train_dir: str) -> bytes:
    with open(os.path.join(train_dir, CKPT), "rb") as f:
        return f.read()


def _summary(out: str) -> str:
    """The ``done:`` line's steps, loss and top-1 (not its timing)."""
    done = next(ln for ln in out.splitlines() if ln.startswith("done:"))
    return done.split(" step_time=")[0]


def _pair(tmp_path, nprocs, flags, tag=""):
    """The cluster and the emulated run of ``flags``, side by side; their
    outputs (the cluster's per process) and train dirs."""
    pdir = _train_dir(tmp_path, f"procs{tag}")
    ldir = _train_dir(tmp_path, f"local{tag}")
    procs = _cluster(tmp_path, nprocs, LENET + flags + ["--train-dir", pdir])
    local = _spawn(LENET + flags + ["--train-dir", ldir], _env())
    outs = _finish(procs + [local], "cluster" + tag)
    return outs[:-1], outs[-1], pdir, ldir


CASES = {
    "m1": (2, ["--num-workers", "4", "--method", "1"]),
    "m4": (2, ["--num-workers", "4", "--method", "4"]),
    "m5_ef": (2, ["--num-workers", "4", "--method", "5",
                  "--error-feedback"]),
    "m4_k3": (2, ["--num-workers", "4", "--method", "4",
                  "--num-aggregate", "3"]),
    # The JAX pod shape: slice s = process s.
    "m5_ef_slice_a_process": (2, ["--num-workers", "4", "--num-slices", "2",
                                  "--method", "5", "--error-feedback"]),
    # Two slices in each process; then a slice over two processes.
    "m4_ef_two_slices_a_process": (2, ["--num-workers", "8", "--num-slices",
                                       "4", "--method", "4",
                                       "--error-feedback"]),
    "m5_ef_slice_spans_processes": (4, ["--num-workers", "4", "--num-slices",
                                        "2", "--method", "5",
                                        "--error-feedback"]),
    # M6 syncs at step 19 (sync period 20): one adoption.
    "m6_adoption": (3, ["--num-workers", "3", "--method", "6",
                        "--max-steps", "21", "--eval-freq", "21"]),
    "feed_device": (2, ["--num-workers", "4", "--method", "4", "--feed",
                        "device"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_checkpoint_equals_the_emulated_run(tmp_path, case):
    """bit: the coordinator's checkpoint is the emulated run's, byte for
    byte; only the coordinator prints the summary."""
    nprocs, flags = CASES[case]
    if "--max-steps" not in flags:
        flags = flags + ["--max-steps", "3", "--eval-freq", "3"]
    outs, local, pdir, ldir = _pair(tmp_path, nprocs, flags)
    assert _blob(pdir) == _blob(ldir)
    assert _summary(outs[0]) == _summary(local)
    assert not any("done:" in out for out in outs[1:])


def test_cluster_resume_continues_byte_equal(tmp_path):
    """bit: a two-process M5 error-feedback run (a full ``[W, ...]``
    checkpoint, residuals and all) restored from its own step-3
    checkpoint runs to step 6 byte-equal to the emulated run's
    continuation of its own."""
    flags = ["--num-workers", "4", "--method", "5", "--error-feedback",
             "--eval-freq", "3"]
    _, _, pdir, ldir = _pair(tmp_path, 2, flags + ["--max-steps", "3"])
    assert _blob(pdir) == _blob(ldir)
    procs = _cluster(tmp_path, 2, LENET + flags + ["--max-steps", "6",
                                                   "--train-dir", pdir])
    local = _spawn(LENET + flags + ["--max-steps", "6", "--train-dir", ldir],
                   _env())
    outs = _finish(procs + [local], "resume")
    assert "restored checkpoint" in outs[1]
    assert _blob(pdir) == _blob(ldir)


def test_two_processes_match_the_jax_trainer(tmp_path, jax_twins):
    """tolerance plus bounded flips: the port's P = 2 x L = 2 M4 LeNet run
    against the JAX Trainer on 4 CPU devices (which the JAX two-process
    cluster of ``tests/test_launcher.py`` equals), both from the JAX
    Trainer's initial state (the port's step-0 checkpoint)."""
    cfg = dict(SLICE_BASE, method=4, eval_freq=3)
    jt = JTrainer(JConfig(train_dir=_train_dir(tmp_path, "jax"), **cfg))
    w0 = worker_slice(jt.state)
    init = jax.tree.map(np.asarray, w0.params)
    pdir = _train_dir(tmp_path, "procs")
    jckpt.save(pdir, w0, 0)
    jres = jt.train()
    argv = ["--platform", "cpu", "--network", "LeNet", "--dataset",
            "mnist10k", "--batch-size", "8", "--lr", "0.01", "--max-steps",
            "3", "--epochs", "100", "--eval-freq", "3", "--log-every",
            "1000", "--no-bf16", "--num-workers", "4", "--pallas",
            "interpret", "--seed", "42", "--method", "4",
            "--train-dir", pdir]
    outs = _finish(_cluster(tmp_path, 2, argv), "jax pair")
    loss = float(_summary(outs[0]).split("loss=")[1].split()[0])
    tt = Trainer(TrainConfig(platform="cpu", train_dir=pdir, **cfg))
    assert tt.maybe_restore() and tt.state.step == 3
    jparams = [jax.tree.map(lambda x, w=w: np.asarray(x[w]),
                            jt.state.worker.params) for w in range(4)]
    tparams = [torch_to_flax(ws.model)[0] for ws in tt.state.workers]
    check_with_flips(Pair(jt, tt, jres, None, jparams, tparams, init))
    assert abs(loss - jres.final_loss) <= 1e-3 * abs(jres.final_loss)


# -- the world's collectives in a two-process child ---------------------------

_WORLD_CHILD = r"""
import dataclasses, sys
import torch
from ewdml_tpu_torch.core.config import from_args
from ewdml_tpu_torch.core.world import LocalWorld, ProcessWorld, build_world
from ewdml_tpu_torch.ops.qsgd import QSGDPayload
from ewdml_tpu_torch.parallel import launcher
from ewdml_tpu_torch.train.loop import Trainer

info = launcher.initialize(platform="cpu")
p = info["process_index"]
assert info == {"process_index": p, "process_count": 2, "local_devices": 1,
                "global_devices": 2}, info
assert launcher.is_coordinator() == (p == 0) and launcher.backend() == "gloo"
world = build_world(4, 2, "cpu")
assert isinstance(world, ProcessWorld) and world.size == 4
assert list(world.ranks) == [2 * p, 2 * p + 1] and list(world.slices) == [p]
assert isinstance(world.ici(p), LocalWorld)
dcn = world.dcn(0)
assert list(dcn.ranks) == [p] and dcn.local_members == (2 * p,)
for bad in (lambda: world.ici(1 - p), lambda: world.ppermute([0, 1])):
    try:
        bad()
    except (ValueError, NotImplementedError):
        pass
    else:
        raise AssertionError("no refusal")

def value(r, dtype):
    return (torch.arange(6, dtype=torch.float32) * (r + 1) - 7).to(dtype)

# Raw bytes: every dtype gathers exactly, in rank order.
for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.bool):
    got = world.all_gather([value(r, dtype) for r in world.ranks])
    assert torch.equal(got, torch.stack([value(r, dtype) for r in range(4)]))
pay = [QSGDPayload(levels=value(r, torch.int8), norm=torch.tensor(r + 0.5),
                   shape=(6,), s=127) for r in world.ranks]
got = world.all_gather(pay)
assert torch.equal(got.levels, torch.stack([value(r, torch.int8)
                                            for r in range(4)]))
assert torch.equal(got.norm, torch.arange(4) + 0.5) and got.shape == (6,)
vals = [value(r, torch.float32) for r in range(4)]
assert torch.equal(world.pmean(vals[2 * p:2 * p + 2]),
                   LocalWorld(4, "cpu").pmean(vals))
staged = world.gather_bytes
assert staged == 2 * (24 + 12 + 6 + 6) + 2 * (6 + 4) + 2 * 24, staged
assert torch.equal(world.gather_rows(torch.full((2, 3), float(p))),
                   torch.tensor([0.0, 1.0]).repeat_interleave(6).reshape(4, 3))
assert world.gather_bytes == staged
got = world.broadcast([value(3 * p, torch.float32), torch.tensor(p == 1)], 3)
assert torch.equal(got[0], value(3, torch.float32)) and bool(got[1])

# The trainer's staged bytes a step: L payloads a unit (flat M4), the one
# slice average a unit over DCN (2 x 2, slice = process).
for flags, rows in ((["--method", "4"], "up"),
                    (["--method", "5", "--error-feedback",
                      "--num-slices", "2"], "dcn")):
    cfg = from_args(["--platform", "cpu", "--network", "LeNet", "--dataset",
                     "mnist10k", "--batch-size", "8", "--no-bf16",
                     "--num-workers", "4", "--max-steps", "2",
                     "--eval-freq", "0", *flags])
    t = Trainer(cfg)
    t.train()
    plan = t.wire
    per_worker = (plan.up_bytes if rows == "up" else
                  sum(v for k, v in plan.per_layer_up.items()
                      if k.startswith("dcn/")))
    assert t.world.gather_bytes == 2 * 2 * per_worker, (
        flags, t.world.gather_bytes, per_worker)
print("WORLD_OK", p, flush=True)
launcher.shutdown()
"""


def test_process_world_gathers_in_rank_order(tmp_path):
    """bit: in a two-process gloo world, gathers of every dtype and of a
    payload are the emulated stacks, the mean is ``LocalWorld.pmean``'s,
    a broadcast moves the bytes, and the trainer stages ``wire_plan``'s
    bytes a step (flat M4, and the DCN rows of the pod shape)."""
    outs = _finish(_cluster(tmp_path, 2, [], script=_WORLD_CHILD), "world")
    for p, out in enumerate(outs):
        assert f"WORLD_OK {p}" in out, out[-2000:]


# -- the launcher and the layout, in process ---------------------------------

def test_initialize_without_an_environment_is_a_no_op(monkeypatch):
    for name in _DIST_ENV:
        monkeypatch.delenv(name, raising=False)
    info = launcher.initialize(platform="cpu")
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 1, "global_devices": 1}
    assert not launcher.is_initialized()
    assert launcher.is_coordinator() and launcher.device_index() is None
    launcher.shutdown()   # a no-op too


@pytest.mark.parametrize("args,want", [
    (("cpu",), "gloo"),
    (("cuda", None, 1, 1), "nccl"),
    (("cuda", None, 4, 8), "nccl"),
    (("cuda", "gloo", 2, 1), "gloo"),
])
def test_backend_resolution(args, want):
    assert launcher.resolve_backend(*args) == want


def test_nccl_refused_where_processes_outnumber_cards():
    with pytest.raises(RuntimeError, match='backend="gloo"'):
        launcher.resolve_backend("cuda", None, 2, 1)
    with pytest.raises(RuntimeError, match="2 processes share"):
        launcher.resolve_backend("cuda", "nccl", 2, 1)
    with pytest.raises(ValueError, match="needs CUDA"):
        launcher.resolve_backend("cpu", "nccl")


@pytest.mark.parametrize("size,slices,nprocs,ranks,held,ici,dcn", [
    (4, 1, 2, [[0, 1], [2, 3]], [[0], [0]], (), ()),
    (4, 2, 2, [[0, 1], [2, 3]], [[0], [1]], (), ()),
    (8, 4, 2, [[0, 1, 2, 3], [4, 5, 6, 7]], [[0, 1], [2, 3]], (), ()),
    (4, 2, 4, [[0], [1], [2], [3]], [[0], [0], [1], [1]],
     ((0, 1), (2, 3)), ((0, 2), (1, 3))),
    (12, 2, 6, [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [10, 11]],
     [[0], [0], [0], [1], [1], [1]], ((0, 1, 2), (3, 4, 5)),
     ((0, 3), (1, 4), (2, 5))),
])
def test_process_layout(size, slices, nprocs, ranks, held, ici, dcn):
    """bit: process p holds ``[p·L, (p+1)·L)``, linear major to minor;
    whole slices stay in a process, a slice over processes has its group
    and each position its DCN group."""
    for p in range(nprocs):
        lay = process_layout(size, slices, p, nprocs)
        assert list(lay.ranks) == ranks[p]
        assert list(lay.slices) == held[p]
        assert lay.ici_groups == ici and lay.dcn_groups == dcn


@pytest.mark.parametrize("size,slices,nprocs,match", [
    (6, 1, 4, "not a multiple of the 4 processes"),
    (12, 2, 3, "neither lies whole in a process"),
    (12, 3, 2, "neither lies whole in a process"),
    (4, 3, 2, "does not divide"),
])
def test_process_layout_refusals(size, slices, nprocs, match):
    with pytest.raises(ValueError, match=match):
        process_layout(size, slices, 0, nprocs)


def _as_cluster(monkeypatch, nprocs):
    monkeypatch.setattr(launcher, "is_initialized", lambda: True)
    monkeypatch.setattr(launcher, "process_count", lambda: nprocs)


def test_adapt_refused_across_processes_as_in_jax(tmp_path, monkeypatch):
    """bit: the ``--adapt`` refusal word for word against the JAX
    Trainer's at a process count of 2; one process keeps it."""
    kw = dict(network="LeNet", dataset="mnist10k", adapt="variance",
              method=5, batch_size=8, bf16_compute=False)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(ValueError) as jerr:
        JTrainer(JConfig(train_dir=str(tmp_path) + "/", **kw))
    _as_cluster(monkeypatch, 2)
    with pytest.raises(ValueError) as terr:
        ttrainer.check_supported(TrainConfig(platform="cpu", **kw))
    assert str(terr.value) == str(jerr.value)
    _as_cluster(monkeypatch, 1)
    ttrainer.check_supported(TrainConfig(platform="cpu", **kw))


@pytest.mark.parametrize("kw,match", [
    (dict(method=5, gather_type="ring"), "--gather-type ring in a multi"),
    (dict(method=4, gather_type="ring_rs"), "--gather-type ring_rs in a"),
    (dict(method=3, collective="fused_q"), "--collective fused_q in a"),
    (dict(method=4, overlap="bucket"), "--overlap bucket in a"),
    (dict(method=4, feed="device", scan_window=4), "--scan-window 4 in a"),
])
def test_multi_process_refusals(monkeypatch, kw, match):
    """The options whose ring shift (or captured collectives) across
    processes is a later slice, refused by name with their ROADMAP item;
    outside a cluster each is accepted."""
    cfg = TrainConfig(platform="cpu", network="LeNet", dataset="mnist10k",
                      **kw)
    ttrainer.check_supported(cfg)
    _as_cluster(monkeypatch, 2)
    with pytest.raises(NotImplementedError, match=match) as err:
        ttrainer.check_supported(cfg)
    assert "ROADMAP Queue 1 item 3b" in str(err.value)


def test_auto_scan_window_is_one_in_a_cluster(monkeypatch):
    cfg = TrainConfig(platform="cpu", network="LeNet", dataset="mnist10k",
                      method=4, feed="device")
    assert tconfig.resolve_scan_window(cfg) == 8
    _as_cluster(monkeypatch, 2)
    assert tconfig.resolve_scan_window(cfg) == 1
