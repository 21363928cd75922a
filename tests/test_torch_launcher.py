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
  order; the ring transports shift the same bytes between processes that
  the emulated ring moves between workers), under the gather and ring
  transports, ``fused_q``, bucketed overlap and scan windows; a resume
  continues byte-equal; the world's gathers and staged bytes
  (``gather_bytes`` against ``wire_plan``'s rows) in a two-process child;
  its ring shift against ``LocalWorld.ppermute`` and its two byte
  counters, and Method 6's adoption against the emulated world's, in a
  three-process child; the rank layout, the ``--adapt`` refusal word for
  word against the JAX package's, and the auto scan window against the
  JAX package's.
- tolerance plus bounded flips (``test_torch_slice.py``): the two-process
  M4 runs (gather and fused ``ring_rs``) against the JAX ``Trainer`` on 4
  CPU devices from the same initial state, the final loss within 1e-3
  relative.
"""

import os
import subprocess
import sys
import uuid

import jax
import numpy as np
import pytest
import torch

from ewdml_tpu.core import config as jconfig
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
    # The ring transports: every hop of a process's boundary ranks crosses
    # to the next process. The fused ring (blockwise int8 wire), then the
    # generic one (per-tensor M2).
    "ring_rs_fused": (2, ["--num-workers", "4", "--method", "4",
                          "--qsgd-block", "4096", "--gather-type",
                          "ring_rs"]),
    "ring_rs_m2": (2, ["--num-workers", "4", "--method", "2",
                       "--gather-type", "ring_rs"]),
    # One worker a process: every hop crosses, K-of-N 3 of the 4 origins.
    "ring_k3_every_hop_crosses": (4, ["--num-workers", "4", "--method", "5",
                                      "--gather-type", "ring",
                                      "--num-aggregate", "3"]),
    "fused_q": (2, ["--num-workers", "4", "--method", "3", "--collective",
                    "fused_q"]),
    "overlap_bucket_ef": (2, ["--num-workers", "4", "--method", "4",
                              "--error-feedback", "--overlap", "bucket",
                              "--overlap-buckets", "4"]),
    "scan_window": (2, ["--num-workers", "4", "--method", "4", "--feed",
                        "device", "--scan-window", "4", "--max-steps", "8",
                        "--eval-freq", "8"]),
    # The auto window is the sync period (20), as in the JAX package; the
    # 21 steps are one window and a tail step.
    "m6_auto_window": (3, ["--num-workers", "3", "--method", "6", "--feed",
                           "device", "--max-steps", "21", "--eval-freq",
                           "21"]),
}
#: What a case's coordinator prints on its start line.
STARTS = {
    "scan_window": "scan window: 4 steps per host launch (a loop on the "
                   "CPU)",
    "m6_auto_window": "scan window: 20 steps per host launch (a loop on "
                      "the CPU)",
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
    if case in STARTS:
        assert STARTS[case] in outs[0] and STARTS[case] in local


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


def _against_jax(tmp_path, cfg: dict, flags: list) -> None:
    """The port's P = 2 x L = 2 LeNet run of ``cfg`` (``flags`` on the
    command line) against the JAX Trainer on 4 CPU devices, both from the
    JAX Trainer's initial state (the port's step-0 checkpoint): bounded
    flips, and the final loss within 1e-3 relative."""
    jt = JTrainer(JConfig(train_dir=_train_dir(tmp_path, "jax"), **cfg))
    w0 = worker_slice(jt.state)
    init = jax.tree.map(np.asarray, w0.params)
    pdir = _train_dir(tmp_path, "procs")
    jckpt.save(pdir, w0, 0)
    jres = jt.train()
    argv = ["--platform", "cpu", "--network", "LeNet", "--dataset",
            "mnist10k", "--batch-size", "8", "--lr", "0.01", "--max-steps",
            "3", "--epochs", "100", "--eval-freq", "3", "--log-every",
            "1000", "--no-bf16", "--num-workers", "4", "--seed", "42",
            *flags, "--train-dir", pdir]
    outs = _finish(_cluster(tmp_path, 2, argv), "jax pair")
    loss = float(_summary(outs[0]).split("loss=")[1].split()[0])
    tt = Trainer(TrainConfig(platform="cpu", train_dir=pdir, **cfg))
    assert tt.maybe_restore() and tt.state.step == 3
    jparams = [jax.tree.map(lambda x, w=w: np.asarray(x[w]),
                            jt.state.worker.params) for w in range(4)]
    tparams = [torch_to_flax(ws.model)[0] for ws in tt.state.workers]
    check_with_flips(Pair(jt, tt, jres, None, jparams, tparams, init))
    assert abs(loss - jres.final_loss) <= 1e-3 * abs(jres.final_loss)


def test_two_processes_match_the_jax_trainer(tmp_path, jax_twins):
    """tolerance plus bounded flips: M4 on the gather transport (the JAX
    two-process cluster of ``tests/test_launcher.py`` equals the JAX
    Trainer on 4 devices)."""
    _against_jax(tmp_path, dict(SLICE_BASE, method=4, eval_freq=3),
                 ["--pallas", "interpret", "--method", "4"])


def test_two_processes_ring_rs_match_the_jax_trainer(tmp_path):
    """tolerance plus bounded flips: M4 on the fused ``ring_rs`` ring
    (``--qsgd-block 4096``), its hops crossing between the two processes,
    against the JAX ring over the 4-device mesh, both under ``--pallas
    auto`` as ``test_torch_slice_ring_rs.py`` runs them."""
    _against_jax(tmp_path, dict(SLICE_BASE, method=4, eval_freq=3,
                                gather_type="ring_rs", qsgd_block=4096,
                                pallas="auto"),
                 ["--method", "4", "--gather-type", "ring_rs",
                  "--qsgd-block", "4096"])


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
try:
    world.ici(1 - p)
except ValueError:
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


# -- the ring shift and the adoption in a three-process child -----------------

_RING_CHILD = r"""
import torch
from ewdml_tpu_torch.core.world import (LocalWorld, ProcessWorld,
                                        build_world, value_nbytes)
from ewdml_tpu_torch.ops.qsgd import QSGDPayload
from ewdml_tpu_torch.parallel import collectives, launcher

info = launcher.initialize(platform="cpu")
p = info["process_index"]
world = build_world(6, 1, "cpu")
assert isinstance(world, ProcessWorld) and list(world.ranks) == [2 * p,
                                                                 2 * p + 1]

def pay(r):
    # An odd number of int8 levels before f32 norms: a field of the packed
    # buffer off its alignment.
    return QSGDPayload(levels=(torch.arange(5) * (r + 1) - 3).to(torch.int8),
                       norm=torch.tensor([r + 0.25, -r - 0.5]), shape=(5,),
                       s=127, block=None)

def pair(r):
    # The fused ring's (levels, norms) tuple, bf16 norms.
    return ((torch.arange(3) - r).to(torch.int8),
            torch.tensor([r * 1.5], dtype=torch.bfloat16))

emulated = LocalWorld(6, "cpu")
sent = 0
for make in (pay, pair):
    every = [make(r) for r in range(6)]
    per_value = value_nbytes(every[0])
    for shift in (1, 5):
        before = world.ppermute_bytes
        got = world.ppermute([make(r) for r in world.ranks], shift)
        want = emulated.ppermute(every, shift)[2 * p:2 * p + 2]
        for g, w in zip(got, want):
            if make is pay:
                assert torch.equal(g.levels, w.levels)
                assert torch.equal(g.norm, w.norm)
                assert (g.shape, g.s, g.block) == (w.shape, w.s, w.block)
            else:
                assert all(torch.equal(a, b) for a, b in zip(g, w))
        # What one rank received; one value crosses to a neighbour.
        assert world.ppermute_bytes - before == per_value
        sent += per_value
        assert world.sent_bytes == sent, (world.sent_bytes, sent)
assert world.gather_bytes == 0

# Method 6's adoption: the gathered candidates' best row, as the emulated
# world's stack-and-select of all six workers' leaves, ties to the first.
losses = torch.tensor([3.0, 2.0, 5.0, 1.0, 1.0, 4.0])
def leaves(r):
    return [torch.full((2, 3), float(r)), torch.arange(4.0) * r]
a = collectives.adopt_best_worker([leaves(r) for r in world.ranks], losses,
                                  world)
b = collectives.adopt_best_worker([leaves(r) for r in range(6)], losses,
                                  emulated)
assert all(torch.equal(x, y) for x, y in zip(a, b))
assert torch.equal(a[0], torch.full((2, 3), 3.0))
assert world.gather_bytes == 0
print("RING_OK", p, flush=True)
launcher.shutdown()
"""


def test_process_world_ring_shift_in_rank_order(tmp_path):
    """bit: in a three-process gloo world of W = 6, ``ppermute`` moves a
    payload dataclass and a tuple of tensors as ``LocalWorld.ppermute``
    does, at shift 1 and W - 1, with ``ppermute_bytes`` the bytes one rank
    received and ``sent_bytes`` those sent across processes; Method 6's
    adoption equals the emulated world's."""
    outs = _finish(_cluster(tmp_path, 3, [], script=_RING_CHILD), "ring")
    for p, out in enumerate(outs):
        assert f"RING_OK {p}" in out, out[-2000:]


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


def test_auto_scan_window_matches_jax_in_and_out_of_a_cluster(monkeypatch):
    """bit: the auto window (and an explicit one) is the JAX package's
    ``resolve_scan_window``, the same inside a cluster as outside it (it
    was 1 in a cluster until the windows ran across processes)."""
    kws = [dict(method=4, feed="device"), dict(method=6, feed="device"),
           dict(method=4, feed="device", log_every=3),
           dict(method=4, feed="device", scan_window=4),
           dict(method=4, feed="u8")]
    for nprocs in (1, 2):
        if nprocs > 1:
            _as_cluster(monkeypatch, nprocs)
        for kw in kws:
            cfg = dict(network="LeNet", dataset="mnist10k", **kw)
            want = jconfig.resolve_scan_window(JConfig(**cfg))
            assert tconfig.resolve_scan_window(
                TrainConfig(platform="cpu", **cfg)) == want, (nprocs, kw)
    assert tconfig.resolve_scan_window(TrainConfig(
        platform="cpu", network="LeNet", dataset="mnist10k", method=6,
        feed="device")) == 20
