"""The run-health watchdog (``obs/health.py``), the ``nan@`` fault clause and
``--health warn|abort`` on the sync trainer, the async parameter server,
the CLI and the reproduction runner, against the JAX package's.

Oracles:
- exact (against the JAX package): the same loss and gradient-norm
  sequences into both watchdogs give the same events, ``(kind, step)`` and
  every ``health.jsonl`` field but the time stamp (a healthy loss drop
  reads as a spike in both); ``nan_due`` on the same
  clauses; the fence step at which a LeNet trainer with ``nan@0=N`` aborts;
  the constructor's rejection of an unknown mode.
- exact (behaviour, the port alone): the latch of one event per episode,
  a spike only after warm-up, a stall under a short deadline and none
  while idle, a torn last line skipped, counters in the registry passed
  in; ``--health warn`` leaves a run bit-equal to ``--health off`` (the
  clause poisons only the observed loss); a resumed run is not
  re-poisoned; an async abort stops the other workers before their step
  budget; the CLI exits 76 on both paths; the runner journals an abort as
  a retryable cell event and the next attempt completes the cell.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from ewdml_tpu.obs import health as jhealth
from ewdml_tpu.parallel.faults import FaultSpec as JFaultSpec
from ewdml_tpu_torch import cli
from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.experiments import runner
from ewdml_tpu_torch.obs import health
from ewdml_tpu_torch.obs.registry import MetricsRegistry
from ewdml_tpu_torch.parallel.faults import FaultSpec
from ewdml_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

NAN = float("nan")

# (what, value) observations: warm-up, a spike, its latch, recovery, a NaN
# episode of three, recovery, a second episode, gradient norms with an
# explosion and a non-finite one.
SEQUENCE = ([("loss", 1.0 + 0.01 * i) for i in range(8)]
            + [("loss", 50.0), ("loss", 60.0), ("loss", 1.1)]
            + [("loss", NAN)] * 3 + [("loss", 1.05), ("loss", float("inf"))]
            + [("grad", 1.0)] * 6 + [("grad", 500.0), ("grad", 600.0),
                                     ("grad", 1.0), ("grad", NAN)])


def _feed(w, sequence):
    for step, (what, v) in enumerate(sequence):
        (w.observe_loss if what == "loss" else w.observe_grad_norm)(step, v)


def _fields(path):
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in health.read_events(path)]


def test_events_equal_the_reference(tmp_path):
    jp, tp = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    reg = MetricsRegistry()
    jw = jhealth.HealthWatchdog("warn", role="r", path=jp)
    tw = health.HealthWatchdog("warn", role="r", path=tp, registry=reg)
    _feed(jw, SEQUENCE)
    _feed(tw, SEQUENCE)
    assert _fields(tp) == _fields(jp)
    kinds = [(e["kind"], e["step"]) for e in _fields(tp)]
    assert kinds == [("spike", 8), ("nan", 11), ("nan", 15),
                     ("grad_norm", 22), ("nan", 25)]
    counters = reg.snapshot()["counters"]
    assert counters["health.spike"] == 1 and counters["health.nan"] == 3
    assert counters["health.grad_norm"] == 1 and counters["health.stall"] == 0
    assert tw.events_emitted == jw.events_emitted == 5
    assert (health.HEALTH_EXIT_CODE, health.MODES, health.KINDS) == (
        jhealth.HEALTH_EXIT_CODE, jhealth.MODES, jhealth.KINDS)
    for mod in (health, jhealth):
        with pytest.raises(ValueError, match="--health must be one of"):
            mod.HealthWatchdog("loud")


@pytest.mark.parametrize("mode", ["warn", "abort"])
def test_abort_raises_where_the_reference_does(mode):
    got = []
    for mod in (jhealth, health):
        w = mod.HealthWatchdog(mode, role="r")
        try:
            _feed(w, SEQUENCE)
            got.append(None)
        except mod.HealthAbort as e:
            got.append((e.kind, e.step, e.detail, w.aborted["kind"]))
    assert got[0] == got[1]
    assert got[1] == (None if mode == "warn" else
                      ("spike", 8, got[0][2], "spike"))


# The losses a healthy VGG11-BN async run (W = K = 4, batch 128, lr 0.01)
# shows the server as (version, loss): four pushes and a stale one near
# 3.3 at versions 0-1, then the first push on the updated weights, lower.
HEALTHY_DROP = [(0, 3.41), (0, 3.22), (0, 3.36), (0, 3.28), (1, 3.35),
                (1, 2.4272), (1, 2.41), (2, 2.05)]


@pytest.mark.parametrize("mode", ["warn", "abort"])
def test_a_healthy_loss_drop_reads_as_a_spike_in_both(mode, tmp_path):
    """Reference behaviour (ROADMAP Queue 3): the z-score is two-sided and
    the EMA variance after a five-push warm-up is small, so the first
    update's loss drop is a spike, and ``--health abort`` stops a healthy
    async run at lr 0.01. Both packages agree; a fix in either shows
    here."""
    got = []
    for name, mod in (("j", jhealth), ("t", health)):
        p = str(tmp_path / f"{name}.jsonl")
        w = mod.HealthWatchdog(mode, role="ps-server", path=p)
        try:
            for step, loss in HEALTHY_DROP:
                w.observe_loss(step, loss)
            verdict = None
        except mod.HealthAbort as e:
            verdict = (e.kind, e.step)
        got.append((verdict, _fields(p)))
    assert got[0] == got[1]
    verdict, events = got[1]
    assert [(e["kind"], e["step"], e["value"]) for e in events] == [
        ("spike", 1, 2.4272)]
    assert events[0]["value"] < min(v for _, v in HEALTHY_DROP[:5])
    assert verdict == (None if mode == "warn" else ("spike", 1))


def test_latch_and_spike_after_warmup(tmp_path):
    p = str(tmp_path / "h.jsonl")
    w = health.HealthWatchdog("warn", role="t", path=p, warmup=5)
    # A jump inside the warm-up is no spike.
    for step, v in enumerate([1.0, 1.0, 50.0, 1.0, 1.0]):
        w.observe_loss(step, v)
    assert health.read_events(p) == []
    for step in range(5, 55):          # one NaN episode of 50 pushes
        w.observe_loss(step, NAN)
    w.observe_loss(55, 1.0)             # re-arms the latch
    w.observe_loss(56, NAN)
    assert [(e["kind"], e["step"]) for e in health.read_events(p)] == [
        ("nan", 5), ("nan", 56)]
    # A constant history has zero variance: a float tick is noise, a jump
    # after the warm-up is a spike.
    w = health.HealthWatchdog("warn", role="t")
    for step in range(10):
        w.observe_loss(step, 0.0)
    w.observe_loss(10, 1e-5)
    assert w.registry.snapshot()["counters"]["health.spike"] == 0
    w.observe_loss(11, 5.0)
    assert w.registry.snapshot()["counters"]["health.spike"] == 1


def _wait_for(path, n, timeout=5.0):
    deadline = time.monotonic() + timeout
    while len(health.read_events(path)) < n and time.monotonic() < deadline:
        time.sleep(0.02)
    return health.read_events(path)


def test_stall_and_idle(tmp_path):
    p = str(tmp_path / "h.jsonl")
    w = health.HealthWatchdog("warn", role="t", path=p,
                              stall_deadline_s=0.1)
    assert [e["kind"] for e in _wait_for(p, 1)] == ["stall"]
    time.sleep(0.2)
    assert len(health.read_events(p)) == 1   # one event per episode
    w.heartbeat(0)                             # progress re-arms it
    assert len(_wait_for(p, 2)) == 2
    w.set_idle(True)
    time.sleep(0.3)
    assert len(health.read_events(p)) == 2   # idle: no deadline
    assert w._stall_thread is None            # and no detector thread
    w.set_idle(False)
    assert [e["kind"] for e in _wait_for(p, 3)] == ["stall"] * 3
    w.close()


def test_torn_tail_and_factory(tmp_path):
    p = tmp_path / "health.jsonl"
    p.write_text(json.dumps({"kind": "nan"}) + "\n\n" + '{"kind": "sp')
    assert health.read_events(str(p)) == jhealth.read_events(str(p)) == [
        {"kind": "nan"}]
    assert health.read_events(str(tmp_path / "none.jsonl")) == []
    cfg = TrainConfig(train_dir=str(tmp_path))
    assert health.make_watchdog(cfg, role="x") is None
    cfg.health = "abort"
    reg = MetricsRegistry()
    w = health.make_watchdog(cfg, role="x", registry=reg)
    assert w.path == str(p) and w.mode == "abort" and w.registry is reg


@pytest.mark.parametrize("spec", ["nan@1=3,nan@1=5,delay@0=2", "nan@0=0",
                                  "crash@2=4"])
def test_nan_due_matches(spec):
    for worker in range(3):
        jw, tw = (JFaultSpec.parse(spec).for_worker(worker),
                  FaultSpec.parse(spec).for_worker(worker))
        assert tw.nan_at == jw.nan_at
        assert [tw.nan_due(s) for s in range(7)] == [jw.nan_due(s)
                                                     for s in range(7)]


# -- the sync trainer ------------------------------------------------------

TINY = dict(network="LeNet", dataset="MNIST", batch_size=4, lr=0.01,
            compress_grad="none", synthetic_data=True, synthetic_size=64,
            max_steps=8, epochs=10**6, eval_freq=0, log_every=3,
            bf16_compute=False, num_workers=2, seed=3)


def _state(trainer):
    return [p.detach().clone() for ws in trainer.state.workers
            for p in ws.model.parameters()]


def test_trainer_abort_fence_matches_the_reference(tmp_path):
    from ewdml_tpu.core.config import TrainConfig as JConfig
    from ewdml_tpu.train.loop import Trainer as JTrainer

    steps = {}
    for name, make in (("jax", lambda d: JTrainer(JConfig(**d))),
                       ("port", lambda d: Trainer(TrainConfig(
                           platform="cpu", **d)))):
        d = str(tmp_path / name)
        t = make(dict(TINY, health="abort", fault_spec="nan@0=4",
                      train_dir=d))
        with pytest.raises(Exception) as ei:
            t.train()
        assert type(ei.value).__name__ == "HealthAbort"
        steps[name] = (ei.value.kind, ei.value.step)
        assert [(e["kind"], e["step"]) for e in
                health.read_events(os.path.join(d, "health.jsonl"))] == [
            steps[name]]
    # Fences at 0, 3, 6: the one covering step 4 is 6.
    assert steps["port"] == steps["jax"] == ("nan", 6)


def test_windowed_abort_within_one_window(tmp_path):
    t = Trainer(TrainConfig(platform="cpu", train_dir=str(tmp_path),
                            **dict(TINY, health="abort",
                                   fault_spec="nan@0=5", feed="device",
                                   scan_window=4, log_every=100)))
    with pytest.raises(health.HealthAbort) as ei:
        t.train()
    # Windows 0-3 and 4-7: the read after the second covers step 5.
    assert (ei.value.kind, ei.value.step) == ("nan", 7)
    assert t.metrics.snapshot()["counters"]["health.nan"] == 1
    assert t._health._idle   # train() left the deadline suspended


@pytest.mark.parametrize("feed,window", [("f32", 1), ("device", 4)],
                         ids=["per_step", "windowed"])
def test_warn_is_bit_equal_to_off(tmp_path, feed, window):
    runs = {}
    for mode in ("off", "warn"):
        t = Trainer(TrainConfig(platform="cpu", train_dir=str(tmp_path / mode),
                                **dict(TINY, health=mode, method=4,
                                       fault_spec="nan@0=2", feed=feed,
                                       scan_window=window)))
        res = t.train()
        assert res.steps == TINY["max_steps"] and np.isfinite(res.final_loss)
        runs[mode] = (_state(t), res.rows)
        if mode == "warn":
            assert t.metrics.snapshot()["counters"]["health.nan"] == 1
        else:
            assert t._health is None
    for a, b in zip(runs["off"][0], runs["warn"][0]):
        assert torch.equal(a, b)
    assert np.array_equal(runs["off"][1], runs["warn"][1])


def test_resumed_run_is_not_repoisoned(tmp_path):
    cfg = TrainConfig(platform="cpu", train_dir=str(tmp_path),
                      **dict(TINY, health="warn", fault_spec="nan@0=1",
                             log_every=2, eval_freq=4))
    t1 = Trainer(cfg)
    t1.train(max_steps=4)     # the fence at 2 covers step 1: one episode
    assert t1.metrics.snapshot()["counters"]["health.nan"] == 1
    t2 = Trainer(cfg)
    assert t2.maybe_restore() and t2.state.step == 4
    t2.train()
    assert t2.metrics.snapshot()["counters"]["health.nan"] == 0
    assert len(health.read_events(str(tmp_path / "health.jsonl"))) == 1


def test_cli_sync_abort_exits_76(tmp_path, capsys):
    rc = cli.main(["--platform", "cpu", "--network", "LeNet", "--dataset",
                   "MNIST", "--synthetic-data", "--synthetic-size", "64",
                   "--num-workers", "2", "--batch-size", "4", "--max-steps",
                   "6", "--log-every", "2", "--no-bf16", "--fault-spec",
                   "nan@0=3", "--health", "abort", "--train-dir",
                   str(tmp_path)])
    assert rc == health.HEALTH_EXIT_CODE == 76
    assert "HEALTH_ABORT kind=nan step=4" in capsys.readouterr().out


# -- the async parameter server ----------------------------------------------

ASYNC = ["--mode", "async", "--platform", "cpu", "--network", "LeNet",
         "--dataset", "MNIST", "--synthetic-data", "--synthetic-size", "128",
         "--num-workers", "3", "--num-aggregate", "3", "--batch-size", "4",
         "--lr", "0.001", "--compress-grad", "none"]


def test_async_abort_stops_the_other_workers(tmp_path):
    from ewdml_tpu_torch.core.config import from_args

    cfg = from_args(ASYNC + ["--max-steps", "300", "--fault-spec", "nan@1=2",
                             "--health", "abort", "--train-dir",
                             str(tmp_path)])
    reg = MetricsRegistry()
    run = cli.build_async(cfg, registry=reg)
    server, workers = run.server, run.workers
    watchdog = server.health
    # What the program guarantees in any thread order (the workers are
    # threads, so how many pushes land before the verdict is timing):
    # every push call per worker, and the pushes counted when the verdict
    # is set, read under the lock that counts them.
    calls = {w.index: 0 for w in workers}
    at_verdict = []
    push, emit = server.push, watchdog._emit

    def counted_push(record, retried=False):
        calls[record.worker] += 1
        return push(record, retried)

    def noted_emit(*a, **kw):
        try:
            emit(*a, **kw)
        finally:
            if watchdog.aborted is not None and not at_verdict:
                with server._lock:
                    at_verdict.append(server.stats.pushes)

    server.push, watchdog._emit = counted_push, noted_emit
    with pytest.raises(health.HealthAbort) as ei:
        run.run()
    assert ei.value.kind == "nan"
    assert watchdog.aborted["kind"] == "nan"
    assert all(not w.is_alive() for w in workers)
    # No push is counted after the verdict.
    assert at_verdict == [server.stats.pushes]
    # Worker 1 pushed steps 0, 1 and its NaN step 2, which raised; every
    # worker stopped before its budget of 300 / 3 steps.
    assert calls[1] == 3 and isinstance(workers[1].exc, health.HealthAbort)
    assert all(c < 100 for c in calls.values())
    assert reg.snapshot()["counters"]["health.nan"] >= 1
    kinds = [e["kind"] for e in
             health.read_events(str(tmp_path / "health.jsonl"))]
    assert kinds[0] == "nan"


def test_async_cli_abort_exits_76_and_warn_completes(tmp_path, capsys):
    base = ASYNC + ["--max-steps", "9", "--fault-spec", "nan@1=1"]
    assert cli.main(base + ["--health", "abort", "--train-dir",
                            str(tmp_path / "a")]) == 76
    assert "HEALTH_ABORT kind=nan" in capsys.readouterr().out
    assert cli.main(base + ["--health", "warn", "--train-dir",
                            str(tmp_path / "w")]) == 0
    assert "async done: pushes=9 updates=3" in capsys.readouterr().out
    assert [e["kind"] for e in health.read_events(
        str(tmp_path / "w" / "health.jsonl"))] == ["nan"]


# -- the reproduction runner ---------------------------------------------------

def test_runner_journals_an_abort_as_a_retry(tmp_path):
    """One CPU child: the nan clause aborts the cell's first attempt with
    exit 76, journaled as a retry whose reason starts ``health_abort``;
    the second attempt, run in process, completes the cell."""
    out = str(tmp_path / "repro")
    summary = runner.run_sweep(
        "baseline", out_dir=out, smoke=True, platform="cpu",
        cells=["lenet_mnist/m1"], fault_spec="nan@0=2", health="abort",
        attempts=1, write_report=False)
    assert summary["failed"] == ["lenet_mnist/m1"], summary
    events = runner.Ledger(os.path.join(out, "ledger.jsonl")).events()
    retries = [e for e in events if e["event"] == "cell_retry"]
    assert len(retries) == 1
    assert retries[0]["reason"].startswith("health_abort rc=76"), retries
    assert "CELL_HEALTH_ABORT lenet_mnist/m1 kind=nan" in retries[0]["reason"]
    assert any(e["event"] == "sweep_start" and e["health"] == "abort"
               for e in events)
    cell_dir = runner.cell_dirs(out, "lenet_mnist/m1")
    assert [e["kind"] for e in health.read_events(
        os.path.join(cell_dir, "health.jsonl"))] == ["nan"]
    # The retry does not re-arm the clause: the cell completes.
    rc = runner.run_cell_child(
        "baseline", "lenet_mnist/m1", out_dir=out, data_dir="data/",
        smoke=True, platform="cpu", fault_spec="nan@0=2", attempt=2,
        health="abort")
    assert rc == 0
