"""The port's trace layer, metrics registry and flags (``obs/``,
``train/flops.py``, ``utils/timing.py``, ``utils/provenance.py``,
``--trace-dir``, ``--profile-dir``, ``--debug-nans``) against the JAX
package's.

Oracles:
- bit: a port shard and a JAX shard written into one directory merge
  through ``ewdml_tpu/obs/merge.py`` into one timeline (same host: offset
  0), every event kept with its role; ``QuantileHistogram`` gives the JAX
  one's summary (count, sum, min, max, mean, p50/p95/p99) on the same
  samples, merged too; ``absorb_step_timer``/``absorb_ps_stats``/
  ``absorb_policy`` give the JAX registry's snapshot (fresh registries on
  both sides, never the process-global one); ``utils/timing``'s summaries
  equal the JAX package's; ``mfu`` is the JAX formula.
- exact: the span counts of a traced per-step and windowed run, the async
  run's ``ps/*`` and ``worker/grad`` spans, a profiled run's Chrome trace
  holding the ``train/dispatch`` ranges; FLOPs of a LeNet forward pass
  against 2 x its multiply-adds.
- ``--debug-nans`` raises ``FloatingPointError`` naming the step, the
  worker and the leaf of an injected NaN or infinity: in a loss, in a
  parameter after an update (per step and at the end of a window), in an
  async worker's loss.
- ``check_supported`` accepts the three flags and ``--health``; it accepts
  ``--metrics-port`` on the sync path and rejects it by name on the
  in-process async path. A refusal for good (a flag the JAX package
  accepts and ignores there) never says "not ported"; one a later slice
  lifts does.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from ewdml_tpu.obs import hist as jhist
from ewdml_tpu.obs import merge as jmerge
from ewdml_tpu.obs import registry as jregistry
from ewdml_tpu.obs import trace as jtrace
from ewdml_tpu.train import flops as jflops
from ewdml_tpu.utils import timing as jtiming
from ewdml_tpu_torch.cli import run_async
from ewdml_tpu_torch.core.config import TrainConfig, from_args
from ewdml_tpu_torch.obs import hist, registry, trace
from ewdml_tpu_torch.parallel.policy import PolicySnapshot
from ewdml_tpu_torch.parallel.ps import PSStats
from ewdml_tpu_torch.train import flops
from ewdml_tpu_torch.train.loop import Trainer
from ewdml_tpu_torch.train.trainer import check_supported
from ewdml_tpu_torch.utils import provenance, timing

torch.set_num_threads(2)

W = 4


@pytest.fixture(autouse=True)
def _no_tracers():
    trace.shutdown(flush=False)
    jtrace.shutdown(flush=False)
    yield
    trace.shutdown(flush=False)
    jtrace.shutdown(flush=False)


def _cfg(tmp_path, **kw):
    base = dict(network="LeNet", dataset="MNIST", batch_size=4, lr=0.01,
                synthetic_data=True, synthetic_size=64, max_steps=6,
                epochs=1000, log_every=1000, bf16_compute=False,
                num_workers=W, platform="cpu", method=4, eval_freq=3,
                train_dir=str(tmp_path / "ckpt") + "/")
    base.update(kw)
    return TrainConfig(**base)


def _events(trace_dir):
    (shard,) = jmerge.load_shards(str(trace_dir))
    return shard["events"]


def _count(events, kind=None):
    out = {}
    for e in events:
        if kind is None or e["kind"] == kind:
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


# -- the shard and the merge ---------------------------------------------------

def test_port_and_jax_shards_merge_into_one_timeline(tmp_path):
    trace.configure(str(tmp_path), role="port-trainer")
    jtrace.configure(str(tmp_path), role="jax-trainer")
    with trace.span("train/checkpoint", step=3):
        jtrace.instant("train/dispatch", step=0)
    trace.instant("train/dispatch", step=1)
    trace.counter("queue", 2)
    trace.complete("train/window", 5, 7, steps=2)
    jtrace.counter("queue", 1)
    trace.set_role("worker-1")
    trace.instant("worker/grad", step=0)
    port_path, jax_path = trace.flush(), jtrace.flush()
    assert os.path.basename(port_path) == f"shard-port-trainer-{os.getpid()}.jsonl"
    with open(port_path) as f:
        meta = json.loads(f.readline())
    with open(jax_path) as f:
        jmeta = json.loads(f.readline())
    assert sorted(meta) == sorted(jmeta) and meta["kind"] == "meta"
    merged = jmerge.merge_dir(str(tmp_path))
    assert len(merged) == 7
    assert [e["ts"] for e in merged] == sorted(e["ts"] for e in merged)
    by_role = _count([dict(e, name=e["role"]) for e in merged])
    assert by_role == {"port-trainer": 4, "jax-trainer": 2, "worker-1": 1}
    port_shard = jmerge.read_shard(port_path)
    assert jmerge.resolve_offset(port_shard["meta"],
                                 jmerge.read_shard(jax_path)["meta"]) == 0
    span = next(e for e in merged if e["name"] == "train/checkpoint")
    assert span["kind"] == "span" and span["dur"] > 0
    assert span["args"] == {"step": 3}


def test_tracing_is_off_by_default():
    assert not trace.enabled()
    assert trace.span("x") is trace.span("y")
    assert trace.flush() is None
    trace.instant("x")
    trace.complete("x", 0, 1)
    trace.counter("x", 1)


# -- histogram, registry, timing, flops ----------------------------------------

def _samples():
    rng = np.random.RandomState(3)
    return list(rng.lognormal(-6, 3, 2000)) + [0.0, -1.0, 1e-12, 1e7,
                                              math.inf, math.nan]


def test_quantile_histogram_equals_the_jax_one():
    a, b = hist.QuantileHistogram(), jhist.QuantileHistogram()
    for v in _samples():
        a.observe(v)
        b.observe(v)
    assert a.summary() == b.summary()
    for q in (0.0, 0.01, 0.5, 0.9, 0.999, 1.0):
        assert a.quantile(q) == b.quantile(q)
    a2, b2 = hist.QuantileHistogram(), jhist.QuantileHistogram()
    for v in _samples()[::7]:
        a2.observe(v * 3)
        b2.observe(v * 3)
    assert a.merge(a2).summary() == b.merge(b2).summary()


def test_registry_absorbers_give_the_jax_snapshot():
    port, ref = registry.MetricsRegistry(), jregistry.MetricsRegistry()
    timing_ = {"compile_s": 1.5, "data_s": 0.25, "step_s": 3.0, "steps": 12,
               "mean_step_ms": 250.0}
    stats = PSStats(pushes=16, updates=4, dropped_stale=1, bytes_up=1000,
                    bytes_down=2000)
    snap = PolicySnapshot(excluded={2: "slow"}, kills_sent=1, contacts=9,
                          members=[0, 1, 2, 3])
    for r in (port, ref):
        r.absorb_step_timer(timing_)
        r.absorb_step_timer(timing_)
        r.absorb_ps_stats(stats)
        r.absorb_policy(snap)
        r.histogram("eval.full_test_s").observe(0.5)
    assert port.snapshot() == ref.snapshot()
    assert set(port.snapshot()["counters"]) == {
        "train.compile_s", "train.data_s", "train.step_s", "train.steps"}


def test_timing_summaries_equal_the_jax_ones():
    a = [3.0, 1.0, 2.5, 9.0, 4.25]
    b = [2.0, 1.5, 2.5, 3.0, 4.0]
    assert timing.summarize(a) == jtiming.summarize(a)
    assert timing.median_iqr(a) == jtiming.median_iqr(a)
    assert timing.paired_ratio(a, b) == jtiming.paired_ratio(a, b)
    calls = []
    ms = timing.timed_windows(lambda: calls.append(1), windows=3, iters=4)
    assert len(ms) == 3 and len(calls) == 12


def test_flops_and_mfu(monkeypatch):
    from ewdml_tpu_torch.models import build_model

    model = build_model("LeNet", 10, dataset="MNIST")
    x = torch.zeros(4, 28, 28, 1)
    # conv1 24*24*20*25, conv2 8*8*50*500, fc1 800*500, fc2 500*10 MACs.
    macs = 24 * 24 * 20 * 25 + 8 * 8 * 50 * 500 + 800 * 500 + 500 * 10
    assert flops.count_flops(model, x) == 2 * macs * 4
    step = flops.count_flops(lambda: model(x).sum().backward())
    assert 2 * 2 * macs * 4 < step < 3 * 2 * macs * 4
    monkeypatch.delenv("EWDML_PEAK_TFLOPS", raising=False)
    assert flops.peak_tflops(torch.device("cpu")) is None
    assert flops.mfu(1e12, 1.0, device=torch.device("cpu")) is None
    assert jflops.mfu(1e12, 1.0) is None
    # The same formula at the same peak: the JAX package's peak from its
    # environment override, the port's from its table.
    monkeypatch.setenv("EWDML_PEAK_TFLOPS", "100")
    monkeypatch.setattr(flops, "peak_tflops", lambda *a, **k: 100.0)
    for args in ((1e12, 0.1), (3e13, 0.25, 4)):
        assert flops.mfu(*args) == jflops.mfu(*args)


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (989.0, 67.0, 3350.0)),
    ("NVIDIA H100 PCIe", (756.0, 51.0, 2000.0)),
    ("NVIDIA A100-SXM4-80GB", (None, None, None)),
])
def test_peaks_from_the_device_name(monkeypatch, name, peaks):
    """Exact: the data-sheet table by device name, None for a card it does
    not hold (no override)."""
    monkeypatch.setattr(flops, "_cuda_name", lambda device: name.lower())
    monkeypatch.setenv("EWDML_PEAK_TFLOPS", "1")
    monkeypatch.setenv("EWDML_PEAK_GBS", "1")
    got = (flops.peak_tflops(bf16=True), flops.peak_tflops(bf16=False),
           flops.hbm_peak_gbs())
    assert got == peaks


def test_provenance_names_the_host():
    p = provenance.hardware_provenance(mesh_devices=4)
    assert p["torch"] == torch.__version__ and p["mesh_devices"] == 4
    if not torch.cuda.is_available():
        assert p["platform"] == "cpu" and p["device_count"] == 0


# -- the traced, profiled and checked loop -------------------------------------

@pytest.mark.parametrize("feed,window", [("u8", 1), ("device", 2)])
def test_trace_dir_records_the_loop_spans(tmp_path, feed, window):
    """6 steps, a checkpoint every 3: the per-step path dispatches 6 times
    and reads back at steps 0, 2, 5 (compile, then two windows); K = 2
    dispatches 3 windows, reads back after each (the first as compile), and
    snaps the saves to steps 4 and 6; each run saves once more at the end
    and evaluates once."""
    t = Trainer(_cfg(tmp_path, feed=feed, scan_window=window,
                     trace_dir=str(tmp_path / "T")))
    t.train()
    t.evaluate()
    trace.flush()
    events = _events(tmp_path / "T")
    saves = [e["args"]["step"] for e in events
             if e["name"] == "train/checkpoint"]
    dispatch = 6 if window == 1 else 3
    assert _count(events) == {"train/dispatch": dispatch, "train/compile": 1,
                              "train/window": 2, "train/checkpoint": 3,
                              "eval/full_test": 1}
    assert saves == ([3, 6, 6] if window == 1 else [4, 6, 6])
    assert {e["role"] for e in events} == {"trainer"}
    assert t.metrics.snapshot()["counters"]["train.steps"] == 5 - (window - 1)


def test_async_trace_holds_the_server_and_worker_spans(tmp_path):
    cfg = from_args(["--mode", "async", "--platform", "cpu", "--network",
                     "LeNet", "--dataset", "MNIST", "--synthetic-data",
                     "--synthetic-size", "64", "--num-workers", "2",
                     "--num-aggregate", "2", "--batch-size", "4",
                     "--max-steps", "4", "--compress-grad", "qsgd",
                     "--server-agg", "homomorphic",
                     "--trace-dir", str(tmp_path / "T")])
    reg = registry.MetricsRegistry()
    _, stats = run_async(cfg, registry=reg)
    gauges = reg.snapshot()["gauges"]
    assert (gauges["ps.pushes"], gauges["ps.updates"]) == (4, 2)
    assert gauges["ps.bytes_up"] == stats.bytes_up > 0
    assert gauges["ps.contacts"] >= 4 and gauges["ps.excluded"] == 0
    events = _events(tmp_path / "T")
    counts = _count(events, "span")
    assert counts["ps/pull"] == counts["ps/push"] == stats.pushes == 4
    assert counts["worker/grad"] == 4 and counts["ps/apply"] == 2
    roles = {e["role"] for e in events if e["name"] == "worker/grad"}
    assert roles == {"worker-0", "worker-1"}


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    t = Trainer(_cfg(tmp_path, max_steps=2, eval_freq=0,
                     profile_dir=str(tmp_path / "P")))
    t.train()
    (name,) = os.listdir(tmp_path / "P")
    with open(tmp_path / "P" / name) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("train/dispatch") == 2


def _poison_after(t, step, leaf):
    """Make the optimizer write inf into worker 1's ``leaf`` at ``step``."""
    update = t.optimizer.update
    calls = {"n": 0}

    def poisoned(grads, state, params):
        update(grads, state, params)
        worker = calls["n"] % W
        if calls["n"] // W == step and worker == 1:
            with torch.no_grad():
                params[leaf].view(-1)[0] = math.inf
        calls["n"] += 1

    t.optimizer.update = poisoned


@pytest.mark.parametrize("case", ["loss", "parameter", "window"])
def test_debug_nans_names_the_step_and_the_leaf(tmp_path, case):
    kw = dict(debug_nans=True, eval_freq=0)
    if case == "window":
        kw.update(feed="device", scan_window=2)
    t = Trainer(_cfg(tmp_path, **kw))
    if case == "loss":
        with torch.no_grad():
            next(t.state.workers[2].model.parameters()).view(-1)[0] = math.nan
        match = r"non-finite loss at step 0 \(worker 2\)"
    else:
        _poison_after(t, 3, 2)   # leaf 2 in JAX order: conv2/bias
        match = ("non-finite parameter conv2/bias after step 3"
                 + (r" \(worker 1\)" if case == "parameter"
                    else r", the end of the window of steps 2-3 \(worker 1\)"))
    with pytest.raises(FloatingPointError, match=match):
        t.train()


def test_debug_nans_in_an_async_worker(tmp_path):
    cfg = from_args(["--mode", "async", "--platform", "cpu", "--network",
                     "LeNet", "--dataset", "MNIST", "--synthetic-data",
                     "--synthetic-size", "64", "--num-workers", "2",
                     "--num-aggregate", "1", "--batch-size", "4",
                     "--max-steps", "4", "--compress-grad", "none",
                     "--lr", "1e30", "--debug-nans"])
    with pytest.raises(FloatingPointError,
                       match=r"non-finite (loss|gradient \S+) at step \d "
                             r"\(async worker \d\)"):
        run_async(cfg)


def test_check_supported_accepts_the_three_flags(tmp_path):
    for async_path in (False, True):
        mode = ["--mode", "async"] if async_path else []
        cfg = from_args(mode + ["--trace-dir", str(tmp_path),
                                "--profile-dir", str(tmp_path),
                                "--debug-nans"])
        check_supported(cfg, async_path=async_path)
        # --health is ported (tests/test_torch_health.py); --metrics-port
        # is served by the sync trainer (tests/test_torch_obs_serve.py)
        # and refused by name, with the reason, on the in-process async
        # path, where the JAX CLI accepts it and arms no exporter.
        check_supported(from_args(mode + ["--health", "warn"]),
                        async_path=async_path)
        metrics = from_args(mode + ["--metrics-port", "0"])
        if async_path:
            with pytest.raises(NotImplementedError,
                               match="--metrics-port on the in-process "
                                     "async path .*arms no exporter"):
                check_supported(metrics, async_path=True)
        else:
            check_supported(metrics)


def test_permanent_refusals_do_not_say_not_ported():
    """Exact: ``--lossy-weights-down`` and ``--metrics-port`` on the
    in-process async path and ``--metrics-port`` on ``--role fed_driver``
    (ROADMAP Queue 3 items 16 and 28), which the JAX package accepts and
    ignores, are refused for good and say so; a row that waits on a later
    slice (``--pull-delta`` on the in-process async path) still says it is
    not ported yet, and ``--num-slices > 1``, ported since, is no longer
    refused."""
    from ewdml_tpu_torch.parallel import ps_net

    refusals = [
        (lambda: check_supported(from_args(
            ["--mode", "async", "--lossy-weights-down"]), async_path=True),
         "--lossy-weights-down"),
        (lambda: check_supported(from_args(
            ["--mode", "async", "--metrics-port", "0"]), async_path=True),
         "--metrics-port"),
        (lambda: ps_net.check_supported(
            from_args(["--metrics-port", "0"]), "fed_driver"),
         "--metrics-port on --role fed_driver"),
    ]
    for refuse, flag in refusals:
        with pytest.raises(NotImplementedError) as e:
            refuse()
        msg = str(e.value)
        assert msg.startswith(flag), msg
        assert "the JAX package accepts it here and ignores it" in msg
        assert "not ported" not in msg
    with pytest.raises(NotImplementedError,
                       match=r"^--pull-delta .*not ported to "
                             r"ewdml_tpu_torch yet"):
        check_supported(from_args(["--mode", "async", "--pull-delta"]),
                        async_path=True)
    check_supported(from_args(["--num-slices", "2"]))
