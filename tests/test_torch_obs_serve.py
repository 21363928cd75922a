"""The port's live metrics plane (``ewdml_tpu_torch/obs/serve.py``) and the
``--metrics-port`` roles.

Oracles:
- byte: ``render_prometheus`` against the JAX package's, called as a pure
  function on the same snapshot (the JAX ``serve.configure`` is never
  called: it would leave a process-global exporter on this test worker);
- exact: unset is a no-op (no exporter, no thread); both formats scraped,
  the 404, the environment variable; two owners never share a registry or
  a port; a scrape under writer load never raises and its counts never go
  back; each role prints the JAX marker line and serves its own registry;
  a sync run with ``--metrics-port`` ends on the parameters of the same
  run without it, bit for bit.
"""

import contextlib
import json
import math
import re
import threading
import time
import timeit
import urllib.error
import urllib.request

import pytest
import torch

from ewdml_tpu.obs import serve as jserve
from ewdml_tpu_torch.core.config import TrainConfig, from_args
from ewdml_tpu_torch.obs import serve as oserve
from ewdml_tpu_torch.obs.registry import MetricsRegistry
from ewdml_tpu_torch.parallel import ps_net

torch.set_num_threads(2)

PROM = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$")
TCP = ["--platform", "cpu", "--network", "LeNet", "--dataset", "mnist10k",
       "--synthetic-data", "--batch-size", "8", "--compress-grad", "qsgd"]


def _get(port: int, path: str) -> bytes:
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=10).read()


def _metrics_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith("ewdml-metrics")]


def _populated() -> MetricsRegistry:
    reg = MetricsRegistry()
    reg.counter("net.bytes_sent").inc(7)
    reg.counter("train.step_s").inc(0.125)
    reg.gauge("ps_net.connections").set(2)
    reg.gauge("adapt.comm_frac_source").set("measured")
    reg.gauge("flag").set(True)
    reg.gauge("unset")
    reg.gauge("nan").set(math.nan)
    reg.gauge("ratio").set(1 / 3)
    for v in (0.01, 0.02, 0.04, math.inf):
        reg.histogram("ps_net.push.latency_s").observe(v)
    reg.histogram("empty.latency_s")
    return reg


@pytest.mark.parametrize("which", ["populated", "empty"])
@pytest.mark.parametrize("role", ["ps-server", "worker-3", "cell:m5"])
def test_render_prometheus_byte_equal(which, role):
    """Byte: the exposition text of one snapshot, both renderers."""
    reg = _populated() if which == "populated" else MetricsRegistry()
    snap = reg.snapshot()
    text = oserve.render_prometheus(snap, role)
    assert text == jserve.render_prometheus(snap, role)
    samples = [ln for ln in text.splitlines()
               if ln and not ln.startswith("#")]
    assert all(PROM.match(ln) for ln in samples), samples
    if which == "populated":
        assert f'ewdml_net_bytes_sent{{role="{role}"}} 7' in samples
        assert not any("comm_frac_source" in ln for ln in samples)
        for name in ("flag", "unset"):
            assert not any(ln.startswith(f"ewdml_{name}{{") for ln in samples)
        assert f'ewdml_nan{{role="{role}"}} NaN' in samples


def test_disabled_is_strict_noop(monkeypatch):
    """Exact: with no port and no environment variable nothing starts, and
    the disabled call costs well under 10 us."""
    monkeypatch.delenv(oserve.ENV, raising=False)
    before = _metrics_threads()
    reg = MetricsRegistry()
    live = oserve.Live(oserve.env_port(None), reg, "trainer")
    assert live.port is None and live.exporter is None
    live.close()
    assert _metrics_threads() == before
    n = 20000

    def f():
        for _ in range(n):
            oserve.Live(oserve.env_port(None), reg, "trainer")

    per_call = min(timeit.repeat(f, number=1, repeat=5)) / n
    assert per_call < 10e-6, f"disabled call costs {per_call * 1e6:.2f} us"


def test_scrape_both_formats_and_404():
    """Exact: /metrics, /metrics.json (and /healthz) of the owner's
    registry, a 404 elsewhere; closing stops the thread and the port."""
    reg = _populated()
    e = oserve.Live(0, reg, "ps-server").exporter
    try:
        assert e.port > 0
        text = _get(e.port, "/metrics").decode()
        assert text == jserve.render_prometheus(reg.snapshot(), "ps-server")
        for path in ("/metrics.json", "/healthz"):
            doc = json.loads(_get(e.port, path))
            assert doc["role"] == "ps-server" and doc["port"] == e.port
            assert sorted(doc) == ["host", "metrics", "pid", "port", "role"]
            assert doc["metrics"]["histograms"]["ps_net.push.latency_s"][
                "count"] == 4
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(e.port, "/nope")
        assert err.value.code == 404
    finally:
        e.close()
    e.close()  # idempotent
    assert e._thread not in threading.enumerate()
    with pytest.raises(OSError):
        _get(e.port, "/metrics")


def test_environment_variable(monkeypatch, tmp_path, capsys):
    """Exact: ``EWDML_METRICS_PORT`` arms a role's entry point that has no
    port of its own (``evaluator.main`` prints its marker); an explicit
    port wins; unset arms nothing. An owner built inside a library (two
    ``Trainer``s in one process, under a fixed port in the variable)
    never reads it, so neither binds the port nor starts a thread."""
    from ewdml_tpu_torch.train import evaluator
    from ewdml_tpu_torch.train.loop import Trainer

    reg = MetricsRegistry()
    monkeypatch.setenv(oserve.ENV, "0")
    e = oserve.Live(oserve.env_port(None), reg, "evaluator").exporter
    try:
        assert e is not None and e.role == "evaluator" and e.port > 0
        assert json.loads(_get(e.port, "/metrics.json"))["role"] == \
            "evaluator"
    finally:
        e.close()
    assert evaluator.main(["--platform", "cpu", "--network", "LeNet",
                           "--dataset", "mnist10k", "--num-workers", "1",
                           "--train-dir", str(tmp_path / "ev") + "/",
                           "--max-polls", "1", "--eval-interval", "0"]) == 0
    first = capsys.readouterr().out.splitlines()[0].split()
    assert first[0] == "EVALUATOR_METRICS" and int(first[1]) > 0
    monkeypatch.setenv(oserve.ENV, "")
    assert oserve.env_port(None) is None
    monkeypatch.delenv(oserve.ENV)
    assert oserve.env_port(None) is None
    monkeypatch.setenv(oserve.ENV, "1")  # a port of its own wins
    assert oserve.env_port(0) == 0
    e = oserve.Live(oserve.env_port(0), reg, "evaluator").exporter
    try:
        assert e.port not in (0, 1)
    finally:
        e.close()
    monkeypatch.setenv(oserve.ENV, str(_free_port()))
    before = _metrics_threads()
    for i in range(2):
        t = Trainer(TrainConfig(
            network="LeNet", dataset="mnist10k", batch_size=8,
            num_workers=1, platform="cpu", synthetic_data=True,
            train_dir=str(tmp_path / f"t{i}") + "/"))
        assert t.live.port is None and t.live.exporter is None
        t.close()
    assert _metrics_threads() == before


def test_two_owners_never_share():
    """Exact: two exporters in one process bind two ports and serve two
    registries; a fixed port bound twice raises."""
    a, b = MetricsRegistry(), MetricsRegistry()
    a.counter("who.a").inc()
    b.counter("who.b").inc(2)
    ea = oserve.Live(0, a, "a")
    eb = oserve.Live(0, b, "b")
    try:
        assert ea.port != eb.port
        assert json.loads(_get(ea.port, "/metrics.json"))["metrics"][
            "counters"] == {"who.a": 1}
        assert json.loads(_get(eb.port, "/metrics.json"))["metrics"][
            "counters"] == {"who.b": 2}
        with pytest.raises(OSError):
            oserve.Live(ea.port, b, "c")
    finally:
        ea.close()
        eb.close()


def test_scrape_under_writer_load_never_raises():
    """Exact: a writer hammering one histogram while both formats are
    scraped 25 times: no error, a count that never goes back."""
    reg = MetricsRegistry()
    e = oserve.Live(0, reg, "w")
    stop = threading.Event()
    h = reg.histogram("load.latency_s")

    def writer():
        i = 0
        while not stop.is_set():
            h.observe(0.001 * (1 + i % 7))
            i += 1

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        last = -1
        for _ in range(25):
            s = json.loads(_get(e.port, "/metrics.json"))["metrics"][
                "histograms"]["load.latency_s"]
            assert s["count"] >= last
            last = s["count"]
            if s["count"]:
                assert s["p50"] is not None
            _get(e.port, "/metrics")
    finally:
        stop.set()
        t.join(5)
        e.close()
    assert last > 0


def _params(trainer) -> list:
    return [p.detach().clone() for ws in trainer.state.workers
            for p in ws.model.parameters()]


def test_trainer_serves_and_is_bit_equal(tmp_path, capsys):
    """Exact: ``cli.main`` prints ``TRAINER_METRICS <port>`` first; a
    ``Trainer`` with ``--metrics-port 0`` serves its own registry (the
    step timer's totals after ``train``) and ends on the parameters of the run
    without the flag, bit for bit; ``close`` stops the endpoint."""
    from ewdml_tpu_torch.cli import main
    from ewdml_tpu_torch.train.loop import Trainer

    base = dict(network="LeNet", dataset="mnist10k", batch_size=8, lr=0.01,
                max_steps=2, eval_freq=0, epochs=100, log_every=1000,
                bf16_compute=False, num_workers=2, method=5, seed=3,
                platform="cpu", synthetic_data=True)
    runs = []
    for port in (None, 0):
        t = Trainer(TrainConfig(train_dir=str(tmp_path / f"r{port}") + "/",
                                metrics_port=port, **base))
        t.train()
        runs.append(t)
    plain, served = runs
    assert plain.live.port is None and plain.live.exporter is None
    assert served.live.port > 0
    doc = json.loads(_get(served.live.port, "/metrics.json"))
    assert doc["role"] == "trainer"
    # The step timer's totals: the first step is the compile, one timed.
    assert doc["metrics"]["counters"]["train.steps"] == 1
    assert doc["metrics"]["counters"]["train.compile_s"] > 0
    served.close()
    for a, b in zip(_params(plain), _params(served)):
        assert torch.equal(a, b)
    argv = ["--platform", "cpu", "--network", "LeNet", "--dataset",
            "mnist10k", "--synthetic-data", "--num-workers", "2",
            "--max-steps", "1", "--batch-size", "8", "--no-bf16",
            "--metrics-port", "0", "--train-dir", str(tmp_path / "cli") + "/"]
    assert main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split()[0] == "TRAINER_METRICS" and int(out[0].split()[1])


def _free_port() -> int:
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


@contextlib.contextmanager
def _served(flags):
    server = ps_net.PSNetServer(from_args(TCP + flags), port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        with contextlib.suppress(OSError):
            ps_net.client_call(server.address, {"op": "shutdown"},
                               retries=0, timeout_s=10)
        thread.join(20)
        server.close()


@pytest.mark.parametrize("role", ["worker", "replica", "aggregator"])
def test_tcp_roles_print_their_markers(role, capsys):
    """Exact: ``ps_net.main --role worker|replica|aggregator
    --metrics-port 0`` prints ``PS_NET_METRICS worker-i|ps-replica|ps-agg-i
    <port>`` and serves its own registry (its role's metrics) at that
    port while it runs."""
    flags, listen = [], []
    port = _free_port()
    if role == "replica":
        flags = ["--pull-delta", "--keyframe-every", "2"]
        listen = ["--replica-port", str(port)]
        name, metric = "ps-replica", "replica.version"
    elif role == "aggregator":
        flags = ["--server-agg", "homomorphic", "--agg-tree",
                 f"127.0.0.1:{port}"]
        listen = ["--agg-port", str(port), "--agg-index", "0"]
        name, metric = "ps-agg-0", "agg.children"
    else:
        listen = ["--worker-index", "1", "--steps", "2"]
        name, metric = "worker-1", None
    with _served(flags) as server:
        argv = TCP + flags + ["--role", role, "--host", server.address[0],
                              "--port", str(server.address[1]),
                              "--metrics-port", "0"] + listen
        rcs = []
        thread = threading.Thread(target=lambda: rcs.append(
            ps_net.main(argv)), daemon=True)
        thread.start()
        deadline = time.time() + 60
        out = ""
        while "PS_NET_METRICS" not in out and time.time() < deadline:
            time.sleep(0.02)
            out += capsys.readouterr().out
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("PS_NET_METRICS"))
        got_role, mport = line.split()[1:]
        assert got_role == name
        if metric is not None:
            doc = json.loads(_get(int(mport), "/metrics.json"))
            assert doc["role"] == name
            assert metric in doc["metrics"]["gauges"]
            ps_net.client_call(("127.0.0.1", port), {"op": "shutdown"})
        thread.join(60)
        out += capsys.readouterr().out
        assert rcs == [0], out
        if role == "worker":
            assert "PS_NET_WORKER_DONE" in out
