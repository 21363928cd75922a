"""The port's trace tools (``ewdml_tpu_torch/obs/{merge,export,rounds,
report}.py`` and ``cli obs``) against the JAX package's on the same trace
directories.

Two directories: a synthetic two-round trace (the hand-placed shards of
``tests/test_obs_rounds.py``, plus an interleaved pair of federated
rounds and a torn shard), and a trace the port's TCP tier wrote on the CPU
(LeNet on synthetic ``mnist10k``, ``--server-agg homomorphic``, K = 2, a
server and two workers in threads of this process, 3 rounds).

Oracle: exact. Both packages' ``merge_dir``, ``flow_groups``,
``chrome_trace``, ``rounds.analyze`` (and its text and JSON renderings)
and ``render_report`` give equal results; every complete round's segments
sum to its wall (to the 3-decimal ms rounding of the rows); the Perfetto
document holds a cross-track flow for every complete round's gating push.
"""

import json
import threading

import pytest
import torch

from ewdml_tpu.obs import export as jexport
from ewdml_tpu.obs import merge as jmerge
from ewdml_tpu.obs import report as jreport
from ewdml_tpu.obs import rounds as jrounds
from ewdml_tpu_torch.obs import export as oexport
from ewdml_tpu_torch.obs import merge as omerge
from ewdml_tpu_torch.obs import report as oreport
from ewdml_tpu_torch.obs import rounds as orounds
from ewdml_tpu_torch.obs import trace as otrace

torch.set_num_threads(2)

MS = 1_000_000


def _shard(path, role, pid, events, host="hostA", offset_ns=None,
           torn=False):
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "meta", "role": role, "pid": pid,
                            "host": host, "offset_ns": offset_ns,
                            "wall_anchor_ns": 10 * MS,
                            "mono_anchor_ns": 5 * MS}) + "\n")
        for e in events:
            f.write(json.dumps(e) + "\n")
        if torn:
            f.write('{"kind": "span", "name": "worker/pu')


def _span(name, ts, dur, **args):
    return {"kind": "span", "name": name, "ts": ts * MS, "dur": dur * MS,
            "tid": "main", "args": args}


def _instant(name, ts, **args):
    return {"kind": "instant", "name": name, "ts": ts * MS, "tid": "main",
            "args": args}


@pytest.fixture
def synthetic_dir(tmp_path):
    """``test_obs_rounds.py``'s two rounds (gated by worker 1, then worker
    0), a federated pair of rounds of another server on another host (a
    handshaken shard), a counter, and a torn worker shard."""
    _shard(tmp_path / "shard-ps-server-1.jsonl", "ps-server", 1, [
        _span("ps_net/pull", 1100, 100, worker=0, req="w0.1", queue_ns=0),
        _span("ps_net/pull", 1150, 100, worker=1, req="w1.1", queue_ns=0),
        _span("ps_net/push", 2300, 150, worker=0, req="w0.2",
              queue_ns=10 * MS, version=0),
        _span("ps_net/push", 2600, 700, worker=1, req="w1.2",
              queue_ns=50 * MS, version=0),
        _span("ps/apply", 2800, 400, k=2, version=0),
        _span("ps_net/recv", 2595, 5, op="push", req="w1.2"),
        _span("ps_net/pull", 4050, 100, worker=0, req="w0.3", queue_ns=0),
        _span("ps_net/push", 4900, 450, worker=0, req="w0.4",
              queue_ns=100 * MS, version=1),
        _span("ps/apply", 5100, 200, k=1, version=1),
        _span("ps_net/stats", 6000, 10, req="local.1"),
        _span("ps_net/stats", 6020, 10, req="local.1"),
        {"kind": "counter", "name": "net/bytes", "ts": 6100 * MS,
         "value": 1234, "tid": "main"},
    ])
    _shard(tmp_path / "shard-worker-0-100.jsonl", "worker-0", 100, [
        _span("worker/pull", 1000, 300, step=0, req="w0.1"),
        _span("worker/grad", 1400, 500, step=0, version=0),
        _span("worker/compress", 1950, 150, step=0, version=0),
        _span("worker/push", 2200, 400, step=0, version=0, req="w0.2"),
        _instant("net/retry", 2250, op="push", attempt=1, req="w0.2"),
        _span("worker/pull", 4000, 200, step=1, req="w0.3"),
        _span("worker/grad", 4300, 300, step=1, version=1),
        _span("worker/compress", 4650, 50, step=1, version=1),
        _span("worker/push", 4800, 600, step=1, version=1, req="w0.4"),
    ])
    _shard(tmp_path / "shard-worker-1-101.jsonl", "worker-1", 101, [
        _span("worker/pull", 1000, 400, step=0, req="w1.1"),
        _span("worker/grad", 1500, 700, step=0, version=0),
        _span("worker/compress", 2250, 100, step=0, version=0),
        _span("worker/push", 2500, 900, step=0, version=0, req="w1.2"),
    ], torn=True)
    _shard(tmp_path / "shard-worker-23-123.jsonl", "worker-23", 123, [
        _span("worker/pull", 8000, 150, step=1, req="p.23"),
        _span("worker/grad", 8200, 200, step=1),
        _span("worker/compress", 8420, 30, step=1),
        _span("worker/push", 8550, 600, step=1, req="x.4"),
    ], host="hostB", offset_ns=3 * MS)
    _shard(tmp_path / "shard-ps-server-7.jsonl", "ps-server-fed", 7, [
        _span("ps_net/push", 7000, 100, worker=20, req="x.1",
              queue_ns=0, version=0, round=0),
        _span("ps_net/push", 7500, 100, worker=21, req="x.2",
              queue_ns=0, version=0, round=1),
        _span("ps_net/push", 8000, 400, worker=22, req="x.3",
              queue_ns=0, version=0, round=0),
        _span("ps/apply", 8200, 150, k=2, version=0, round=0),
        _span("ps_net/pull", 8050, 50, worker=23, req="p.23", queue_ns=0),
        _span("ps_net/push", 8600, 500, worker=23, req="x.4",
              queue_ns=0, version=1, round=1),
        _span("ps/apply", 8900, 150, k=2, version=1, round=1),
    ], host="hostB", offset_ns=0)
    (tmp_path / "shard-dead-9.jsonl").write_text("not json\n")
    return str(tmp_path)


@pytest.fixture(scope="module")
def tcp_dir(tmp_path_factory):
    """A trace of the port's TCP tier: a server and two workers in threads
    (each thread records under its own role), 3 rounds of K = 2."""
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.parallel import ps_net

    root = str(tmp_path_factory.mktemp("tcp_trace"))
    flags = ["--platform", "cpu", "--network", "LeNet", "--dataset",
             "mnist10k", "--synthetic-data", "--batch-size", "8",
             "--compress-grad", "qsgd", "--server-agg", "homomorphic",
             "--num-aggregate", "2", "--trace-dir", root]
    otrace.shutdown()
    cfg = from_args(flags)
    server = ps_net.PSNetServer(cfg, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        workers = [ps_net.PSNetWorker(cfg, i, server.address)
                   for i in range(2)]
        results = [None, None]
        runs = [threading.Thread(
            target=lambda i=i: results.__setitem__(i, workers[i].run(3)))
            for i in range(2)]
        for t in runs:
            t.start()
        for t in runs:
            t.join(120)
        assert all(r is not None and r["steps"] == 3 for r in results)
        ps_net.client_call(server.address, {"op": "shutdown"}, retries=0,
                           timeout_s=10)
        thread.join(30)
    finally:
        server.close()
        otrace.flush()
        otrace.shutdown()
    return root


@pytest.fixture(params=["synthetic", "tcp"])
def trace_dir(request):
    return request.getfixturevalue(
        "synthetic_dir" if request.param == "synthetic" else "tcp_dir")


def test_merge_and_flow_groups_equal(trace_dir):
    """Exact: the aligned, time-sorted events and the request groups."""
    merged = omerge.merge_dir(trace_dir)
    assert merged == jmerge.merge_dir(trace_dir)
    assert merged
    assert omerge.flow_groups(merged) == jmerge.flow_groups(merged)
    shards = omerge.load_shards(trace_dir)
    assert shards == jmerge.load_shards(trace_dir)
    ref = omerge._pick_reference(shards)
    assert ref["meta"]["role"] == "ps-server"
    for shard in shards:
        assert (omerge.resolve_offset(shard["meta"], ref["meta"])
                == jmerge.resolve_offset(shard["meta"], ref["meta"]))


def test_chrome_trace_equal_with_a_flow_per_round(trace_dir, tmp_path):
    """Exact: the Perfetto document, and the file each package's export
    writes; every complete round's gating push has a cross-track flow."""
    merged = omerge.merge_dir(trace_dir)
    doc = oexport.chrome_trace(merged)
    assert doc == jexport.chrome_trace(merged)
    ours = oexport.export_perfetto(trace_dir, str(tmp_path / "a.json"))
    theirs = jexport.export_perfetto(trace_dir, str(tmp_path / "b.json"))
    with open(ours) as a, open(theirs) as b:
        assert a.read() == b.read()
    flows = {e["args"]["req"] for e in doc["traceEvents"]
             if e.get("cat") == "flow" and e["ph"] == "s"}
    analysis = orounds.analyze(merged)
    gating_reqs = _gating_reqs(merged)
    complete = [r for r in analysis["rounds"] if r["complete"]]
    assert complete
    for row in complete:
        assert gating_reqs[(row["round"], row.get("fed_round"))] in flows


def _gating_reqs(merged) -> dict:
    """(round, fed round) -> the request id of the server push whose
    dispatch ran the round's apply (the push whose interval holds it)."""
    pushes = [e for e in merged if e.get("name") == "ps_net/push"]
    out = {}
    for ap in (e for e in merged if e.get("name") == "ps/apply"):
        a = ap["args"]
        hold = [p for p in pushes if p["ts"] <= ap["ts"]
                and p["ts"] + p["dur"] >= ap["ts"] + ap["dur"]
                and p["role"] == ap["role"]]
        if hold:
            out[(a.get("version"), a.get("round"))] = str(
                hold[-1]["args"]["req"])
    return out


def test_rounds_equal_and_segments_sum(trace_dir):
    """Exact: the rounds analysis, its text and JSON; every complete
    round's six segments sum to its wall (each row rounds to 0.001 ms)."""
    merged = omerge.merge_dir(trace_dir)
    analysis = orounds.analyze(merged, excluded={"0": "straggler"})
    assert analysis == jrounds.analyze(merged, excluded={"0": "straggler"})
    assert (orounds.render_text(analysis, trace_dir)
            == jrounds.render_text(analysis, trace_dir))
    assert orounds.render_json(analysis) == jrounds.render_json(analysis)
    assert orounds.render(trace_dir) == jrounds.render(trace_dir)
    for row in analysis["rounds"]:
        if row["complete"]:
            total = sum(row["segments_ms"][k] for k in orounds.SEGMENT_KEYS)
            assert abs(total - row["wall_ms"]) <= 0.004, row
    if "tcp_trace" in trace_dir:
        assert analysis["completed"] == len(analysis["rounds"]) == 3


def test_report_and_cli_equal(trace_dir, capsys):
    """Exact: the text report, and ``python -m ewdml_tpu_torch.cli obs
    report|rounds|export`` against the JAX entry point's output."""
    from ewdml_tpu_torch.cli import main

    assert (oreport.render_report(trace_dir, top=5)
            == jreport.render_report(trace_dir, top=5))
    summary = oreport.summarize(omerge.merge_dir(trace_dir))
    assert set(summary["spans"]) == set(jreport.summarize(
        jmerge.merge_dir(trace_dir))["spans"])
    for sub in (["report", trace_dir], ["rounds", trace_dir],
                ["rounds", trace_dir, "--json"]):
        assert main(["obs"] + sub) == 0
        ours = capsys.readouterr().out
        assert jreport.main(sub) == 0
        assert ours == capsys.readouterr().out
    assert main(["obs", "export", trace_dir]) == 0
    assert "trace.json" in capsys.readouterr().out
    assert main(["obs", "report", trace_dir + "/missing"]) == 2
