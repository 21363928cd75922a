"""The port's TCP parameter server (``ewdml_tpu_torch/parallel/ps_net.py``)
on the CPU: LeNet at batch 8 on synthetic ``mnist10k``, servers and
workers in threads of the test process over localhost sockets, and one
real server process for ``serverkill``.

Oracles:
- frames and requests: bit, against the JAX package's ``make_request``,
  ``send_frame`` and ``recv_frame``.
- the wire under a byte-at-a-time sender, a torn frame and the injected
  faults (``reset``, ``drop``, ``partition``): exact (the server keeps
  serving; retry, reconnect and resync counts; every push applied once).
- the two planes: bit (the same request sequence, the same reply frames).
- ``push_batch``: bit against sequential ``push`` (parameters, optimizer
  state, verdicts and counters), a kill and a corrupt payload isolated.
- the relay from ``--lossy-weights-down``: bit against
  ``run_async_ps(relay_compress=True)``'s server.
- ``prng.normal``: the uniform on jax's bounds bit-equal, the normal
  within 4 ulp of ``jax.random.normal`` (XLA's ``log1p`` differs from
  torch's in the last bits).
- the rejections: exact (``ValueError`` naming the flag); the server
  under ``--metrics-port``: exact (its marker line and a scrape).
- the replica and aggregator roles' entry points: exact (the READY line,
  the ``stats`` reply, ``shutdown``).
- the homomorphic scale contract across processes: exact (the same CRC
  at one and two intra-op threads).
- ``serverkill``: exact (the restarted server recovers past the kill with
  ``recoveries`` 1, no push applied twice, both workers finish). Marked
  slow: it does not fit the tier-1 lane's 20 s a test.
"""

import contextlib
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ewdml_tpu.parallel import ps as jps
from ewdml_tpu.parallel import ps_net as jps_net
from ewdml_tpu_torch import native
from ewdml_tpu_torch.core.config import from_args
from ewdml_tpu_torch.obs.health import HealthAbort
from ewdml_tpu_torch.parallel import ps_net
from ewdml_tpu_torch.parallel.policy import StragglerKilled
from ewdml_tpu_torch.parallel.ps import PushRecord
from ewdml_tpu_torch.utils import prng, transfer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--platform", "cpu", "--network", "LeNet", "--dataset", "mnist10k",
        "--synthetic-data", "--batch-size", "8", "--fusion", "none"]


def _cfg(*extra):
    return from_args(BASE + list(extra))


@contextlib.contextmanager
def _serving(cfg):
    """A server of ``cfg`` serving in a thread; shut down on exit."""
    server = ps_net.PSNetServer(cfg, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        if thread.is_alive():
            with contextlib.suppress(OSError):
                ps_net.client_call(server.address, {"op": "shutdown"},
                                   retries=0, timeout_s=10)
        thread.join(20)
        server.close()


def _raw_call(sock, header, sections=()) -> bytes:
    ps_net.send_frame(sock, ps_net.make_request(header, sections))
    return ps_net.recv_frame(sock)


def _payload(setup, seed: int) -> bytes:
    """One push frame of a numpy-made gradient, compressed by the port."""
    rng = np.random.default_rng(seed)
    grads = [torch.from_numpy(rng.standard_normal(tuple(g.shape)).astype(
        np.float32) * 0.01) for g in setup.params]
    tree = (setup.compress_tree(grads, prng.key(seed))
            if setup.compress_tree is not None else grads)
    return native.encode_arrays([transfer.make_device_packer()(tree).numpy()])


# -- frames ------------------------------------------------------------------

HEADERS = [
    {"op": "pull", "worker": 3, "worker_version": -1, "plan_version": 0},
    {"op": "push", "worker": 0, "version": 12, "loss": 2.302585092994046,
     "plan_version": 0, "push_id": "0:12"},
    {"op": "stats_ok", "excluded": {"1": "straggler"}, "nested": [1, 2.5],
     "v": np.int64(7), "f": np.float32(0.5), "none": None, "t": True},
]


@pytest.mark.parametrize("i", range(len(HEADERS)))
def test_request_frames_equal_the_jax_frames(i):
    sections = [b"", bytes(range(7)), os.urandom(1021)]
    mine = ps_net.make_request(HEADERS[i], sections)
    assert bytes(mine) == bytes(jps_net.make_request(HEADERS[i], sections))
    header, secs = ps_net.parse_request(mine)
    assert header == jps_net.parse_request(bytes(mine))[0]
    assert [bytes(s) for s in secs] == sections
    a, b = socket.socketpair()
    with a, b:
        counter = ps_net.ByteCounter()
        ps_net.send_frame(a, mine, counter)
        assert jps_net.recv_frame(b) == bytes(mine)
        jps_net.send_frame(b, bytes(mine))
        got, recv_ns = ps_net.recv_frame_timed(a, counter)
        assert got == bytes(mine) and recv_ns >= 0
        assert counter.sent == counter.received == 8 + len(mine)


def test_reply_scratch_bytes_equal_the_allocating_path():
    scratch = ps_net._ReplyScratch(size=16)
    secs = [b'{"op": "x"}', os.urandom(100)]
    view = scratch.encode(secs)
    assert scratch.busy and bytes(view) == native.wire_encode(secs)


# -- the wire -----------------------------------------------------------------

@pytest.mark.parametrize("plane", ["threads", "evloop"])
def test_slow_sender_and_torn_frame(plane):
    """A frame sent a byte at a time is answered; a peer that dies mid-frame
    costs its own session, and the server keeps serving."""
    with _serving(_cfg("--compress-grad", "qsgd", "--num-aggregate", "1",
                       "--wire-plane", plane)) as server:
        msg = ps_net.make_request({"op": "resync"})
        data = ps_net._LEN.pack(len(msg)) + bytes(msg)
        with socket.create_connection(server.address, timeout=10) as s:
            for b in data:
                s.sendall(bytes([b]))
            header, _ = ps_net.parse_request(ps_net.recv_frame(s))
        assert header == {"op": "resync_ok", "version": 0}
        with socket.create_connection(server.address, timeout=10) as s:
            s.sendall(data[:len(data) // 2])
        with socket.create_connection(server.address, timeout=10) as s:
            s.sendall(ps_net._LEN.pack(len(msg)) + b"\x00" * len(msg))
            with pytest.raises((ConnectionError, OSError)):
                ps_net.recv_frame(s)  # a corrupt frame closes the session
        header, _ = ps_net.client_call(server.address, {"op": "resync"})
        assert header["op"] == "resync_ok"


@pytest.mark.parametrize("fault,retries,reconnects", [
    ("reset@0=1", 1, 1), ("drop@0=1", 0, 1), ("partition@0=1", 1, 1)])
def test_retrying_connection_rides_out_wire_faults(fault, retries,
                                                   reconnects):
    """Each fault costs the worker a retry or a fresh connection and one
    resync, never a step: 3 pushes, 3 updates, none applied twice."""
    cfg = _cfg("--compress-grad", "qsgd", "--num-aggregate", "1",
               "--net-timeout", "5", "--net-backoff", "0.01",
               "--fault-spec", fault)
    with _serving(cfg) as server:
        worker = ps_net.PSNetWorker(cfg, 0, server.address)
        result = worker.run(3)
        stats, _ = ps_net.client_call(server.address, {"op": "stats"})
    assert (result["retries"], result["reconnects"]) == (retries, reconnects)
    assert result["resyncs"] == 1 and result["rejected"] == 0
    assert (stats["pushes"], stats["updates"], stats["dup_pushes"]) == (3, 3,
                                                                       0)


def test_excluded_worker_gets_the_kill_frame():
    cfg = _cfg("--compress-grad", "qsgd", "--num-aggregate", "1")
    with _serving(cfg) as server:
        server.policy.exclude(1, "straggler: injected")
        worker = ps_net.PSNetWorker(cfg, 1, server.address)
        with pytest.raises(StragglerKilled, match="injected"):
            worker.run(2)
        stats, _ = ps_net.client_call(server.address, {"op": "stats"})
    assert stats["kills_sent"] == 1 and stats["excluded"] == {
        "1": "straggler: injected"}


# -- the two planes -----------------------------------------------------------

def _scripted_replies(cfg, setup) -> list:
    """The replies (raw frames) of one request sequence: a first pull, two
    pushes at K = 2, a pull, resync, join, bn_stats, two later slices' ops,
    an unknown op, shutdown."""
    server = ps_net.PSNetServer(cfg, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    replies = []
    try:
        with socket.create_connection(server.address, timeout=30) as s:
            replies.append(_raw_call(s, {"op": "pull", "worker": 0,
                                         "worker_version": -1}))
            for w in (0, 1):
                replies.append(_raw_call(
                    s, {"op": "push", "worker": w, "version": 0,
                        "loss": 1.5, "push_id": f"{w}:0"},
                    [_payload(setup, w)]))
            replies.append(_raw_call(s, {"op": "pull", "worker": 0,
                                         "worker_version": 0}))
            for header in ({"op": "resync", "worker": 1},
                           {"op": "join", "worker": 5},
                           {"op": "bn_stats", "worker": 0},
                           {"op": "subscribe", "since": -1},
                           {"op": "fed_begin", "round": 0},
                           {"op": "frobnicate"}, {"op": "shutdown"}):
                replies.append(_raw_call(s, header))
        thread.join(20)
    finally:
        server.close()
    return replies


@pytest.mark.parametrize("agg", ["decode", "homomorphic"])
def test_planes_reply_with_the_same_bytes(agg):
    flags = ("--compress-grad", "qsgd", "--server-agg", agg,
             "--num-aggregate", "2")
    setup = ps_net.build_endpoint_setup(_cfg(*flags))
    got = {plane: _scripted_replies(_cfg(*flags, "--wire-plane", plane),
                                    setup)
           for plane in ("threads", "evloop")}
    assert got["threads"] == got["evloop"]
    headers = [ps_net.parse_request(r)[0] for r in got["evloop"]]
    assert headers[1:3] == [{"op": "push_ok", "accepted": True}] * 2
    assert headers[3]["version"] == 1 and headers[4] == {
        "op": "resync_ok", "version": 1}
    assert headers[5] == {"op": "join_ok", "version": 1, "live": 3,
                          "num_aggregate": 2}
    # The publication stream, armed by this first subscriber at version 1
    # (no --pull-delta: a keyframe every version): the JAX server's frame
    # of the same contract, its keyframe the pull's weights.
    pull_weights = ps_net.parse_request(got["evloop"][3])[1][0]
    flat = len(pull_weights)
    assert bytes(got["evloop"][7]) == bytes(jps_net.make_request(
        {"op": "subscribe_ok", "mode": "keyframe", "version": 1,
         "keyframe": 1, "flat": flat, "block": 4096, "s": 127,
         "keyframe_every": 1,
         "crc": jps.pd_contract_crc(flat, 4096, 127, 1)},
        [bytes(pull_weights)]))
    assert headers[8] == {"op": "error", "detail": "server not federated"}
    assert headers[9]["detail"] == "unknown op 'frobnicate'"
    assert ("scale_crc" in headers[0]) == (agg == "homomorphic")


def test_push_batch_equals_sequential_push():
    """One tick's pushes through push_batch against the same pushes one by
    one: the same verdicts, state and counters, with an excluded worker's
    kill and a corrupt payload isolated inside the tick."""
    cfg = _cfg("--compress-grad", "qsgd", "--num-aggregate", "2")
    setup = ps_net.build_endpoint_setup(cfg)
    servers = [ps_net.PSNetServer(cfg, port=0) for _ in range(2)]
    try:
        corrupt = bytearray(_payload(setup, 9))
        corrupt[-5] ^= 0xFF
        records = [PushRecord(worker=w, version=0, message=m, loss=1.0,
                              push_id=f"{w}:{i}")
                   for i, (w, m) in enumerate([
                       (0, _payload(setup, 0)), (3, _payload(setup, 1)),
                       (1, bytes(corrupt)), (1, _payload(setup, 2)),
                       (2, _payload(setup, 3)), (0, _payload(setup, 4))])]
        for srv in servers:
            srv.policy.exclude(3, "straggler: injected")
        batch = servers[0].server.push_batch(records)
        seq = []
        for r in records:
            try:
                seq.append(servers[1].server.push(r))
            except Exception as e:  # noqa: BLE001 -- the verdict compared
                seq.append(e)
        assert [type(o) for o in batch] == [type(o) for o in seq] == [
            bool, StragglerKilled, ValueError, bool, bool, bool]
        assert [o for o in batch if isinstance(o, bool)] == [True] * 4
        a, b = (s.server for s in servers)
        assert a.version == b.version == 2
        assert all(torch.equal(x, y) for x, y in zip(a.params, b.params))
        assert all(torch.equal(x, y) for x, y in
                   zip(a.opt_state.momentum_buf, b.opt_state.momentum_buf))
        assert (a.stats.pushes, a.stats.kills_sent) == (
            b.stats.pushes, b.stats.kills_sent) == (4, 1)
    finally:
        for srv in servers:
            srv.close()


# -- the relay, the watchdog, the draws ------------------------------------------

def test_lossy_relay_armed_from_the_flag_equals_run_async_ps():
    """``--ps-mode weights --lossy-weights-down`` arms the TCP server's
    relay (``ps_net.py:683``): its pulls equal the relay of
    ``run_async_ps(relay_compress=True)``'s server at every version, and
    without the flag the pull is the dense parameters."""
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.ops import make_compressor
    from ewdml_tpu_torch.optim import SGD
    from ewdml_tpu_torch.parallel.ps import build_async_ps

    flags = ("--compress-grad", "qsgd", "--ps-mode", "weights",
             "--num-aggregate", "1", "--momentum", "0.9")
    tcp = ps_net.PSNetServer(_cfg(*flags, "--lossy-weights-down"), port=0)
    plain = ps_net.PSNetServer(_cfg(*flags), port=0)
    try:
        cfg = tcp.cfg
        model = build_model("LeNet", 10, dataset="mnist10k", seed=cfg.seed)
        batch = (np.zeros((8, 28, 28, 1), np.float32), np.zeros(8, np.int32))
        run = build_async_ps(model, SGD(cfg.lr, cfg.momentum),
                             lambda i: iter([batch] * 4), num_workers=1,
                             steps_per_worker=1,
                             compressor=make_compressor("qsgd"),
                             relay_compress=True, seed=cfg.seed,
                             device="cpu")
        ref = run.server
        assert tcp.server.relay_compress and not plain.server.relay_compress
        assert all(torch.equal(a, b)
                   for a, b in zip(tcp.server.params, ref.params))
        setup = ps_net.build_endpoint_setup(cfg)
        dense = transfer.make_device_packer()(plain.server.params).numpy()
        for v in range(2):
            mode, got, version, nbytes = tcp.server.pull(-1)
            _, want, _, want_bytes = ref.pull(-1)
            assert (mode, version) == ("weights", v)
            assert np.array_equal(got, want) and nbytes == want_bytes
            assert not np.array_equal(got, dense)
            assert nbytes == sum(ref.compressor.wire_bytes(tuple(p.shape))
                                 for p in ref.params)
            for srv in (tcp.server, ref):
                srv.push(PushRecord(worker=0, version=v, loss=1.0,
                                    message=_payload(setup, v)))
        assert plain.server.pull(-1)[1].tobytes() == dense.tobytes()
    finally:
        tcp.close()
        plain.close()


def test_health_abort_stops_the_server():
    """``--health abort`` with ``nan@0=1``: the server's watchdog reads the
    poisoned loss, its ``on_abort`` stops the accept loop, and the worker's
    own watchdog raises after the push."""
    cfg = _cfg("--compress-grad", "qsgd", "--num-aggregate", "1",
               "--health", "abort", "--fault-spec", "nan@0=1",
               "--train-dir", "")
    server = ps_net.PSNetServer(cfg, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        worker = ps_net.PSNetWorker(cfg, 0, server.address)
        with pytest.raises(HealthAbort):
            worker.run(3)
        thread.join(20)
        assert not thread.is_alive()
        assert server.health.aborted["kind"] == "nan"
        assert server.server.stats.updates == 1
    finally:
        server.close()


def test_normal_within_4_ulp_of_jax():
    """The uniform on jax's bounds is bit-equal; the normal is within 4
    ulp: torch's and XLA's ``log1p`` differ in the last bit, and torch's
    own can move by an ulp with its vector path (a 2-ulp move of every
    ``log1p`` keeps the normal within 3 ulp)."""
    import jax
    import jax.numpy as jnp

    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    for seed in (0, 42):
        key = prng.fold_in(prng.key(seed), 0x7C13)
        jkey = jax.random.fold_in(jax.random.key(seed), 0x7C13)
        shape = (8, 28, 28, 1)
        u = torch.clamp_min(prng.uniform(key, shape) * float(1 - lo)
                            + float(lo), float(lo))
        ju = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, 1.0))
        assert np.array_equal(u.numpy(), ju)
        want = np.asarray(jax.random.normal(jkey, shape, jnp.float32))
        got = prng.normal(key, shape).numpy()
        ulp = np.abs(want.view(np.int32).astype(np.int64)
                     - got.view(np.int32).astype(np.int64))
        assert got.dtype == np.float32 and ulp.max() <= 4, (seed,
                                                             int(ulp.max()))


# -- rejections by name ---------------------------------------------------------

@pytest.mark.parametrize("extra,name", [
    (["--role", "fed_driver", "--federated", "--adapt", "variance",
      "--pool-size", "8", "--cohort", "2", "--compress-grad", "qsgd",
      "--server-agg", "homomorphic"], "--adapt"),
    (["--role", "server", "--federated", "--metrics-port", "0",
      "--pool-size", "8", "--cohort", "2", "--compress-grad", "qsgd",
      "--server-agg", "homomorphic"], "--metrics-port"),
    (["--role", "server", "--federated", "--round-pipeline", "overlap",
      "--adapt", "variance", "--pool-size", "8", "--cohort", "2",
      "--compress-grad", "qsgd", "--server-agg", "homomorphic"], "--adapt"),
    (["--role", "worker", "--adapt", "variance", "--compress-grad", "qsgd",
      "--replicas", "127.0.0.1:7001"], "--adapt"),
    (["--role", "server", "--metrics-port", "0"], "--metrics-port"),
])
def test_later_slices_rejected_by_name(extra, name, capsys):
    """``--adapt`` is ported and refused only where the JAX package
    refuses it (with ``--federated`` and ``--replicas``), by its
    validators' ``ValueError``. ``--metrics-port`` is served now: the
    server (federated or not) runs, prints ``PS_NET_METRICS ps-server
    <port>`` after its READY line, answers a scrape of its registry and
    stops on ``shutdown`` (``tests/test_torch_obs_serve.py`` holds the
    other roles; ``--role fed_driver`` still refuses it by name)."""
    if name == "--adapt":
        with pytest.raises(ValueError, match=r"\-\-adapt"):
            ps_net.main(BASE + extra)
        return
    import json
    import urllib.request

    port = _free_port()
    rcs = []
    thread = threading.Thread(target=lambda: rcs.append(ps_net.main(
        BASE + extra + ["--port", str(port)])), daemon=True)
    thread.start()
    deadline = time.time() + 60
    out = ""
    while "PS_NET_METRICS" not in out and time.time() < deadline:
        time.sleep(0.05)
        out += capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == f"PS_NET_READY 127.0.0.1:{port}", out
    role, mport = lines[1].split()[1:]
    assert role == "ps-server" and int(mport) > 0
    doc = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{mport}/metrics.json", timeout=10).read())
    assert doc["role"] == "ps-server" and doc["port"] == int(mport)
    assert "ps_net.connections" in doc["metrics"]["gauges"]
    h, _ = ps_net.client_call(("127.0.0.1", port), {"op": "shutdown"})
    assert h == {"op": "shutdown_ok"}
    thread.join(30)
    assert rcs == [0]
    with pytest.raises(OSError):  # main closed the exporter on its way out
        urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                               timeout=5)


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


@pytest.mark.parametrize("role,plane,index", [
    ("replica", "threads", None), ("replica", "evloop", None),
    ("aggregator", "threads", 0), ("aggregator", "evloop", 1)])
def test_replica_and_aggregator_entry_points(role, plane, index, capsys):
    """``ps_net.main --role replica|aggregator`` on the CPU: it prints its
    READY line once it serves, answers ``stats`` and stops on
    ``shutdown``."""
    flags = ["--compress-grad", "qsgd", "--wire-plane", plane]
    port = _free_port()
    if role == "aggregator":
        tree = [f"127.0.0.1:{_free_port()}"]
        tree.insert(index, f"127.0.0.1:{port}")
        flags += ["--server-agg", "homomorphic", "--agg-tree", ",".join(tree)]
        listen = ["--agg-port", str(port), "--agg-index", str(index)]
        marker, stats_op = "PS_AGG_READY", "agg_stats"
    else:
        flags += ["--pull-delta", "--keyframe-every", "2"]
        listen = ["--replica-port", str(port)]
        marker, stats_op = "PS_REPLICA_READY", "stats"
    with _serving(_cfg(*flags)) as server:
        argv = BASE + ["--role", role, "--host", server.address[0],
                       "--port", str(server.address[1]), *flags, *listen]
        rcs = []
        thread = threading.Thread(target=lambda: rcs.append(
            ps_net.main(argv)), daemon=True)
        thread.start()
        deadline = time.time() + 60
        out = ""
        while marker not in out and time.time() < deadline:
            time.sleep(0.05)
            out += capsys.readouterr().out
        assert f"{marker} 127.0.0.1:{port}" in out
        stats, _ = ps_net.client_call(("127.0.0.1", port), {"op": stats_op})
        if role == "replica":
            assert stats["op"] == "stats_ok" and stats["version"] == 0
            assert stats["replica_keyframes"] == 1
        else:
            assert stats["op"] == "agg_stats_ok" and stats["index"] == index
            assert (stats["children"], stats["forwards"]) == (0, 0)
        h, _ = ps_net.client_call(("127.0.0.1", port), {"op": "shutdown"})
        assert h == {"op": "shutdown_ok"}
        thread.join(30)
    assert rcs == [0]


def test_overlap_and_bad_wire_plane_rejected():
    with pytest.raises(ValueError, match="--overlap bucket"):
        ps_net.build_endpoint_setup(_cfg("--overlap", "bucket"))
    cfg = _cfg()
    cfg.wire_plane = "epoll"
    with pytest.raises(ValueError, match="--wire-plane"):
        ps_net.check_supported(cfg)


# -- the scale contract across processes ----------------------------------------

_CRC_SCRIPT = """
import sys
from ewdml_tpu_torch.core.config import from_args
from ewdml_tpu_torch.parallel import ps_net
setup = ps_net.build_endpoint_setup(from_args(sys.argv[1:]))
print(setup.comp.contract_checksum())
"""


def test_scale_contract_agrees_across_processes_and_thread_counts():
    """Processes at different intra-op thread counts derive the same
    homomorphic scale contract (exact: the CRC a worker checks against the
    server's). A multi-threaded CPU conv backward sums in a varying order,
    so the derivation runs on one thread."""
    argv = BASE + ["--compress-grad", "qsgd", "--server-agg", "homomorphic"]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CRC_SCRIPT, *argv],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS=str(t)),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for t in (1, 2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    crcs = {int(o.split()[-1]) for o, _ in outs}
    here = ps_net.build_endpoint_setup(_cfg(*argv[len(BASE):]))
    assert crcs == {here.comp.contract_checksum()}
    assert torch.get_num_threads() == 2


# -- serverkill across processes -------------------------------------------------

def _spawn_server(port, state_dir, flags):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "ewdml_tpu_torch.parallel.ps_net",
         "--role", "server", "--port", str(port), *BASE, *flags,
         "--server-state-dir", state_dir, "--snapshot-every", "2",
         "--fault-spec", "serverkill@3"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _await_ready(proc):
    deadline = time.time() + 60
    while time.time() < deadline:
        line = proc.stdout.readline()
        if "PS_NET_READY" in line:
            return
        if not line and proc.poll() is not None:
            break
    raise AssertionError("the server never became ready")


# Slow: two server processes (torch import, model setup) and the retry
# backoff through the outage take 12 s alone and 35 s in the -n 6 lane.
@pytest.mark.slow
def test_serverkill_recovers_with_a_real_server_process(tmp_path):
    """A server process SIGKILLs itself after apply 3; started again on the
    same directory and port it recovers at 3, the two worker threads ride
    their retries through the outage and resync, and the run ends at
    version 12 (K = 1: every acknowledged push was applied) with the one
    re-sent push of the killed apply acknowledged as a duplicate."""
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    flags = ["--compress-grad", "qsgd", "--num-aggregate", "1",
             "--net-retries", "12", "--net-backoff", "0.25",
             "--net-timeout", "10"]
    state = str(tmp_path / "state")
    first = _spawn_server(port, state, flags)
    second = None
    try:
        _await_ready(first)
        cfg = _cfg(*flags)
        results, errors = {}, []

        def work(i):
            try:
                results[i] = ps_net.PSNetWorker(
                    cfg, i, ("127.0.0.1", port)).run(6)
            except Exception as e:  # noqa: BLE001 -- asserted below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        assert first.wait(timeout=60) == -9
        second = _spawn_server(port, state, flags)
        _await_ready(second)
        for t in threads:
            t.join(60)
        assert not errors and sorted(results) == [0, 1]
        assert all(r["resyncs"] >= 1 for r in results.values())
        stats, _ = ps_net.client_call(("127.0.0.1", port), {"op": "stats"})
        assert stats["recoveries"] == 1 and stats["version"] == 12
        assert stats["dup_pushes"] == 1
        ps_net.client_call(("127.0.0.1", port), {"op": "shutdown"})
        assert second.wait(timeout=30) == 0
    finally:
        for proc in (first, second):
            if proc is not None and proc.poll() is None:
                proc.kill()
