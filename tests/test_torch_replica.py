"""The read replicas and the publication stream (``--replicas``,
``--pull-delta``): the port against the JAX package, on the CPU.

Oracles, per test:
- ``pd_apply_delta`` and ``pd_contract_crc``: bit against the JAX functions.
- the stream's delta quantizer: given the same difference and key, the
  scales within 4 f32 ulps (``shared_scales``' block norms are f32
  reductions summed in different orders) and the levels bit-equal wherever
  the two scales are; elsewhere a level within +-1 on at most 0.1% of the
  elements (the tolerance oracle of ROADMAP Queue 3 item 4).
- ``subscribe_stream``'s modes and bytes: exact (the keyframe is the packed
  parameters; a replay through ``pd_apply_delta`` equals the shadow bit for
  bit at every version).
- a ``PullReplicaServer`` following a port server over sockets: bit (its
  pulls equal the server's shadow at every version and a direct pull at a
  keyframe) and exact (its refusals).
- eight pullers against a replica while the server applies: exact (every
  reply pairs its version with that version's shadow bytes).
- the address-list failover and ``parse_replicas``: exact.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ewdml_tpu.ops import qsgd as jqsgd
from ewdml_tpu.parallel import ps as jps
from ewdml_tpu.parallel import ps_net as jps_net
from ewdml_tpu_torch import native
from ewdml_tpu_torch.core.config import from_args
from ewdml_tpu_torch.ops.qsgd import QSGDCompressor
from ewdml_tpu_torch.optim import SGD
from ewdml_tpu_torch.parallel import ps, ps_net
from ewdml_tpu_torch.parallel.replica import PullReplicaServer, subscribe_call
from ewdml_tpu_torch.utils import prng, transfer

torch.set_num_threads(2)

BASE = ["--platform", "cpu", "--network", "LeNet", "--dataset", "mnist10k",
        "--synthetic-data", "--batch-size", "8", "--fusion", "none",
        "--compress-grad", "qsgd", "--num-aggregate", "1", "--momentum",
        "0.0", "--lr", "0.05"]


# -- the stream's functions --------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4096, 4097, 3 * 4096 + 5, 61_706])
def test_pd_apply_delta_and_contract_crc_equal_jax(n):
    rng = np.random.default_rng(n)
    flat = rng.standard_normal(n).astype(np.float32)
    levels = rng.integers(-127, 128, n).astype(np.int8)
    scales = rng.random(-(-n // ps.PD_BLOCK)).astype(np.float32)
    got = ps.pd_apply_delta(flat, levels, scales)
    want = jps.pd_apply_delta(flat, levels, scales)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert (ps.PD_BLOCK, ps.PD_S) == (jps.PD_BLOCK, jps.PD_S)
    for every in (1, 4, 64):
        assert ps.pd_contract_crc(4 * n, ps.PD_BLOCK, ps.PD_S, every) == \
            jps.pd_contract_crc(4 * n, jps.PD_BLOCK, jps.PD_S, every)


@pytest.mark.parametrize("n,version", [(61_706, 1), (61_706, 7),
                                       (3 * 4096 + 5, 3)])
def test_delta_quantizer_matches_jax(n, version):
    diff = (np.random.default_rng(version).standard_normal(n) * 1e-3).astype(
        np.float32)
    diff[:4096] = 0.0  # a zero block takes the fallback scale
    levels, scales = ps.pd_quantize(
        torch.from_numpy(diff.copy()),
        prng.fold_in(prng.key(0 ^ 0x9D17), version))
    jkey = jax.random.fold_in(jax.random.key(0 ^ 0x9D17), version)
    jscales = jqsgd.shared_scales(jnp.asarray(diff), jps.PD_S,
                                  block=jps.PD_BLOCK)
    jlevels = jqsgd.shared_levels(
        jkey, jnp.asarray(diff),
        jqsgd.expand_scales(jscales, jps.PD_BLOCK, n), jps.PD_S)
    sc, jsc = scales.numpy(), np.asarray(jscales)
    assert sc.dtype == np.float32 and levels.dtype == torch.int8
    assert np.all(np.abs(sc - jsc) <= 2.0 ** -21 * np.abs(jsc))
    same = np.repeat(sc == jsc, ps.PD_BLOCK)[:n]
    lv, jlv = levels.numpy(), np.asarray(jlevels)
    assert np.array_equal(lv[same], jlv[same])
    off = np.abs(lv.astype(np.int32) - jlv.astype(np.int32))
    assert off.max() <= 1 and np.count_nonzero(off) <= 0.001 * n


# -- subscribe_stream (in-process server) --------------------------------------------

def _server(pull_delta=True, every=4, n=5000):
    rng = np.random.default_rng(1)
    server = ps.ParameterServer(
        [torch.from_numpy(rng.standard_normal(n).astype(np.float32))],
        SGD(0.1), QSGDCompressor(127), num_aggregate=1, device="cpu",
        pull_delta=pull_delta, keyframe_every=every, seed=3)
    ct = ps.make_compress_tree(server.compressor)
    server.register_payload_schema(ct([torch.zeros(n)], prng.key(0)))

    def push(i):
        g = [torch.from_numpy(np.random.default_rng(10 + i).standard_normal(
            n).astype(np.float32))]
        buf = transfer.make_device_packer()(ct(g, prng.key(i))).numpy()
        assert server.push(ps.PushRecord(
            worker=0, version=server.version, loss=1.0,
            message=native.encode_arrays([buf])))

    return server, push


def _packed(server) -> bytes:
    return transfer.make_device_packer()(server.params).numpy().tobytes()


def test_subscribe_stream_modes_and_replay():
    server, push = _server()
    mode, version, kf, bufs = server.subscribe_stream(-1)
    assert (mode, version, kf, len(bufs)) == ("keyframe", 0, 0, 1)
    assert bufs[0].tobytes() == _packed(server)
    contract = server.pd_contract()
    assert contract == {"flat": 20_000, "block": 4096, "s": 127,
                        "keyframe_every": 4,
                        "crc": jps.pd_contract_crc(20_000, 4096, 127, 4)}
    flat = np.frombuffer(bufs[0].tobytes(), np.float32).copy()
    for v in range(1, 4):
        push(v)
        mode, version, kf, bufs = server.subscribe_stream(v - 1)
        assert (mode, version, kf, len(bufs)) == ("delta", v, 0, 2)
        assert bufs[0].dtype == np.int8 and bufs[1].size == 2
        flat = ps.pd_apply_delta(flat, bufs[0], bufs[1])
        assert flat.tobytes() == server._pd_shadow.tobytes()
        assert flat.tobytes() != _packed(server)  # the shadow lags
    assert server.subscribe_stream(3) == ("delta", 3, 0, [])
    push(4)
    mode, version, kf, bufs = server.subscribe_stream(3)
    assert (mode, version, kf, len(bufs)) == ("keyframe", 4, 4, 1)
    assert bufs[0].tobytes() == _packed(server)  # exact at a keyframe
    push(5)
    mode, version, kf, bufs = server.subscribe_stream(1)  # behind the window
    assert (mode, version, kf, len(bufs)) == ("keyframe", 5, 4, 3)
    flat = ps.pd_apply_delta(np.frombuffer(bufs[0], np.float32), bufs[1],
                             bufs[2])
    assert flat.tobytes() == server._pd_shadow.tobytes()


def test_without_pull_delta_every_version_is_a_keyframe():
    server, push = _server(pull_delta=False)
    assert server.pd_contract()["keyframe_every"] == 1
    server.subscribe_stream(-1)
    for v in (1, 2):
        push(v)
        mode, version, kf, bufs = server.subscribe_stream(v - 1)
        assert (mode, version, kf) == ("keyframe", v, v)
        assert bufs[0].tobytes() == _packed(server)


def test_stream_is_free_until_a_subscriber_arms_it():
    server, push = _server()
    push(1)
    assert not server._pd_on and server._pd_shadow is None
    assert server.subscribe_stream(-1)[:3] == ("keyframe", 1, 1)


# -- a replica over sockets -----------------------------------------------------------

class _Serving:
    def __init__(self, server):
        self.server = server
        self.thread = threading.Thread(target=server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        try:
            ps_net.client_call(self.server.address, {"op": "shutdown"},
                               retries=0, timeout_s=10)
        except OSError:
            pass
        self.thread.join(30)
        self.server.close()


def _push_n(addr, payload, n):
    for _ in range(n):
        hdr, _ = ps_net.client_call(addr, {"op": "push", "worker": 0,
                                           "version": 0, "loss": 1.0},
                                    [payload])
        assert hdr["op"] == "push_ok", hdr


def _wait_version(addr, version, deadline_s=30):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        hdr, _ = ps_net.client_call(addr, {"op": "stats"}, timeout_s=10)
        if hdr["version"] >= version:
            return hdr
        time.sleep(0.02)
    raise AssertionError(f"replica never reached v{version}: {hdr}")


@pytest.mark.parametrize("plane", ["threads", "evloop"])
def test_replica_tracks_a_port_server(plane):
    """Bootstrap, replay, the shadow at every version and the parameters at
    a keyframe, resync, and the read-only refusals."""
    cfg = from_args(BASE + ["--pull-delta", "--keyframe-every", "4",
                            "--wire-plane", plane])
    server = _Serving(ps_net.PSNetServer(cfg, port=0))
    replica = _Serving(PullReplicaServer(cfg, server.server.address))
    setup = ps_net.build_endpoint_setup(cfg)
    payload = native.encode_arrays(
        [transfer.make_device_packer()(setup.template).numpy()])
    raddr, saddr = replica.server.address, server.server.address
    try:
        hdr, secs = ps_net.client_call(raddr, {"op": "pull",
                                               "worker_version": -1})
        assert hdr == {"op": "pull_ok", "mode": "weights", "version": 0}
        boot = bytes(secs[0])
        for v in range(1, 6):
            _push_n(saddr, payload, 1)
            _wait_version(raddr, v)
            hdr, secs = ps_net.client_call(raddr, {"op": "pull",
                                                   "worker_version": -1})
            assert hdr["version"] == v
            assert bytes(secs[0]) == \
                server.server.server._pd_shadow.tobytes()
            if v == 4:
                dhdr, dsecs = ps_net.client_call(saddr, {
                    "op": "pull", "worker_version": -1})
                assert dhdr["version"] == 4 and bytes(dsecs[0]) == bytes(
                    secs[0])
        assert bytes(secs[0]) != boot
        stats = _wait_version(raddr, 5)
        assert stats["replica_keyframes"] == 2 and stats["replica_deltas"] \
            >= 4 and stats["replica_keyframe"] == 4
        reg = replica.server.registry.snapshot()
        assert reg["gauges"]["replica.version"] == 5
        assert reg["counters"]["replica.pulls"] == stats["replica_pulls"]
        hdr, _ = ps_net.client_call(raddr, {"op": "resync", "worker": 0})
        assert hdr == {"op": "resync_ok", "version": 5}
        with pytest.raises((ConnectionError, OSError)):
            with socket.create_connection(raddr, timeout=10) as s:
                ps_net.send_frame(s, ps_net.make_request(
                    {"op": "push", "worker": 0, "version": 5, "loss": 1.0},
                    [payload]))
                ps_net.recv_frame(s)
        hdr, _ = ps_net.client_call(raddr, {"op": "fed_begin", "round": 0})
        assert hdr["op"] == "error" and "replica" in hdr["detail"]
        srv_stats, _ = ps_net.client_call(saddr, {"op": "stats"})
        assert "pull" in srv_stats["segments"]  # only the direct one above
        assert srv_stats["segments"]["pull"]["latency_s"]["count"] == 1
    finally:
        replica.stop()
        server.stop()


def test_replica_swaps_its_copy_whole_under_concurrent_pulls():
    """Stress: eight pullers against a replica polling every 5 ms while a
    pusher drives eight applies, under a short switch interval. Every reply
    pairs a version with that version's shadow bytes: a torn swap of the
    served copy would pair one version with another's bytes."""
    import sys

    cfg = from_args(BASE + ["--pull-delta", "--keyframe-every", "3",
                            "--subscribe-every", "0.005"])
    server = _Serving(ps_net.PSNetServer(cfg, port=0))
    srv = server.server.server
    shadows = {}
    publish = srv._pd_publish

    def recording_publish(new_params, version_now):
        publish(new_params, version_now)
        shadows[version_now] = srv._pd_shadow.tobytes()

    srv._pd_publish = recording_publish
    replica = _Serving(PullReplicaServer(cfg, server.server.address))
    shadows[0] = srv._pd_shadow.tobytes()
    setup = ps_net.build_endpoint_setup(cfg)
    payload = native.encode_arrays(
        [transfer.make_device_packer()(setup.template).numpy()])
    seen, errors, done = [], [], threading.Event()

    def puller():
        try:
            while not done.is_set():
                hdr, secs = ps_net.client_call(replica.server.address, {
                    "op": "pull", "worker_version": -1})
                seen.append((hdr["version"], bytes(secs[0])))
        except Exception as e:  # noqa: BLE001 -- asserted below
            errors.append(e)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pullers = [threading.Thread(target=puller) for _ in range(8)]
        for t in pullers:
            t.start()
        _push_n(server.server.address, payload, 8)
        _wait_version(replica.server.address, 8)
        done.set()
        for t in pullers:
            t.join(30)
        assert not any(t.is_alive() for t in pullers)
    finally:
        sys.setswitchinterval(saved)
        done.set()
        replica.stop()
        server.stop()
    assert not errors and len(seen) >= 8
    assert {v for v, _ in seen} <= set(range(9))
    assert all(b == shadows[v] for v, b in seen)


def _stub_upstream(replies):
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)

    def serve():
        try:
            conn, _ = lsock.accept()
            with conn:
                conn.settimeout(30)
                for header, secs in replies:
                    ps_net.recv_frame(conn)
                    ps_net.send_frame(conn, ps_net.make_request(header, secs))
        except OSError:
            pass
        finally:
            lsock.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return lsock.getsockname(), t


def _kf(version, n=8, every=4, crc=None):
    flat = np.arange(n, dtype=np.float32)
    crc = ps.pd_contract_crc(4 * n, 4096, 127, every) if crc is None else crc
    return ({"op": "subscribe_ok", "mode": "keyframe", "version": version,
             "keyframe": version, "flat": 4 * n, "block": 4096, "s": 127,
             "keyframe_every": every, "crc": crc}, [flat.tobytes()])


@pytest.mark.parametrize("second,match", [
    (_kf(1, every=8), "contract changed"),
    (_kf(1, crc=12345), "CRC mismatch"),
    (_kf(1, n=16), "contract changed")])
def test_replica_refuses_a_changed_contract(second, match):
    addr, t = _stub_upstream([_kf(0), second])
    cfg = from_args(BASE + ["--net-retries", "0"])
    replica = PullReplicaServer(cfg, addr)
    try:
        with pytest.raises(RuntimeError, match=match):
            replica._sync_once()
    finally:
        replica.close()
        t.join(10)


def test_replica_refuses_an_upstream_that_is_not_a_stream():
    addr, t = _stub_upstream([({"op": "error", "detail": "x"}, [])])
    conn = ps_net.RetryingConnection(addr, timeout_s=10, retries=0)
    try:
        with pytest.raises(ConnectionError, match="subscribe refused"):
            subscribe_call(conn, -1)
    finally:
        conn.close()
        t.join(10)


# -- failover and the address list ----------------------------------------------------

def test_dead_first_address_rotates_to_a_live_one():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        dead = probe.getsockname()  # bound, never listening
        addr, t = _stub_upstream([({"op": "stats_ok", "version": 7}, [])])
        conn = ps_net.RetryingConnection([dead, addr], timeout_s=10,
                                         retries=3, backoff_s=0.05)
        try:
            header, _ = conn.call({"op": "stats"})
        finally:
            conn.close()
        t.join(10)
    assert header["version"] == 7 and conn.addr == addr
    assert conn.counters.retries == 1


@pytest.mark.parametrize("spec", ["h1:7001", "h1:7001,h2:7002,h3:7003",
                                  " h1:7001 , h2:7002, ", "", "   ", ",",
                                  "h1", "h1:xx"])
def test_parse_replicas_matches_jax(spec):
    try:
        want = jps_net.parse_replicas(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as exc:
            ps_net.parse_replicas(spec)
        assert str(exc.value) == str(e)
        return
    assert ps_net.parse_replicas(spec) == want
