"""The cross-implementation pin of the TCP tier: a JAX server and a port
server, and workers of both packages, on one localhost wire (threads of
this test process, LeNet at batch 8 on synthetic ``mnist10k``, QSGD,
``--platform cpu``).

The two packages' initial weights differ (the port's initialisers draw from
a torch generator), so the port server starts from the JAX server's initial
snapshot (``--server-state-dir``), which its ``recover`` reads.

Oracles:
- (a) the same scripted requests to the JAX server and to the port server
  recovered from its snapshot: bit for every reply frame before the apply
  (the first pull's headers and weights, the push verdicts), for the
  headers after it, and for the control replies (resync, join, bn_stats,
  an unknown op, shutdown); the weights after one K = 2 apply within a
  tolerance of the decode oracle's kind (ROADMAP Queue 3 item 1): the two
  decodes and SGD steps round differently in the last bits, so every
  weight is within 4 float32 ulps of the larger weight's magnitude, i.e.
  ``|d| <= 2**-21 * max|w|``.
- (b) mixed training in decode mode, a port worker against the JAX server
  and a JAX worker against the port server, 3 steps: every push accepted;
  the server's ``bytes_up``/``bytes_down`` equal the one-package run's
  (the payloads are the same schema); the two sides' socket counts agree
  exactly.
- (c) homomorphic pairings across the packages fail loud: the worker's
  scale-CRC check raises, and the port's ``recover`` of a homomorphic JAX
  snapshot raises the scale-contract desync.
"""

import os
import shutil
import threading

import numpy as np
import pytest
import torch

from ewdml_tpu.core.config import from_args as jfrom_args
from ewdml_tpu.parallel import ps_net as jps_net
from ewdml_tpu_torch import native
from ewdml_tpu_torch.core.config import from_args
from ewdml_tpu_torch.parallel import ps_net
from ewdml_tpu_torch.utils import prng, transfer

torch.set_num_threads(2)

FLAGS = ["--network", "LeNet", "--dataset", "mnist10k", "--synthetic-data",
         "--batch-size", "8", "--compress-grad", "qsgd", "--fusion", "none",
         "--platform", "cpu"]


def _cfgs(*extra):
    argv = FLAGS + list(extra)
    return jfrom_args(argv), from_args(argv)


class _Serving:
    """A server of either package serving in a thread."""

    def __init__(self, server):
        self.server = server
        self.thread = threading.Thread(target=server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def address(self):
        return tuple(self.server.address)

    def stop(self):
        if self.thread.is_alive():
            ps_net.client_call(self.address, {"op": "shutdown"})
        self.thread.join(30)
        self.server.close()


def _payload(seed: int) -> bytes:
    setup = ps_net.build_endpoint_setup(_cfgs()[1])
    rng = np.random.default_rng(seed)
    grads = [torch.from_numpy(rng.standard_normal(tuple(g.shape)).astype(
        np.float32) * 0.01) for g in setup.params]
    tree = setup.compress_tree(grads, prng.key(seed))
    return native.encode_arrays([transfer.make_device_packer()(tree).numpy()])


def _script(address, payload: bytes) -> list:
    import socket

    replies = []
    with socket.create_connection(address, timeout=60) as s:
        def call(header, sections=()):
            ps_net.send_frame(s, ps_net.make_request(header, sections))
            replies.append(ps_net.recv_frame(s))

        call({"op": "pull", "worker": 0, "worker_version": -1,
              "plan_version": 0})
        for w in (0, 1):
            call({"op": "push", "worker": w, "version": 0, "loss": 1.25,
                  "plan_version": 0, "push_id": f"{w}:0"}, [payload])
        call({"op": "pull", "worker": 0, "worker_version": 0,
              "plan_version": 0})
        for header in ({"op": "resync", "worker": 1, "plan_version": 0},
                       {"op": "join", "worker": 4},
                       {"op": "bn_stats", "worker": 0},
                       {"op": "frobnicate"}, {"op": "shutdown"}):
            call(header)
    return replies


def test_port_server_from_a_jax_snapshot_replies_as_the_jax_server(tmp_path):
    jcfg, _ = _cfgs("--num-aggregate", "2", "--server-state-dir",
                    str(tmp_path / "jax"))
    jserver = jps_net.PSNetServer(jcfg, port=0)  # writes its snapshot
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    _, cfg = _cfgs("--num-aggregate", "2", "--server-state-dir",
                   str(tmp_path / "port"))
    server = ps_net.PSNetServer(cfg, port=0)
    assert server._recoveries == 1 and server.server.version == 0
    payload = _payload(7)
    got = {}
    for name, srv in (("jax", jserver), ("port", server)):
        serving = _Serving(srv)
        got[name] = _script(serving.address, payload)
        serving.thread.join(30)
        srv.close()
    jr, pr = got["jax"], got["port"]
    assert pr[:3] == jr[:3] and pr[4:] == jr[4:]
    (jh, (jw,)), (ph, (pw,)) = (ps_net.parse_request(jr[3]),
                                ps_net.parse_request(pr[3]))
    assert ph == jh == {"op": "pull_ok", "mode": "weights", "version": 1,
                        "nbytes": len(pw)}
    a = np.frombuffer(bytes(jw), np.float32)
    b = np.frombuffer(bytes(pw), np.float32)
    assert np.max(np.abs(a - b)) <= 2.0 ** -21 * np.max(np.abs(a))
    before = np.frombuffer(bytes(ps_net.parse_request(pr[0])[1][0]),
                           np.float32)
    assert not np.array_equal(b, before)  # the apply moved the weights


def _train(server, worker_cls, cfg, steps=3):
    """One worker of ``worker_cls`` against ``server`` for ``steps``; the
    server's stats, the worker's result and the stats request's bytes."""
    serving = _Serving(server)
    try:
        result = worker_cls(cfg, 0, serving.address).run(steps)
        stats_req = len(ps_net.make_request({"op": "stats"})) + 8
        stats, _ = ps_net.client_call(serving.address, {"op": "stats"})
    finally:
        serving.stop()
    return stats, result, stats_req


@pytest.mark.parametrize("pairing", ["jax-server", "port-server"])
def test_mixed_package_training_in_decode_mode(pairing):
    jcfg, cfg = _cfgs("--num-aggregate", "1")
    base = _train(ps_net.PSNetServer(cfg, port=0), ps_net.PSNetWorker,
                  cfg)[0]
    if pairing == "jax-server":
        run = _train(jps_net.PSNetServer(jcfg, port=0), ps_net.PSNetWorker,
                     cfg)
    else:
        run = _train(ps_net.PSNetServer(cfg, port=0), jps_net.PSNetWorker,
                     jcfg)
    stats, result, stats_req = run
    assert result["rejected"] == 0 and np.isfinite(result["loss"])
    assert (stats["pushes"], stats["updates"]) == (3, 3)
    assert (stats["bytes_up"], stats["bytes_down"]) == (base["bytes_up"],
                                                        base["bytes_down"])
    assert stats["socket_received"] - stats_req == result["socket_sent"]
    assert stats["socket_sent"] == result["socket_received"]


HOM = ("--num-aggregate", "1", "--server-agg", "homomorphic")


@pytest.mark.parametrize("pairing", ["jax-server", "port-server"])
def test_homomorphic_pairing_fails_on_the_workers_scale_crc(pairing):
    jcfg, cfg = _cfgs(*HOM)
    if pairing == "jax-server":
        server, worker_cls, wcfg = (jps_net.PSNetServer(jcfg, port=0),
                                    ps_net.PSNetWorker, cfg)
    else:
        server, worker_cls, wcfg = (ps_net.PSNetServer(cfg, port=0),
                                    jps_net.PSNetWorker, jcfg)
    serving = _Serving(server)
    try:
        with pytest.raises(RuntimeError, match="contract desync"):
            worker_cls(wcfg, 0, serving.address).run(1)
    finally:
        serving.stop()


def test_port_recover_of_a_homomorphic_jax_snapshot_refuses(tmp_path):
    jcfg, _ = _cfgs(*HOM, "--server-state-dir", str(tmp_path))
    jps_net.PSNetServer(jcfg, port=0).close()
    assert os.path.exists(tmp_path / "snapshot.bin")
    _, cfg = _cfgs(*HOM, "--server-state-dir", str(tmp_path))
    with pytest.raises(RuntimeError, match="scale-contract desync"):
        ps_net.PSNetServer(cfg, port=0)
