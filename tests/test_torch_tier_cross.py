"""The scale-out tier across the two packages over real sockets: pull
replicas and aggregators of one package between the other package's
endpoints (threads of this test process, LeNet at batch 8 on synthetic
``mnist10k``, QSGD, ``--platform cpu``).

Oracles:
- a replica following the other package's apply server: bit (its pull at
  every version is the server's publication shadow, the stream's keyframe
  and delta bytes being the JAX packer's f32 leaves).
- an aggregator between the other package's leaves and root: bit (the
  root's parameters equal a flat root's that took the same four leaf
  pushes: the int16 frame is ``native.encode_arrays``' in both packages,
  and the integer sum is exact).
- a leaf of one package under the other package's homomorphic root, through
  either package's aggregator: refused by the worker's scale-CRC check, as
  the flat pairings are (``tests/test_torch_ps_net_cross.py``).
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax

from ewdml_tpu import native as jnative
from ewdml_tpu.core.config import from_args as jfrom_args
from ewdml_tpu.parallel import ps_net as jps_net
from ewdml_tpu.parallel.aggtree import AggregatorServer as JAggregator
from ewdml_tpu.parallel.replica import PullReplicaServer as JReplica
from ewdml_tpu.utils import transfer as jtransfer
from ewdml_tpu_torch import native
from ewdml_tpu_torch.core.config import from_args
from ewdml_tpu_torch.parallel import ps_net
from ewdml_tpu_torch.parallel.aggtree import AggregatorServer
from ewdml_tpu_torch.parallel.replica import PullReplicaServer
from ewdml_tpu_torch.utils import prng, transfer

torch.set_num_threads(2)

FLAGS = ["--network", "LeNet", "--dataset", "mnist10k", "--synthetic-data",
         "--batch-size", "8", "--compress-grad", "qsgd", "--fusion", "none",
         "--platform", "cpu"]
STREAM = ["--num-aggregate", "1", "--pull-delta", "--keyframe-every", "4"]


def _cfgs(*extra):
    argv = FLAGS + list(extra)
    return jfrom_args(argv), from_args(argv)


class _Serving:
    """An endpoint of either package serving in a thread."""

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
            try:
                ps_net.client_call(self.address, {"op": "shutdown"},
                                   retries=0, timeout_s=10)
            except OSError:
                pass
        self.thread.join(30)
        self.server.close()


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _jax_frames(server, count):
    """Leaf push frames of ``count`` seeded gradients, compressed by a JAX
    server's own compressor."""
    from ewdml_tpu.parallel.ps import make_compress_tree

    compress_tree = make_compress_tree(server.compressor)
    pack = jtransfer.make_device_packer()
    leaves, treedef = jax.tree.flatten(server.params)
    frames = []
    for i in range(count):
        rng = np.random.default_rng(i)
        grads = jax.tree.unflatten(treedef, [
            (rng.standard_normal(l.shape) * 0.01).astype(np.float32)
            for l in leaves])
        tree = compress_tree(grads, jax.random.key(i))
        frames.append(jnative.encode_arrays([np.asarray(pack(tree))]))
    return frames


def _port_frames(server, count):
    """The same with a port server's compressor."""
    from ewdml_tpu_torch.parallel.ps import make_compress_tree

    compress_tree = make_compress_tree(server.compressor)
    frames = []
    for i in range(count):
        rng = np.random.default_rng(i)
        grads = [torch.from_numpy((rng.standard_normal(tuple(p.shape))
                                   * 0.01).astype(np.float32))
                 for p in server.params]
        tree = compress_tree(grads, prng.key(i))
        frames.append(native.encode_arrays(
            [transfer.make_device_packer()(tree).numpy()]))
    return frames


def _weights(addr) -> bytes:
    hdr, secs = ps_net.client_call(addr, {"op": "pull",
                                          "worker_version": -1})
    assert hdr["op"] == "pull_ok", hdr
    return bytes(secs[0])


# -- replicas --------------------------------------------------------------------------

@pytest.mark.parametrize("pairing", ["port-replica-jax-server",
                                     "jax-replica-port-server"])
def test_replica_follows_the_other_packages_server(pairing):
    """Five K = 1 applies across a keyframe (every 4): at each version the
    replica serves the server's publication shadow byte for byte."""
    jcfg, cfg = _cfgs(*STREAM)
    if pairing == "port-replica-jax-server":
        server = _Serving(jps_net.PSNetServer(jcfg, port=0))
        replica = _Serving(PullReplicaServer(cfg, server.address))
        frame = _jax_frames(server.server.server, 1)[0]
    else:
        server = _Serving(ps_net.PSNetServer(cfg, port=0))
        replica = _Serving(JReplica(jcfg, server.address))
        frame = _port_frames(server.server.server, 1)[0]
    try:
        assert _weights(replica.address) == _weights(server.address)
        for v in range(1, 6):
            hdr, _ = ps_net.client_call(server.address, {
                "op": "push", "worker": 0, "version": v - 1, "loss": 1.0,
                "push_id": f"0:{v}"}, [frame])
            assert hdr == {"op": "push_ok", "accepted": True}
            deadline = time.monotonic() + 30
            while True:
                hdr, secs = ps_net.client_call(replica.address, {
                    "op": "pull", "worker_version": -1})
                if hdr["version"] == v or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            assert hdr["version"] == v
            assert bytes(secs[0]) == \
                server.server.server._pd_shadow.tobytes()
        assert bytes(secs[0]) != _weights(server.address)  # between keyframes
        stats, _ = ps_net.client_call(replica.address, {"op": "stats"})
        assert stats["replica_keyframes"] == 2
        assert stats["replica_keyframe"] == 4
    finally:
        replica.stop()
        server.stop()


# -- aggregators -----------------------------------------------------------------------

def _tree_against_flat(root_pkg: str):
    """Four leaf pushes of ``root_pkg``'s compressor through the other
    package's two aggregators into a tree root, and the same four pushes
    into a flat root: the two roots' weights after the apply."""
    ports = _free_ports(2)
    tree = ",".join(f"127.0.0.1:{p}" for p in ports)
    hom = ["--server-agg", "homomorphic", "--num-aggregate", "4",
           "--net-timeout", "20"]
    jflat, flat = _cfgs(*hom)
    jtree, ptree = _cfgs(*hom, "--agg-tree", tree)
    if root_pkg == "jax":
        roots = [_Serving(jps_net.PSNetServer(c, port=0))
                 for c in (jtree, jflat)]
        aggs = [_Serving(AggregatorServer(ptree, roots[0].address,
                                          port=ports[i], index=i))
                for i in range(2)]
        frames = _jax_frames(roots[1].server.server, 4)
    else:
        roots = [_Serving(ps_net.PSNetServer(c, port=0))
                 for c in (ptree, flat)]
        aggs = [_Serving(JAggregator(jtree, roots[0].address,
                                     port=ports[i], index=i))
                for i in range(2)]
        frames = _port_frames(roots[1].server.server, 4)
    replies = {}

    def leaf(w):
        conn = ps_net.RetryingConnection(aggs[w % 2].address, timeout_s=30,
                                         retries=0)
        try:
            replies[w] = conn.call(
                {"op": "push", "worker": w, "version": 0, "loss": 1.0,
                 "plan_version": 0, "push_id": f"{w}:0"}, [frames[w]])[0]
        finally:
            conn.close()

    try:
        for w in range(4):
            h, _ = ps_net.client_call(aggs[w % 2].address,
                                      {"op": "agg_register", "worker": w})
            assert h["op"] == "agg_register_ok"
        threads = [threading.Thread(target=leaf, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for w in range(4):
            h, _ = ps_net.client_call(roots[1].address, {
                "op": "push", "worker": w, "version": 0, "loss": 1.0,
                "push_id": f"{w}:0"}, [frames[w]])
            assert h["accepted"]
        stats = [ps_net.client_call(r.address, {"op": "stats"})[0]
                 for r in roots]
        weights = [_weights(r.address) for r in roots]
        agg_stats = [ps_net.client_call(a.address, {"op": "agg_stats"})[0]
                     for a in aggs]
    finally:
        for s in aggs + roots:
            s.stop()
    return replies, stats, weights, agg_stats, frames


@pytest.mark.parametrize("root_pkg", ["jax", "port"])
def test_aggregator_between_the_other_packages_leaves_and_root(root_pkg):
    replies, stats, weights, agg_stats, frames = _tree_against_flat(root_pkg)
    assert replies == {w: {"op": "push_ok", "accepted": True}
                       for w in range(4)}
    tree, flat = stats
    assert (tree["version"], flat["version"]) == (1, 1)
    assert (tree["agg_pushes"], tree["agg_weight"], tree["decode_count"]) \
        == (2, 4, 1)
    assert flat["decode_count"] == 1
    assert weights[0] == weights[1]
    # The in-links: four int8 leaf frames into the flat root, two int16
    # frames of the same levels into the tree root.
    n = native.decode_arrays(frames[0])[0].size
    wide = native.encoded_arrays_size([np.empty(2 * n, np.uint8)])
    assert flat["bytes_up"] == 4 * len(frames[0])
    assert tree["bytes_up"] == 2 * wide == sum(a["bytes_up"]
                                               for a in agg_stats)
    assert [a["forwarded_weight"] for a in agg_stats] == [2, 2]


@pytest.mark.parametrize("root_pkg", ["jax", "port"])
def test_other_packages_leaf_under_a_tree_root_fails_on_the_scale_crc(
        root_pkg):
    """A leaf of one package under the other's homomorphic root, through
    an aggregator of its own package: its first pull's CRC check raises."""
    ports = _free_ports(2)
    tree = ",".join(f"127.0.0.1:{p}" for p in ports)
    jcfg, cfg = _cfgs("--server-agg", "homomorphic", "--num-aggregate", "2",
                      "--agg-tree", tree)
    if root_pkg == "jax":
        root = _Serving(jps_net.PSNetServer(jcfg, port=0))
        aggs = [_Serving(AggregatorServer(cfg, root.address, port=ports[i],
                                          index=i)) for i in range(2)]
        worker = ps_net.PSNetWorker(cfg, 0, root.address)
    else:
        root = _Serving(ps_net.PSNetServer(cfg, port=0))
        aggs = [_Serving(JAggregator(jcfg, root.address, port=ports[i],
                                     index=i)) for i in range(2)]
        worker = jps_net.PSNetWorker(jcfg, 0, root.address)
    try:
        with pytest.raises(RuntimeError, match="contract desync"):
            worker.run(1)
        h, _ = ps_net.client_call(aggs[0].address, {"op": "agg_stats"})
        assert h["children"] == 1 and h["pushes_in"] == 0
    finally:
        for s in aggs + [root]:
            s.stop()
