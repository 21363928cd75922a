"""The aggregation tree (``--agg-tree``): the port's budgets, config matrix,
widened schema, weighted root and aggregator against the JAX package, on
the CPU.

Oracles, per test:
- the budgets (``max_subtree_weight``, ``check_tier_budget``,
  ``tree_max_cohort``, ``federated_max_cohort``) and the config matrices
  (``validate_agg_tree``, ``validate_replicas``, ``parse_agg_tree``): exact,
  the same values and the same messages as the JAX functions.
- ``widen_payload_tree``: bit (the packed bytes and leaf specs of the JAX
  int16 template).
- ``homomorphic_mean(k=)`` on int16 stacks and ``decode_sum`` at any k: bit
  against the JAX twin and ``pallas_kernels.acc_decode(interpret=True)``
  given the same scales (an exact integer sum, ``1/k`` rounded once to f32,
  one f32 product per element in the same order).
- the port's tree root against its flat root, the push-id retry, the
  fragmented round, the WAL replay: bit (parameters) and exact (versions,
  counters, one decode a round).
- the aggregator's ``dup_members`` loop and its control plane: exact (the
  forwarded members, weights and levels; the leaves' verdicts).
- ``aggkill@A=N``: exact, the JAX grammar.
- a rehomed leaf under the base policy: exact, the same counts in both
  packages (it is counted twice: ROADMAP Queue 3, reference behaviour).
"""

import socket
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from ewdml_tpu import native as jnative
from ewdml_tpu.core import config as jconfig
from ewdml_tpu.ops import homomorphic as jhom
from ewdml_tpu.ops import pallas_kernels
from ewdml_tpu.ops import qsgd as jqsgd
from ewdml_tpu.optim import SGD as JSGD
from ewdml_tpu.parallel import ps as jps
from ewdml_tpu.parallel.faults import FaultSpec as JFaultSpec
from ewdml_tpu.utils import transfer as jtransfer
from ewdml_tpu_torch import native
from ewdml_tpu_torch.core import config
from ewdml_tpu_torch.ops import homomorphic, kernels, qsgd
from ewdml_tpu_torch.optim import SGD
from ewdml_tpu_torch.parallel import ps, ps_net
from ewdml_tpu_torch.parallel.aggtree import AggregatorServer
from ewdml_tpu_torch.parallel.faults import FaultSpec
from ewdml_tpu_torch.utils import prng, transfer

torch.set_num_threads(2)

TREE2 = "127.0.0.1:7201,127.0.0.1:7202"
N = 1024


# -- budgets and the config matrix ------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(s=st.integers(1, 127), weight=st.integers(1, 40_000),
       n_aggs=st.integers(1, 20_000))
def test_budgets_equal_the_jax_functions(s, weight, n_aggs):
    assert homomorphic.INT16_WIRE_MAX == jhom.INT16_WIRE_MAX
    assert homomorphic.max_subtree_weight(s) == jhom.max_subtree_weight(s)
    assert homomorphic.tree_max_cohort(s, n_aggs) == jhom.tree_max_cohort(
        s, n_aggs)
    fits = weight <= jhom.max_subtree_weight(s)
    for check in (homomorphic.check_tier_budget, jhom.check_tier_budget):
        if fits:
            check(s, weight)
        else:
            with pytest.raises(ValueError, match="int16 mid-tier wire"):
                check(s, weight)


@pytest.mark.parametrize("s", [1, 2, 63, 127])
def test_max_subtree_weight_is_tight(s):
    w = homomorphic.max_subtree_weight(s)
    assert w * s <= homomorphic.INT16_WIRE_MAX < (w + 1) * s
    sat = np.full((w, 8), s, np.int8).astype(np.int32).sum(axis=0)
    assert np.array_equal(sat.astype(np.int16).astype(np.int32), sat)


def _both(**kw):
    return jconfig.TrainConfig(**kw), config.TrainConfig(**kw)


def _same_verdict(jfn, fn, jcfg, cfg):
    """Both validators accept, or both raise the same message."""
    try:
        jfn(jcfg)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        fn(cfg)
    else:
        with pytest.raises(ValueError) as exc:
            fn(cfg)
        assert str(exc.value) == want
    return want


HOM = dict(compress_grad="qsgd", quantum_num=127, server_agg="homomorphic")
AGG_TREE_CASES = [
    dict(agg_tree=TREE2, **HOM),
    dict(agg_tree=""),
    dict(compress_grad="topk", agg_tree=""),
    dict(agg_tree="127.0.0.1:7201,127.0.0.1:7201", **HOM),
    dict(agg_tree=TREE2, **{**HOM, "server_agg": "decode"}),
    dict(agg_tree=TREE2, **{**HOM, "compress_grad": "topk"}),
    dict(agg_tree=TREE2, **{**HOM, "compress_grad": "topk_qsgd"}),
    dict(agg_tree=TREE2, **{**HOM, "compress_grad": "none"}),
    dict(agg_tree=TREE2, adapt="variance", adapt_every=10, **HOM),
    dict(agg_tree=TREE2, federated=True, pool_size=1024, cohort=517, **HOM),
    dict(agg_tree=TREE2, federated=True, pool_size=1024, cohort=516, **HOM),
    dict(agg_tree="localhost", **HOM),
]


@pytest.mark.parametrize("i", range(len(AGG_TREE_CASES)))
def test_validate_agg_tree_matches_jax(i):
    jcfg, cfg = _both(**AGG_TREE_CASES[i])
    _same_verdict(jconfig.validate_agg_tree, config.validate_agg_tree,
                  jcfg, cfg)


REPLICA_CASES = [
    dict(),
    dict(keyframe_every=0),
    dict(keyframe_every=1, pull_delta=True),
    dict(replicas="127.0.0.1:7001"),
    dict(replicas="127.0.0.1:7001", subscribe_every_s=0.0),
    dict(replicas="127.0.0.1:7001", adapt="bytes"),
    dict(replicas="127.0.0.1:7001", ps_down="delta"),
    dict(replicas="127.0.0.1:7001", lossy_weights_down=True),
    dict(adapt="bytes"),
]


@pytest.mark.parametrize("i", range(len(REPLICA_CASES)))
def test_validate_replicas_matches_jax(i):
    jcfg, cfg = _both(**REPLICA_CASES[i])
    _same_verdict(jconfig.validate_replicas, config.validate_replicas,
                  jcfg, cfg)


@pytest.mark.parametrize("spec", [
    "", "   ", TREE2, " h1:1 , h2:2, ", "localhost", "host:notaport", ",",
    ":7000", "a:b:7000"])
def test_parse_agg_tree_matches_jax(spec):
    try:
        want = jconfig.parse_agg_tree(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as exc:
            config.parse_agg_tree(spec)
        assert str(exc.value) == str(e)
        return
    assert config.parse_agg_tree(spec) == want


@pytest.mark.parametrize("kw", [
    dict(**HOM), dict(agg_tree=TREE2, **HOM),
    dict(agg_tree=TREE2, **{**HOM, "quantum_num": 3}),
    dict(compress_grad="qsgd")])
def test_federated_max_cohort_matches_jax(kw):
    jcfg, cfg = _both(**kw)
    assert config.federated_max_cohort(cfg) == jconfig.federated_max_cohort(
        jcfg)


# -- the widened schema and the weighted mean --------------------------------------

def _levels(rows, n, s=127, seed=0):
    return np.random.default_rng(seed).integers(
        -s, s + 1, size=(rows, n)).astype(np.int8)


@pytest.mark.parametrize("block", [None, 4096])
def test_widen_payload_tree_is_the_jax_layout(block):
    lv = _levels(2, 5000)
    jtmpl = {"a": jqsgd.SharedScaleQSGDPayload(
        levels=jnp.asarray(lv[0]), shape=(50, 100), s=127, block=block),
        "b": jqsgd.SharedScaleQSGDPayload(
            levels=jnp.asarray(lv[1]), shape=(5000,), s=127, block=block)}
    tmpl = [qsgd.SharedScaleQSGDPayload(levels=torch.from_numpy(lv[0]),
                                        shape=(50, 100), s=127, block=block),
            qsgd.SharedScaleQSGDPayload(levels=torch.from_numpy(lv[1]),
                                        shape=(5000,), s=127, block=block)]
    jw, w = jhom.widen_payload_tree(jtmpl), homomorphic.widen_payload_tree(
        tmpl)
    assert all(p.levels.dtype == torch.int16 for p in w)
    want = np.asarray(jtransfer.make_device_packer()(jw))
    got = transfer.make_device_packer()(w).numpy()
    assert got.tobytes() == want.tobytes()
    assert [tuple(s) for s in transfer.specs_of(w)] == [
        (str(s.dtype), tuple(s.shape), s.nbytes)
        for s in jtransfer.specs_of(jw)]
    back = transfer.make_device_unpacker(w)(torch.from_numpy(got))
    assert all(torch.equal(a.levels, b.levels) for a, b in zip(back, w))
    with pytest.raises(TypeError, match="no widened wire form"):
        homomorphic.widen_payload_tree([torch.zeros(3)])


@pytest.mark.parametrize("block", [None, 4096])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8])
def test_tree_homomorphic_mean_equals_jax(k, block):
    """An int16 stack of weighted partial sums, divided by the total leaf
    weight k, against the JAX twin given the same scales."""
    n = 3 * 4096 + 77
    parts = max(1, k // 2)
    sums = _levels(k, n, seed=k).astype(np.int32)
    rows = [sums[i::parts].sum(axis=0).astype(np.int16)
            for i in range(parts)]
    nb = 1 if block is None else -(-n // block)
    scales = (np.random.default_rng(k).random(nb).astype(np.float32)
              * np.float32(0.01) + np.float32(1e-4))
    sub = qsgd.SharedScaleQSGD(torch.from_numpy(scales), 127, block)
    jsub = jqsgd.SharedScaleQSGD(jnp.asarray(scales), 127, block)
    got = sub.homomorphic_mean(
        [qsgd.SharedScaleQSGDPayload(torch.from_numpy(r), (n,), 127, block)
         for r in rows], k=k)
    want = jsub.homomorphic_mean(
        [jqsgd.SharedScaleQSGDPayload(jnp.asarray(r), (n,), 127, block)
         for r in rows], k=k)
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(want).view(np.uint32))
    # The tree's int16 partials sum to the flat int8 sum: the same mean.
    flat = sub.homomorphic_mean(
        [qsgd.SharedScaleQSGDPayload(torch.from_numpy(r.astype(np.int8)),
                                     (n,), 127, block)
         for r in _levels(k, n, seed=k)])
    assert torch.equal(flat, got)


@pytest.mark.parametrize("block", [None, 4096])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 11, 13])
def test_decode_sum_rounds_one_over_k_as_the_pallas_kernel(k, block):
    """The divisor of a round is any leaf weight: ``decode_sum`` equals the
    Pallas ``acc_decode`` in interpret mode bit for bit."""
    n = 2 * 4096 + 9
    acc = np.random.default_rng(k).integers(-127 * k, 127 * k + 1,
                                            n).astype(np.int32)
    nb = 1 if block is None else -(-n // block)
    scales = np.random.default_rng(k + 1).random(nb).astype(np.float32)
    got = kernels.decode_sum(torch.from_numpy(acc), torch.from_numpy(scales),
                             k, block=block)
    want = pallas_kernels.acc_decode(jnp.asarray(acc), jnp.asarray(scales),
                                     k, block=block, interpret=True)
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(want).view(np.uint32))


# -- the root (in-process ParameterServer) -------------------------------------------

def _root(k_leaves, n_aggs=None, store=None):
    """A homomorphic root: widened at ``n_aggs`` slots with a ``k_leaves``
    weight quota, or flat (``n_aggs`` None) at K = ``k_leaves``."""
    rng = np.random.default_rng(7)
    tmpl = [torch.from_numpy((rng.standard_normal(N) * 0.1).astype(
        np.float32))]
    comp = homomorphic.make_homomorphic(qsgd.QSGDCompressor(127), tmpl)
    server = ps.ParameterServer([torch.ones(N)], SGD(0.1), comp,
                                num_aggregate=k_leaves,
                                server_agg="homomorphic", device="cpu",
                                leaf_names=["w"])
    ct = ps.make_compress_tree(server.compressor)
    template = ct([torch.zeros(N)], prng.key(0))
    if n_aggs is None:
        server.register_payload_schema(template)
    else:
        server.register_payload_schema(
            homomorphic.widen_payload_tree(template), schema_k=n_aggs,
            agg_weight=k_leaves)
    return server, ct


def _leaf_trees(ct, count, seed0=100):
    return [ct([torch.from_numpy((np.random.default_rng(seed0 + i)
                                  .standard_normal(N) * 0.1)
                                 .astype(np.float32))], prng.key(seed0 + i))
            for i in range(count)]


def _frame(tree) -> bytes:
    return native.encode_arrays([transfer.make_device_packer()(tree)
                                 .numpy()])


def _pseudo(trees, members, version, push_id):
    """The record an aggregator forwards: the int16 sum of the members'
    int8 levels."""
    summed = np.stack([t[0].levels.numpy().astype(np.int32)
                       for t in trees]).sum(axis=0)
    p = trees[0][0]
    wide = [qsgd.SharedScaleQSGDPayload(
        torch.from_numpy(summed.astype(np.int16)), p.shape, p.s, p.block)]
    return ps.PushRecord(worker=-1, version=version, message=_frame(wide),
                         loss=0.0, push_id=push_id, weight=len(members),
                         members=tuple(members))


def test_tree_root_bit_equal_to_flat_root():
    """Four leaves as two weight-2 pseudo-pushes land the flat root's
    parameters bit for bit, with one decode (``tests/test_aggtree.py:214``
    in the port)."""
    tree, ct = _root(4, 2)
    flat, _ = _root(4)
    trees = _leaf_trees(ct, 4)
    for i, t in enumerate(trees):
        assert flat.push(ps.PushRecord(worker=i, version=0,
                                       message=_frame(t), loss=0.0))
    for j, members in enumerate(((0, 1), (2, 3))):
        assert tree.push_subtree(_pseudo([trees[m] for m in members],
                                         members, 0, f"agg{j}:0:0")) == (
            True, ())
    assert tree.version == flat.version == 1
    assert torch.equal(tree.params[0], flat.params[0])
    assert (tree.stats.decode_count, tree.stats.agg_pushes,
            tree.stats.agg_weight) == (1, 2, 4)
    assert flat.stats.decode_count == 1 and flat.stats.agg_pushes == 0


def test_pseudo_push_retry_is_idempotent_by_push_id():
    server, ct = _root(4, 2)
    rec = _pseudo(_leaf_trees(ct, 2), (0, 1), 0, "agg0:0:0")
    assert server.push_subtree(rec) == (True, ())
    assert server.push_subtree(rec, retried=True) == (True, ())
    assert (server.stats.dup_pushes, server.stats.agg_pushes,
            server.stats.agg_weight, server.version) == (1, 1, 2, 0)


def test_fragmented_round_pends_past_its_slots_and_applies_exactly():
    """Four weight-1 fragments at two slots: the round waits for its weight
    (never fires on a slot count) and applies at height 4, bit-equal to two
    weight-2 pseudo-pushes."""
    server, ct = _root(4, 2)
    trees = _leaf_trees(ct, 4)
    for j in range(3):
        assert server.push_subtree(_pseudo([trees[j]], (j,), 0,
                                           f"agg0:0:{j}")) == (True, ())
        assert server.version == 0
    assert server.push_subtree(_pseudo([trees[3]], (3,), 0, "agg1:0:0")) \
        == (True, ())
    ref, _ = _root(4, 2)
    for j, members in enumerate(((0, 1), (2, 3))):
        ref.push_subtree(_pseudo([trees[m] for m in members], members, 0,
                                 f"agg{j}:0:0"))
    assert server.version == ref.version == 1
    assert server.stats.decode_count == 1
    assert torch.equal(server.params[0], ref.params[0])
    assert sorted(server._agg_apply_cache) == [(4, 2), (4, 4)]


def test_flush_pending_applies_a_partial_batch_at_its_weight():
    server, ct = _root(4, 2)
    trees = _leaf_trees(ct, 3)
    assert not server.flush_pending()
    server.push_subtree(_pseudo(trees, (0, 1, 2), 0, "agg0:0:0"))
    assert server.version == 0 and server.flush_pending()
    assert server.version == 1 and (3, 2) in server._agg_apply_cache
    flat, _ = _root(2)
    flat.push(ps.PushRecord(worker=0, version=0, message=_frame(trees[0]),
                            loss=0.0))
    with pytest.raises(RuntimeError, match="agg-mode"):
        flat.flush_pending()


def test_tree_wal_replays_the_weighted_divisor(tmp_path):
    """A durable root journals each batch's weights; a second root recovers
    bit-equal through a weight-3 and a weight-4 apply."""
    from ewdml_tpu_torch.parallel.server_state import ServerStateStore

    live, ct = _root(4, 2)
    live.arm_durability(ServerStateStore(str(tmp_path)), snapshot_every=0)
    trees = _leaf_trees(ct, 7)
    live.push_subtree(_pseudo(trees[:3], (0, 1, 2), 0, "agg0:0:0"))
    live.flush_pending()
    live.push_subtree(_pseudo(trees[3:5], (0, 1), 1, "agg0:1:1"))
    live.push_subtree(_pseudo(trees[5:], (2, 3), 1, "agg1:1:0"))
    assert live.version == 2
    store = ServerStateStore(str(tmp_path))
    assert [r.get("weights") for r in store.read_wal()] == [[3], [2, 2]]
    fresh, _ = _root(4, 2)
    assert fresh.recover(store)["replayed"] == 2
    assert fresh.version == 2
    assert torch.equal(fresh.params[0], live.params[0])
    assert all(torch.equal(a, b) for a, b in zip(
        fresh.opt_state.momentum_buf, live.opt_state.momentum_buf))


# -- the double count of a rehomed leaf (both packages) -----------------------------

def _jax_root():
    tmpl = {"w": jax.random.normal(jax.random.key(7), (N,)) * 0.1}
    comp = jhom.make_homomorphic(jqsgd.QSGDCompressor(127), tmpl)
    server = jps.ParameterServer({"w": jnp.ones((N,), jnp.float32)},
                                 JSGD(0.1), comp, num_aggregate=4,
                                 server_agg="homomorphic")
    ct = jps.make_compress_tree(server.compressor)
    template = ct({"w": jnp.zeros((N,), jnp.float32)}, jax.random.key(0))
    server.register_payload_schema(jhom.widen_payload_tree(template),
                                   schema_k=2, agg_weight=4)
    pack = jtransfer.make_device_packer()

    def pseudo(members, push_id):
        levels = np.stack([np.asarray(ct({"w": jax.random.normal(
            jax.random.key(100 + m), (N,)) * 0.1}, jax.random.key(100 + m))
            ["w"].levels, np.int32) for m in members]).sum(axis=0)
        wide = jax.tree.map(
            lambda p: type(p)(levels=jnp.asarray(levels, jnp.int16),
                              shape=p.shape, s=p.s, block=p.block),
            template, is_leaf=lambda x: hasattr(x, "wire_bytes"))
        return jps.PushRecord(worker=-1, version=0, message=jnative
                              .encode_arrays([np.asarray(pack(wide))]),
                              loss=0.0, push_id=push_id,
                              weight=len(members), members=tuple(members))

    return server, pseudo


def _port_root_pseudo():
    server, ct = _root(4, 2)
    trees = _leaf_trees(ct, 4)
    return server, lambda members, push_id: _pseudo(
        [trees[m] for m in members], members, 0, push_id)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_rehomed_leaf_is_counted_twice_under_the_base_policy(package):
    """``aggkill``: aggregator 0 forwards leaves 0 and 1, the root applies
    it, and the aggregator dies before acknowledging them. The leaves
    re-send to aggregator 1, whose forward carries all four leaves under
    its own push id. The base policy admits every subtree and reports no
    duplicate member, so the root counts leaves 0 and 1 twice: one apply at
    weight 6 for four leaves. Both packages do so."""
    server, pseudo = (_jax_root() if package == "jax"
                      else _port_root_pseudo())
    assert server.push_subtree(pseudo((0, 1), "agg0:0:0")) == (True, ())
    assert server.version == 0
    assert server.push_subtree(pseudo((0, 1, 2, 3), "agg1:0:0")) == (True,
                                                                       ())
    stats = server.stats
    assert (server.version, stats.agg_pushes, stats.agg_weight,
            stats.agg_dup_members, stats.dup_pushes) == (1, 2, 6, 0, 0)


# -- the aggregator (real sockets) ----------------------------------------------------

def _stub_upstream(replies):
    """A frame-speaking upstream: answers each request with the next
    header of ``replies`` and records ``(header, sections)``."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    seen = []

    def serve():
        try:
            conn, _ = lsock.accept()
            with conn:
                conn.settimeout(30)
                for reply in replies:
                    seen.append(ps_net.parse_request(ps_net.recv_frame(conn)))
                    ps_net.send_frame(conn, ps_net.make_request(reply))
        except OSError:
            pass
        finally:
            lsock.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return lsock.getsockname(), t, seen


def _agg_cfg(**kw):
    return config.TrainConfig(network="LeNet", dataset="mnist10k",
                              batch_size=8, synthetic_data=True,
                              agg_tree=TREE2, net_timeout_s=10.0,
                              net_retries=0, **{**HOM, **kw})


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


def test_dup_members_subtract_and_reforward_against_a_stub_upstream():
    """The upstream answers the first forward with ``dup_members [0]``: the
    aggregator acknowledges leaf 0, re-forwards leaf 1 alone under a fresh
    push id, and both leaves get ``accepted`` once the root takes it."""
    addr, t, seen = _stub_upstream([
        {"op": "agg_push_ok", "accepted": False, "dup_members": [0]},
        {"op": "agg_push_ok", "accepted": True, "dup_members": []}])
    agg = AggregatorServer(_agg_cfg(), addr, port=0, index=1)
    serving = _Serving(agg)
    lv = _levels(2, 3000, seed=3)
    replies = {}

    def leaf(w):
        conn = ps_net.RetryingConnection(agg.address, timeout_s=30,
                                         retries=0)
        try:
            replies[w], _ = conn.call(
                {"op": "push", "worker": w, "version": 5, "loss": 1.0 + w,
                 "plan_version": 0, "push_id": f"{w}:0"},
                [native.encode_arrays([lv[w].view(np.uint8)])])
        finally:
            conn.close()

    try:
        # Both children registered before either pushes: the group closes
        # when both are present.
        for w in (0, 1):
            ps_net.client_call(agg.address, {"op": "agg_register",
                                             "worker": w})
        leaves = [threading.Thread(target=leaf, args=(w,)) for w in (0, 1)]
        for th in leaves:
            th.start()
        for th in leaves:
            th.join(30)
        stats, _ = ps_net.client_call(agg.address, {"op": "agg_stats"})
    finally:
        serving.stop()
        t.join(10)
    assert replies == {0: {"op": "push_ok", "accepted": True},
                       1: {"op": "push_ok", "accepted": True}}
    (h1, s1), (h2, s2) = seen
    assert (h1["op"], h1["worker"], h1["version"], h1["weight"],
            h1["members"], h1["loss"]) == ("agg_push", -2, 5, 2, [0, 1],
                                           1.5)
    assert (h2["weight"], h2["members"], h2["loss"]) == (1, [1], 2.0)
    assert h1["push_id"] != h2["push_id"]
    both = native.decode_arrays(bytes(s1[0]))[0].view(np.int16)
    alone = native.decode_arrays(bytes(s2[0]))[0].view(np.int16)
    assert np.array_equal(both, lv.astype(np.int16).sum(axis=0))
    assert np.array_equal(alone, lv[1].astype(np.int16))
    assert (stats["pushes_in"], stats["forwards"], stats["dup_members"],
            stats["forwarded_weight"], stats["parked"]) == (2, 2, 1, 3, 0)


def test_aggregator_control_plane():
    """Idempotent registration, the stats reply, an unsupported op answered
    with an error frame, and a push refused by the upstream acknowledged as
    not accepted."""
    addr, t, _ = _stub_upstream([{"op": "agg_push_ok", "accepted": False,
                                  "dup_members": []}])
    agg = AggregatorServer(_agg_cfg(), addr, port=0, index=0)
    serving = _Serving(agg)
    try:
        for expect in (1, 2, 2):
            h, _ = ps_net.client_call(agg.address, {
                "op": "agg_register", "worker": expect - 1})
            assert h == {"op": "agg_register_ok", "children": expect}
        h, _ = ps_net.client_call(agg.address, {"op": "agg_stats"})
        assert h["op"] == "agg_stats_ok" and h["index"] == 0
        assert h["children"] == 2 and h["parked"] == 0
        h, _ = ps_net.client_call(agg.address, {"op": "pull",
                                                "worker_version": -1})
        assert h["op"] == "error" and "aggregator" in h["detail"]
        # One child of two pushes: the group idles past the flush window
        # and forwards alone; the upstream refuses it.
        lv = _levels(1, 100)[0]
        h, _ = ps_net.client_call(agg.address, {
            "op": "push", "worker": 0, "version": 0, "loss": 1.0,
            "push_id": "0:0"}, [native.encode_arrays([lv.view(np.uint8)])])
        assert h == {"op": "push_ok", "accepted": False}
        h, _ = ps_net.client_call(agg.address, {"op": "agg_stats"})
        assert (h["aged_flushes"], h["forwards"]) == (1, 1)
    finally:
        serving.stop()
        t.join(10)


def test_aggregator_requires_a_valid_tree_and_index():
    with pytest.raises(ValueError, match="agg-index"):
        AggregatorServer(_agg_cfg(), ("127.0.0.1", 1), index=2)
    with pytest.raises(ValueError, match="--server-agg homomorphic"):
        AggregatorServer(_agg_cfg(server_agg="decode"), ("127.0.0.1", 1))


@pytest.mark.parametrize("spec", [
    "aggkill@0=2", "aggkill@1=1,aggkill@0=3", "crash@1=2,aggkill@1=4",
    "serverkill@3,aggkill@0=0", "", "aggkill@0=-1", "aggkill@x=2",
    "agkill@0=1"])
def test_aggkill_clause_parses_as_in_jax(spec):
    try:
        want = JFaultSpec.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as exc:
            FaultSpec.parse(spec)
        assert str(exc.value) == str(e)
        return
    got = FaultSpec.parse(spec)
    for a in range(3):
        assert got.agg_kill_after(a) == want.agg_kill_after(a)
    assert got.server_kill_at == want.server_kill_at
