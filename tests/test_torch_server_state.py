"""The port's durable parameter server (``ewdml_tpu_torch/parallel/
server_state.py`` and ``ParameterServer.recover``) against the JAX
package's, following the cases of ``tests/test_server_state.py`` (the
federated ones are a later slice).

Oracles:
- the store: exact (round trip, CRC refusal, torn WAL tail, rotation); the
  files a port store writes equal the JAX store's byte for byte.
- the snapshot blob: bit. At the same state the port server's blob and
  meta equal the JAX server's, and each package recovers the other's
  initial snapshot to the same parameters.
- recovery in the port: bit. Snapshot plus WAL replay lands on the live
  server's parameters, optimizer state, shadow and version exactly (the
  same apply on the same device), on the CPU as on the card.
- dedupe, exclusions, membership and elastic K: exact counters.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.ops.qsgd import QSGDCompressor as JQSGD
from ewdml_tpu.optim import SGD as JSGD
from ewdml_tpu.parallel import ps as jps
from ewdml_tpu.parallel import server_state as jstate
from ewdml_tpu_torch import native
from ewdml_tpu_torch.ops.qsgd import QSGDCompressor
from ewdml_tpu_torch.optim import SGD
from ewdml_tpu_torch.parallel.policy import StragglerPolicy
from ewdml_tpu_torch.parallel.ps import (ParameterServer, PushRecord,
                                         make_compress_tree)
from ewdml_tpu_torch.parallel.server_state import (ServerStateStore,
                                                   decode_bufs, encode_bufs)
from ewdml_tpu_torch.utils import prng, transfer

torch.set_num_threads(2)

N = 2048


# -- the state store ----------------------------------------------------------

def test_snapshot_roundtrip_and_atomic_replace(tmp_path):
    store = ServerStateStore(str(tmp_path))
    blob = os.urandom(4096)
    store.write_snapshot({"version": 7, "plan_version": 2}, blob)
    assert not [f for f in os.listdir(tmp_path) if "tmp" in f]
    meta, got = store.load_snapshot()
    assert got == blob and meta["version"] == 7
    assert store.peek_meta()["plan_version"] == 2


def test_store_files_equal_the_jax_store(tmp_path):
    """The same snapshot and WAL records give the same files in both
    packages, and each reads the other's."""
    blob = os.urandom(1000)
    meta = {"version": 3, "applied_ids": {"0:1": 2}, "scale_crc": None}
    recs = [{"version": 4, "bufs": encode_bufs([np.arange(9, dtype=np.uint8)])},
            {"kind": "join", "worker": 2, "version": 4}]
    paths = []
    for name, cls in (("port", ServerStateStore),
                      ("jax", jstate.ServerStateStore)):
        store = cls(str(tmp_path / name))
        store.write_snapshot(meta, blob)
        for r in recs:
            store.append_wal(r)
        store.close()
        paths.append(store)
    for attr in ("snapshot_path", "wal_path"):
        with open(getattr(paths[0], attr), "rb") as a, \
                open(getattr(paths[1], attr), "rb") as b:
            assert a.read() == b.read()
    assert ServerStateStore(paths[1].dir).load_snapshot() == (
        jstate.ServerStateStore(paths[0].dir).load_snapshot())


def test_corrupt_blob_fails_loud(tmp_path):
    store = ServerStateStore(str(tmp_path))
    store.write_snapshot({"version": 1}, b"payload-bytes" * 100)
    with open(store.snapshot_path, "r+b") as f:
        f.seek(-3, os.SEEK_END)
        f.write(b"\xff")
    with pytest.raises(ValueError, match="CRC"):
        store.load_snapshot()


def test_empty_store_is_none(tmp_path):
    store = ServerStateStore(str(tmp_path))
    assert store.load_snapshot() is None and store.read_wal() == []


def test_wal_torn_tail_tolerated(tmp_path):
    store = ServerStateStore(str(tmp_path))
    for v in (1, 2, 3):
        store.append_wal({"version": v, "bufs": []})
    store.close()
    with open(store.wal_path, "a") as f:
        f.write('{"version": 4, "bu')
    assert [r["version"] for r in store.read_wal()] == [1, 2, 3]


def test_rotate_truncates_wal(tmp_path):
    store = ServerStateStore(str(tmp_path))
    store.append_wal({"version": 1})
    store.rotate_wal()
    assert store.read_wal() == []
    store.append_wal({"version": 2})
    assert [r["version"] for r in store.read_wal()] == [2]


def test_buf_codec_roundtrip():
    bufs = [np.frombuffer(os.urandom(64), np.uint8) for _ in range(3)]
    back = decode_bufs(encode_bufs(bufs))
    assert all(np.array_equal(a, b) for a, b in zip(bufs, back))
    assert encode_bufs(bufs) == jstate.encode_bufs(bufs)


# -- recovery ---------------------------------------------------------------

def _make_server(k=1, policy=None, momentum=0.9, elastic_k=False):
    """A deterministic port server: a fresh instance is the restarted
    process before its recovery."""
    comp = QSGDCompressor(127)
    params = [torch.ones(N)]
    server = ParameterServer(params, SGD(0.1, momentum=momentum), comp,
                             num_aggregate=k, seed=3, policy=policy,
                             device="cpu", leaf_names=["w"],
                             elastic_k=elastic_k)
    ct = make_compress_tree(comp)
    server.register_payload_schema(ct([torch.zeros(N)], prng.key(0)))
    return server, ct


def _grad(seed):
    return np.random.default_rng(seed).standard_normal(N).astype(
        np.float32) * 0.1


def _push_record(ct, seed, worker=0, version=0, push_id=""):
    tree = ct([torch.from_numpy(_grad(seed))], prng.key(70 + seed))
    buf = transfer.make_device_packer()(tree).numpy()
    return PushRecord(worker=worker, version=version,
                      message=native.encode_arrays([buf]), loss=0.0,
                      push_id=push_id)


def _state(server) -> list:
    opt = server.opt_state
    return ([p.clone() for p in server.params]
            + [b.clone() for b in opt.momentum_buf]
            + [s.clone() for s in server._shadow]
            + [torch.tensor(float(opt.initialized))])


def _bit_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x.view(-1).view(torch.uint8),
                                           y.view(-1).view(torch.uint8))
        for x, y in zip(a, b))


@pytest.mark.parametrize("snapshot_every", [1, 3, 100])
def test_snapshot_plus_wal_replay_bit_identical(tmp_path, snapshot_every):
    """7 applies under a snapshot cadence: the recovered state equals the
    live one bit for bit whatever the snapshot/WAL split."""
    server, ct = _make_server(k=1)
    store = ServerStateStore(str(tmp_path))
    server.arm_durability(store, snapshot_every=snapshot_every)
    for i in range(7):
        assert server.push(_push_record(ct, i, version=server.version,
                                        push_id=f"0:{i}"))
    assert server.version == 7 and server.stats.wal_records == 7
    fresh, _ = _make_server(k=1)
    summary = fresh.recover(store)
    assert summary["version"] == 7
    assert summary["replayed"] == 7 - (7 // snapshot_every) * snapshot_every
    assert fresh.version == 7 and _bit_equal(_state(fresh), _state(server))


def test_replayed_push_deduped_exactly_once(tmp_path):
    server, ct = _make_server(k=1)
    store = ServerStateStore(str(tmp_path))
    server.arm_durability(store, snapshot_every=100)
    rec = _push_record(ct, 1, push_id="0:5")
    assert server.push(rec) is True and server.version == 1
    fresh, _ = _make_server(k=1)
    fresh.recover(store)
    before = _state(fresh)
    assert fresh.push(rec) is True  # acknowledged: the worker moves on
    assert fresh.stats.dup_pushes == 1 and fresh.version == 1
    assert _bit_equal(_state(fresh), before)


def test_dedupe_without_restart_and_unkeyed_pushes():
    server, ct = _make_server(k=1)
    rec = _push_record(ct, 1, push_id="2:7")
    assert server.push(rec) is True and server.version == 1
    assert server.push(rec) is True
    assert server.stats.dup_pushes == 1 and server.version == 1
    blank = _push_record(ct, 2, version=1)
    assert server.push(blank) and server.push(blank)
    assert server.version == 3


def test_pending_push_id_deduped_and_eviction_bound():
    server, ct = _make_server(k=2)
    rec = _push_record(ct, 1, push_id="0:0")
    assert server.push(rec) and server.push(rec)  # the second is pending
    assert server.stats.dup_pushes == 1 and server.version == 0
    server._note_applied_ids([f"x:{i}" for i in range(
        server.APPLIED_IDS_MAX + 5)], 1)
    assert len(server._applied_ids) == server.APPLIED_IDS_MAX
    assert "x:0" not in server._applied_ids


def test_policy_exclusions_survive_recovery(tmp_path):
    server, ct = _make_server(k=1)
    store = ServerStateStore(str(tmp_path))
    server.arm_durability(store, snapshot_every=1)
    server.policy.exclude(4, "straggler: injected")
    server.push(_push_record(ct, 0, push_id="0:0"))
    fresh, _ = _make_server(k=1)
    fresh.recover(store)
    assert "straggler" in fresh.policy.excluded()[4]
    assert fresh.policy.is_excluded(4)


def test_join_recomputes_k_and_rewarms():
    pol = StragglerPolicy(num_aggregate=1)
    server, ct = _make_server(k=1, policy=pol, elastic_k=True)
    pol.note_join(0)
    info = server.join_worker(1)
    assert info == {"version": 0, "live": 2, "num_aggregate": 2}
    assert server._schema_k == 2 and server.stats.joins == 1
    server.push(_push_record(ct, 0, worker=0, push_id="0:0"))
    assert server.version == 0
    server.push(_push_record(ct, 1, worker=1, push_id="1:0"))
    assert server.version == 1


def test_join_drops_pending_old_k_buffers():
    pol = StragglerPolicy(num_aggregate=2)
    server, ct = _make_server(k=2, policy=pol, elastic_k=True)
    pol.note_join(0)
    pol.note_join(1)
    server.push(_push_record(ct, 0, worker=0, push_id="0:0"))
    info = server.join_worker(2)
    assert info["num_aggregate"] == 3 and server.stats.dropped_stale == 1


def test_fixed_k_join_only_registers():
    pol = StragglerPolicy(num_aggregate=2)
    server, _ = _make_server(k=2, policy=pol)
    info = server.join_worker(5)
    assert info["num_aggregate"] == 2
    assert pol.live_workers() == 1 and server.stats.joins == 1


def test_membership_survives_recovery(tmp_path):
    server, ct = _make_server(k=1)
    store = ServerStateStore(str(tmp_path))
    server.arm_durability(store, snapshot_every=100)
    server.join_worker(7)
    assert server.stats.wal_records == 1
    server.push(_push_record(ct, 0, push_id="0:0"))
    fresh, _ = _make_server(k=1)
    fresh.recover(store)
    assert fresh.stats.joins == 1 and fresh.policy.is_member(7)


def test_elastic_mixed_k_wal_replays(tmp_path):
    """The WAL straddles an elastic K change: a batch at K=1, the join, a
    batch at K=2; the replay follows K and lands bit-equal."""
    pol = StragglerPolicy(num_aggregate=1)
    server, ct = _make_server(k=1, policy=pol, elastic_k=True)
    pol.note_join(0)
    store = ServerStateStore(str(tmp_path))
    server.arm_durability(store, snapshot_every=100)
    server.push(_push_record(ct, 0, worker=0, push_id="0:0"))
    server.join_worker(1)
    server.push(_push_record(ct, 1, worker=0, version=1, push_id="0:1"))
    server.push(_push_record(ct, 2, worker=1, version=1, push_id="1:1"))
    assert server.version == 2
    fresh, _ = _make_server(k=1, policy=StragglerPolicy(num_aggregate=1),
                            elastic_k=True)
    summary = fresh.recover(store)
    assert summary["version"] == 2 and summary["replayed"] == 2
    assert fresh.num_aggregate == 2 and fresh._schema_k == 2
    assert fresh.stats.joins == 1 and fresh.policy.is_member(1)
    assert _bit_equal(_state(fresh), _state(server))


def test_wal_gap_refused(tmp_path):
    server, ct = _make_server(k=1)
    store = ServerStateStore(str(tmp_path))
    server.arm_durability(store, snapshot_every=100)
    server.push(_push_record(ct, 0, push_id="0:0"))
    rec = store.read_wal()[0]
    store.append_wal({**rec, "version": 3})
    fresh, _ = _make_server(k=1)
    with pytest.raises(RuntimeError, match="WAL gap"):
        fresh.recover(store)


# -- the snapshot blob across the packages -------------------------------------

def _jax_server(momentum=0.9):
    comp = JQSGD(127)
    params = {"w": jnp.ones((N,), jnp.float32)}
    server = jps.ParameterServer(params, JSGD(0.1, momentum=momentum), comp,
                                 num_aggregate=1, seed=3)
    ct = jps.make_compress_tree(comp)
    server.register_payload_schema(
        ct({"w": jnp.zeros((N,), jnp.float32)}, jax.random.key(0)))
    return server


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_initial_snapshot_equals_the_jax_servers(tmp_path, momentum):
    """At version 0 the two servers hold the same state, and their initial
    snapshots are the same files; each package recovers the other's."""
    jserver = _jax_server(momentum)
    jstore = jstate.ServerStateStore(str(tmp_path / "jax"))
    jserver.arm_durability(jstore, snapshot_every=100)
    server, _ = _make_server(momentum=momentum)
    store = ServerStateStore(str(tmp_path / "port"))
    server.arm_durability(store, snapshot_every=100)
    with open(jstore.snapshot_path, "rb") as a, \
            open(store.snapshot_path, "rb") as b:
        assert a.read() == b.read()
    # A port server recovers the JAX snapshot, and the reverse.
    fresh, _ = _make_server(momentum=momentum)
    assert fresh.recover(jstate.ServerStateStore(jstore.dir))["version"] == 0
    assert _bit_equal(_state(fresh), _state(server))
    jfresh = _jax_server(momentum)
    jfresh.recover(jstate.ServerStateStore(store.dir))
    assert np.array_equal(np.asarray(jfresh.params["w"]),
                          server.params[0].numpy())


def test_port_recovers_a_jax_wal_within_tolerance(tmp_path):
    """A JAX server's snapshot and WAL (pushes of numpy-made payloads)
    replay in the port: the same versions and applied ids, the parameters
    within the decode oracle's tolerance (the two decodes differ in the
    last bits, ROADMAP Queue 3 item 1)."""
    jserver = _jax_server()
    jstore = jstate.ServerStateStore(str(tmp_path))
    jserver.arm_durability(jstore, snapshot_every=100)
    server, ct = _make_server()
    for i in range(4):
        rec = _push_record(ct, i, version=i, push_id=f"0:{i}")
        jserver.push(jps.PushRecord(worker=0, version=i, message=rec.message,
                                    loss=0.0, push_id=f"0:{i}"))
    fresh, _ = _make_server()
    summary = fresh.recover(jstore)
    assert summary == {"version": 4, "snapshot_version": 0, "replayed": 4}
    assert sorted(fresh._applied_ids) == [f"0:{i}" for i in range(4)]
    got, want = fresh.params[0].numpy(), np.asarray(jserver.params["w"])
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))
    assert jstore.peek_meta()["num_aggregate"] == 1
