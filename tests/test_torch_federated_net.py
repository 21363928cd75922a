"""Federated rounds over TCP in the port: a ``PSNetServer --federated`` on
both wire planes, driven by the port's ``NetTransport`` (threads of this
test process, LeNet on synthetic MNIST, ``--platform cpu``).

Oracles, per test:
- a sequential run over TCP against the same run in process: bit (the
  server's journal byte-equal to the in-process one), exact (one decode a
  round);
- the ``fed_*`` replies: bit, the same bytes on both planes and the bytes
  the JAX ``make_request`` encodes for the same reply;
- a re-sent ``fed_begin`` / ``fed_drop``: exact, the recorded outcome;
- the event-loop plane's parked ``fed_end``: structure (answered after
  the commit, a push served while it waits); an unreachable quota: the
  barrier-timeout error frame, bit;
- a federated ``join``, ``--role fed_driver``, ``--agg-tree`` with two
  aggregators (one pseudo-push per aggregator per round), ``--replicas``
  (no pull at the apply server, by its per-op segments) and ``--server-state-dir`` (a restarted
  server resumes its rounds): exact counts and replies.
"""

import socket
import threading

import numpy as np
import pytest
import torch

from ewdml_tpu.parallel import ps_net as jps_net
from ewdml_tpu_torch import native
from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.federated import (CohortSampler, read_ledger,
                                       round_sequence, run_federated)
from ewdml_tpu_torch.federated.loop import NetTransport, drive_rounds
from ewdml_tpu_torch.parallel import ps_net
from ewdml_tpu_torch.parallel.aggtree import AggregatorServer
from ewdml_tpu_torch.parallel.replica import PullReplicaServer
from ewdml_tpu_torch.utils import transfer

torch.set_num_threads(2)

SEED = 42
FED = dict(network="LeNet", dataset="MNIST", batch_size=8,
           compress_grad="qsgd", quantum_num=127, synthetic_data=True,
           synthetic_size=64, bf16_compute=False, server_agg="homomorphic",
           federated=True, pool_size=6, cohort=2, local_steps=1,
           partition="iid", fed_rounds=2, momentum=0.0, lr=0.05, seed=SEED,
           platform="cpu", net_timeout_s=10.0, net_retries=2,
           net_backoff_s=0.05)


def _cfg(tmp_path, name: str, **kw) -> TrainConfig:
    return TrainConfig(**dict(FED, train_dir=str(tmp_path / name), **kw))


class _Serving:
    """An endpoint serving in a thread."""

    def __init__(self, server):
        self.server = server
        self.address = server.address
        self.thread = threading.Thread(target=server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stats(self) -> dict:
        return ps_net.client_call(self.address, {"op": "stats"})[0]

    def stop(self) -> None:
        try:
            ps_net.client_call(self.address, {"op": "shutdown"}, retries=0,
                               timeout_s=10)
        except OSError:
            pass
        self.thread.join(30)
        self.server.close()


def _ledger_bytes(cfg) -> bytes:
    with open(f"{cfg.train_dir}/fed_rounds.jsonl", "rb") as f:
        return f.read()


def _first_client() -> int:
    return CohortSampler(6, 2, SEED).sample(0, range(6))[0]


@pytest.mark.parametrize("plane", ["threads", "evloop"])
def test_tcp_ledger_is_the_in_process_one(plane, tmp_path):
    """Bit: the server's journal of a sequential run with a dropout equals
    the in-process run's; exact: one decode a round, the stats block."""
    kw = dict(wire_plane=plane, fault_spec=f"crash@{_first_client()}=0")
    local = run_federated(_cfg(tmp_path, "local", **kw))
    serving = _Serving(ps_net.PSNetServer(_cfg(tmp_path, "server", **kw)))
    try:
        res = run_federated(_cfg(tmp_path, "driver", **kw),
                            addr=serving.address)
        stats = serving.stats()
    finally:
        serving.stop()
    assert _ledger_bytes(_cfg(tmp_path, "server")) == \
        _ledger_bytes(_cfg(tmp_path, "local"))
    # The wire's fed_end_ok carries no event name.
    assert res.round_records == [
        {k: v for k, v in r.items() if k != "event"}
        for r in local.round_records]
    assert (res.dropouts, res.resampled, res.rejected) == (
        local.dropouts, local.resampled, local.rejected) == (1, 1, 0)
    assert stats["decode_count"] == stats["apply_rounds"] == 2
    fed = stats["federated"]
    assert fed == dict(local.coordinator, round_pipeline="off")
    assert fed["rounds_done"] == 2 and fed["dropouts"] == 1
    assert stats["fed_rejected"] == 0 and stats["dropped_round_stale"] == 0


def _raw(addr, requests) -> list:
    """Each request's raw reply frame, on one connection."""
    out = []
    with socket.create_connection(addr, timeout=20) as sock:
        for header in requests:
            ps_net.send_frame(sock, ps_net.make_request(header))
            out.append(bytes(ps_net.recv_frame(sock)))
    return out


SCRIPT = ([{"op": "fed_register", "client": c} for c in range(6)]
          + [{"op": "fed_register", "client": 9},
             {"op": "fed_begin", "round": 0},
             {"op": "fed_begin", "round": 0, "retry": 1},
             {"op": "fed_begin", "round": 3},
             {"op": "fed_drop", "client": 1, "round": 0},
             {"op": "fed_drop", "client": 1, "round": 0, "retry": 1},
             {"op": "fed_flush"},
             {"op": "fed_end", "round": 0},
             {"op": "join", "worker": 4},
             {"op": "join", "worker": 7},
             {"op": "fed_bogus"}])


def test_fed_replies_are_equal_across_planes_and_to_jax(tmp_path):
    """Bit: every reply of the script on both planes, and each the bytes
    the JAX ``make_request`` encodes for it."""
    replies = {}
    for plane in ("threads", "evloop"):
        serving = _Serving(ps_net.PSNetServer(_cfg(
            tmp_path, plane, wire_plane=plane, net_timeout_s=1.0)))
        try:
            replies[plane] = _raw(serving.address, SCRIPT)
        finally:
            serving.stop()
    assert replies["threads"] == replies["evloop"]
    for raw in replies["threads"]:
        header, sections = ps_net.parse_request(raw)
        assert raw == bytes(jps_net.make_request(header, sections))
    headers = [ps_net.parse_request(r)[0] for r in replies["threads"]]
    assert [h["op"] for h in headers[:6]] == ["fed_register_ok"] * 6
    assert headers[5] == {"op": "fed_register_ok", "pool": 6, "round": -1,
                          "cohort": 2, "accept": 2,
                          "max_cohort": headers[5]["max_cohort"]}
    assert headers[6]["op"] == "error" and "outside" in headers[6]["detail"]
    assert headers[13] == {"op": "error", "detail": "round 0 barrier timed "
                           "out (accept quota unreachable?)"}
    assert headers[14]["op"] == "join_ok" and headers[14]["live"] == 5
    assert headers[15]["op"] == "error"
    assert headers[16] == {"op": "error", "detail": "unknown op 'fed_bogus'"}


@pytest.mark.parametrize("plane", ["threads", "evloop"])
def test_retried_begin_and_drop_replay_their_outcome(plane, tmp_path):
    """Exact: a re-sent ``fed_begin`` returns the sampled cohort and a
    re-sent ``fed_drop`` its recorded replacement; neither journals
    twice; an out-of-order begin is an error frame."""
    cfg = _cfg(tmp_path, plane, wire_plane=plane, net_timeout_s=1.0)
    serving = _Serving(ps_net.PSNetServer(cfg))
    try:
        h = [ps_net.parse_request(r)[0]
             for r in _raw(serving.address, SCRIPT[:13])]
    finally:
        serving.stop()
    begin, again, bad, drop, drop_again, flush = h[7:13]
    assert begin["op"] == "fed_begin_ok" and begin["version"] == 0
    assert again == begin and len(begin["cohort"]) == 2
    assert bad == {"op": "error", "detail": "fed_begin out of order: "
                   "expected round 1, got 3"}
    assert drop["op"] == "fed_drop_ok" and drop_again == drop
    assert drop["dropped"] == 1
    assert flush == {"op": "fed_flush_ok", "flushed": False}
    events = [r["event"] for r in read_ledger(
        f"{cfg.train_dir}/fed_rounds.jsonl")]
    assert events.count("round_begin") == 1 and events.count("dropout") == 1


def _payload(cfg) -> bytes:
    setup = ps_net.build_endpoint_setup(cfg)
    return native.encode_arrays(
        [transfer.make_device_packer()(setup.template).numpy()])


def test_evloop_parks_fed_end_and_serves_pushes(tmp_path):
    """Structure: on the event-loop plane a ``fed_end`` sent before the
    commit is answered after it, and the pushes that commit the round
    are served while it is parked."""
    cfg = _cfg(tmp_path, "ev", wire_plane="evloop")
    serving = _Serving(ps_net.PSNetServer(cfg))
    try:
        for c in range(6):
            ps_net.client_call(serving.address,
                               {"op": "fed_register", "client": c})
        begin, _ = ps_net.client_call(serving.address,
                                      {"op": "fed_begin", "round": 0})
        waiter = socket.create_connection(serving.address, timeout=20)
        ps_net.send_frame(waiter, ps_net.make_request(
            {"op": "fed_end", "round": 0}))
        payload = _payload(cfg)
        verdicts = []
        for c in begin["cohort"]:
            h, _ = ps_net.client_call(
                serving.address, {"op": "push", "worker": c, "version": 0,
                                  "loss": 1.0, "round": 0}, [payload])
            verdicts.append(h)
            if len(verdicts) == 1:
                # The round is open: the parked fed_end has no reply yet.
                waiter.settimeout(0.2)
                with pytest.raises(socket.timeout):
                    ps_net.recv_frame(waiter)
                waiter.settimeout(20)
        done = ps_net.parse_request(ps_net.recv_frame(waiter))[0]
        waiter.close()
        stats = serving.stats()
    finally:
        serving.stop()
    assert verdicts == [{"op": "push_ok", "accepted": True}] * 2
    assert done == {"op": "fed_end_ok", "round": 0,
                    "accepted": sorted(begin["cohort"]), "version": 1}
    assert stats["apply_rounds"] == 1 and stats["version"] == 1


def test_fed_driver_entry_point(tmp_path, capsys):
    """``ps_net.main --role fed_driver`` drives a threads-plane server's
    rounds and prints ``PS_NET_FED_DONE``."""
    serving = _Serving(ps_net.PSNetServer(_cfg(tmp_path, "srv")))
    flags = ["--platform", "cpu", "--network", "LeNet", "--dataset",
             "MNIST", "--synthetic-data", "--synthetic-size", "64",
             "--batch-size", "8", "--compress-grad", "qsgd",
             "--server-agg", "homomorphic", "--federated", "--pool-size",
             "6", "--cohort", "2", "--local-steps", "1", "--fed-rounds", "2",
             "--lr", "0.05", "--momentum", "0", "--seed", str(SEED),
             "--no-bf16", "--port", str(serving.address[1])]
    try:
        rc = ps_net.main(["--role", "fed_driver"] + flags)
        stats = serving.stats()
    finally:
        serving.stop()
    out = capsys.readouterr().out
    assert rc == 0 and "PS_NET_FED_DONE " in out
    done = __import__("json").loads(out.split("PS_NET_FED_DONE ", 1)[1]
                                    .splitlines()[0])
    assert done["rounds"] == 2 and np.isfinite(done["final_loss"])
    assert stats["federated"]["rounds_done"] == 2


def test_agg_tree_closes_one_pseudo_push_per_aggregator_a_round(tmp_path):
    """Exact: with the whole cohort as one push wave, each aggregator
    holding members of a round forwards one pseudo-push for it
    (``subtree_expect``), and each round is one decode."""
    hom = dict(pool_size=8, cohort=4, fed_rounds=2)
    placeholder = "127.0.0.1:1,127.0.0.1:2"
    server = _Serving(ps_net.PSNetServer(_cfg(
        tmp_path, "root", agg_tree=placeholder, **hom)))
    aggs = [_Serving(AggregatorServer(
        _cfg(tmp_path, f"agg{i}", agg_tree=placeholder, **hom),
        server.address, port=0, index=i)) for i in range(2)]
    tree = ",".join(f"{a.address[0]}:{a.address[1]}" for a in aggs)
    try:
        res = run_federated(_cfg(tmp_path, "drv", agg_tree=tree, **hom),
                            addr=server.address, thread_batch=4)
        stats = server.stats()
    finally:
        for a in aggs:
            a.stop()
        server.stop()
    homes = sum(len({c % 2 for c in rec["accepted"]})
                for rec in res.round_records)
    assert stats["agg_pushes"] == homes
    assert stats["agg_weight"] == 4 * 2
    assert stats["decode_count"] == stats["apply_rounds"] == 2
    assert [len(r["accepted"]) for r in res.round_records] == [4, 4]


def test_replicas_take_every_pull(tmp_path):
    """Exact: with ``--replicas`` every cohort pull goes to the replica
    (the apply server ships no weights), and the rounds complete."""
    server = _Serving(ps_net.PSNetServer(_cfg(tmp_path, "srv")))
    replica = _Serving(PullReplicaServer(_cfg(tmp_path, "rep"),
                                         server.address))
    rep = f"{replica.address[0]}:{replica.address[1]}"
    try:
        res = run_federated(_cfg(tmp_path, "drv", replicas=rep),
                            addr=server.address)
        stats = server.stats()
        rstats = replica.stats()
    finally:
        replica.stop()
        server.stop()
    assert res.rounds == 2 and stats["federated"]["rounds_done"] == 2
    # The apply server answered no pull (its per-op segments); the
    # replica's subscribe stream is its only down-link.
    assert "pull" not in stats["segments"]
    assert "subscribe" in stats["segments"]
    assert rstats["replica_pulls"] == stats["pushes"] == 4


def test_restarted_server_resumes_its_rounds(tmp_path):
    """Exact: a federated server restarted on its ``--server-state-dir``
    resumes at its last completed round: the version, the rounds done, a
    retried begin of that round replays its journaled cohort, and the
    next round begins."""
    state = str(tmp_path / "state")
    cfg = _cfg(tmp_path, "srv", server_state_dir=state)
    first = _Serving(ps_net.PSNetServer(cfg))
    try:
        run_federated(_cfg(tmp_path, "drv"), addr=first.address)
    finally:
        first.stop()
    rounds = round_sequence(read_ledger(f"{cfg.train_dir}/fed_rounds.jsonl"))
    second = _Serving(ps_net.PSNetServer(cfg))
    try:
        stats = second.stats()
        replay, _ = ps_net.client_call(second.address,
                                       {"op": "fed_begin", "round": 1})
        nxt, _ = ps_net.client_call(second.address,
                                    {"op": "fed_begin", "round": 2})
    finally:
        second.stop()
    assert stats["version"] == 2 and stats["recoveries"] == 1
    assert stats["federated"]["rounds_done"] == 2
    assert stats["federated"]["round"] == 1
    assert replay["cohort"] == list(rounds[1][1])
    assert nxt["op"] == "fed_begin_ok" and nxt["version"] == 2


def test_net_transport_drives_rounds_with_a_pool(tmp_path):
    """Exact: ``drive_rounds`` over a ``NetTransport`` built by hand (the
    pieces ``run_federated(addr=)`` composes) registers the pool, stamps
    no wave without a tree, and closes its connections."""
    from ewdml_tpu_torch.data import datasets
    from ewdml_tpu_torch.federated.client import ClientPool

    cfg = _cfg(tmp_path, "srv")
    serving = _Serving(ps_net.PSNetServer(cfg))
    transport = NetTransport(serving.address, cfg)
    try:
        pool = ClientPool(cfg, datasets.load(
            "MNIST", train=True, synthetic=True, seed=SEED,
            synthetic_size=64), ps_net.build_endpoint_setup(cfg))
        transport.stamp_push_wave([0, 1])
        assert transport._round_expect == {}
        res = drive_rounds(cfg, transport, pool, rounds=1)
    finally:
        transport.close()
        serving.stop()
    assert res.rounds == 1 and len(res.round_records[0]["accepted"]) == 2
    assert transport.bytes.sent > 0 and transport.bytes.received > 0
