"""The federated round driver over either transport
(``ewdml_tpu/federated/loop.py``).

- :class:`InProcessTransport` makes direct calls on a ``ParameterServer``
  and a :class:`~ewdml_tpu_torch.federated.coordinator.FederatedCoordinator`
  of this process: the pool-scale simulation.
- :class:`NetTransport` speaks the same verbs over the TCP wire
  (``fed_register``, ``fed_begin``, ``fed_end``, ``fed_drop``,
  ``fed_flush`` beside ``pull`` and ``push``) to a ``PSNetServer`` built
  with ``--federated``, which owns the coordinator and the ledger
  (``ps_net --role fed_driver``).

Per round the coordinator samples the cohort (``begin_round``), the driver
runs each sampled client (one after another, the replayable mode, or in
thread batches), reports the ``--fault-spec`` dropouts (the coordinator
resamples a replacement into the round, so the accept quota stays
reachable) and waits on the round barrier for the accepted set. Under
``--server-agg homomorphic`` the server's apply is one integer accumulate
and one dequantize a round, whatever the cohort.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ewdml_tpu_torch.obs import clock
from ewdml_tpu_torch.obs.registry import MetricsRegistry
from ewdml_tpu_torch.parallel.faults import FaultSpec

#: The in-process round barrier's bound. A timeout is a driver fault (an
#: unreachable quota), not a tuning knob.
BARRIER_TIMEOUT_S = 120.0


class InProcessTransport:
    """Direct calls on a local ``ParameterServer`` and coordinator."""

    def __init__(self, server, coordinator):
        self.server = server
        self.fed = coordinator

    def register(self, client: int) -> dict:
        return self.fed.register(client)

    def begin_round(self, round_idx: int) -> list[int]:
        return self.fed.begin_round(round_idx, version=self.server.version)

    def pull(self, client: int) -> tuple[np.ndarray, int]:
        mode, payload, version, _ = self.server.pull(-1, worker=client)
        assert mode == "weights", mode  # validate_federated: weights down
        return np.asarray(payload), int(version)

    def push(self, client: int, version: int, message: bytes,
             loss: float, round_idx: int = -1) -> bool:
        from ewdml_tpu_torch.parallel.ps import PushRecord

        return self.server.push(PushRecord(worker=client, version=version,
                                           message=message, loss=loss,
                                           round_id=round_idx))

    def flush(self) -> bool:
        """Commit the server's partial pending batch (the async drain)."""
        return self.server.flush_pending()

    def drop(self, client: int, round_idx: int) -> int:
        return self.fed.report_drop(client, round_idx)

    def end_round(self, round_idx: int) -> dict:
        rec = self.fed.wait_round(round_idx, timeout=BARRIER_TIMEOUT_S)
        if rec is None:
            raise RuntimeError(
                f"round {round_idx} barrier timed out (accept quota "
                f"unreachable? dropouts without replacements?)")
        return rec

    def close(self) -> None:
        pass


class NetTransport:
    """The same verbs over the TCP wire: one driver connection, each
    client's id in the request headers as on the worker ops
    (``loop.py:91-292``). ``registry`` takes the socket byte totals and
    the per-op client latencies."""

    def __init__(self, addr, cfg, registry: Optional[MetricsRegistry] = None):
        from ewdml_tpu_torch.core.config import parse_agg_tree
        from ewdml_tpu_torch.parallel.ps_net import (ByteCounter,
                                                     RetryingConnection,
                                                     parse_replicas)

        self.registry = registry
        self.bytes = ByteCounter(registry)
        self.timeout_s = cfg.net_timeout_s
        self._conn = RetryingConnection(
            addr, timeout_s=cfg.net_timeout_s, retries=cfg.net_retries,
            backoff_s=cfg.net_backoff_s, byte_counter=self.bytes,
            registry=registry)
        # One socket serves every verb, and RetryingConnection is not
        # thread-safe: thread-batched cohorts take turns on its round
        # trips. Local SGD runs outside the calls, so this costs only
        # wire time.
        self._call_lock = threading.Lock()
        # With --replicas the weight pulls go to the replica tier over a
        # connection and a lock of their own, so a slow pull never holds
        # a round barrier on the apply server. A replica lags the apply
        # plane by its poll, and a round's pushes must be computed at the
        # version its round began at (the cohort policy's staleness is
        # strict), so a pull first waits for the replica to reach it.
        self._begun_version = -1
        self._pull_conn = self._conn
        self._pull_lock = self._call_lock
        if cfg.replicas:
            self._pull_conn = RetryingConnection(
                parse_replicas(cfg.replicas), timeout_s=cfg.net_timeout_s,
                retries=cfg.net_retries, backoff_s=cfg.net_backoff_s,
                byte_counter=self.bytes,
                jitter_seed=(cfg.seed << 8) ^ 0xF1D0, registry=registry)
            self._pull_lock = threading.Lock()
        # With --agg-tree a client's push goes to its home aggregator
        # (client % A, the others as failover) over a connection of the
        # client's own: an aggregator parks a push until its group
        # flushes, so cohort members sharing one socket would wait behind
        # the first parked reply, a deadlock at fan-in > 1.
        self._seed = cfg.seed
        self._retries = cfg.net_retries
        self._backoff_s = cfg.net_backoff_s
        self._agg_addrs = parse_agg_tree(cfg.agg_tree) if cfg.agg_tree else []
        self._agg_conns: dict = {}   # ewdml: guarded-by[_agg_guard]
        self._agg_guard = threading.Lock()
        # Per aggregator, the members of the driver's current push wave,
        # stamped on every tree-routed push (subtree_expect) so a group
        # closes at the count that can be in flight, not on the idle
        # flush. Rebuilt by the driver thread and swapped whole; client
        # threads only read it.
        self._round_expect: dict = {}

    def stamp_push_wave(self, clients) -> None:
        """Announce the driver's next wave: exactly these clients push
        before any ack is read. A whole-cohort wave closes every subtree at
        its sampled membership (one pseudo-push per aggregator a round); a
        sequential driver stamps 1 and is acknowledged at once."""
        if not self._agg_addrs:
            return
        a = len(self._agg_addrs)
        expect: dict = {}
        for c in clients:
            expect[c % a] = expect.get(c % a, 0) + 1
        self._round_expect = expect

    def _agg_conn_for(self, client: int):
        """``(connection, lock)`` carrying ``client``'s pushes to its home
        aggregator, made at first use."""
        from ewdml_tpu_torch.parallel.ps_net import RetryingConnection

        with self._agg_guard:
            entry = self._agg_conns.get(client)
            if entry is None:
                home = client % len(self._agg_addrs)
                conn = RetryingConnection(
                    self._agg_addrs[home:] + self._agg_addrs[:home],
                    timeout_s=self.timeout_s, retries=self._retries,
                    backoff_s=self._backoff_s, byte_counter=self.bytes,
                    jitter_seed=(self._seed << 8) ^ client ^ 0xA660,
                    registry=self.registry)
                entry = self._agg_conns[client] = (conn, threading.Lock())
            return entry

    def _call(self, header: dict, ok: str, sections=()) -> dict:
        with self._call_lock:
            reply, _ = self._conn.call(header, sections)
        if reply["op"] != ok:
            raise RuntimeError(f"{header['op']} failed: "
                               f"{reply.get('detail', reply)}")
        return reply

    def register(self, client: int) -> dict:
        header = self._call({"op": "fed_register", "client": client},
                            "fed_register_ok")
        if self._agg_addrs:
            # Subtree membership from round one, so a group is complete
            # when all its registered children are in.
            conn, lock = self._agg_conn_for(client)
            with lock:
                ah, _ = conn.call({"op": "agg_register", "worker": client})
            if ah.get("op") != "agg_register_ok" \
                    or int(ah["children"]) < 1:
                raise RuntimeError(f"agg_register failed: {ah}")
        return {"pool": int(header["pool"]), "round": int(header["round"]),
                "cohort": int(header["cohort"]),
                "accept": int(header["accept"]),
                "max_cohort": header["max_cohort"]}

    def begin_round(self, round_idx: int) -> list[int]:
        header = self._call({"op": "fed_begin", "round": round_idx},
                            "fed_begin_ok")
        if int(header["round"]) != round_idx or "version" not in header:
            raise RuntimeError(f"fed_begin({round_idx}) answered {header}")
        self._begun_version = max(self._begun_version, int(header["version"]))
        return [int(c) for c in header["cohort"]]

    def _await_replica(self) -> None:
        """Poll the replica's version (``resync``, no weights) until it
        reaches the version the newest round began at; the reference's
        driver pulls at once, and a lagging replica's pushes are then
        dropped as stale (ROADMAP Queue 3 item 22)."""
        deadline = clock.monotonic() + self.timeout_s
        while True:
            with self._pull_lock:
                header, _ = self._pull_conn.call({"op": "resync"})
            if int(header.get("version", -1)) >= self._begun_version:
                return
            if clock.monotonic() > deadline:
                raise RuntimeError(
                    f"replica at version {header.get('version')} never "
                    f"reached the round's version {self._begun_version}")
            time.sleep(0.005)

    def pull(self, client: int) -> tuple[np.ndarray, int]:
        if self._pull_conn is not self._conn:
            self._await_replica()
        with self._pull_lock:
            header, sections = self._pull_conn.call(
                {"op": "pull", "worker": client, "worker_version": -1,
                 "plan_version": 0})
        if header.get("op") != "pull_ok" or header.get("mode") != "weights":
            raise RuntimeError(f"federated pull answered {header}")
        return (np.frombuffer(sections[0], np.uint8),
                int(header["version"]))

    def push(self, client: int, version: int, message: bytes,
             loss: float, round_idx: int = -1) -> bool:
        if self._agg_addrs:
            # The same frame to the home aggregator; the ack comes once the
            # group flushed and the root admitted its pseudo-push.
            # subtree_expect: this wave's members homed there.
            expect = self._round_expect.get(
                client % len(self._agg_addrs), 0)
            conn, lock = self._agg_conn_for(client)
            with lock:
                header, _ = conn.call(
                    {"op": "push", "worker": client, "version": version,
                     "loss": loss, "plan_version": 0,
                     "subtree_expect": int(expect)}, [message])
        else:
            # ``round`` routes the push to its round's grid; -1 is an
            # unstamped push, as before the pipeline.
            with self._call_lock:
                header, _ = self._conn.call(
                    {"op": "push", "worker": client, "version": version,
                     "loss": loss, "plan_version": 0,
                     "round": int(round_idx)}, [message])
        if header.get("op") != "push_ok":
            raise RuntimeError(f"push answered {header}")
        return bool(header.get("accepted", True))

    def flush(self) -> bool:
        """Commit the server's partial pending batch (the async drain)."""
        return bool(self._call({"op": "fed_flush"}, "fed_flush_ok")
                    ["flushed"])

    def drop(self, client: int, round_idx: int) -> int:
        header = self._call({"op": "fed_drop", "client": client,
                             "round": round_idx}, "fed_drop_ok")
        _ = int(header["dropped"])  # the run's dropout total, validated
        return int(header["replacement"])

    def end_round(self, round_idx: int) -> dict:
        with self._call_lock:
            header, _ = self._conn.call({"op": "fed_end",
                                         "round": round_idx})
        if header["op"] != "fed_end_ok":
            raise RuntimeError(f"fed_end failed (barrier timeout?): "
                               f"{header.get('detail', header)}")
        return {"round": int(header["round"]),
                "accepted": [int(c) for c in header["accepted"]],
                "version": int(header["version"])}

    def close(self) -> None:
        if self._pull_conn is not self._conn:
            self._pull_conn.close()
        with self._agg_guard:
            for conn, _lock in self._agg_conns.values():
                conn.close()
            self._agg_conns.clear()
        self._conn.close()


@dataclasses.dataclass
class FedRunResult:
    """One federated run's outcome (JSON-able except ``params``)."""

    rounds: int
    round_records: list          # the (round, accepted, version) records
    round_losses: list           # mean pushed loss per round
    round_walls_s: list
    dropouts: int
    resampled: int
    rejected: int                # pushes the server refused (quota/stale)
    skew: float                  # partition heterogeneity statistic
    data_source: str
    ledger_path: Optional[str]
    params: object = None        # final server parameters (a leaf list)
    stats: object = None         # the server's PSStats
    coordinator: object = None   # the coordinator's snapshot
    # First begin_round to the last barrier, without the endpoint set-up.
    drive_wall_s: float = 0.0

    @property
    def final_loss(self) -> float:
        return self.round_losses[-1] if self.round_losses else float("nan")


def drive_rounds(cfg, transport, pool, rounds: Optional[int] = None,
                 fault_spec=None, thread_batch: int = 0,
                 registry: Optional[MetricsRegistry] = None) -> FedRunResult:
    """Run ``rounds`` federated rounds of ``pool``'s clients against
    ``transport``: one client after another by default (the replayable
    mode), or in thread batches of ``thread_batch`` > 1 (the accepted set
    then depends on arrival order, so ledgers compare structurally).

    ``fault_spec`` uses the shared grammar with client ids as the worker:
    ``crash@C=R`` drops client C at its first sampling in a round >= R
    (reported to the coordinator, which resamples a replacement and
    excludes C from later draws); ``delay@C=S`` sleeps the client before
    its push; ``nan@C=R`` poisons its reported loss in round R.
    ``federated.client_s`` and ``federated.round_s`` are observed in
    ``registry``."""
    from ewdml_tpu_torch import native

    if not isinstance(fault_spec, FaultSpec):
        fault_spec = FaultSpec.parse(fault_spec if fault_spec is not None
                                     else cfg.fault_spec)
    metrics = registry if registry is not None else MetricsRegistry()
    rounds = int(rounds if rounds is not None else cfg.fed_rounds)
    for c in range(cfg.pool_size):
        transport.register(c)
    crashed: set = set()
    records, losses, walls = [], [], []
    rejected = 0
    resampled = 0  # replacements the coordinator issued for our drops
    t_drive = clock.monotonic()
    book_lock = threading.Lock()  # thread-batched bookkeeping only

    def run_client(client: int, round_idx: int, flags: dict,
                   round_losses: list) -> None:
        wf = fault_spec.for_worker(client)
        buf, version = transport.pull(client)
        t0 = clock.monotonic()
        payload, loss = pool.run_client_round(client, buf, round_idx)
        metrics.histogram("federated.client_s").observe(
            clock.monotonic() - t0)
        wf.sleep_if_due()
        if wf.nan_due(round_idx):
            loss = float("nan")
        ok = transport.push(client, version,
                            native.encode_arrays([payload]), loss)
        with book_lock:
            flags[client] = ok
            round_losses.append(loss)

    def run_threads(live: list, round_idx: int, flags: dict,
                    round_losses: list) -> None:
        errors: list = []

        def target(client):
            try:
                run_client(client, round_idx, flags, round_losses)
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                errors.append(e)

        threads = [threading.Thread(target=target, args=(c,),
                                    name=f"fed-client-{c}") for c in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    for r in range(rounds):
        t_round = clock.monotonic()
        cohort = list(transport.begin_round(r))
        queue = list(cohort)
        flags: dict = {}
        round_losses: list = []
        while queue:
            batch = ([queue.pop(0)] if thread_batch <= 1
                     else [queue.pop(0)
                           for _ in range(min(thread_batch, len(queue)))])
            live = []
            for client in batch:
                wf = fault_spec.for_worker(client)
                if (client in crashed
                        or (wf.crash_at is not None and r >= wf.crash_at)):
                    # Dropout: the client never pushes again; the server
                    # resamples a replacement into the round, which the
                    # driver then runs.
                    crashed.add(client)
                    replacement = transport.drop(client, r)
                    if replacement >= 0:
                        queue.append(replacement)
                        resampled += 1
                    continue
                live.append(client)
            if live:
                # Tree-routed pushes close their subtree at this wave.
                stamp = getattr(transport, "stamp_push_wave", None)
                if stamp is not None:
                    stamp(live)
            if thread_batch <= 1:
                for client in live:
                    run_client(client, r, flags, round_losses)
            elif live:
                run_threads(live, r, flags, round_losses)
        rec = transport.end_round(r)
        records.append(rec)
        rejected += sum(1 for ok in flags.values() if not ok)
        losses.append(float(np.nanmean(round_losses))
                      if round_losses else float("nan"))
        wall = clock.monotonic() - t_round
        walls.append(wall)
        metrics.histogram("federated.round_s").observe(wall)
    return FedRunResult(
        rounds=rounds, round_records=records, round_losses=losses,
        round_walls_s=walls, dropouts=len(crashed), resampled=resampled,
        rejected=rejected, skew=pool.skew, data_source=pool.ds.source,
        ledger_path=None, drive_wall_s=clock.monotonic() - t_drive)


def ledger_path_for(cfg) -> Optional[str]:
    """The round journal's home, ``<train_dir>/fed_rounds.jsonl``."""
    if not cfg.train_dir:
        return None
    return os.path.join(cfg.train_dir, "fed_rounds.jsonl")


def run_federated(cfg, rounds: Optional[int] = None, addr=None,
                  thread_batch: int = 0, device=None,
                  registry: Optional[MetricsRegistry] = None
                  ) -> FedRunResult:
    """One federated run end to end, on the card unless ``cfg.platform`` or
    ``device`` says the CPU.

    ``addr=None`` builds the whole stack in process: the coordinator, a
    ``ParameterServer`` and the client pool. ``addr=(host, port)`` drives a
    ``PSNetServer`` built elsewhere with the same config over sockets: the
    server owns the coordinator and the ledger, this side the clients.
    ``--round-pipeline overlap|async`` picks the pipelined driver.
    ``registry`` takes the round timings and, in process, the
    coordinator's snapshot and the server's totals at the end."""
    from ewdml_tpu_torch.core.config import validate_federated
    from ewdml_tpu_torch.data import datasets
    from ewdml_tpu_torch.federated.client import ClientPool
    from ewdml_tpu_torch.federated.coordinator import FederatedCoordinator
    from ewdml_tpu_torch.optim import make_optimizer
    from ewdml_tpu_torch.parallel import ps
    from ewdml_tpu_torch.parallel.ps_net import build_endpoint_setup

    validate_federated(cfg)
    if not cfg.federated:
        raise ValueError("run_federated needs cfg.federated=True")
    setup = build_endpoint_setup(cfg, device)
    ds = datasets.load(cfg.dataset, cfg.data_dir, train=True,
                       synthetic=cfg.synthetic_data, seed=cfg.seed,
                       synthetic_size=cfg.synthetic_size)
    pool = ClientPool(cfg, ds, setup)
    metrics = registry if registry is not None else MetricsRegistry()
    driver = drive_rounds
    if cfg.round_pipeline != "off":
        from ewdml_tpu_torch.federated.pipeline import drive_rounds_pipelined

        driver = drive_rounds_pipelined
    if addr is not None:
        transport = NetTransport(addr, cfg, registry=metrics)
        try:
            return driver(cfg, transport, pool, rounds=rounds,
                          thread_batch=thread_batch, registry=metrics)
        finally:
            transport.close()
    coordinator = FederatedCoordinator(cfg, ledger_path_for(cfg),
                                       registry=metrics)
    optimizer = make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum,
                               cfg.weight_decay, cfg.nesterov,
                               state_dtype=cfg.precision.state_dtype)
    server = ps.ParameterServer(
        setup.params, optimizer, setup.comp, policy=coordinator.policy,
        seed=cfg.seed, down_mode="weights", precision=cfg.precision_policy,
        server_agg=cfg.server_agg, device=setup.device)
    if cfg.round_pipeline == "async":
        # The tick quota (accept x WEIGHT_SCALE unit copies): the weighted
        # apply divides by the realized tick total, so a batch of fresh
        # and down-weighted deltas is an exact weighted mean.
        quota_ticks = coordinator.policy.num_aggregate
        server.register_payload_schema(setup.template, schema_k=quota_ticks,
                                       agg_weight=quota_ticks)
    else:
        server.register_payload_schema(setup.template)
    if cfg.round_pipeline != "off":
        server.arm_round_pipeline(cfg.round_pipeline)
    try:
        result = driver(cfg, InProcessTransport(server, coordinator), pool,
                        rounds=rounds, thread_batch=thread_batch,
                        registry=metrics)
    finally:
        coordinator.close()
    if setup.device.type == "cuda":
        torch.cuda.synchronize(setup.device)
    snap = coordinator.snapshot()
    metrics.absorb_federated(snap)
    metrics.absorb_ps_stats(server.stats)
    result.params = server.params
    result.stats = server.stats
    result.coordinator = snap
    result.resampled = snap["resampled"]
    result.ledger_path = ledger_path_for(cfg)
    return result


def evaluate_params(cfg, params, batch_stats=None, device=None) -> dict:
    """Top-1 and loss of ``params`` (the JAX tree's leaf order and
    layout) on the held-out split, on ``device`` (default: the card unless
    ``cfg.platform`` says the CPU). As in the JAX package, a model with
    BatchNorm needs ``batch_stats`` ({Flax path: statistic}, flat or
    nested): without them it raises (a ``ValueError`` naming the missing
    statistics, where Flax raises ``ScopeCollectionNotFound``)."""
    from ewdml_tpu_torch.core.world import resolve_device
    from ewdml_tpu_torch.models import build_model, num_classes_for
    from ewdml_tpu_torch.models.convert import from_jax, leaf_specs
    from ewdml_tpu_torch.train.loop import run_eval
    from ewdml_tpu_torch.train.state import _flat, _stat_buffers, leaf_params

    device = resolve_device(cfg.platform, device)
    model = build_model(cfg.network, num_classes_for(cfg.dataset),
                        dataset=cfg.dataset).to(device)
    specs = leaf_specs(model)
    stats = _stat_buffers(model)
    given = _flat(batch_stats) if batch_stats else {}
    missing = [path for path, _ in stats if path not in given]
    if missing:
        raise ValueError(
            f"evaluate_params: {cfg.network} reads BatchNorm statistics "
            f"and batch_stats holds none for {missing[0]!r} "
            f"({len(missing)} missing); pass batch_stats")
    with torch.no_grad():
        for p, leaf, spec in zip(leaf_params(model, specs), params, specs):
            p.copy_(from_jax(torch.as_tensor(leaf).to(device), spec.kind))
        for path, buf in stats:
            buf.copy_(torch.as_tensor(given[path]).to(device))
        ev = run_eval(model, cfg, device)
    return {"top1": ev["top1"], "loss": ev["loss"],
            "examples": ev["examples"]}
