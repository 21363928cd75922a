"""Pipelined federated round drivers, ``--round-pipeline overlap|async``
(``ewdml_tpu/federated/pipeline.py``).

The sequential driver (:func:`~ewdml_tpu_torch.federated.loop.drive_rounds`)
keeps one round in flight: begin, run the cohort, wait on the barrier. A
single straggler then holds the fleet. The two drivers here relax that in
two bounded ways; both use the transport's verbs plus a ``round_idx`` stamp
on every push, by which the server routes a delta to its round's grid.

``overlap``: depth-2 round pipelining. The driver begins round R+1 (a real
cohort draw, journaled as ``round_pipeline_begin``) and starts its clients
while round R's stragglers drain, then joins round R and waits on its
barrier. The server keeps one homomorphic grid per open round
(``ParameterServer._rp_pending``), and each round pays one dequantize at
its commit. A push for a committed round is refused as round-stale. Thread
start makes the arrival order depend on the scheduler, so ledgers compare
structurally.

``async``: FedBuff-style bounded staleness. No barrier: the server admits
a delta whose round is within ``--fed-staleness-bound`` of the newest,
weights it by staleness (integer ticks,
:class:`~ewdml_tpu_torch.parallel.policy.AsyncCohortPolicy`) and commits
when the tick quota fills; the ledger's ``round_commit`` carries the
commit index. A ``delay@C`` client computes its delta in round R and ships
it during round R+1 (staleness 1, down-weighted) instead of sleeping, so
the ledger is a function of the config, the seed and the fault spec.

Both report ``crash@C=R`` clients before launch; the coordinator's
resample uses its per-round attempt counters.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ewdml_tpu_torch.federated.loop import FedRunResult
from ewdml_tpu_torch.obs import clock
from ewdml_tpu_torch.obs.registry import MetricsRegistry
from ewdml_tpu_torch.parallel.faults import FaultSpec


def drive_rounds_pipelined(cfg, transport, pool,
                           rounds: Optional[int] = None, fault_spec=None,
                           thread_batch: int = 0,
                           registry: Optional[MetricsRegistry] = None
                           ) -> FedRunResult:
    """Run ``rounds`` rounds with the driver ``cfg.round_pipeline`` names.
    ``thread_batch`` is ignored: ``overlap`` threads the whole cohort, and
    ``async`` runs one client after another. ``federated.client_s`` and
    ``federated.round_s`` are observed in ``registry``."""
    mode = cfg.round_pipeline
    if mode not in ("overlap", "async"):
        raise ValueError(f"drive_rounds_pipelined needs round_pipeline in "
                         f"('overlap', 'async'), got {mode!r}")
    if not isinstance(fault_spec, FaultSpec):
        fault_spec = FaultSpec.parse(fault_spec if fault_spec is not None
                                     else cfg.fault_spec)
    metrics = registry if registry is not None else MetricsRegistry()
    rounds = int(rounds if rounds is not None else cfg.fed_rounds)
    for c in range(cfg.pool_size):
        transport.register(c)
    drive = _drive_overlap if mode == "overlap" else _drive_async
    return drive(cfg, transport, pool, rounds, fault_spec, metrics)


def _resolve_cohort(transport, fault_spec, crashed: set, cohort: list,
                    round_idx: int) -> tuple[list, int]:
    """Report the cohort's crash-due members and fold their replacements
    (which may be crash-due too) into the draw: ``(live clients in push
    order, replacements issued)``."""
    queue = list(cohort)
    live: list = []
    resampled = 0
    while queue:
        client = queue.pop(0)
        wf = fault_spec.for_worker(client)
        if (client in crashed
                or (wf.crash_at is not None and round_idx >= wf.crash_at)):
            crashed.add(client)
            replacement = transport.drop(client, round_idx)
            if replacement >= 0:
                queue.append(replacement)
                resampled += 1
            continue
        live.append(client)
    return live, resampled


def _result(rounds, records, losses, walls, crashed, resampled, rejected,
            pool, t_drive) -> FedRunResult:
    return FedRunResult(
        rounds=rounds, round_records=records, round_losses=losses,
        round_walls_s=walls, dropouts=len(crashed), resampled=resampled,
        rejected=rejected, skew=pool.skew, data_source=pool.ds.source,
        ledger_path=None, drive_wall_s=clock.monotonic() - t_drive)


def _drive_overlap(cfg, transport, pool, rounds: int, fault_spec,
                   metrics: MetricsRegistry) -> FedRunResult:
    """Depth-2 window: start round R+1's cohort, then join and commit
    round R. Round walls overlap, so their sum can exceed the drive."""
    from ewdml_tpu_torch import native

    crashed: set = set()
    records, losses, walls = [], [], []
    rejected = 0
    resampled = 0
    t_drive = clock.monotonic()
    book_lock = threading.Lock()

    def run_client(client: int, round_idx: int, flags: dict,
                   round_losses: list, errors: list) -> None:
        try:
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
                                native.encode_arrays([payload]), loss,
                                round_idx=round_idx)
            with book_lock:
                flags[client] = ok
                round_losses.append(loss)
        except BaseException as e:  # noqa: BLE001 -- re-raised in finish
            errors.append(e)

    def launch(round_idx: int):
        nonlocal resampled
        t_round = clock.monotonic()
        cohort = list(transport.begin_round(round_idx))
        live, extra = _resolve_cohort(transport, fault_spec, crashed,
                                      cohort, round_idx)
        resampled += extra
        flags: dict = {}
        round_losses: list = []
        errors: list = []
        threads = [threading.Thread(
            target=run_client,
            args=(c, round_idx, flags, round_losses, errors),
            name=f"fed-client-{c}-r{round_idx}") for c in live]
        for t in threads:
            t.start()
        return round_idx, threads, flags, round_losses, errors, t_round

    def finish(inflight) -> None:
        nonlocal rejected
        round_idx, threads, flags, round_losses, errors, t_round = inflight
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        records.append(transport.end_round(round_idx))
        rejected += sum(1 for ok in flags.values() if not ok)
        losses.append(float(np.nanmean(round_losses))
                      if round_losses else float("nan"))
        wall = clock.monotonic() - t_round
        walls.append(wall)
        metrics.histogram("federated.round_s").observe(wall)

    prev = None
    for r in range(rounds):
        cur = launch(r)          # R begins while R-1 may still be open
        if prev is not None:
            finish(prev)
        prev = cur
    if prev is not None:
        finish(prev)
    return _result(rounds, records, losses, walls, crashed, resampled,
                   rejected, pool, t_drive)


def _drive_async(cfg, transport, pool, rounds: int, fault_spec,
                 metrics: MetricsRegistry) -> FedRunResult:
    """Bounded-staleness admission, one client after another. A
    ``delay@C`` client defers its push by one round, so staleness, its
    down-weight and the ledger do not depend on wall-clock scheduling."""
    from ewdml_tpu_torch import native

    crashed: set = set()
    records, losses, walls = [], [], []
    rejected = 0
    resampled = 0
    t_drive = clock.monotonic()
    deferred: list = []   # (client, round_idx, version, message, loss)

    def ship(item) -> None:
        nonlocal rejected
        client, round_idx, version, message, loss = item
        if not transport.push(client, version, message, loss,
                              round_idx=round_idx):
            rejected += 1

    for r in range(rounds):
        t_round = clock.monotonic()
        cohort = list(transport.begin_round(r))
        # The previous round's deferred deltas go first: their stamp is
        # now one behind the newest round, so they are down-weighted.
        backlog, deferred = deferred, []
        for item in backlog:
            ship(item)
        live, extra = _resolve_cohort(transport, fault_spec, crashed,
                                      cohort, r)
        resampled += extra
        round_losses: list = []
        for client in live:
            wf = fault_spec.for_worker(client)
            buf, version = transport.pull(client)
            t0 = clock.monotonic()
            payload, loss = pool.run_client_round(client, buf, r)
            metrics.histogram("federated.client_s").observe(
                clock.monotonic() - t0)
            if wf.nan_due(r):
                loss = float("nan")
            item = (client, r, version, native.encode_arrays([payload]),
                    loss)
            if wf.delay_s > 0 and r + 1 < rounds:
                deferred.append(item)
            else:
                ship(item)
            round_losses.append(loss)
        losses.append(float(np.nanmean(round_losses))
                      if round_losses else float("nan"))
        wall = clock.monotonic() - t_round
        walls.append(wall)
        metrics.histogram("federated.round_s").observe(wall)
    for item in deferred:   # nothing left to defer behind
        ship(item)
    # Commit the ticks still pending below the quota: the weighted apply
    # takes a partial batch exactly.
    transport.flush()
    return _result(rounds, records, losses, walls, crashed, resampled,
                   rejected, pool, t_drive)
