"""The federated round driver (``ewdml_tpu/federated/loop.py``), in one
process.

:class:`InProcessTransport` makes direct calls on a ``ParameterServer``
and a :class:`~ewdml_tpu_torch.federated.coordinator.FederatedCoordinator`
of this process: the pool-scale simulation. The TCP transport
(``NetTransport``, ``--role fed_driver``) is ROADMAP Queue 1 item 6b.

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
             loss: float) -> bool:
        from ewdml_tpu_torch.parallel.ps import PushRecord

        return self.server.push(PushRecord(worker=client, version=version,
                                           message=message, loss=loss))

    def drop(self, client: int, round_idx: int) -> int:
        return self.fed.report_drop(client, round_idx)

    def end_round(self, round_idx: int) -> dict:
        rec = self.fed.wait_round(round_idx, timeout=BARRIER_TIMEOUT_S)
        if rec is None:
            raise RuntimeError(
                f"round {round_idx} barrier timed out (accept quota "
                f"unreachable? dropouts without replacements?)")
        return rec


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
    """One federated run end to end, in process: the coordinator, a
    ``ParameterServer`` and the client pool, on the card unless
    ``cfg.platform`` or ``device`` says the CPU. ``registry`` takes the
    round timings and, at the end, the coordinator's snapshot and the
    server's totals. ``addr`` (driving a TCP server) is ROADMAP Queue 1
    item 6b."""
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
    if addr is not None:
        raise NotImplementedError(
            "run_federated(addr=...) (NetTransport, the federated TCP "
            "tier) is not ported to ewdml_tpu_torch yet (ROADMAP.md Queue "
            "1 item 6b)")
    setup = build_endpoint_setup(cfg, device)
    ds = datasets.load(cfg.dataset, cfg.data_dir, train=True,
                       synthetic=cfg.synthetic_data, seed=cfg.seed,
                       synthetic_size=cfg.synthetic_size)
    pool = ClientPool(cfg, ds, setup)
    metrics = registry if registry is not None else MetricsRegistry()
    coordinator = FederatedCoordinator(cfg, ledger_path_for(cfg),
                                       registry=metrics)
    optimizer = make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum,
                               cfg.weight_decay, cfg.nesterov,
                               state_dtype=cfg.precision.state_dtype)
    server = ps.ParameterServer(
        setup.params, optimizer, setup.comp, policy=coordinator.policy,
        seed=cfg.seed, down_mode="weights", precision=cfg.precision_policy,
        server_agg=cfg.server_agg, device=setup.device)
    server.register_payload_schema(setup.template)
    try:
        result = drive_rounds(cfg, InProcessTransport(server, coordinator),
                              pool, rounds=rounds, thread_batch=thread_batch,
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


def evaluate_params(cfg, params, batch_stats=None) -> dict:
    """Top-1 and loss of ``params`` (the JAX tree's leaf order and
    layout) on the held-out split. As in the JAX package, a model with
    BatchNorm needs ``batch_stats`` ({Flax path: statistic}, flat or
    nested): without them it raises (a ``ValueError`` naming the missing
    statistics, where Flax raises ``ScopeCollectionNotFound``)."""
    from ewdml_tpu_torch.core.world import resolve_device
    from ewdml_tpu_torch.models import build_model, num_classes_for
    from ewdml_tpu_torch.models.convert import from_jax, leaf_specs
    from ewdml_tpu_torch.train.loop import run_eval
    from ewdml_tpu_torch.train.state import _flat, _stat_buffers, leaf_params

    device = resolve_device(cfg.platform)
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
