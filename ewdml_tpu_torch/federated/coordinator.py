"""Server-side federated round state: sampler, ledger and cohort policy
(``ewdml_tpu/federated/coordinator.py``).

One coordinator per server. It owns:

- the registered pool (clients register before round 0, or later: a late
  joiner is eligible from the next draw; only registered, non-dropped
  clients are sampled);
- the :class:`~ewdml_tpu_torch.federated.sampler.CohortSampler` and the
  :class:`~ewdml_tpu_torch.federated.ledger.RoundLedger`, the journal a
  replay is compared against;
- the cohort policy the ``ParameterServer`` consults on every push, chosen
  by ``--round-pipeline``: :class:`~ewdml_tpu_torch.parallel.policy.CohortPolicy`
  (``off``), ``PipelinedCohortPolicy`` (``overlap``) or
  ``AsyncCohortPolicy`` (``async``); its apply-commit hook completes a
  round here;
- the round barrier (:meth:`wait_round`).

Its gauges (``federated.round``, ``pool``, ``cohort``, ``max_cohort``) and
counters (``federated.dropouts``, ``resampled``) go into the
``MetricsRegistry`` its caller passes, never into a process-global one.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from ewdml_tpu_torch.core.config import (federated_max_cohort,
                                         validate_federated,
                                         validate_round_pipeline)
from ewdml_tpu_torch.federated.ledger import RoundLedger, read_ledger
from ewdml_tpu_torch.federated.sampler import CohortSampler
from ewdml_tpu_torch.obs.registry import MetricsRegistry
from ewdml_tpu_torch.parallel.policy import (AsyncCohortPolicy, CohortPolicy,
                                             PipelinedCohortPolicy)

logger = logging.getLogger("ewdml_tpu_torch.federated")


class FederatedCoordinator:
    """Round lifecycle: register -> begin (sample) -> [dropout/resample]
    -> apply commit (the policy's hook) -> done (barrier released)."""

    def __init__(self, cfg, ledger_path: Optional[str] = None,
                 resume: bool = False,
                 registry: Optional[MetricsRegistry] = None):
        validate_federated(cfg)
        validate_round_pipeline(cfg)
        if not cfg.federated:
            raise ValueError("FederatedCoordinator needs cfg.federated=True")
        self.cfg = cfg
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.pool_size = cfg.pool_size
        self.cohort_size = cfg.cohort
        # 0 accepts the whole cohort (the --num-aggregate 0 convention).
        self.accept = cfg.num_aggregate or cfg.cohort
        self.max_cohort = federated_max_cohort(cfg)
        self.mode = cfg.round_pipeline
        self.sampler = CohortSampler(cfg.pool_size, cfg.cohort, cfg.seed)
        # Under ``resume`` (a recovered server) the journal is read back
        # before the ledger reopens in append mode: it is the record that
        # registrations, dropouts and completed rounds replay from.
        prior: list = []
        if ledger_path and resume and os.path.exists(ledger_path):
            prior = read_ledger(ledger_path)
        self.ledger = (RoundLedger(ledger_path, resume=resume)
                       if ledger_path else None)
        # The policy follows the mode; all three fire the same
        # apply-commit callback, and only the journal's event name differs.
        if self.mode == "overlap":
            self.policy = PipelinedCohortPolicy(
                num_aggregate=self.accept,
                on_round=self._on_round_applied)
        elif self.mode == "async":
            self.policy = AsyncCohortPolicy(
                self.accept, decay=cfg.fed_staleness_decay,
                bound=cfg.fed_staleness_bound,
                on_commit=self._on_round_applied)
        else:
            self.policy = CohortPolicy(num_aggregate=self.accept,
                                       on_round=self._on_round_applied)
        # One condition guards the round state; the policy's lock is never
        # held while it is taken (note_applied calls back outside it).
        self._cond = threading.Condition()
        self._registered: set = set()   # ewdml: guarded-by[_cond]
        self._dropped: dict = {}        # ewdml: guarded-by[_cond]
        # client -> its recorded replacement: a retried report_drop
        # replays it instead of counting the dropout twice.
        self._drop_replacement: dict = {}  # ewdml: guarded-by[_cond]
        self._round = -1                # ewdml: guarded-by[_cond]
        self._cohort: list = []         # ewdml: guarded-by[_cond]
        self._resamples = 0             # ewdml: guarded-by[_cond]
        self._done: dict = {}           # round -> its round_done record
        # The pipelined modes' round state (empty under 'off'): every begun
        # round's final cohort (a retried begin replays it, a drop's
        # replacement extends it), the overlap window's open rounds (gated
        # before sampling, so a too-deep begin changes nothing) and the
        # per-round resample attempt counters.
        self._begun: dict = {}          # ewdml: guarded-by[_cond]
        self._open_rounds: set = set()  # ewdml: guarded-by[_cond]
        self._rp_attempts: dict = {}    # ewdml: guarded-by[_cond]
        self.dropouts = 0
        self.resampled = 0
        if self.max_cohort is not None:
            self.metrics.gauge("federated.max_cohort").set(self.max_cohort)
        self.metrics.gauge("federated.cohort").set(self.cohort_size)
        if prior:
            self._restore_from_records(prior)

    def _restore_from_records(self, records: list) -> None:
        """Rebuild membership and the round position from a journal:
        registrations, dropouts (with their replacements, so a retried
        ``report_drop`` stays idempotent across a restart) and completed
        rounds. The round counter resumes at the last completed round, so
        the driver's next ``begin_round`` (or its retry of the completed
        one, which replays the recorded cohort) passes the sequence
        check."""
        cohorts: dict[int, list] = {}
        with self._cond:
            for rec in records:
                ev = rec.get("event")
                if ev == "register":
                    self._registered.add(int(rec["client"]))
                elif ev == "dropout":
                    c = int(rec["client"])
                    self._dropped[c] = (
                        f"dropout at round {rec.get('round', -1)}")
                    self._drop_replacement[c] = int(
                        rec.get("replacement", -1))
                    if rec.get("replacement", -1) >= 0:
                        cohorts.setdefault(int(rec.get("round", -1)),
                                           []).append(int(rec["replacement"]))
                        self.resampled += 1
                    self.dropouts += 1
                elif ev == "round_begin":
                    cohorts[int(rec["round"])] = list(rec["cohort"])
                elif ev == "round_done":
                    r = int(rec["round"])
                    self._done[r] = {"event": "round_done", "round": r,
                                     "accepted": list(rec["accepted"]),
                                     "version": int(rec["version"])}
            self._round = max(self._done) if self._done else -1
            self._cohort = list(cohorts.get(self._round, []))
            rnd = self._round
            pool = len(self._registered) - len(self._dropped)
            dropped = dict(self._dropped)
            rounds = len(self._done)
        # A recovered dropout that contacts the server again is still
        # refused.
        for client, reason in dropped.items():
            self.policy.exclude(client, f"federated {reason} (recovered)")
        self.metrics.gauge("federated.pool").set(pool)
        self.metrics.gauge("federated.round").set(rnd)
        logger.info(
            "federated: recovered %d completed rounds, %d registered, "
            "%d dropped from the round ledger", rounds, pool + len(dropped),
            len(dropped))

    def state(self) -> dict:
        """The round state for a server snapshot's metadata (the ledger
        stays the authority a recovery reads)."""
        with self._cond:
            return {"registered": sorted(self._registered),
                    "dropped": {str(k): v for k, v in self._dropped.items()},
                    "round": self._round,
                    "rounds_done": len(self._done)}

    # -- pool membership --------------------------------------------------
    def register(self, client: int) -> dict:
        """Idempotent registration of a client id in ``[0, pool_size)``;
        open mid-run. A first registration is journaled."""
        client = int(client)
        if not 0 <= client < self.pool_size:
            raise ValueError(
                f"client {client} outside the registered pool "
                f"[0, {self.pool_size})")
        with self._cond:
            first = client not in self._registered
            self._registered.add(client)
            pool = len(self._registered) - len(self._dropped)
            rnd = self._round
        if first and self.ledger is not None:
            self.ledger.append(event="register", client=client)
        self.metrics.gauge("federated.pool").set(pool)
        return {"pool": pool, "round": rnd}

    # ewdml: requires[_cond] -- membership reads must pair with the round
    # state they gate; guarded-by-flow verifies every caller holds it.
    def _eligible(self) -> set:
        """Registered and not dropped."""
        return self._registered - set(self._dropped)

    # -- round lifecycle --------------------------------------------------
    def begin_round(self, round_idx: int, version: int = -1) -> list[int]:
        """Sample and journal round ``round_idx``'s cohort. Rounds are
        strictly sequential; a repeated begin of the current round (a wire
        retry) returns its cohort again, without a second journal record
        or a second install in the policy."""
        round_idx = int(round_idx)
        if self.mode != "off":
            return self._begin_round_pipelined(round_idx, version)
        with self._cond:
            if round_idx == self._round:
                return list(self._cohort)  # wire-retry replay
            if round_idx != self._round + 1:
                raise RuntimeError(
                    f"fed_begin out of order: expected round "
                    f"{self._round + 1}, got {round_idx}")
            cohort = self.sampler.sample(round_idx, self._eligible())
            self._round = round_idx
            self._cohort = list(cohort)
            self._resamples = 0
        # The policy holds the cohort before any member can push.
        self.policy.begin_round(round_idx, cohort)
        if self.ledger is not None:
            self.ledger.append(event="round_begin", round=round_idx,
                               cohort=cohort, version=int(version))
        self.metrics.gauge("federated.round").set(round_idx)
        return cohort

    def _begin_round_pipelined(self, round_idx: int,
                               version: int = -1) -> list[int]:
        """The pipelined begin (``overlap``, ``async``): sampling stays
        strictly sequential, but round R need not have committed before
        R+1 begins. Overlap's depth-2 window is checked before any state
        changes. Journals ``round_pipeline_begin`` (the fields of
        ``round_begin``)."""
        with self._cond:
            if round_idx in self._begun:
                return list(self._begun[round_idx])  # wire-retry replay
            if round_idx != self._round + 1:
                raise RuntimeError(
                    f"fed_begin out of order: expected round "
                    f"{self._round + 1}, got {round_idx}")
            if self.mode == "overlap" and len(self._open_rounds) >= 2:
                raise RuntimeError(
                    f"pipeline depth 2 exceeded: rounds "
                    f"{sorted(self._open_rounds)} still open at "
                    f"fed_begin({round_idx})")
            cohort = self.sampler.sample(round_idx, self._eligible())
            self._round = round_idx
            self._cohort = list(cohort)
            self._begun[round_idx] = list(cohort)
            self._open_rounds.add(round_idx)
            self._rp_attempts[round_idx] = 0
        self.policy.begin_round(round_idx, cohort)
        if self.ledger is not None:
            self.ledger.append(event="round_pipeline_begin",
                               round=round_idx, cohort=cohort,
                               version=int(version))
        self.metrics.gauge("federated.round").set(round_idx)
        return cohort

    def report_drop(self, client: int, round_idx: int) -> int:
        """A client's dropout: exclude it from all later draws, resample
        one replacement into the current cohort (so the accept quota stays
        reachable) and journal both. Returns the replacement, -1 when the
        pool is exhausted. Idempotent per client: a retried report returns
        the recorded replacement and changes nothing."""
        client, round_idx = int(client), int(round_idx)
        with self._cond:
            if client in self._drop_replacement:
                return self._drop_replacement[client]  # wire-retry replay
            self._dropped[client] = f"dropout at round {round_idx}"
            if self.mode != "off":
                # Pipelined: the resample extends the drop's own round
                # (its quota is the one that became unreachable), with a
                # per-round attempt counter, so the draw is a function of
                # (round, attempt, eligible) whatever the interleaving.
                cohort_r = self._begun.get(round_idx)
                replacement = -1
                if cohort_r is not None:
                    self._rp_attempts[round_idx] = (
                        self._rp_attempts.get(round_idx, 0) + 1)
                    replacement = self.sampler.resample_one(
                        round_idx, self._rp_attempts[round_idx],
                        self._eligible() - set(cohort_r))
                if replacement >= 0:
                    cohort_r.append(replacement)
                    if round_idx == self._round:
                        self._cohort.append(replacement)
            else:
                self._resamples += 1
                eligible = self._eligible() - set(self._cohort)
                replacement = (self.sampler.resample_one(round_idx,
                                                         self._resamples,
                                                         eligible)
                               if round_idx == self._round else -1)
                if replacement >= 0:
                    self._cohort.append(replacement)
            self._drop_replacement[client] = replacement
            pool = len(self._registered) - len(self._dropped)
        # A dropped client that contacts the server again is refused.
        self.policy.exclude(client, f"federated dropout (round {round_idx})")
        if replacement >= 0:
            self.policy.extend_cohort(replacement, round_idx=round_idx)
            self.resampled += 1
            self.metrics.counter("federated.resampled").inc()
        self.dropouts += 1
        self.metrics.counter("federated.dropouts").inc()
        self.metrics.gauge("federated.pool").set(pool)
        if self.ledger is not None:
            self.ledger.append(event="dropout", round=round_idx,
                               client=client, replacement=replacement)
        logger.warning("federated: client %d dropped in round %d "
                       "(replacement %d)", client, round_idx, replacement)
        return replacement

    def _on_round_applied(self, round_idx: int, accepted: list,
                          version: int) -> None:
        """The policy's apply-commit callback: journal the round, record
        it and release the barrier. The pipelined modes journal
        ``round_commit`` (the same fields), so a replay sees the commit
        order apart from the begin order; under ``async`` ``round_idx`` is
        the commit index, since one commit can mix several rounds."""
        event = "round_done" if self.mode == "off" else "round_commit"
        record = {"event": event, "round": round_idx,
                  "accepted": accepted, "version": version}
        if self.ledger is not None:
            self.ledger.append(**record)
        with self._cond:
            self._done[round_idx] = record
            self._open_rounds.discard(round_idx)
            self._cond.notify_all()

    def wait_round(self, round_idx: int, timeout: float) -> Optional[dict]:
        """The round barrier: ``round_idx``'s ``round_done`` record once its
        apply committed, or None on timeout."""
        round_idx = int(round_idx)
        with self._cond:
            self._cond.wait_for(lambda: round_idx in self._done,
                                timeout=timeout)
            return self._done.get(round_idx)

    def rounds_done(self) -> int:
        with self._cond:
            return len(self._done)

    def close(self) -> None:
        if self.ledger is not None:
            self.ledger.close()

    def snapshot(self) -> dict:
        """JSON-able view (``MetricsRegistry.absorb_federated``)."""
        with self._cond:
            return {
                "pool": len(self._registered) - len(self._dropped),
                "registered": len(self._registered),
                "round": self._round,
                "rounds_done": len(self._done),
                "cohort": self.cohort_size,
                "accept": self.accept,
                "max_cohort": self.max_cohort,
                "dropouts": self.dropouts,
                "resampled": self.resampled,
                "quota_dropped": self.policy.quota_dropped,
                "round_pipeline": self.mode,
            }
