"""The straggler/staleness policy of the parameter server
(``ewdml_tpu/parallel/policy.py:1-434``, ``StragglerPolicy`` and
``CohortPolicy`` copied: the port imports nothing of the JAX package).

:class:`StragglerPolicy` keeps per-worker last-contact timestamps and makes
the three decisions of the reference's section 5.3: *exclude* (a contact
gap above ``kill_threshold`` seconds; the excluded worker gets
:class:`StragglerKilled` on its next pull or push), *drop-stale* (a push
more than ``max_staleness`` versions behind) and *K-of-N accept* (apply
once ``num_aggregate`` pushes pend). The first ``grace_steps`` gaps per
worker are not judged: they hold one-time costs such as the first batch.
The TCP server (``parallel/ps_net.py``) adds a retried contact (refreshes
liveness, not judged), elastic membership (``note_join``) and the restore
of a recovered server. The base policy's cohort hooks are no-ops;
:class:`CohortPolicy` implements them for the federated rounds,
:class:`PipelinedCohortPolicy` and :class:`AsyncCohortPolicy` (``:436-659``)
for ``--round-pipeline overlap`` and ``async``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

from ewdml_tpu_torch.obs import clock as _clock

#: Exit status of a kill-signalled TCP worker: the reference's MPI kill tag.
KILL_EXIT_CODE = 77


class StragglerKilled(RuntimeError):
    """The kill signal: this worker has been excluded by the server.

    In-process it propagates up the worker thread; over TCP it is serialized
    as a ``{"op": "kill"}`` reply frame and re-raised worker-side.
    """

    def __init__(self, worker: int, reason: str):
        super().__init__(f"worker {worker} killed: {reason}")
        self.worker = int(worker)
        self.reason = reason


@dataclasses.dataclass
class PolicySnapshot:
    """Stats-op view of the policy (JSON-able)."""

    excluded: dict            # worker -> reason
    kills_sent: int           # kill signals delivered (>= len(excluded))
    contacts: int             # total observed worker contacts
    members: list             # workers ever seen (contact or join), sorted


class StragglerPolicy:
    """Per-worker liveness bookkeeping + the §5.3 decisions, thread-safe.

    ``clock`` is injectable (tests drive a fake monotonic clock so the
    decision matrix is deterministic); production uses the shared monotonic
    source (``ewdml_tpu_torch.obs.clock``), so contact gaps land on the same
    timebase as every trace span and timer fence.
    """

    def __init__(self, kill_threshold: Optional[float] = None,
                 max_staleness: Optional[int] = None,
                 num_aggregate: int = 1, grace_steps: int = 1,
                 clock: Callable[[], float] = _clock.monotonic):
        # kill_threshold: 0 and negative mean "disabled" (the config default
        # is 0.0, the reference's inert flag value) — a 0-second step budget
        # is nonsensical, so it is safe to fold into "off".
        # max_staleness is NOT normalized the same way: 0 is a MEANINGFUL
        # strict bound ("accept only pushes at the current version");
        # "unbounded" is spelled None here, and config-level users translate
        # their 0-means-unbounded flag before constructing the policy
        # (ps_net.PSNetServer / cli._main_async do).
        self.kill_threshold = (float(kill_threshold)
                               if kill_threshold and kill_threshold > 0
                               else None)
        self.max_staleness = max_staleness
        self.num_aggregate = max(1, int(num_aggregate))
        self.grace_steps = max(0, int(grace_steps))
        self._clock = clock
        self._lock = threading.Lock()
        self._last_seen: dict[int, float] = {}
        self._gaps_seen: dict[int, int] = {}
        self._excluded: dict[int, str] = {}
        self.kills_sent = 0
        self.contacts = 0

    # -- exclusion (the kill protocol) -----------------------------------
    def observe(self, worker, retried: bool = False) -> Optional[str]:
        """Record a contact from ``worker``.

        Returns ``None`` for a healthy worker, or the exclusion reason when
        the worker is (or just became) a straggler — every non-None return
        corresponds to one kill signal the caller must deliver.

        ``retried=True`` marks a contact the wire layer re-sent after a
        fault: it refreshes liveness and still kills an excluded worker,
        but its gap (the client's timeout and backoff) is not judged.
        """
        if worker is None:
            return None
        worker = int(worker)
        now = self._clock()
        with self._lock:
            self.contacts += 1
            if worker in self._excluded:
                self.kills_sent += 1
                return self._excluded[worker]
            prev = self._last_seen.get(worker)
            self._last_seen[worker] = now
            if prev is None or self.kill_threshold is None or retried:
                return None
            n = self._gaps_seen.get(worker, 0)
            self._gaps_seen[worker] = n + 1
            if n < self.grace_steps:
                return None  # warmup gap (first batch load / cold jit)
            gap = now - prev
            if gap <= self.kill_threshold:
                return None
            reason = (f"straggler: {gap:.2f}s since last contact exceeds "
                      f"kill threshold {self.kill_threshold:.2f}s")
            self._excluded[worker] = reason
            self.kills_sent += 1
            return reason

    def exclude(self, worker, reason: str) -> None:
        """Exclude a worker by hand (operator or tooling path)."""
        with self._lock:
            self._excluded[int(worker)] = reason

    def is_excluded(self, worker) -> bool:
        with self._lock:
            return int(worker) in self._excluded

    def excluded(self) -> dict:
        with self._lock:
            return dict(self._excluded)

    # -- elastic membership and recovery ----------------------------------
    def note_join(self, worker) -> None:
        """Seed liveness for a worker admitted mid-run (the ``join`` op);
        its first real gap still gets the warm-up grace."""
        now = self._clock()
        with self._lock:
            self._last_seen.setdefault(int(worker), now)

    def live_workers(self) -> int:
        """K-of-N's N, observed: workers ever seen (contact or join) less
        the excluded."""
        with self._lock:
            return len([w for w in self._last_seen
                        if w not in self._excluded])

    def is_member(self, worker) -> bool:
        """Whether ``worker`` has ever been seen (contact or join)."""
        with self._lock:
            return int(worker) in self._last_seen

    def restore(self, excluded: dict, kills_sent: int = 0,
                contacts: int = 0, members=()) -> None:
        """Re-install a :class:`PolicySnapshot`'s durable half after a
        server restart: exclusions and counters survive; members are
        re-stamped now (the dead process's clock means nothing here), so a
        restored member's first gap gets the grace of a join."""
        now = self._clock()
        with self._lock:
            for worker, reason in (excluded or {}).items():
                self._excluded[int(worker)] = str(reason)
            self.kills_sent = max(self.kills_sent, int(kills_sent))
            self.contacts = max(self.contacts, int(contacts))
            for worker in members or ():
                self._last_seen.setdefault(int(worker), now)

    # -- staleness + K-of-N ----------------------------------------------
    def stale(self, staleness: int) -> bool:
        """Drop decision for a push ``staleness`` versions behind the server."""
        return (self.max_staleness is not None
                and staleness > self.max_staleness)

    def ready_to_apply(self, n_pending: int) -> bool:
        """K-of-N acceptance: apply once ``num_aggregate`` pushes pend."""
        return n_pending >= self.num_aggregate

    # -- cohort hooks (no-ops on the base policy) ------------------------
    def admit_push(self, worker, round_id: int = -1) -> Optional[str]:
        """Pre-acceptance gate: None admits (every worker, here).
        ``round_id`` is the round the push was stamped with (-1 unstamped;
        only the pipelined policies route by it)."""
        return None

    def round_stale(self, round_id: int) -> bool:
        """Whether a push stamped ``round_id`` targets a round that has
        already committed or left the staleness window, judged before any
        decode work. Always False here (no round routing)."""
        return False

    def push_weight(self, round_id: int) -> int:
        """Integer tick weight of a push stamped ``round_id`` on the
        homomorphic grid: 1 here; :class:`AsyncCohortPolicy` down-weights
        by staleness."""
        return 1

    def note_applied(self, version: int, workers: list,
                     round_id: Optional[int] = None) -> None:
        """Apply-commit hook (a no-op here)."""

    def retract_push(self, worker, round_id: int = -1) -> None:
        """Undo an :meth:`admit_push` whose push was dropped (a no-op
        here: admission is unlimited)."""

    def admit_subtree(self, members) -> tuple:
        """Member-granularity admission of an aggregation tree's
        pseudo-push: ``(reason, dup_members)``, where a reason rejects the
        whole pseudo-push and ``dup_members`` names the members the round
        already holds. The base policy admits every subtree ``(None, ())``
        and so never reports a duplicate member."""
        return None, ()

    def retract_subtree(self, members) -> None:
        """Undo an :meth:`admit_subtree` whose pseudo-push was dropped (a
        no-op here)."""

    def snapshot(self) -> PolicySnapshot:
        with self._lock:
            return PolicySnapshot(excluded=dict(self._excluded),
                                  kills_sent=self.kills_sent,
                                  contacts=self.contacts,
                                  members=sorted(self._last_seen))


class CohortPolicy(StragglerPolicy):
    """The K-of-N accept over sampled cohorts (federated rounds,
    ``ewdml_tpu_torch/federated``).

    Each round the coordinator installs a sampled cohort
    (:meth:`begin_round`), and :meth:`admit_push` admits a push only while
    its round is open, from a cohort member that has not contributed yet,
    and while the accept quota (``num_aggregate``, K of the cohort) is not
    filled. A push past the quota is a dropped straggler: counted in
    ``quota_dropped``, refused, never applied, so the server's pending
    batch only ever holds the current round's K payloads.

    The contact-gap timer is disarmed (``kill_threshold=None``): a pool
    client is contacted only when sampled, so its gaps measure sampling
    luck, not step time. Straggler handling is the quota plus the
    driver-reported dropout (``FederatedCoordinator.report_drop`` ->
    :meth:`exclude`).
    """

    def __init__(self, num_aggregate: int, max_staleness: Optional[int] = 0,
                 on_round=None, clock: Callable[[], float] = _clock.monotonic):
        # Strict staleness by default: a round's pushes are all computed at
        # the round's pull version; an older one is a previous round's
        # straggler.
        super().__init__(kill_threshold=None, max_staleness=max_staleness,
                         num_aggregate=num_aggregate, clock=clock)
        self._round = -1          # ewdml: guarded-by[_lock]
        self._round_open = False  # ewdml: guarded-by[_lock]
        self._cohort: set = set()       # ewdml: guarded-by[_lock]
        self._contributed: set = set()  # ewdml: guarded-by[_lock]
        self.quota_dropped = 0    # pushes refused past the accept quota
        self._on_round = on_round  # (round, accepted workers, version)

    def begin_round(self, round_idx: int, cohort) -> None:
        with self._lock:
            if self._round_open:
                raise RuntimeError(
                    f"round {self._round} still open (begin_round "
                    f"({round_idx}) before its apply committed)")
            self._round = int(round_idx)
            self._round_open = True
            self._cohort = {int(c) for c in cohort}
            self._contributed = set()

    def extend_cohort(self, client: int,
                      round_idx: Optional[int] = None) -> None:
        """Admit a mid-round replacement (a dropout's resample) to the open
        cohort; ``round_idx`` is unused while one round is open at a
        time."""
        with self._lock:
            self._cohort.add(int(client))

    def admit_push(self, worker, round_id: int = -1) -> Optional[str]:
        worker = int(worker)
        with self._lock:
            if not self._round_open:
                if (worker in self._cohort
                        and worker not in self._contributed):
                    # A cohort member arriving after its round's apply
                    # committed: the sequential spelling of the quota drop.
                    self.quota_dropped += 1
                    return (f"round {self._round} complete: straggler "
                            f"dropped past the accept quota")
                return (f"no active federated round (round {self._round} "
                        f"complete)")
            if worker not in self._cohort:
                return (f"client {worker} not in round {self._round}'s "
                        f"sampled cohort")
            if worker in self._contributed:
                return (f"duplicate push from client {worker} in round "
                        f"{self._round}")
            if len(self._contributed) >= self.num_aggregate:
                self.quota_dropped += 1
                return (f"round {self._round} accept quota "
                        f"{self.num_aggregate} filled (straggler dropped)")
            self._contributed.add(worker)
            return None

    def retract_push(self, worker, round_id: int = -1) -> None:
        with self._lock:
            if self._round_open:
                self._contributed.discard(int(worker))

    def admit_subtree(self, members) -> tuple:
        members = [int(m) for m in members]
        with self._lock:
            dups = tuple(m for m in members if m in self._contributed)
            fresh = [m for m in members if m not in self._contributed]
            if not self._round_open:
                # Round already applied: an already-contributed member is
                # an idempotent replay (named in dups); a fresh one is the
                # quota-drop verdict.
                if fresh:
                    self.quota_dropped += len(fresh)
                return (f"round {self._round} complete: {len(fresh)} "
                        f"subtree member(s) past the accept quota"
                        if fresh else
                        f"round {self._round} complete: subtree replay",
                        dups)
            outsiders = [m for m in fresh if m not in self._cohort]
            if outsiders:
                return (f"client(s) {outsiders} not in round "
                        f"{self._round}'s sampled cohort", dups)
            if dups:
                # A partial sum holding an already-counted contribution
                # cannot be applied; the aggregator subtracts the named
                # members and re-forwards.
                return (f"{len(dups)} subtree member(s) already "
                        f"contributed to round {self._round}", dups)
            if (len(self._contributed) + len(fresh)
                    > self.num_aggregate):
                self.quota_dropped += len(fresh)
                return (f"round {self._round} accept quota "
                        f"{self.num_aggregate} cannot hold {len(fresh)} "
                        f"more subtree member(s) (stragglers dropped)",
                        dups)
            self._contributed.update(fresh)
            return None, ()

    def retract_subtree(self, members) -> None:
        with self._lock:
            if self._round_open:
                for m in members:
                    self._contributed.discard(int(m))

    def note_applied(self, version: int, workers: list,
                     round_id: Optional[int] = None) -> None:
        with self._lock:
            if not self._round_open:
                return
            self._round_open = False
            round_idx = self._round
            cb = self._on_round
        # Outside the policy lock: the callback journals (fsync) and wakes
        # the round barrier.
        if cb is not None:
            cb(round_idx, sorted(int(w) for w in workers), int(version))


class PipelinedCohortPolicy(CohortPolicy):
    """``--round-pipeline overlap``: up to ``depth`` rounds open at once,
    each with its own (cohort, contributed) scope; pushes are routed by
    their stamped round id.

    The coordinator begins round R+1 while round R's stragglers drain, so
    a push is judged against its own round's cohort and quota. A push for
    a round that has committed is round-stale (:meth:`round_stale`, judged
    by the server before any decode); its client recovers by pulling.
    ``max_staleness`` is ``depth - 1``.
    """

    def __init__(self, num_aggregate: int, depth: int = 2, on_round=None,
                 clock: Callable[[], float] = _clock.monotonic):
        super().__init__(num_aggregate=num_aggregate,
                         max_staleness=depth - 1, on_round=on_round,
                         clock=clock)
        self.depth = max(2, int(depth))
        # round -> (cohort set, contributed set); at most ``depth`` live.
        self._open: dict[int, tuple] = {}  # ewdml: guarded-by[_lock]
        self._committed: set = set()       # ewdml: guarded-by[_lock]

    def begin_round(self, round_idx: int, cohort) -> None:
        round_idx = int(round_idx)
        with self._lock:
            if round_idx in self._open or round_idx in self._committed:
                return  # wire-retry replay: the round is installed
            if len(self._open) >= self.depth:
                raise RuntimeError(
                    f"pipeline depth {self.depth} exceeded: rounds "
                    f"{sorted(self._open)} still open at "
                    f"begin_round({round_idx})")
            self._open[round_idx] = ({int(c) for c in cohort}, set())
            self._round = max(self._round, round_idx)
            self._round_open = True

    def extend_cohort(self, client: int,
                      round_idx: Optional[int] = None) -> None:
        with self._lock:
            rid = (int(round_idx) if round_idx is not None
                   else (max(self._open) if self._open else -1))
            entry = self._open.get(rid)
            if entry is not None:
                entry[0].add(int(client))

    def admit_push(self, worker, round_id: int = -1) -> Optional[str]:
        worker, rid = int(worker), int(round_id)
        with self._lock:
            entry = self._open.get(rid)
            if entry is None:
                if rid in self._committed:
                    # The post-commit straggler: its round's apply already
                    # fired on another grid.
                    self.quota_dropped += 1
                    return (f"round {rid} committed: straggler dropped "
                            f"past the accept quota")
                return (f"round {rid} is not an open pipelined round "
                        f"(open: {sorted(self._open)})")
            cohort, contributed = entry
            if worker not in cohort:
                return (f"client {worker} not in round {rid}'s sampled "
                        f"cohort")
            if worker in contributed:
                return f"duplicate push from client {worker} in round {rid}"
            if len(contributed) >= self.num_aggregate:
                self.quota_dropped += 1
                return (f"round {rid} accept quota {self.num_aggregate} "
                        f"filled (straggler dropped)")
            contributed.add(worker)
            return None

    def retract_push(self, worker, round_id: int = -1) -> None:
        with self._lock:
            entry = self._open.get(int(round_id))
            if entry is not None:
                entry[1].discard(int(worker))

    def round_stale(self, round_id: int) -> bool:
        with self._lock:
            return int(round_id) in self._committed

    def admit_subtree(self, members) -> tuple:
        # validate_round_pipeline refuses --agg-tree; this is the runtime
        # guard for a deployment built by hand.
        return ("aggtree pseudo-pushes cannot ride a pipelined round "
                "(no round id on the subtree frame)", ())

    def note_applied(self, version: int, workers: list,
                     round_id: Optional[int] = None) -> None:
        with self._lock:
            if round_id is None or int(round_id) not in self._open:
                return
            rid = int(round_id)
            del self._open[rid]
            self._committed.add(rid)
            self._round_open = bool(self._open)
            cb = self._on_round
        if cb is not None:
            cb(rid, sorted(int(w) for w in workers), int(version))


class AsyncCohortPolicy(CohortPolicy):
    """``--round-pipeline async``: FedBuff-style bounded staleness with
    homomorphic down-weighting.

    A cohort member's delta at most ``bound`` rounds behind the newest
    begun round is admitted. A delta ``s`` rounds old weighs
    ``(1 + s) ** -decay``, realized on the int8 grid as integer ticks: a
    fresh delta pends :data:`WEIGHT_SCALE` copies of its buffer, a stale
    one fewer, and the apply divides by the tick total, the weighted mean
    ``sum(w_i * g_i) / sum(w_i)`` in the compressed domain. The commit
    quota is ``accept * WEIGHT_SCALE`` ticks, with no per-round barrier
    and no per-round accept cap: a delta older than ``bound`` rounds is
    round-stale.
    """

    #: Ticks a fresh (staleness-0) delta pends: three down-weight levels
    #: below 1.0 before the floor at 1 tick.
    WEIGHT_SCALE = 4

    def __init__(self, accept: int, decay: float = 0.5, bound: int = 2,
                 on_commit=None,
                 clock: Callable[[], float] = _clock.monotonic):
        super().__init__(num_aggregate=max(1, int(accept))
                         * self.WEIGHT_SCALE,
                         max_staleness=None, on_round=on_commit,
                         clock=clock)
        self.accept = max(1, int(accept))
        self.decay = float(decay)
        self.bound = max(1, int(bound))
        # round -> (cohort set, contributed set); rounds more than
        # ``bound`` behind the newest are evicted.
        self._windows: dict[int, tuple] = {}  # ewdml: guarded-by[_lock]
        self._commits = 0                     # ewdml: guarded-by[_lock]

    @property
    def weight_scale(self) -> int:
        return self.WEIGHT_SCALE

    def begin_round(self, round_idx: int, cohort) -> None:
        round_idx = int(round_idx)
        with self._lock:
            if round_idx in self._windows:
                return  # wire-retry replay
            self._windows[round_idx] = ({int(c) for c in cohort}, set())
            self._round = max(self._round, round_idx)
            self._round_open = True
            for old in [r for r in self._windows
                        if self._round - r > self.bound]:
                del self._windows[old]

    def extend_cohort(self, client: int,
                      round_idx: Optional[int] = None) -> None:
        with self._lock:
            rid = (int(round_idx) if round_idx is not None
                   else (max(self._windows) if self._windows else -1))
            entry = self._windows.get(rid)
            if entry is not None:
                entry[0].add(int(client))

    def push_weight(self, round_id: int) -> int:
        """``(1 + staleness) ** -decay`` on :data:`WEIGHT_SCALE` ticks,
        rounded half to even and floored at 1 (an admitted delta always
        contributes)."""
        with self._lock:
            staleness = max(0, self._round - int(round_id))
        w = self.WEIGHT_SCALE * (1.0 + staleness) ** -self.decay
        return max(1, min(self.WEIGHT_SCALE, round(w)))

    def admit_push(self, worker, round_id: int = -1) -> Optional[str]:
        worker, rid = int(worker), int(round_id)
        with self._lock:
            entry = self._windows.get(rid)
            if entry is None:
                return (f"round {rid} outside the staleness window "
                        f"(bound {self.bound}, newest {self._round})")
            cohort, contributed = entry
            if worker not in cohort:
                return (f"client {worker} not in round {rid}'s sampled "
                        f"cohort")
            if worker in contributed:
                return f"duplicate push from client {worker} in round {rid}"
            # No per-round quota: the commit fires on the tick quota.
            contributed.add(worker)
            return None

    def retract_push(self, worker, round_id: int = -1) -> None:
        with self._lock:
            entry = self._windows.get(int(round_id))
            if entry is not None:
                entry[1].discard(int(worker))

    def round_stale(self, round_id: int) -> bool:
        rid = int(round_id)
        with self._lock:
            return 0 <= rid <= self._round and rid not in self._windows

    def admit_subtree(self, members) -> tuple:
        return ("aggtree pseudo-pushes cannot ride async admission "
                "(no round id on the subtree frame)", ())

    def note_applied(self, version: int, workers: list,
                     round_id: Optional[int] = None) -> None:
        with self._lock:
            commit_idx = self._commits
            self._commits += 1
            cb = self._on_round
        # The commit index, not a round id: an async batch can mix deltas
        # of several rounds, so the ledger records the commit sequence.
        if cb is not None:
            cb(commit_idx, sorted({int(w) for w in workers}), int(version))
