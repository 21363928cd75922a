"""The straggler/staleness policy of the parameter server
(``ewdml_tpu/parallel/policy.py:1-284``, ``StragglerPolicy`` copied: the
port imports nothing of the JAX package).

:class:`StragglerPolicy` keeps per-worker last-contact timestamps and makes
the three decisions of the reference's section 5.3: *exclude* (a contact
gap above ``kill_threshold`` seconds; the excluded worker gets
:class:`StragglerKilled` on its next pull or push), *drop-stale* (a push
more than ``max_staleness`` versions behind) and *K-of-N accept* (apply
once ``num_aggregate`` pushes pend). The first ``grace_steps`` gaps per
worker are not judged: they hold one-time costs such as the first batch.
The TCP server (``parallel/ps_net.py``) adds a retried contact (refreshes
liveness, not judged), elastic membership (``note_join``) and the restore
of a recovered server. The cohort policies of the federated path are a
later slice; their hooks are no-ops here.
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
        """Pre-acceptance gate: None admits (every worker, here)."""
        return None

    def note_applied(self, version: int, workers: list,
                     round_id: Optional[int] = None) -> None:
        """Apply-commit hook (a no-op here)."""

    def retract_push(self, worker, round_id: int = -1) -> None:
        """Undo an :meth:`admit_push` whose push was dropped (a no-op
        here: admission is unlimited)."""

    def snapshot(self) -> PolicySnapshot:
        with self._lock:
            return PolicySnapshot(excluded=dict(self._excluded),
                                  kills_sent=self.kills_sent,
                                  contacts=self.contacts,
                                  members=sorted(self._last_seen))
