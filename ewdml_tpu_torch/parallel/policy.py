"""The straggler/staleness policy of the parameter server
(``ewdml_tpu/parallel/policy.py:1-284``, the part the in-process server
uses, copied: the port imports nothing of the JAX package).

:class:`StragglerPolicy` keeps per-worker last-contact timestamps and makes
the three decisions of the reference's section 5.3: *exclude* (a contact
gap above ``kill_threshold`` seconds; the excluded worker gets
:class:`StragglerKilled` on its next pull or push), *drop-stale* (a push
more than ``max_staleness`` versions behind) and *K-of-N accept* (apply
once ``num_aggregate`` pushes pend). The first ``grace_steps`` gaps per
worker are not judged: they hold one-time costs such as the first batch.
The cohort policies of the federated path are a later slice.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

from ewdml_tpu_torch.obs import clock as _clock

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
    def observe(self, worker) -> Optional[str]:
        """Record a contact from ``worker``.

        Returns ``None`` for a healthy worker, or the exclusion reason when
        the worker is (or just became) a straggler — every non-None return
        corresponds to one kill signal the caller must deliver. (The JAX
        policy's ``retried`` flag belongs to the wire retry path of
        ``ps_net``, a later slice.)
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
            if prev is None or self.kill_threshold is None:
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

    def excluded(self) -> dict:
        with self._lock:
            return dict(self._excluded)

    # -- staleness + K-of-N ----------------------------------------------
    def stale(self, staleness: int) -> bool:
        """Drop decision for a push ``staleness`` versions behind the server."""
        return (self.max_staleness is not None
                and staleness > self.max_staleness)

    def ready_to_apply(self, n_pending: int) -> bool:
        """K-of-N acceptance: apply once ``num_aggregate`` pushes pend."""
        return n_pending >= self.num_aggregate

    def snapshot(self) -> PolicySnapshot:
        with self._lock:
            return PolicySnapshot(excluded=dict(self._excluded),
                                  kills_sent=self.kills_sent,
                                  contacts=self.contacts,
                                  members=sorted(self._last_seen))
