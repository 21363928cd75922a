"""Deterministic fault injection for the parameter server
(``ewdml_tpu/parallel/faults.py``, copied: the port imports nothing of the
JAX package).

The faults are config (``--fault-spec``), parsed once and applied
deterministically per (worker, step). The in-process thread PS
(``parallel/ps.py``) consumes the ``delay``, ``crash`` and ``nan`` clauses;
the TCP tier (``parallel/ps_net.py``) also the wire clauses: ``reset``,
``drop`` and ``partition`` at a worker's step, ``join`` (a late joiner's
wait in seconds) and ``serverkill`` (SIGKILL the server after apply N).
The aggregation tree's aggregators (``parallel/aggtree.py``) read
``aggkill@A=N``: aggregator A SIGKILLs itself after its Nth forward.

Spec grammar: comma-separated clauses, ``kind@worker=value`` (``delay``
seconds, or a step for the others), ``serverkill@N`` (an apply count) or
``aggkill@A=N`` (an aggregator index). Example:
``--fault-spec "delay@2=6,crash@1=5"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

#: Exit status of a process that executed a ``crash`` clause (a sweep's
#: cell child, ``experiments/runner.py``), distinct from the straggler kill
#: (77) and the health abort (76).
CRASH_EXIT_CODE = 13

_KINDS = ("delay", "crash", "reset", "drop", "nan", "partition", "join")

#: Aggregator-side clause kinds — ``kind@agg=value`` grammar where the
#: "worker" part names an ``--agg-tree`` index, so these clauses never
#: merge into a worker's :class:`WorkerFaults`.
_AGG_KINDS = ("aggkill",)

#: The server-side clause kinds — ``kind@value`` grammar (no worker part;
#: the value names an apply count).
_SERVER_KINDS = ("serverkill",)


class FaultCrash(RuntimeError):
    """An injected crash-at-step fired (fault harness, not a real bug)."""

    def __init__(self, worker: int, step: int):
        super().__init__(f"injected crash: worker {worker} at step {step}")
        self.worker = int(worker)
        self.step = int(step)


@dataclasses.dataclass
class WorkerFaults:
    """The faults one worker executes, resolved from a :class:`FaultSpec`."""

    worker: int = 0
    delay_s: float = 0.0
    crash_at: Optional[int] = None
    reset_at: frozenset = frozenset()
    drop_at: frozenset = frozenset()
    nan_at: frozenset = frozenset()
    # step -> black-holed attempts at that step (``partition`` clauses;
    # a repeated clause widens the window by one attempt).
    partition_at: dict = dataclasses.field(default_factory=dict)
    join_after: Optional[float] = None  # ``join`` clause: seconds to wait
                                        # before late admission

    def sleep_if_due(self) -> float:
        """Apply the delay clause; returns the seconds slept."""
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        return self.delay_s

    def crash_due(self, step: int) -> None:
        """Raise :class:`FaultCrash` when the crash clause fires at ``step``."""
        if self.crash_at is not None and step == self.crash_at:
            raise FaultCrash(self.worker, step)

    def reset_due(self, step: int) -> bool:
        return step in self.reset_at

    def drop_due(self, step: int) -> bool:
        return step in self.drop_at

    def nan_due(self, step: int) -> bool:
        """Whether a ``nan`` clause poisons the loss observed at ``step``."""
        return step in self.nan_at

    def partition_due(self, step: int) -> int:
        """Attempts to black-hole at ``step`` (0 = no partition clause)."""
        return self.partition_at.get(step, 0)


class FaultSpec:
    """Parsed ``--fault-spec``: per-worker deterministic fault schedules."""

    def __init__(self, by_worker: Optional[dict] = None,
                 server_kill_at: Optional[int] = None,
                 agg_kills: Optional[dict] = None):
        self._by_worker: dict[int, WorkerFaults] = dict(by_worker or {})
        #: ``serverkill@N``: SIGKILL the server right after apply N commits
        #: (None = no server-kill clause).
        self.server_kill_at = server_kill_at
        #: ``aggkill@A=N``: aggregator index -> SIGKILL after its Nth
        #: upstream forward (empty = no aggregator-kill clauses).
        self._agg_kills: dict[int, int] = dict(agg_kills or {})

    @classmethod
    def parse(cls, spec: Optional[str]) -> "FaultSpec":
        """Parse the clause grammar; raises ``ValueError`` with the offending
        clause on malformed input (config errors must fail loudly at startup,
        not as a silently-absent fault mid-run)."""
        out: dict[int, WorkerFaults] = {}
        server_kill_at: Optional[int] = None
        agg_kills: dict[int, int] = {}
        for clause in (spec or "").split(","):
            clause = clause.strip()
            if not clause:
                continue
            try:
                if "=" not in clause:
                    # Server-side grammar: ``kind@value`` (no worker — the
                    # value names an apply count, not a worker id).
                    kind, value = clause.split("@", 1)
                    kind = kind.strip().lower()
                    if kind not in _SERVER_KINDS:
                        raise ValueError(f"unknown fault kind {kind!r}")
                    val = int(value)
                    if val < 0:
                        raise ValueError("fault values must be >= 0")
                    server_kill_at = val
                    continue
                kind_worker, value = clause.split("=", 1)
                kind, worker_s = kind_worker.split("@", 1)
                kind = kind.strip().lower()
                worker = int(worker_s)
                if kind not in _KINDS and kind not in _AGG_KINDS:
                    raise ValueError(f"unknown fault kind {kind!r}")
                val = float(value) if kind in ("delay", "join") else int(value)
                if val < 0:
                    raise ValueError("fault values must be >= 0")
            except ValueError as e:
                raise ValueError(
                    f"bad --fault-spec clause {clause!r} "
                    f"(want kind@worker=value, kind in {_KINDS}, "
                    f"kind@agg=value, kind in {_AGG_KINDS}, or "
                    f"kind@value, kind in {_SERVER_KINDS}): {e}"
                ) from None
            if kind == "aggkill":
                # Aggregator clause: the @-part is an --agg-tree index,
                # never merged into a worker's fault schedule.
                agg_kills[worker] = val
                continue
            wf = out.setdefault(worker, WorkerFaults(worker=worker))
            if kind == "delay":
                wf.delay_s = val
            elif kind == "crash":
                wf.crash_at = val
            elif kind == "reset":
                wf.reset_at = wf.reset_at | {val}
            elif kind == "drop":
                wf.drop_at = wf.drop_at | {val}
            elif kind == "partition":
                wf.partition_at[val] = wf.partition_at.get(val, 0) + 1
            elif kind == "join":
                wf.join_after = val
            else:
                wf.nan_at = wf.nan_at | {val}
        return cls(out, server_kill_at=server_kill_at, agg_kills=agg_kills)

    def for_worker(self, worker: int) -> WorkerFaults:
        return self._by_worker.get(int(worker), WorkerFaults(worker=worker))

    def agg_kill_after(self, agg_index: int) -> Optional[int]:
        """The ``aggkill`` clause of aggregator ``agg_index``: the forward
        after which it SIGKILLs itself (None: no clause)."""
        return self._agg_kills.get(int(agg_index))

    def delays(self) -> dict:
        """``worker -> delay_s`` map (feeds ``run_async_ps``'s
        ``straggler_delays`` — the in-process PS's existing injection knob)."""
        return {w: f.delay_s for w, f in self._by_worker.items()
                if f.delay_s > 0}

    def crashes(self) -> dict:
        """``worker -> crash_at`` map for the in-process path."""
        return {w: f.crash_at for w, f in self._by_worker.items()
                if f.crash_at is not None}
