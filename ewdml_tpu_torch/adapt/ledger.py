"""The replayable decision ledger: append-only JSONL keyed by step
(``ewdml_tpu/adapt/ledger.py``, copied; the two packages' ledgers read
in each other).

One file per run surface (trainer, PS server). Line 1 is a meta header;
every later line is one decision event: the full plan, the signals that
produced it, and whether it switched the program. ``--adapt replay``
applies these rows verbatim and never re-derives them. Every append is
flushed and fsync'd, and the reader drops a torn tail.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ewdml_tpu_torch.adapt.plan import Plan


class DecisionLedger:
    """Append-only writer. Opening an existing file appends (a resumed run
    keeps journaling into the same history; replay takes the LAST decision
    per step, so a re-decided step after resume supersedes cleanly)."""

    def __init__(self, path: str, meta: Optional[dict] = None):
        self.path = os.path.abspath(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fresh = not (os.path.isfile(self.path)
                     and os.path.getsize(self.path) > 0)
        self._f = open(self.path, "a")
        if fresh:
            self._write({"kind": "meta", **(meta or {})})

    def _write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def append_decision(self, plan: Plan, *, trigger: str, switched: bool,
                        signals: Optional[dict] = None,
                        bytes_per_sync: Optional[int] = None,
                        latency_s: Optional[float] = None) -> None:
        self._write({
            "kind": "decision",
            "step": int(plan.step),
            "plan_version": int(plan.version),
            "switched": bool(switched),
            "trigger": trigger,
            "signals": signals or {},
            "bytes_per_sync": bytes_per_sync,
            "latency_ms": (None if latency_s is None
                           else round(latency_s * 1e3, 4)),
            "plan": plan.to_json(),
        })

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


def read_decisions(path: str) -> list:
    """Decision rows, in file order; torn tail and junk lines dropped."""
    out = []
    if not os.path.isfile(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail of a killed writer
            if rec.get("kind") == "decision":
                out.append(rec)
    return out


class ReplaySchedule:
    """Step → plan lookup over a recorded ledger. The LAST row per step
    wins (a resumed recording re-decides steps it re-trains)."""

    def __init__(self, decisions: list):
        self._by_step: dict[int, dict] = {}
        for rec in decisions:
            self._by_step[int(rec["step"])] = rec
        self.steps = sorted(self._by_step)

    @classmethod
    def from_path(cls, path: str) -> "ReplaySchedule":
        decisions = read_decisions(path)
        if not decisions:
            raise FileNotFoundError(
                f"--adapt replay: no decisions in ledger {path!r} "
                "(record one with --adapt variance first)")
        return cls(decisions)

    def has(self, step: int) -> bool:
        return int(step) in self._by_step

    def record_at(self, step: int) -> dict:
        return self._by_step[int(step)]

    def plan_at(self, step: int) -> Plan:
        return Plan.from_json(self._by_step[int(step)]["plan"])

    def plan_at_or_before(self, step: int) -> Optional[Plan]:
        """Latest journaled plan with ``row.step <= step`` — what a resumed
        replay must start from."""
        best = None
        for s in self.steps:
            if s <= step:
                best = s
            else:
                break
        return None if best is None else self.plan_at(best)
