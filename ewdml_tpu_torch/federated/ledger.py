"""The federated round journal, append-only JSONL: the replay oracle
(``ewdml_tpu/federated/ledger.py``, copied).

Events, one JSON object a line (keys sorted, fsync'd on every append, so
the two packages write byte-identical journals for the same run):

- ``{"event": "register", "client": c}``: a first-time pool registration;
- ``{"event": "round_begin", "round": r, "cohort": [...], "version": v}``;
- ``{"event": "dropout", "round": r, "client": c, "replacement": c2}``
  (``replacement`` -1 when the pool is exhausted);
- ``{"event": "round_done", "round": r, "accepted": [...], "version": v}``;
- ``round_pipeline_begin`` / ``round_commit``: the pipelined twins of
  ``round_begin`` / ``round_done`` (written by the round pipeline, a later
  slice; :func:`round_sequence` reads them already).

No timestamps: every field is a deterministic function of the config, the
seed and the fault spec, and :func:`round_sequence` extracts the
``(round, cohort, accepted)`` triples a replay must reproduce.
"""

from __future__ import annotations

import json
import os


class RoundLedger:
    """Append-only writer (torn-tail tolerant on the read side). A ledger
    is one run's journal, so it truncates on open, except under ``resume``
    (a recovered server continuing the same run), which appends."""

    def __init__(self, path: str, resume: bool = False):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a" if resume else "w")

    def append(self, **event) -> None:
        self._f.write(json.dumps(event, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_ledger(path: str) -> list[dict]:
    """All complete records; a torn last line (a run killed mid-append) is
    dropped."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                break  # torn tail
    return out


def round_sequence(records: list[dict]) -> list[tuple]:
    """The deterministic round identity: ``(round, cohort-tuple,
    accepted-tuple)`` per completed round, in order, the cohort being the
    final one (primary draw plus in-round replacements). ``register``
    events are ignored."""
    cohorts: dict[int, list] = {}
    out = []
    for rec in records:
        ev = rec.get("event")
        if ev in ("round_begin", "round_pipeline_begin"):
            cohorts[rec["round"]] = list(rec["cohort"])
        elif ev == "dropout":
            if rec.get("replacement", -1) >= 0:
                cohorts.setdefault(rec["round"], []).append(
                    rec["replacement"])
        elif ev in ("round_done", "round_commit"):
            r = rec["round"]
            out.append((r, tuple(sorted(cohorts.get(r, []))),
                        tuple(rec["accepted"])))
    return out
