"""Merged trace -> Chrome-trace/Perfetto JSON (``ewdml_tpu/obs/export.py``,
the same document).

The output is the Trace Event Format JSON object (``{"traceEvents": [...]}``)
that both ``chrome://tracing`` and https://ui.perfetto.dev load directly:
one "process" per role (the PS server, each worker, the evaluator, the
experiments runner render as separate tracks on ONE aligned timeline),
complete spans as ``ph: "X"``, instants as ``ph: "i"``, counters as
``ph: "C"``, plus the ``ph: "M"`` metadata naming rows.

Causal flow links (``ph: "s"/"t"/"f"``): every event group sharing a
request id (``args.req`` — ``obs.merge.flow_groups``) that spans at least
two process tracks emits one flow: start anchored on the earliest event
(the worker's call span), steps on any retry/kill instants, finish bound
to the server's dispatch span (``bp: "e"``). In the Perfetto UI the arrow
answers "which server dispatch served THIS worker pull/push" across
process tracks — the causal edge r10's parallel tracks lacked.

Timestamps convert ns -> us (the format's unit) relative to the earliest
merged event, so the timeline starts at ~0 regardless of monotonic epochs.
"""

from __future__ import annotations

import json
import os

from ewdml_tpu_torch.obs import merge as _merge


def chrome_trace(merged_events: list) -> dict:
    """Trace Event Format document from ``obs.merge`` output."""
    events = []
    pids: dict[str, int] = {}
    tids: dict[tuple, int] = {}
    t0 = min((e["ts"] for e in merged_events), default=0)

    def pid_of(role: str) -> int:
        if role not in pids:
            pids[role] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M",
                           "pid": pids[role], "tid": 0,
                           "args": {"name": role}})
        return pids[role]

    def tid_of(role: str, tname: str) -> int:
        key = (role, tname)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == role]) + 1
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pid_of(role), "tid": tids[key],
                           "args": {"name": tname}})
        return tids[key]

    # Where each renderable slice landed, keyed by event identity — so the
    # flow anchors below can reuse obs.merge.flow_groups (the ONE request
    # grouping definition, shared with obs/rounds) instead of re-deriving
    # membership here.
    placed: dict[int, tuple] = {}  # id(event) -> (ts_us, pid, tid)
    for ev in merged_events:
        role = ev.get("role") or "?"
        pid = pid_of(role)
        tid = tid_of(role, ev.get("tid") or "main")
        ts_us = (ev["ts"] - t0) / 1e3
        base = {"name": ev["name"], "pid": pid, "tid": tid,
                "ts": round(ts_us, 3), "cat": role}
        kind = ev.get("kind")
        if kind == "span":
            base.update(ph="X", dur=round(ev.get("dur", 0) / 1e3, 3))
            if ev.get("args"):
                base["args"] = ev["args"]
        elif kind == "counter":
            base.update(ph="C", args={ev["name"]: ev.get("value", 0)})
        else:  # instant
            base.update(ph="i", s="t")
            if ev.get("args"):
                base["args"] = ev["args"]
        events.append(base)
        if kind in ("span", "instant"):
            placed[id(ev)] = (ts_us, pid, tid)
    anchors: dict[str, list] = {}  # req id -> [(ts_us, pid, tid)]
    for req, group in _merge.flow_groups(merged_events).items():
        # Only renderable slices (span/instant) can anchor an arrow; a
        # counter sample carrying a req has no slice to bind to.
        pts = [placed[id(e)] for e in group if id(e) in placed]
        if pts:
            anchors[req] = pts
    events.extend(_flow_events(anchors))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _flow_events(anchors: dict) -> list:
    """Flow-event triplets from the per-request anchor lists: s (earliest
    anchor, normally the worker call span) -> t steps -> f (latest anchor,
    the server dispatch span; ``bp: "e"`` binds it to that enclosing
    slice). Single-track groups emit nothing — a flow arrow inside one
    process track is noise. Flow ids are small ints; the request id rides
    ``args.req`` for grep-ability."""
    out = []
    flow_id = 0
    for req in sorted(anchors):
        group = sorted(anchors[req])
        if len(group) < 2 or len({pid for _, pid, _ in group}) < 2:
            continue
        flow_id += 1
        prev_ts = None
        for i, (ts_us, pid, tid) in enumerate(group):
            if prev_ts is not None and ts_us < prev_ts:
                ts_us = prev_ts  # flows must be time-ordered within an id
            prev_ts = ts_us
            ph = "s" if i == 0 else ("f" if i == len(group) - 1 else "t")
            ev = {"name": "req", "cat": "flow", "ph": ph, "id": flow_id,
                  "pid": pid, "tid": tid, "ts": round(ts_us, 3),
                  "args": {"req": req}}
            if ph == "f":
                ev["bp"] = "e"
            out.append(ev)
    return out


def export_perfetto(trace_dir: str, out_path: str | None = None) -> str:
    """Merge every shard under ``trace_dir`` and write the Perfetto JSON.
    Returns the output path (default ``<trace_dir>/trace.json``)."""
    doc = chrome_trace(_merge.merge_dir(trace_dir))
    out_path = out_path or os.path.join(trace_dir, "trace.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return out_path
