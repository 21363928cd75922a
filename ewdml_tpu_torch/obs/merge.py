"""Cross-process shard alignment onto one timeline
(``ewdml_tpu/obs/merge.py``, the same rules and results; the port's
shards carry the same meta keys, ``obs/trace.py``).

Every process flushes one JSONL shard of LOCAL monotonic timestamps
(``obs.trace``). Alignment resolves, per shard, an offset into the trace
timebase (the reference shard's clock domain), in priority order:

1. **Handshaken offset** (``meta.offset_ns``): the TCP worker's first pull
   carries its monotonic stamp; the server's reply carries its own; the
   worker stores ``server_mono - rtt_midpoint`` (``parallel/ps_net.py``).
   Exact up to half the round trip.
2. **Same host as the reference shard: zero.** CLOCK_MONOTONIC is
   machine-wide (``obs.clock``), so two processes on one host already share
   the timebase exactly — better than any handshake estimate, which is why
   the handshake only records a nonzero offset cross-host.
3. **Wall-anchor fallback**: each shard's meta pairs a wall-clock and a
   monotonic reading captured together; the offset between two shards'
   ``wall - mono`` gaps aligns them to NTP accuracy (launcher-spawned
   multi-host runs without a PS wire to handshake over).

Torn shards — a killed worker flushing when the signal landed — parse line
by line; the torn tail line (and only it) is dropped, exactly like the
experiments ledger's torn-tail rule.
"""

from __future__ import annotations

import glob
import json
import os


def read_shard(path: str) -> dict | None:
    """Parse one shard, tolerating a torn tail. Returns ``{"meta", "events"}``
    or None when the file holds no valid meta line (nothing to place on a
    timeline)."""
    meta, events = None, []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail from a killed writer
                if rec.get("kind") == "meta":
                    meta = rec
                elif "ts" in rec:
                    events.append(rec)
    except OSError:
        return None
    if meta is None:
        return None
    meta.setdefault("path", path)
    return {"meta": meta, "events": events}


def load_shards(trace_dir: str) -> list:
    shards = []
    for path in sorted(glob.glob(os.path.join(trace_dir, "shard-*.jsonl"))):
        shard = read_shard(path)
        if shard is not None:
            shards.append(shard)
    return shards


def _pick_reference(shards: list) -> dict:
    """The timebase owner: prefer the PS server (the handshake's far end);
    when the server left no shard (SIGKILL'd mid-run — the r7 fault paths),
    prefer a HANDSHAKEN shard, so every other handshaken shard still aligns
    consistently via offset differences (both offsets point into the same,
    now-absent, server domain); else the first shard."""
    for s in shards:
        if s["meta"].get("role") == "ps-server":
            return s
    for s in shards:
        if s["meta"].get("offset_ns") is not None:
            return s
    return shards[0]


def resolve_offset(meta: dict, ref_meta: dict) -> int:
    """ns to ADD to this shard's local timestamps to land on the reference
    shard's timebase. Handshaken offsets point into the SERVER's clock
    domain, so they only apply directly when the reference IS the server
    (offset None/0); against a non-server handshaken reference the two
    server-domain offsets difference out."""
    if meta is ref_meta:
        return 0
    ref_off = ref_meta.get("offset_ns")
    if meta.get("host") == ref_meta.get("host"):
        return 0  # shared CLOCK_MONOTONIC — exact, beats any estimate
    if meta.get("offset_ns") is not None:
        # Both handshaken into the server domain: difference lands in the
        # reference's local domain. An un-handshaken (or server, offset 0)
        # reference keeps the absolute offset.
        return int(meta["offset_ns"]) - int(ref_off or 0)
    try:  # wall-anchor fallback (cross-host, no handshake)
        gap = meta["wall_anchor_ns"] - meta["mono_anchor_ns"]
        ref_gap = ref_meta["wall_anchor_ns"] - ref_meta["mono_anchor_ns"]
        return int(gap - ref_gap)
    except (KeyError, TypeError):
        return 0


def merge_shards(shards: list) -> list:
    """Aligned, time-sorted event dicts across all shards. Each event gains
    the shard's pid/host and keeps its own role (thread-level override
    included); ``ts`` is rebased onto the reference timebase."""
    if not shards:
        return []
    ref = _pick_reference(shards)["meta"]
    merged = []
    for shard in shards:
        meta = shard["meta"]
        off = resolve_offset(meta, ref)
        for ev in shard["events"]:
            e = dict(ev)
            e["ts"] = int(ev["ts"]) + off
            e.setdefault("role", meta.get("role"))
            e["pid"] = meta.get("pid")
            e["host"] = meta.get("host")
            merged.append(e)
    merged.sort(key=lambda e: e["ts"])
    return merged


def merge_dir(trace_dir: str) -> list:
    """One call: load every shard under ``trace_dir`` and align."""
    return merge_shards(load_shards(trace_dir))


#: Segment child spans (``ps_net/recv`` etc.) carry the request id for
#: attribution but are NOT flow anchors — the flow links the worker's call
#: span to the server's dispatch span, not to every sub-segment.
_FLOW_EXCLUDE = frozenset({"ps_net/recv", "ps_net/parse", "ps_net/queue",
                           "ps_net/serialize", "ps_net/send"})


def flow_groups(merged_events: list) -> dict:
    """Causal request flows: request id -> the time-sorted anchor events
    that carried it (``args.req``, stamped by ``RetryingConnection.call``
    into the wire header and by both endpoints into their spans). A group
    typically holds the worker-side call span, the server-side dispatch
    span, and any retry/kill instants of the same round trip; consumers
    (``obs.export`` flow events, ``obs.rounds`` client/server pairing)
    share this one grouping definition."""
    groups: dict = {}
    for ev in merged_events:
        args = ev.get("args")
        if not args:
            continue
        req = args.get("req")
        if req is None or ev.get("name") in _FLOW_EXCLUDE:
            continue
        groups.setdefault(str(req), []).append(ev)
    for evs in groups.values():
        evs.sort(key=lambda e: e["ts"])
    return groups
