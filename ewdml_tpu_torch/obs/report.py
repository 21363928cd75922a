"""``python -m ewdml_tpu_torch.cli obs {report,export,rounds} <trace-dir>``
(``ewdml_tpu/obs/report.py``, the same text).

``report`` renders the merged run as text: per role, the top spans by total
time, then counters (socket bytes, retries), instants (dispatches, kills,
cell events), and the shard inventory (who flushed, who tore). ``export``
writes the Perfetto JSON (``obs.export``). ``rounds`` runs the round
critical-path analyzer (``obs.rounds``): per-round gating worker and the
wire/queue/handler/apply/compute split that sums to the round wall.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from collections import defaultdict

from ewdml_tpu_torch.obs import export as _export, merge as _merge
from ewdml_tpu_torch.obs.hist import QuantileHistogram


def summarize(merged_events: list, top: int = 12) -> dict:
    """Aggregate merged events into the report's tables. Span durations
    fold through the same log-bucket quantile histogram the live plane
    uses (``obs/hist.py``), so the post-hoc report and a mid-run scrape
    quote comparable p50/p99 columns."""
    spans: dict = defaultdict(lambda: {"count": 0, "total_ns": 0, "max_ns": 0,
                                       "hist": QuantileHistogram()})
    instants: dict = defaultdict(int)
    counters: dict = {}
    roles: dict = defaultdict(int)
    for ev in merged_events:
        key = (ev.get("role") or "?", ev["name"])
        roles[ev.get("role") or "?"] += 1
        kind = ev.get("kind")
        if kind == "span":
            s = spans[key]
            s["count"] += 1
            s["total_ns"] += ev.get("dur", 0)
            s["max_ns"] = max(s["max_ns"], ev.get("dur", 0))
            s["hist"].observe(ev.get("dur", 0) / 1e9)
        elif kind == "instant":
            instants[key] += 1
        elif kind == "counter":
            counters[key] = ev.get("value")  # merged is time-sorted: last wins
    return {"spans": dict(spans), "instants": dict(instants),
            "counters": dict(counters), "roles": dict(roles), "top": top}


def render_report(trace_dir: str, top: int = 12) -> str:
    shards = _merge.load_shards(trace_dir)
    merged = _merge.merge_shards(shards)
    agg = summarize(merged, top=top)
    lines = [f"obs report — {trace_dir}",
             f"shards: {len(shards)}, events: {len(merged)}"]
    for shard in shards:
        m = shard["meta"]
        off = m.get("offset_ns")
        lines.append(
            f"  {m.get('role')} (pid {m.get('pid')}, host {m.get('host')}): "
            f"{len(shard['events'])} events, "
            f"offset={'handshake ' + str(off) + 'ns' if off is not None else 'same-host/anchor'}"
            + (f", dropped={m['dropped']}" if m.get("dropped") else ""))
    # load_shards already parsed every file; a shard path it did NOT return
    # had no readable meta line (no second parse to find out).
    readable = {s["meta"].get("path") for s in shards}
    torn = [p for p in glob.glob(os.path.join(trace_dir, "shard-*.jsonl"))
            if p not in readable]
    if torn:
        lines.append(f"  unreadable shards (no meta): {len(torn)}")

    by_role: dict = defaultdict(list)
    for (role, name), s in agg["spans"].items():
        by_role[role].append((name, s))
    for role in sorted(by_role):
        lines.append(f"\n[{role}] top spans (by total time)")
        rows = sorted(by_role[role], key=lambda kv: -kv[1]["total_ns"])[:top]
        for name, s in rows:
            total_ms = s["total_ns"] / 1e6
            mean_ms = total_ms / max(1, s["count"])
            p50 = (s["hist"].quantile(0.5) or 0) * 1e3
            p99 = (s["hist"].quantile(0.99) or 0) * 1e3
            lines.append(f"  {name:<28} n={s['count']:<7} "
                         f"total={total_ms:10.2f} ms  mean={mean_ms:8.3f} ms  "
                         f"p50={p50:8.3f} ms  p99={p99:8.3f} ms  "
                         f"max={s['max_ns'] / 1e6:8.3f} ms")
    if agg["instants"]:
        lines.append("\ninstants")
        for (role, name), n in sorted(agg["instants"].items()):
            lines.append(f"  {role}/{name}: {n}")
    if agg["counters"]:
        lines.append("\ncounters (last value)")
        for (role, name), v in sorted(agg["counters"].items()):
            lines.append(f"  {role}/{name}: {v}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ewdml_tpu_torch.cli obs",
        description="trace report / Perfetto export")
    sub = p.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="text summary of a merged trace dir")
    rp.add_argument("trace_dir")
    rp.add_argument("--top", type=int, default=12)
    ep = sub.add_parser("export", help="write Perfetto/Chrome-trace JSON")
    ep.add_argument("trace_dir")
    ep.add_argument("--out", default=None)
    rd = sub.add_parser("rounds", help="round critical-path analysis: "
                        "gating worker + wire/queue/handler/apply/compute "
                        "split per round")
    rd.add_argument("trace_dir")
    rd.add_argument("--json", action="store_true", dest="as_json")
    ns = p.parse_args(argv)
    if not os.path.isdir(ns.trace_dir):
        print(f"no such trace dir: {ns.trace_dir}", file=sys.stderr)
        return 2
    if ns.cmd == "report":
        print(render_report(ns.trace_dir, top=ns.top))
        return 0
    if ns.cmd == "rounds":
        from ewdml_tpu_torch.obs import rounds as _rounds

        analysis = _rounds.analyze(_merge.merge_dir(ns.trace_dir))
        print(_rounds.render_json(analysis) if ns.as_json
              else _rounds.render_text(analysis, ns.trace_dir))
        return 0
    out = _export.export_perfetto(ns.trace_dir, ns.out)
    print(f"wrote {out} (load at https://ui.perfetto.dev or chrome://tracing)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
