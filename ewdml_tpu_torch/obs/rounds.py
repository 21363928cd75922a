"""Round critical-path analyzer: who gated round N, and where its time went
(``ewdml_tpu/obs/rounds.py``, the same rows).

Input is a merged trace (``obs.merge``) of a TCP PS deployment whose spans
carry the r17 causal context: worker call spans and server dispatch spans
share a request id (``args.req``), server push/pull spans carry their
lock-wait split (``args.queue_ns``), and every ``ps/apply`` span names the
round (server version) it consumed. From those this module answers the two
questions the flat per-op histograms cannot:

- **Which worker gated round N?** The apply that produced version N+1 runs
  inside the dispatch of the push that completed the K-of-N batch — the
  *gating* push. Its request id walks back to the worker's push span, step
  chain, and pull, i.e. the round's critical path.
- **Where did the round wall go?** The gating worker's chain decomposes the
  wall (pull start → apply end) into segments that SUM to it:

  ========== =========================================================
  wire_s     both sockets' transit + serialize (client span minus the
             server's dispatch time; push counts only the up-leg — the
             reply returns after the round is already applied)
  queue_s    server lock/convoy waits (``obs.reqctx`` timed locks)
  handler_s  server dispatch minus queue minus apply (decode, policy,
             schema work)
  apply_s    the K-of-N apply
  compute_s  the worker's local grad + compress spans
  other_s    exact residual (data loading, host gaps) — keeps the sum
             identically equal to the measured wall
  ========== =========================================================

All timestamps are merged-timeline ns, so cross-process subtraction is
legal by construction (``obs.merge`` alignment).
"""

from __future__ import annotations

import json as _json
from collections import defaultdict

from ewdml_tpu_torch.obs import merge as _merge

#: Segment keys, rendering order. ``other_s`` is the residual that makes
#: the decomposition sum exactly to ``wall_s``.
SEGMENT_KEYS = ("wire_s", "queue_s", "handler_s", "apply_s", "compute_s",
                "other_s")


def _spans(merged, name):
    return [e for e in merged if e.get("kind") == "span"
            and e.get("name") == name]


def _args(ev) -> dict:
    return ev.get("args") or {}


def _end(ev) -> int:
    return ev["ts"] + ev.get("dur", 0)


def analyze(merged_events: list, excluded=None) -> dict:
    """Merged events -> per-round critical-path rows.

    ``excluded`` (optional): a worker->reason mapping from a
    ``StragglerPolicy`` snapshot (e.g. the ps_net stats reply) — a round
    gated by an excluded worker is flagged, the cross-check that the
    analyzer's gating attribution and the policy's straggler verdicts
    tell one story.
    """
    flows = _merge.flow_groups(merged_events)
    # req -> the worker-side call span / server-side dispatch span pair.
    client_of, server_of = {}, {}
    for req, evs in flows.items():
        for e in evs:
            if e.get("kind") != "span":
                continue
            if e["name"].startswith("worker/"):
                client_of[req] = e
            elif e["name"].startswith("ps_net/"):
                server_of[req] = e

    # Worker step chains: (role, step) -> {pull/grad/compress/push: span}.
    chains: dict = defaultdict(dict)
    for part in ("pull", "grad", "compress", "push"):
        for e in _spans(merged_events, f"worker/{part}"):
            step = _args(e).get("step")
            if step is not None:
                chains[(e.get("role"), step)][part] = e

    applies = sorted(_spans(merged_events, "ps/apply"), key=lambda e: e["ts"])
    server_pushes = sorted(_spans(merged_events, "ps_net/push"),
                           key=lambda e: e["ts"])
    excluded = {str(k): v for k, v in (excluded or {}).items()}

    rounds, gating_counts = [], defaultdict(int)
    prev_apply_ts = None
    for ap in applies:
        rnd = _args(ap).get("version")
        fed_round = _args(ap).get("round")
        if fed_round is not None:
            # Pipelined apply (r24 --round-pipeline overlap): two rounds
            # are in flight, so "pushes since the previous apply" spans
            # BOTH rounds' arrivals. The apply span names its round and so
            # does every stamped push — window by round identity, not by
            # timestamp adjacency.
            window = [p for p in server_pushes
                      if _args(p).get("round") == fed_round
                      and p["ts"] <= ap["ts"]]
        else:
            # The batch this apply consumed: pushes dispatched since the
            # previous apply began; the gating push is the one whose
            # dispatch interval contains the apply (its handler thread
            # ran it).
            window = [p for p in server_pushes if p["ts"] <= ap["ts"]
                      and (prev_apply_ts is None or p["ts"] > prev_apply_ts)]
        prev_apply_ts = ap["ts"]
        gating = next((p for p in reversed(window)
                       if _end(p) >= _end(ap)), None)
        if gating is None and window:
            gating = window[-1]
        row = {"round": rnd, "k": _args(ap).get("k"),
               "apply_ms": round(ap.get("dur", 0) / 1e6, 3),
               "workers": sorted({str(_args(p).get("worker"))
                                  for p in window}),
               "complete": False}
        if fed_round is not None:
            row["fed_round"] = fed_round
        if gating is None:
            rounds.append(row)
            continue
        worker = _args(gating).get("worker")
        row["gating_worker"] = str(worker)
        gating_counts[str(worker)] += 1
        if str(worker) in excluded:
            row["gating_excluded"] = excluded[str(worker)]
        client_push = client_of.get(str(_args(gating).get("req")))
        chain = (chains.get((client_push.get("role"),
                             _args(client_push).get("step")), {})
                 if client_push is not None else {})
        row.update(_attribute(chain, client_push, gating, ap, server_of))
        rounds.append(row)

    return {
        "rounds": rounds,
        "completed": sum(1 for r in rounds if r.get("complete")),
        "gating_counts": dict(sorted(gating_counts.items())),
        "gating_excluded": sorted({r["gating_worker"] for r in rounds
                                   if "gating_excluded" in r}),
        "flow_pairs": sum(1 for req in client_of if req in server_of),
    }


def _attribute(chain: dict, client_push, gating, ap, server_of) -> dict:
    """Segment the gating worker's chain; sums exactly to ``wall_s``."""
    pull = chain.get("pull")
    if pull is None or client_push is None:
        return {"complete": False}
    wall_ns = _end(ap) - pull["ts"]
    wire = queue = handler = compute = 0
    # Pull round trip: client wall minus server dispatch = wire + client
    # overhead; the server side splits queue (args) from handler.
    spull = server_of.get(str(_args(pull).get("req")))
    if spull is not None:
        q = _args(spull).get("queue_ns") or 0
        wire += max(0, pull.get("dur", 0) - spull.get("dur", 0))
        queue += q
        handler += max(0, spull.get("dur", 0) - q)
    else:
        wire += pull.get("dur", 0)
    # Local compute: the step's grad + compress spans.
    for part in ("grad", "compress"):
        e = chain.get(part)
        if e is not None:
            compute += e.get("dur", 0)
    # Push leg, truncated at apply end (the reply leg happens after the
    # round is done): up-wire to the server dispatch start, then queue,
    # then pre-apply handler, then the apply itself.
    qpush = _args(gating).get("queue_ns") or 0
    wire += max(0, gating["ts"] - client_push["ts"])
    queue += qpush
    handler += max(0, (ap["ts"] - gating["ts"]) - qpush)
    apply_ns = ap.get("dur", 0)
    other = wall_ns - (wire + queue + handler + apply_ns + compute)
    return {
        "complete": True,
        "wall_ms": round(wall_ns / 1e6, 3),
        "segments_ms": {
            "wire_s": round(wire / 1e6, 3),
            "queue_s": round(queue / 1e6, 3),
            "handler_s": round(handler / 1e6, 3),
            "apply_s": round(apply_ns / 1e6, 3),
            "compute_s": round(compute / 1e6, 3),
            "other_s": round(other / 1e6, 3),
        },
    }


# -- rendering ---------------------------------------------------------------

def render(trace_dir: str, excluded=None) -> str:
    analysis = analyze(_merge.merge_dir(trace_dir), excluded=excluded)
    return render_text(analysis, trace_dir)


def render_text(analysis: dict, trace_dir: str = "") -> str:
    lines = [f"obs rounds — {trace_dir}".rstrip(" —"),
             f"completed rounds: {analysis['completed']} of "
             f"{len(analysis['rounds'])}, "
             f"flow-linked request pairs: {analysis['flow_pairs']}"]
    header = (f"  {'round':>5}  {'gating':>8}  {'wall_ms':>9}  "
              + "  ".join(f"{k[:-2]:>9}" for k in SEGMENT_KEYS))
    lines.append(header)
    for r in analysis["rounds"]:
        if not r.get("complete"):
            lines.append(f"  {str(r.get('round')):>5}  "
                         f"{str(r.get('gating_worker', '?')):>8}  "
                         f"{'(incomplete: unpaired spans)':>9}")
            continue
        seg = r["segments_ms"]
        lines.append(
            f"  {str(r['round']):>5}  {r['gating_worker']:>8}  "
            f"{r['wall_ms']:>9.3f}  "
            + "  ".join(f"{seg[k]:>9.3f}" for k in SEGMENT_KEYS)
            + (f"  [fed round {r['fed_round']}]"
               if "fed_round" in r else "")
            + ("  [EXCLUDED: " + r["gating_excluded"] + "]"
               if "gating_excluded" in r else ""))
    if analysis["gating_counts"]:
        lines.append("gating counts: " + ", ".join(
            f"{w}×{n}" for w, n in analysis["gating_counts"].items()))
    if analysis["gating_excluded"]:
        lines.append("WARNING: rounds gated by policy-excluded workers: "
                     + ", ".join(analysis["gating_excluded"]))
    if not analysis["rounds"]:
        lines.append("  (no ps/apply spans — not a traced PS run, or the "
                     "server shard is missing)")
    return "\n".join(lines)


def render_json(analysis: dict) -> str:
    return _json.dumps(analysis, indent=1)
