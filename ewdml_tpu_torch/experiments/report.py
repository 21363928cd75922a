"""``REPRO.md`` (for people) and ``REPRO.json`` (for programs)
(``ewdml_tpu/experiments/report.py``).

Each model block renders, for each metric family, three rows across the
M1-M6 columns: the measured value, the reference's published value
(BASELINE.md, via the registry) and the deviation (measured - published,
with percent), under the hardware of both sides. The reference ran a
2-worker Gloo PS on a Colab CPU; this run names its card and the card's
power limit (``nvidia-smi --query-gpu=name,power.limit``). Apart from the
command line and the hardware lines, the report renders as the JAX
package's does.

Runs in the sweep parent, which never touches a device.
"""

from __future__ import annotations

import json
import os

from ewdml_tpu_torch.experiments.registry import (METHOD_LABELS,
                                                  REFERENCE_HARDWARE)

#: (published metric key, measured metric key(s), row label). The comm/comp
#: families carry two measured keys: the measured split (``comm_min``/
#: ``comp_min``, under ``--trace-dir``) and the bytes-proportional
#: estimate (``*_est``). The measured value wins, and an estimated one is
#: marked ``~`` (legend below the report).
FAMILIES = [
    ("comm_mb_per_iter", ("comm_mb_per_iter",), "Avg comm cost / iter (MB)"),
    ("top1_pct", ("top1_pct",), "Top-1 accuracy (%)"),
    ("comm_min", ("comm_min", "comm_min_est"),
     "Communication time, total (min)"),
    ("comp_min", ("comp_min", "comp_min_est"),
     "Computation time, total (min)"),
    ("end_to_end_min", ("end_to_end_min",),
     "End-to-end training time (min)"),
    ("epochs_to_converge", ("epochs_to_converge",), "Epochs to converge"),
]

MODEL_TITLES = {
    "lenet_mnist": "LeNet / MNIST (20 epochs, batch 64)",
    "vgg11_cifar10": "VGG11 / CIFAR-10 (50 epochs, batch 64)",
}


def _fmt(v) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _deviation(measured, published) -> str:
    if measured is None or published is None:
        return "—"
    dev = measured - published
    if published:
        return f"{dev:+.3g} ({dev / published * 100:+.0f}%)"
    return f"{dev:+.3g}"


def _measured(row: dict | None, spec, measured_keys: tuple):
    """``(value, estimated)``: the first present measured key wins, and
    ``estimated`` says it came from a ``*_est`` key."""
    if row is None:
        return None, False
    m = row.get("metrics", {})
    if measured_keys[0] == "epochs_to_converge":
        # None on a run that armed the oracle (full mode) means the target
        # was not reached: rendered against the oracle's cap. Smoke runs
        # never arm it and render "—".
        v = m.get("epochs_to_converge")
        if v is None and row.get("target_top1") is not None:
            return f">{spec.epoch_cap}", False
        return v, False
    for key in measured_keys:
        if m.get(key) is not None:
            return m[key], key.endswith("_est")
    return None, False


def _hw_sig(hw: dict) -> str:
    return (f"{hw.get('platform')} ({hw.get('device_kind')}) "
            f"x{hw.get('device_count')}, host `{hw.get('hostname')}`, "
            f"{hw.get('name_power_limit') or 'no GPU'}")


def write_report(table: str, specs: list, rows: dict, *, out_dir: str,
                 smoke: bool, attempts: dict | None = None,
                 summary: dict | None = None) -> tuple[str, str]:
    """Render ``REPRO.md`` and ``REPRO.json`` from the completed rows (a
    partial sweep renders a partial table: pending cells show "—" and are
    listed). Returns the two paths."""
    os.makedirs(out_dir, exist_ok=True)
    attempts = attempts or {}
    by_model: dict[str, list] = {}
    for s in specs:
        by_model.setdefault(s.model_key, []).append(s)

    hardware = next((rows[s.cell_id].get("hardware") for s in specs
                     if s.cell_id in rows), None)
    # A resumed sweep may span machines (the ledger moves with --out): a
    # disagreement is listed, never averaged behind one block.
    hw_signatures: dict[str, list] = {}
    for s in specs:
        hw = rows.get(s.cell_id, {}).get("hardware")
        if hw:
            hw_signatures.setdefault(_hw_sig(hw), []).append(s.cell_id)
    stand_ins = sorted({
        (s.model_key, rows[s.cell_id].get("dataset"))
        for s in specs if s.cell_id in rows
        and rows[s.cell_id].get("stand_in")})
    pending = [s.cell_id for s in specs if s.cell_id not in rows]

    lines = [
        f"# REPRO — published-table reproduction (`{table}`)",
        "",
        "One command: `python -m ewdml_tpu_torch.experiments --table "
        f"{table}{' --smoke' if smoke else ''}` — resumable (re-invoking "
        "skips completed cells via the ledger; the in-flight cell restarts "
        "from its checkpoint). Published numbers: BASELINE.md.",
        "",
        "## Hardware provenance",
        "",
    ]
    if hardware:
        lines.append(
            f"- **this run**: {hardware.get('platform')} "
            f"({hardware.get('device_kind')}) x{hardware.get('device_count')}"
            f", mesh {hardware.get('mesh_devices', '?')} workers, host "
            f"`{hardware.get('hostname')}`, "
            f"{hardware.get('name_power_limit') or 'no GPU'}, torch "
            f"{hardware.get('torch')} / CUDA {hardware.get('cuda')}, "
            f"{hardware.get('os')}")
    else:
        lines.append("- **this run**: no cells completed yet")
    lines.append(f"- **reference**: {REFERENCE_HARDWARE}")
    if len(hw_signatures) > 1:
        lines += ["", "**MIXED HARDWARE** — this (resumed) sweep's rows "
                  "were measured on different machines; their deviations "
                  "are not mutually comparable:"]
        lines += [f"- {sig}: {', '.join(cells)}"
                  for sig, cells in hw_signatures.items()]
    if smoke:
        lines += ["", "**SMOKE RUN** — tiny step budgets; time/accuracy "
                  "columns are mechanism checks, not reproduction numbers."]
    if stand_ins:
        pretty = ", ".join(f"{mk} -> `{ds}`" for mk, ds in stand_ins)
        lines += ["", f"**Stand-in data**: {pretty} (the reference blobs "
                  "are not on disk; these cells ran the committed REAL "
                  "stand-in split, so accuracy/epoch deviations vs the "
                  "published row are expected and NOT comparable — they "
                  "become comparable the moment the real dataset appears "
                  "under `data/`)."]
    if pending:
        lines += ["", f"**Pending cells** ({len(pending)}): "
                  + ", ".join(pending)]

    any_est = False
    for model_key, mspecs in by_model.items():
        # An adaptive cell (same preset, controller armed) is its own AD
        # column; a federated cell (all share one method preset) is
        # labelled by its sweep axis, its own table the "Federated rounds"
        # block.
        col = {s.cell_id: ("AD" if s.adapt != "off"
                           else s.cell_id.rsplit("/", 1)[-1] if s.federated
                           else f"M{s.method}")
               for s in mspecs}
        lines += ["", f"## {MODEL_TITLES.get(model_key, model_key)}", ""]
        header = ("| Metric | row | "
                  + " | ".join(col[s.cell_id] for s in mspecs) + " |")
        lines += [header, "|---|---|" + "---|" * len(mspecs)]
        for pub_key, meas_keys, label in FAMILIES:
            pub = {s.cell_id: s.published.get(pub_key) for s in mspecs}
            if all(v is None for v in pub.values()) and not any(
                    _measured(rows.get(s.cell_id), s, meas_keys)[0]
                    is not None for s in mspecs):
                continue  # family absent on both sides (e.g. LeNet comm/comp)
            meas, est = {}, {}
            for s in mspecs:
                meas[s.cell_id], est[s.cell_id] = _measured(
                    rows.get(s.cell_id), s, meas_keys)
            if any(est.values()):
                any_est = True
            lines.append(f"| {label} | measured | " + " | ".join(
                _fmt(meas[s.cell_id]) + ("~" if est[s.cell_id] else "")
                for s in mspecs) + " |")
            lines.append("| | published | " + " | ".join(
                _fmt(pub[s.cell_id]) for s in mspecs) + " |")
            lines.append("| | deviation | " + " | ".join(
                _deviation(meas[s.cell_id]
                           if isinstance(meas[s.cell_id], (int, float))
                           else None, pub[s.cell_id])
                for s in mspecs) + " |")
        # Per-method run facts the published table has no row for.
        fact_rows = [
            ("step time (ms)", lambda r: r.get("mean_step_ms")),
            ("wire MB/step/worker",
             lambda r: r.get("wire_mb_per_step_worker")),
            ("bytes reduction vs dense",
             lambda r: r.get("bytes_reduction_vs_dense")),
            ("dataset", lambda r: f"`{r.get('dataset')}`"),
            ("attempts", lambda r: attempts.get(r.get("cell"), 1)),
        ]
        for label, fn in fact_rows:
            vals = [(fn(rows[s.cell_id]) if s.cell_id in rows else None)
                    for s in mspecs]
            lines.append(f"| {label} | — | "
                         + " | ".join(_fmt(v) for v in vals) + " |")

    # Every adaptive cell's journaled decisions, so the AD column's bytes
    # are auditable against when and why the controller switched.
    adaptive = [(s, rows[s.cell_id]["adapt"]) for s in specs
                if s.adapt != "off" and s.cell_id in rows
                and rows[s.cell_id].get("adapt")]
    if adaptive:
        lines += ["", "## Adaptive decision provenance", ""]
        for s, ad in adaptive:
            lines += [f"### `{s.cell_id}` — mode `{ad.get('mode')}`, "
                      f"{ad.get('decisions', 0)} decisions, "
                      f"{ad.get('switches', 0)} switches "
                      f"(ledger: `{ad.get('ledger')}`)", ""]
            windows = ad.get("windows") or []
            if windows:
                lines += ["| step | plan | switched | bytes/sync | trigger "
                          "| methods |", "|---|---|---|---|---|---|"]
                for w in windows:
                    methods = ", ".join(
                        f"{k}:{v}" for k, v in sorted(
                            (w.get("methods") or {}).items()))
                    lines.append(
                        f"| {w.get('step')} | v{w.get('plan_version')} | "
                        f"{'yes' if w.get('switched') else ''} | "
                        f"{_fmt(w.get('bytes_per_sync'))} | "
                        f"{w.get('trigger', '')} | {methods} |")
                lines.append("")

    # The federated sweep: cohort x heterogeneity x dropout, with the flat
    # server cost per cell (one decode a round on the homomorphic sum).
    federated = [(s, rows[s.cell_id]) for s in specs
                 if s.federated and s.cell_id in rows
                 and rows[s.cell_id].get("mode") == "federated"]
    if federated:
        lines += ["", "## Federated rounds (pool-scale client sampling)",
                  "",
                  "| cell | cohort | partition | skew | rounds | final "
                  "loss | top1 | decode/round | dropouts→resampled | "
                  "up MB/round | round ms |",
                  "|---|---|---|---|---|---|---|---|---|---|---|"]
        for s, r in federated:
            dpr = r.get("decode_count", 0) / max(1, r.get("apply_rounds", 1))
            up_round = (r.get("bytes_up_mb", 0)
                        / max(1, r.get("rounds", 1)))
            lines.append(
                f"| `{s.cell_id.rsplit('/', 1)[-1]}` | {r.get('cohort')} "
                f"| {r.get('partition')}(α={r.get('partition_alpha')}) "
                f"| {_fmt(r.get('skew'))} | {r.get('rounds')} "
                f"| {_fmt(r.get('final_loss'))} | {_fmt(r.get('top1'))} "
                f"| {_fmt(dpr)} "
                f"| {r.get('dropouts', 0)}→{r.get('resampled', 0)} "
                f"| {_fmt(up_round)} "
                f"| {_fmt(r.get('round_wall_ms_mean'))} |")
        lines.append("")

    if any_est:
        lines += ["", "`~` = bytes-proportional ESTIMATE of the fused "
                  "step's comm/comp split (no trace was armed for that "
                  "cell). Unmarked comm/comp values are MEASURED via the "
                  "trace-fence probe (`--trace-dir`; "
                  "`experiments/collect._comm_split_measured`)."]

    lines += ["", "## Methods",
              ""] + [f"- **M{m}** — {label}"
                     for m, label in METHOD_LABELS.items()]
    lines += ["", "Machine-readable twin: `REPRO.json` (same directory); "
              "run journal: `ledger.jsonl`.", ""]

    md_path = os.path.join(out_dir, "REPRO.md")
    with open(md_path, "w") as f:
        f.write("\n".join(lines))

    payload = {
        "table": table,
        "smoke": smoke,
        "hardware": hardware,
        "hardware_signatures": hw_signatures,
        "reference_hardware": REFERENCE_HARDWARE,
        "summary": summary or {},
        "cells": {
            s.cell_id: {
                "spec": {
                    "network": s.network, "method": s.method,
                    "ref_dataset": s.ref_dataset, "stand_in": s.stand_in,
                    "epochs": s.epochs, "batch_size": s.batch_size,
                    "num_workers": s.num_workers,
                    "precision_policy": s.precision_policy,
                    "adapt": s.adapt,
                },
                "published": s.published,
                "status": "done" if s.cell_id in rows else "pending",
                "attempts": attempts.get(s.cell_id),
                "row": rows.get(s.cell_id),
            }
            for s in specs
        },
    }
    json_path = os.path.join(out_dir, "REPRO.json")
    with open(json_path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    return md_path, json_path
