"""The resumable sweep: cells in order, a JSONL ledger, one child process
per cell under a watchdog (``ewdml_tpu/experiments/runner.py``).

The parent never touches a device: it plans (registry), journals (ledger),
supervises (one child OS process per cell with a timeout, so a hung cell
is killed and retried and never eats the sweep) and reports
(``report.py``). Each child trains its cell on ``--platform`` (CUDA unless
the caller asks for the CPU; a CUDA child with no GPU raises).

Ledger (``<out>/ledger.jsonl``, append-only, fsync'd per event)::

    {"event": "sweep_start", "table": ..., "smoke": ...}
    {"event": "cell_start", "cell": ..., "spec_hash": ..., "attempt": 1}
    {"event": "cell_retry", "cell": ..., "attempt": 1, "reason": "rc=13",
     "resume_step": 4}
    {"event": "cell_done",  "cell": ..., "spec_hash": ..., "attempts": 2,
     "row": {...collect.run_cell output...}}
    {"event": "cell_failed"/"cell_skipped"/"cell_budget_skipped", ...}

Resume: a cell whose latest ``cell_done`` carries the current spec hash is
skipped; anything else (in flight, failed, stale hash) runs again, and its
Trainer restores from the cell's checkpoint, so an interrupted cell
restarts from its last checkpoint.

Fault injection (``--fault-spec``, the ``parallel/faults.py`` grammar):
a clause's worker index addresses a cell by its position in the sweep's
run list. ``delay@I=S`` makes cell I's child sleep S seconds before
training (a straggler; long enough trips the watchdog); ``crash@I=N``
makes it die at step N with ``faults.CRASH_EXIT_CODE`` on the cell's
first journaled attempt (attempts are numbered across invocations through
the ledger, so the clause fires once per cell history). Either way the
ledger records a retry, the next attempt resumes from the checkpoint, and
only a completed attempt writes the cell's row. ``--health warn|abort``
arms the run-health watchdog in every cell child, and ``nan@I=N`` makes
cell I's trainer observe a NaN loss at the fence covering step N, on its
first journaled attempt; under ``abort`` the child exits
``obs/health.HEALTH_EXIT_CODE`` and the ledger records a retry whose
reason starts ``health_abort``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from ewdml_tpu_torch.experiments import registry
from ewdml_tpu_torch.obs import clock
from ewdml_tpu_torch.obs import trace as otrace
from ewdml_tpu_torch.obs.health import HEALTH_EXIT_CODE, HealthAbort
from ewdml_tpu_torch.parallel.faults import FaultSpec

#: Seconds of budget below which no further cell is launched.
_MIN_LAUNCH_S = 10.0

#: The child's one-line result marker on stdout.
RESULT_MARK = "CELL_RESULT "

PLATFORMS = ("cuda", "cpu")


class Ledger:
    """Append-only JSONL journal, tolerant of a torn tail: a sweep killed
    mid-write leaves a truncated last line, which ``events()`` drops (the
    event it described did not complete either)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, **event) -> None:
        # A wall-clock stamp for people correlating the ledger with other
        # logs; never used for durations.
        event.setdefault("ts", round(clock.wall_ns() / 1e9, 3))
        line = json.dumps(event, sort_keys=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def events(self) -> list:
        if not os.path.isfile(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn tail from a killed writer
        return out


def completed_rows(events: list) -> dict:
    """cell_id -> (spec_hash, row, attempts) for every completed cell (the
    latest ``cell_done`` wins: a rerun after a spec change supersedes)."""
    done = {}
    for ev in events:
        if ev.get("event") == "cell_done" and "cell" in ev:
            done[ev["cell"]] = (ev.get("spec_hash", ""), ev.get("row", {}),
                                ev.get("attempts", 1))
    return done


def _journaled_attempt_seconds(events: list, cell_id: str,
                               spec_hash: str) -> float:
    """Wall seconds of earlier failed attempts of a cell at the current
    spec: each ``cell_start`` with ``spec_hash`` paired with the next
    ``cell_retry`` of the cell. Attempts of another spec trained another
    experiment and are left out; an attempt orphaned by a killed parent
    has no end event and is not counted (the end-to-end time is a floor,
    never an invention)."""
    total, start_ts = 0.0, None
    for e in events:
        if e.get("cell") != cell_id:
            continue
        if e.get("event") == "cell_start":
            start_ts = e.get("ts") if e.get("spec_hash") == spec_hash \
                else None
        elif e.get("event") == "cell_retry" and start_ts is not None:
            total += max(0.0, e.get("ts", start_ts) - start_ts)
            start_ts = None
    return total


def _journaled_attempt_count(events: list, cell_id: str,
                             spec_hash: str) -> int:
    """How many attempts of this cell at the current spec were ever
    journaled: the attempt numbering that makes a crash clause fire once
    per cell history, not once per invocation."""
    return sum(1 for e in events
               if e.get("event") == "cell_start"
               and e.get("cell") == cell_id
               and e.get("spec_hash") == spec_hash)


def cell_dirs(out_dir: str, cell_id: str) -> str:
    """The per-cell checkpoint directory (slashes in ids become subdirs)."""
    return os.path.join(out_dir, "cells", cell_id)


def _check_platform(platform: str) -> None:
    if platform not in PLATFORMS:
        raise ValueError(f"--platform must be one of {PLATFORMS}, got "
                         f"{platform!r}")


def _child_env(platform: str) -> dict:
    """The environment of a cell child: the repo on ``PYTHONPATH``; a CPU
    child runs two OpenMP threads (sweeps share a machine)."""
    env = dict(os.environ)
    if platform == "cpu":
        env["OMP_NUM_THREADS"] = "2"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_repo_root(), env.get("PYTHONPATH", "")) if p)
    return env


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _resume_step(train_dir: str) -> int:
    """The step this cell will resume from, for the journal: 0 with no
    checkpoint."""
    from ewdml_tpu_torch.train import checkpoint

    path = checkpoint.latest_path(train_dir)
    return 0 if path is None else checkpoint.peek_step(path)


def run_cell_child(table: str, cell_id: str, *, out_dir: str, data_dir: str,
                   smoke: bool, platform: str = "cuda", fault_spec: str = "",
                   cell_index: int = 0, attempt: int = 1,
                   health: str = "off") -> int:
    """The ``--run-cell`` entry: runs one cell in this process on
    ``platform`` and prints its row as the ``CELL_RESULT`` line. Runs in
    the child the parent spawned; tests may call it in process."""
    from ewdml_tpu_torch.data import datasets
    from ewdml_tpu_torch.experiments import collect
    from ewdml_tpu_torch.parallel.faults import CRASH_EXIT_CODE, FaultCrash

    _check_platform(platform)
    if platform == "cpu":
        import torch

        torch.set_num_threads(min(2, torch.get_num_threads()))
    # The child runs from the repo root: anchor relative paths first.
    out_dir, data_dir = os.path.abspath(out_dir), os.path.abspath(data_dir)
    spec = {c.cell_id: c for c in registry.table_cells(table)}[cell_id]
    faults = FaultSpec.parse(fault_spec).for_worker(cell_index)
    faults.sleep_if_due()  # delay clause: a straggling cell, every attempt

    cfg = spec.to_config(data_dir=data_dir,
                         train_dir=cell_dirs(out_dir, cell_id), smoke=smoke)
    # The sweep's --health applies to every cell (hash-excluded). A
    # nan@I=N clause for this cell poisons the trainer's observed loss at
    # step N (nan@0=N), on the first journaled attempt only: the abort
    # fires before the fence's checkpoint, so a re-armed clause would
    # abort every retry.
    cfg.health = health
    if faults.nan_at and attempt == 1:
        cfg.fault_spec = ",".join(f"nan@0={n}" for n in sorted(faults.nan_at))
    if os.environ.get("EWDML_TRACE_DIR"):
        # The sweep parent armed tracing: the cell traces into the shared
        # directory and collect.py measures the comm/comp split
        # (trace_dir is hash-excluded).
        cfg.trace_dir = os.environ["EWDML_TRACE_DIR"]
    # No synthetic data: a cache deleted between plan and run fails here.
    if not datasets.has_real(cfg.dataset, data_dir):
        raise FileNotFoundError(
            f"cell {cell_id}: {cfg.dataset!r} no longer loads as real data "
            f"under {data_dir!r}")

    target = None
    max_epochs = None
    if not smoke:
        pub = spec.published.get("top1_pct")
        target = None if pub is None else pub / 100.0
        max_epochs = spec.epoch_cap
    crash_at = faults.crash_at if attempt == 1 else None
    try:
        row = collect.run_cell(
            cfg, device=platform, evaluate=True, target_top1=target,
            max_epochs=max_epochs, budget_epochs=spec.epochs,
            per_epoch_eval=not smoke, crash_at=crash_at)
    except FaultCrash as e:
        print(f"CELL_FAULT_CRASH {cell_id} at step {e.step}", flush=True)
        return CRASH_EXIT_CODE
    except HealthAbort as e:
        print(f"CELL_HEALTH_ABORT {cell_id} kind={e.kind} step={e.step}",
              flush=True)
        return HEALTH_EXIT_CODE
    # What the trainer consumed must have been the real split.
    if row["data_source"] != "real":
        raise RuntimeError(f"cell {cell_id} trained on "
                           f"{row['data_source']!r} data")
    row["cell"] = cell_id
    row["stand_in"] = spec.resolve_dataset(data_dir)[1]
    row["attempt"] = attempt
    print(RESULT_MARK + json.dumps(row), flush=True)
    return 0


def _launch_cell(table: str, spec, *, index: int, out_dir: str, data_dir: str,
                 smoke: bool, platform: str, fault_spec: str, attempt: int,
                 timeout_s: float | None, env: dict, health: str = "off"):
    """One child attempt; returns ``(row | None, reason)``."""
    cmd = [sys.executable, "-m", "ewdml_tpu_torch.experiments",
           "--run-cell", spec.cell_id, "--table", table,
           "--out", out_dir, "--data-dir", data_dir,
           "--platform", platform,
           "--cell-index", str(index), "--attempt", str(attempt)]
    if smoke:
        cmd.append("--smoke")
    if fault_spec:
        cmd += ["--fault-spec", fault_spec]
    if health != "off":
        cmd += ["--health", health]
    try:
        proc = subprocess.run(cmd, cwd=_repo_root(), env=env,
                              timeout=timeout_s, capture_output=True,
                              text=True)
    except subprocess.TimeoutExpired as e:
        out = e.stdout or b""
        tail = (out if isinstance(out, str)
                else out.decode(errors="replace"))[-1500:]
        return None, f"timeout after {timeout_s:.0f}s; tail: {tail!r}"
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith(RESULT_MARK) and proc.returncode == 0:
            return json.loads(line[len(RESULT_MARK):]), "ok"
    tail = (proc.stdout + proc.stderr)[-1500:]
    if proc.returncode == HEALTH_EXIT_CODE:
        return None, f"health_abort rc={proc.returncode}; tail: {tail!r}"
    return None, f"rc={proc.returncode}; tail: {tail!r}"


def run_sweep(table: str, *, out_dir: str, data_dir: str = "data/",
              smoke: bool = False, platform: str = "cuda",
              budget_s: float = 0.0, cell_timeout_s: float = 0.0,
              attempts: int = 2, fault_spec: str = "",
              cells: list | None = None, write_report: bool = True,
              trace_dir: str | None = None, health: str = "off") -> dict:
    """Run (or resume) one table's sweep; returns a summary dict.

    ``budget_s`` (0 = unlimited) bounds the whole sweep's wall clock:
    cells that do not fit are journaled ``cell_budget_skipped``, the report
    renders partial, and the next invocation picks them up. ``cells``
    selects a subset by id; the others are reported pending, not failed.
    ``trace_dir`` (or an inherited ``EWDML_TRACE_DIR``) traces the sweep's
    cell lifecycle (role ``experiments-runner``) and every cell child (role
    ``cell:<id>``) into one directory, and makes each cell measure its
    comm/comp split."""
    _check_platform(platform)
    FaultSpec.parse(fault_spec)  # a malformed spec fails before any child
    # Children run from the repo root: anchor relative paths now, or the
    # ledger and the checkpoints would land in different trees.
    out_dir, data_dir = os.path.abspath(out_dir), os.path.abspath(data_dir)
    trace_dir = trace_dir or os.environ.get("EWDML_TRACE_DIR")
    if trace_dir:
        trace_dir = os.path.abspath(trace_dir)
        otrace.configure(trace_dir, role="experiments-runner")
    specs = registry.table_cells(table)
    wanted = ([s for s in specs if s.cell_id in set(cells)]
              if cells else specs)
    if cells and len(wanted) != len(set(cells)):
        known = [s.cell_id for s in specs]
        raise ValueError(f"unknown cell in {cells}; know {known}")
    ledger = Ledger(os.path.join(out_dir, "ledger.jsonl"))
    prior_events = ledger.events()
    done = completed_rows(prior_events)
    hashes = {s.cell_id: s.spec_hash(data_dir=data_dir, smoke=smoke)
              for s in specs}
    # The latest journaled start per cell: whose spec the checkpoints under
    # cells/<id>/ belong to.
    last_start_hash = {}
    for e in prior_events:
        if e.get("event") == "cell_start" and "cell" in e:
            last_start_hash[e["cell"]] = e.get("spec_hash")
    ledger.append(event="sweep_start", table=table, smoke=smoke,
                  platform=platform, budget_s=budget_s,
                  cells=[s.cell_id for s in wanted], fault_spec=fault_spec,
                  health=health)

    timeout = cell_timeout_s or (900.0 if smoke else None)
    env = _child_env(platform)
    if trace_dir:
        env["EWDML_TRACE_DIR"] = trace_dir
    otrace.instant("sweep/start", table=table, smoke=smoke)
    t0 = clock.monotonic()
    ran, skipped, failed, budget_skipped = [], [], [], []
    # Fault clauses address cells by their position in this sweep's run
    # list (crash@0=N is the first cell this invocation runs).
    for index, spec in enumerate(wanted):
        cid = spec.cell_id
        if cid in done and done[cid][0] == hashes[cid]:
            ledger.append(event="cell_skipped", cell=cid,
                          spec_hash=hashes[cid], reason="ledger hash match")
            skipped.append(cid)
            continue
        if budget_s:
            remaining = budget_s - (clock.monotonic() - t0)
            if remaining <= _MIN_LAUNCH_S:
                ledger.append(event="cell_budget_skipped", cell=cid)
                budget_skipped.append(cid)
                continue
        cell_dir = cell_dirs(out_dir, cid)
        if (os.path.isdir(cell_dir)
                and last_start_hash.get(cid) != hashes[cid]):
            # The checkpoints belong to another spec (a changed registry)
            # or to no journaled run: resuming from them would contaminate
            # the rerun, so the hash that invalidated the row clears them.
            shutil.rmtree(cell_dir)
            ledger.append(event="cell_artifacts_cleared", cell=cid,
                          stale_hash=last_start_hash.get(cid),
                          spec_hash=hashes[cid])
        base_attempt = _journaled_attempt_count(prior_events, cid,
                                                hashes[cid])
        row = None
        for attempt in range(base_attempt + 1,
                             base_attempt + attempts + 1):
            eff_timeout = timeout
            if budget_s:
                remaining = budget_s - (clock.monotonic() - t0)
                if remaining <= _MIN_LAUNCH_S:
                    break
                eff_timeout = (min(timeout, remaining) if timeout
                               else remaining)
            resume_step = _resume_step(cell_dirs(out_dir, cid))
            ledger.append(event="cell_start", cell=cid,
                          spec_hash=hashes[cid], attempt=attempt,
                          resume_step=resume_step)
            otrace.instant("cell/start", cell=cid, attempt=attempt)
            if resume_step:
                otrace.instant("cell/resume", cell=cid,
                               resume_step=resume_step)
            cell_env = env
            if trace_dir:
                cell_env = dict(env)
                cell_env["EWDML_TRACE_ROLE"] = f"cell:{cid}"
            row, reason = _launch_cell(
                table, spec, index=index, out_dir=out_dir, data_dir=data_dir,
                smoke=smoke, platform=platform, fault_spec=fault_spec,
                attempt=attempt, timeout_s=eff_timeout, env=cell_env,
                health=health)
            if row is not None:
                # End to end counts the work the retries threw away: the
                # journaled walls of earlier failed attempts of this spec.
                prior_s = _journaled_attempt_seconds(ledger.events(), cid,
                                                     hashes[cid])
                if prior_s > 0:
                    row["wall_s_all_attempts"] = round(
                        prior_s + row.get("wall_s", 0.0), 3)
                    if "end_to_end_min" in row.get("metrics", {}):
                        row["metrics"]["end_to_end_min"] = round(
                            row["wall_s_all_attempts"] / 60.0, 4)
                ledger.append(event="cell_done", cell=cid,
                              spec_hash=hashes[cid], attempts=attempt,
                              row=row)
                otrace.instant("cell/done", cell=cid, attempts=attempt)
                done[cid] = (hashes[cid], row, attempt)
                ran.append(cid)
                break
            ledger.append(event="cell_retry", cell=cid, attempt=attempt,
                          reason=reason[:2000],
                          resume_step=_resume_step(cell_dirs(out_dir, cid)))
            otrace.instant("cell/retry", cell=cid, attempt=attempt,
                           reason=reason[:120])
        else:
            ledger.append(event="cell_failed", cell=cid,
                          attempts=attempts)
            otrace.instant("cell/failed", cell=cid)
            failed.append(cid)
        if row is None and cid not in failed and cid not in ran:
            # the budget ran out between attempts
            budget_skipped.append(cid)
            ledger.append(event="cell_budget_skipped", cell=cid)

    summary = {
        "table": table, "out_dir": out_dir, "smoke": smoke,
        "platform": platform,
        "ran": ran, "resumed_skipped": skipped, "failed": failed,
        "budget_skipped": budget_skipped,
        "done_total": sum(1 for c in done
                          if done[c][0] == hashes.get(c)),
        "cells_total": len(specs),
        "wall_s": round(clock.monotonic() - t0, 1),
    }
    ledger.append(event="sweep_end", **{k: v for k, v in summary.items()
                                        if k != "out_dir"})
    otrace.instant("sweep/end", ran=len(ran), failed=len(failed))
    otrace.flush()
    if write_report:
        from ewdml_tpu_torch.experiments import report

        rows = {c: done[c][1] for c in done if done[c][0] == hashes.get(c)}
        attempts_by_cell = {c: done[c][2] for c in rows}
        md, js = report.write_report(
            table, specs, rows, out_dir=out_dir, smoke=smoke,
            attempts=attempts_by_cell, summary=summary)
        summary["repro_md"] = md
        summary["repro_json"] = js
    return summary
