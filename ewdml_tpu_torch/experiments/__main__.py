"""``python -m ewdml_tpu_torch.experiments``: the one-command table sweep.

    # the paper's table on the card (resumable: invoke again to continue)
    python -m ewdml_tpu_torch.experiments --table baseline

    # the sweep's mechanism at tiny budgets (all 12 cells), on the CPU
    python -m ewdml_tpu_torch.experiments --table baseline --smoke \\
        --platform cpu

Outputs land in ``--out`` (default ``output/repro/<table>/``, or
``<table>-smoke``): ``REPRO.md``, ``REPRO.json``, ``ledger.jsonl`` and
each cell's checkpoints under ``cells/``. Also reachable as
``python -m ewdml_tpu_torch.cli repro ...``.

``--run-cell`` is the per-cell child entry the runner spawns (one process
per cell, each under its own timeout); it runs a single cell by hand for
debugging.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ewdml_tpu_torch.experiments", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--table", default="baseline",
                   help="registry table name (registry.TABLES)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny per-cell budgets; the sweep's ledger, resume "
                        "and watchdog are the full table's")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="where each cell trains: the GPU (default; a cell "
                        "with no GPU raises) or the CPU")
    p.add_argument("--out", default=None,
                   help="output dir (default output/repro/<table>, or "
                        "output/repro/<table>-smoke under --smoke: the two "
                        "modes must not share a ledger)")
    p.add_argument("--data-dir", default="data/")
    p.add_argument("--budget-s", type=float, default=0.0,
                   help="whole-sweep wall-clock budget; 0 = unlimited. "
                        "Cells that do not fit are journaled and run at the "
                        "next invocation")
    p.add_argument("--cell-timeout-s", type=float, default=0.0,
                   help="per-cell child watchdog; 0 = 900 under --smoke, "
                        "unlimited otherwise")
    p.add_argument("--attempts", type=int, default=2,
                   help="attempts per cell (each retry resumes from the "
                        "cell's checkpoint)")
    p.add_argument("--fault-spec", default="",
                   help="injection, clause worker = cell index in the run "
                        "list: delay@I=S (a straggling cell), crash@I=N "
                        "(the child dies at step N), nan@I=N (the watchdog "
                        "observes a NaN loss at step N), the last two on "
                        "the first journaled attempt only; "
                        "parallel/faults.py grammar")
    p.add_argument("--cells", nargs="*", default=None,
                   help="subset of cell ids (e.g. lenet_mnist/m1); the "
                        "others stay pending")
    p.add_argument("--health", default="off",
                   choices=["off", "warn", "abort"],
                   help="the run-health watchdog in every cell child; "
                        "an abort exits 76, journaled as a retry")
    p.add_argument("--trace-dir", default=None,
                   help="trace the sweep and every cell child into this "
                        "dir; also switches the comm/comp split from the "
                        "bytes estimate to the measured probe")
    # the child protocol (spawned by runner._launch_cell)
    p.add_argument("--run-cell", default=None, help=argparse.SUPPRESS)
    p.add_argument("--cell-index", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--attempt", type=int, default=1, help=argparse.SUPPRESS)
    ns = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    out_dir = ns.out or (f"output/repro/{ns.table}-smoke" if ns.smoke
                         else f"output/repro/{ns.table}")

    from ewdml_tpu_torch.experiments import runner

    if ns.run_cell:
        if ns.trace_dir:  # a single cell driven by hand
            import os

            os.environ["EWDML_TRACE_DIR"] = os.path.abspath(ns.trace_dir)
        return runner.run_cell_child(
            ns.table, ns.run_cell, out_dir=out_dir, data_dir=ns.data_dir,
            smoke=ns.smoke, platform=ns.platform, fault_spec=ns.fault_spec,
            cell_index=ns.cell_index, attempt=ns.attempt, health=ns.health)

    summary = runner.run_sweep(
        ns.table, out_dir=out_dir, data_dir=ns.data_dir, smoke=ns.smoke,
        platform=ns.platform, budget_s=ns.budget_s,
        cell_timeout_s=ns.cell_timeout_s, attempts=ns.attempts,
        fault_spec=ns.fault_spec, cells=ns.cells, trace_dir=ns.trace_dir,
        health=ns.health)
    print(json.dumps(summary))
    done, total = summary["done_total"], summary["cells_total"]
    print(f"repro sweep {ns.table}: {done}/{total} cells done "
          f"(+{len(summary['resumed_skipped'])} resumed-skipped this "
          f"invocation); report: {summary.get('repro_md')}")
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
