#!/usr/bin/env python3
"""Time the paths the port's threefry draws lie on, for one checkout or
several in turns on one card.

    python3 scripts/threefry_paths.py [--root DIR ...] [--rounds N]

Each ``--root`` is a checkout of the repository (default: this one). In
each round every root runs once, in the given order on even rounds and in
reverse on odd ones (so two roots run A, B, B, A), each as a child process
``python3 scripts/threefry_paths.py --child DIR`` that imports that
checkout's package and ``chip_smoke.py``, builds its kernels and measures,
in its own code:

- the async server's delta step and apply alone, no worker threads
  (``chip_smoke.apply_alone`` under ``chip_smoke.DELTA_FLAGS``: QSGD block
  4096, ``--ps-down delta``), VGG11-BN and ResNet50, ms an update;
- the reproduction driver's LeNet cells M1, M2, M4 and M5 (table
  ``baseline``, the full config: W = 2, batch 64, ``mnist10k``) for their
  first ``CELL_STEPS`` steps through ``experiments.collect.run_cell``,
  mean ms a step;
- VGG11-BN M1 per step and windowed (K = 8, 24 steps, ``--feed device``,
  deterministic kernels: ``chip_smoke.window_phase``), ms a step.

With ``--store`` a child measures the store kernel alone instead: at
512x512x3x3 and as a vector of as many elements, and VGG11-BN's 38-leaf
SGD set, each the median event time of single launches (L2 flushed) and
the kernel's own time from a trace (``chip_smoke.Timer``).

Each child prints one ``paths {json}`` line; the parent prints them again,
then the card's name and power limit (nvidia-smi). Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENET_CELLS = ("lenet_mnist/m1", "lenet_mnist/m2", "lenet_mnist/m4",
               "lenet_mnist/m5")
CELL_STEPS = 200


def child(root: str) -> dict:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from ewdml_tpu_torch.experiments import collect, registry
    from ewdml_tpu_torch.kernels import library
    from ewdml_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise SystemExit("threefry_paths: no CUDA device visible")
    library()
    out = {"root": root, "delta": {}, "cells": {}}
    for network in ("VGG11", "ResNet50"):
        stats = cs.apply_alone(torch, cs.DELTA_FLAGS, network)
        out["delta"][network] = dict(delta_ms=stats.delta_ms_mean,
                                     apply_ms=stats.apply_ms_mean)
    specs = {c.cell_id: c for c in registry.table_cells("baseline")}
    with tempfile.TemporaryDirectory() as tmp:
        for cell in LENET_CELLS:
            cfg = specs[cell].to_config(
                data_dir=os.path.join(root, "data/"),
                train_dir=os.path.join(tmp, cell), smoke=False)
            cfg.max_steps = CELL_STEPS
            row = collect.run_cell(cfg, device="cuda", evaluate=False)
            out["cells"][cell] = row["mean_step_ms"]
    _, windows = cs.window_phase(torch, kernels, [
        ("M1", "VGG11", 24, 8, ["--method", "1"])])
    w = windows["VGG11 M1"]
    out["window"] = dict(per_step_ms=w["per_step_ms"],
                         window_ms=w["window_ms"])
    return out


def store(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from ewdml_tpu_torch.kernels import library
    from ewdml_tpu_torch.ops import kernels

    library()
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(60)
    names = cs.KERNEL_NAMES["stochastic_round"]
    out = {"root": root}
    for kind, shape in (("conv", cs.SROUND_SHAPE),
                        ("vector", (2_359_296,))):
        x = torch.randn(shape, device="cuda", generator=g)
        o = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        fn = lambda: kernels.stochastic_round_bf16(x, (3, 4), kind, out=o)
        out[kind] = dict(ms=timer(fn), device_ms=timer.device(fn, names))
    xs, kinds, paths = cs.store_sets(torch, "VGG11", g)["sgd"]
    fn = lambda: kernels.stochastic_round_set((3, 4), xs, paths, kinds)
    out["set"] = dict(ms=timer(fn), device_ms=timer.device(fn, names))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", default=None,
                        help="a checkout to measure (repeatable)")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--store", action="store_true",
                        help="time the store kernel alone")
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        run = store if args.store else child
        print("paths " + json.dumps(run(os.path.abspath(args.child))),
              flush=True)
        return 0
    roots = [os.path.abspath(r) for r in (args.root or [HERE])]
    lines = []
    for r in range(args.rounds):
        for root in (roots if r % 2 == 0 else roots[::-1]):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root]
                + (["--store"] if args.store else []),
                cwd=root, capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
                return proc.returncode
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("paths ")][-1]
            lines.append(line)
            print(line, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
