#!/usr/bin/env python3
"""The homomorphic server apply alone, for one checkout or several in
turns on one card.

    python3 scripts/decode_apply.py [--root DIR ...] [--rounds N] [--applies A]

Each ``--root`` is a checkout of the repository (default: this one). In
each round every root runs once, in the given order on even rounds and in
reverse on odd ones (so two roots run A, B, B, A), each as a child process
``python3 scripts/decode_apply.py --child DIR`` that imports that
checkout's package and ``chip_smoke.py``, builds its kernels and runs
``chip_smoke.apply_alone`` (the server's apply with no worker threads: K =
4 pushes of one gradient's payloads a round, ``--fusion none``) for
``--applies`` rounds under ``--server-agg homomorphic``: QSGD on VGG11-BN
and on ResNet50, and Top-k QSGD at 1% on VGG11-BN. It reports the server's
``apply_ms_mean`` and the ``int_accumulate`` and ``acc_decode`` launches
of the rounds and the warm apply.

Each child prints one ``apply {json}`` line; the parent prints them again,
then the card's name and power limit (nvidia-smi). Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = (("VGG11", "qsgd", ["--compress-grad", "qsgd",
                           "--server-agg", "homomorphic"]),
        ("ResNet50", "qsgd", ["--compress-grad", "qsgd",
                              "--server-agg", "homomorphic"]),
        ("VGG11", "topk_qsgd", ["--compress-grad", "topk_qsgd",
                                "--topk-ratio", "0.01",
                                "--server-agg", "homomorphic"]))


def child(root: str, applies: int) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from ewdml_tpu_torch.kernels import library
    from ewdml_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise SystemExit("decode_apply: no CUDA device visible")
    library()
    out = {"root": root}
    for network, name, flags in RUNS:
        kernels.reset_launches()
        stats = cs.apply_alone(torch, flags, network, rounds=applies)
        torch.cuda.synchronize()
        out[f"{network} {name}"] = dict(
            apply_ms=stats.apply_ms_mean, updates=stats.updates,
            acc_decode=kernels.LAUNCHES["acc_decode"],
            int_accumulate=kernels.LAUNCHES["int_accumulate"])
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", default=None,
                        help="a checkout to measure (repeatable)")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--applies", type=int, default=20)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        print("apply " + json.dumps(child(os.path.abspath(args.child),
                                          args.applies)), flush=True)
        return 0
    roots = [os.path.abspath(r) for r in (args.root or [HERE])]
    for r in range(args.rounds):
        for root in (roots if r % 2 == 0 else roots[::-1]):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root,
                 "--applies", str(args.applies)],
                cwd=root, capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
                return proc.returncode
            print([ln for ln in proc.stdout.splitlines()
                   if ln.startswith("apply ")][-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
