"""The paper's experiment matrix, Methods 1-6 in one run
(``examples/experiment_matrix.py`` of the JAX package): the same model
under each method, then the comparison table (wire bytes a step, final
loss and top-1, step time, compression against Method 1).

A thin wrapper: each method runs through ``experiments/collect.run_cell``,
the code every cell of ``python -m ewdml_tpu_torch.experiments`` runs, so
the two cannot drift. What stays here is the ad-hoc parameterization (any
network, dataset and step budget, synthetic data allowed) and the compact
table; the published tables, with their ledger and resume, are the
experiments driver's.

    python -m ewdml_tpu_torch.examples.experiment_matrix --network LeNet \\
        --dataset MNIST --max-steps 30
    python -m ewdml_tpu_torch.examples.experiment_matrix --platform cpu \\
        --dataset mnist10k --real-data --epochs 20 --num-workers 4

Runs on the card unless ``--platform cpu`` is given. ``--num-workers``
sets the emulated workers (default: one per visible device).
"""

from __future__ import annotations

import argparse
import logging
import sys


def rows(ns) -> list:
    """``[(label, run_cell row)]`` for each method (and its error-feedback
    variant under ``--ef-variants``) of the parsed flags ``ns``."""
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.experiments import collect

    if ns.real_data:
        from ewdml_tpu_torch.data import datasets

        probe = datasets.load(ns.dataset, ns.data_dir, train=True)
        if probe.source != "real":
            raise SystemExit(
                f"--real-data: no on-disk files for {ns.dataset!r} under "
                f"{ns.data_dir!r}")
    if ns.target_top1 is not None and not ns.real_data:
        raise SystemExit("--target-top1 needs --real-data (the oracle is "
                         "test accuracy on the real held-out split)")
    variants = [(m, False) for m in ns.methods]
    if ns.ef_variants:
        variants += [(m, True) for m in (5, 6)]
    out = []
    for method, ef in variants:
        label = f"{method}+EF" if ef else str(method)
        cfg = TrainConfig(
            network=ns.network, dataset=ns.dataset, batch_size=ns.batch_size,
            lr=ns.lr, method=method, quantum_num=127, error_feedback=ef,
            synthetic_data=not ns.real_data, data_dir=ns.data_dir,
            # Both caps hold; an unset --max-steps is 30 standalone, or
            # "epochs only" when --epochs is given.
            max_steps=ns.max_steps if ns.max_steps is not None
            else (10**9 if ns.epochs < 10**6 else 30),
            epochs=10**6 if ns.target_top1 is not None else ns.epochs,
            eval_freq=0, log_every=10**9, bf16_compute=False,
            seed=ns.seed, feed=ns.feed, num_workers=ns.num_workers,
            platform=ns.platform)
        if ns.topk_ratio is not None and method in (5, 6):
            cfg.topk_ratio = ns.topk_ratio  # after the preset's 0.5
        # resume=False: this script trains from scratch (eval_freq=0 writes
        # no checkpoint either).
        row = collect.run_cell(
            cfg, evaluate=ns.real_data, target_top1=ns.target_top1,
            max_epochs=ns.max_epochs if ns.target_top1 is not None else None,
            resume=False)
        out.append((label, row))
        line = (f"method {label}: loss={row['final_loss']} "
                f"top1={row['train_top1']} "
                f"wire/step={row['wire_mb_per_step_worker']:.4f} MB "
                f"step={row['mean_step_ms']:.1f} ms")
        if row["eval"] is not None:
            line += (f" | test top1={row['eval']['top1']:.3f} "
                     f"({row['eval']['examples']} real)")
        if ns.target_top1 is not None:
            ept = row["epochs_to_target"]
            line += (f" | epochs-to-{ns.target_top1:.0%}="
                     f"{ept if ept else f'>{ns.max_epochs}'}")
        print(line, flush=True)
    return out


def print_table(ns, rows_) -> None:
    base = next((r for m, r in rows_ if m == "1"), rows_[0][1])
    test_col = " test top-1 |" if ns.real_data else ""
    ep_col = " epochs-to-target |" if ns.target_top1 is not None else ""
    print(f"\n| Method | wire MB/step | vs M1 | final loss | top-1 |"
          f"{test_col}{ep_col} ms/step |")
    print("|---|---|---|---|---|" + ("---|" if ns.real_data else "")
          + ("---|" if ns.target_top1 is not None else "") + "---|")
    for label, r in rows_:
        ratio = (base["wire_mb_per_step_worker"]
                 / max(1e-9, r["wire_mb_per_step_worker"]))
        tc = f" {r['eval']['top1']:.3f} |" if r["eval"] is not None else ""
        ec = ""
        if ns.target_top1 is not None:
            ept = r["epochs_to_target"]
            ec = f" {ept if ept else f'>{ns.max_epochs}'} |"
        print(f"| {label} | {r['wire_mb_per_step_worker']:.4f} | "
              f"{ratio:.1f}x | {r['final_loss']} | {r['train_top1']} |{tc}"
              f"{ec} {r['mean_step_ms']:.1f} |", flush=True)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="LeNet")
    p.add_argument("--dataset", default="MNIST")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--max-steps", type=int, default=None,
                   help="step cap (default 30, or unlimited with --epochs)")
    p.add_argument("--epochs", type=int, default=10**6)
    p.add_argument("--platform", default=None)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--real-data", action="store_true",
                   help="train and evaluate on the on-disk split; error if "
                        "absent")
    p.add_argument("--data-dir", default="data/")
    p.add_argument("--methods", type=int, nargs="*",
                   default=[1, 2, 3, 4, 5, 6])
    p.add_argument("--topk-ratio", type=float, default=None,
                   help="override the Method 5/6 preset's Top-k keep ratio "
                        "(the presets use the paper's 0.5)")
    p.add_argument("--target-top1", type=float, default=None,
                   help="train epoch by epoch until test top-1 reaches "
                        "this target (needs --real-data)")
    p.add_argument("--max-epochs", type=int, default=40,
                   help="epoch cap for --target-top1")
    p.add_argument("--ef-variants", action="store_true",
                   help="also run methods 5 and 6 with --error-feedback")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--feed", default="u8", choices=["u8", "f32", "device"])
    return p


def main(argv=None) -> int:
    ns = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    print_table(ns, rows(ns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
