"""Deep-model convergence on real pixels: VGG11 and ResNet18 on
``mnist10k32`` (``examples/deep_real_pixels.py`` of the JAX package).

The paper's deep-model rows are VGG11 on CIFAR-10, which the repository
does not hold. The closest stand-in is the committed real MNIST test
split zero-padded from 28 to 32 pixels (``mnist10k32``), through the same
32x32 conv stacks: BatchNorm under data parallelism (per-worker
statistics), the dropout streams and the compressed relay on real data.
Methods 1 and 4, and Method 5 at a 1% ratio with and without error
feedback (the accuracy cost that error feedback exists to repair), on
each network; then a table of wire bytes, test top-1 and step time.

    python -m ewdml_tpu_torch.examples.deep_real_pixels --epochs 20
    python -m ewdml_tpu_torch.examples.deep_real_pixels --platform cpu \\
        --num-workers 2 --max-steps 2 --only VGG11/M1

Runs on the card unless ``--platform cpu`` is given. ``--num-workers``
sets the emulated workers (default 8, the JAX script's CPU mesh).
"""

from __future__ import annotations

import argparse
import sys

CONFIGS = [
    # (label, network, overrides)
    ("VGG11/M1", "VGG11", dict(method=1)),
    ("VGG11/M4", "VGG11", dict(method=4)),
    ("VGG11/M5+EF@1%", "VGG11",
     dict(method=5, topk_ratio=0.01, error_feedback=True)),
    ("VGG11/M5@1%", "VGG11", dict(method=5, topk_ratio=0.01)),
    ("ResNet18/M1", "ResNet18", dict(method=1)),
    ("ResNet18/M4", "ResNet18", dict(method=4)),
    ("ResNet18/M5+EF@1%", "ResNet18",
     dict(method=5, topk_ratio=0.01, error_feedback=True)),
    ("ResNet18/M5@1%", "ResNet18", dict(method=5, topk_ratio=0.01)),
]


def rows(ns) -> list:
    """``[(label, TrainResult, eval dict)]`` for the configs ``--only``
    selects."""
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.data import datasets
    from ewdml_tpu_torch.train.loop import Trainer

    probe = datasets.load("mnist10k32", ns.data_dir, train=True)
    if probe.source != "real":
        raise SystemExit("mnist10k32 real data not found under "
                         f"{ns.data_dir!r} (data/mnist_data must exist)")
    out = []
    for label, network, overrides in CONFIGS:
        if ns.only and not any(s in label for s in ns.only):
            continue
        cfg = TrainConfig(
            network=network, dataset="mnist10k32", batch_size=ns.batch_size,
            lr=ns.lr, quantum_num=127, synthetic_data=False,
            data_dir=ns.data_dir, max_steps=ns.max_steps, epochs=ns.epochs,
            eval_freq=0, log_every=10**9, bf16_compute=False,
            num_workers=ns.num_workers, platform=ns.platform, **overrides)
        trainer = Trainer(cfg)
        try:
            result = trainer.train()
            ev = trainer.evaluate()
        finally:
            trainer.close()
        out.append((label, result, ev))
        print(f"{label}: loss={result.final_loss:.4f} "
              f"train_top1={result.final_top1:.3f} "
              f"test_top1={ev['top1']:.4f} ({ev['examples']} real) "
              f"wire/step={result.wire.per_step_bytes / 1e6:.4f} MB "
              f"step={result.mean_step_s * 1e3:.0f} ms", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch-size", type=int, default=16,
                   help="per-worker batch (global = batch x workers)")
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--max-steps", type=int, default=10**9,
                   help="step cap (default: the epochs alone)")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--platform", default=None)
    p.add_argument("--data-dir", default="data/")
    p.add_argument("--only", nargs="*", default=None,
                   help="substring filter on config labels")
    ns = p.parse_args(argv)

    out = rows(ns)
    print("\n| config | wire MB/step | test top-1 (real) | ms/step |")
    print("|---|---|---|---|")
    for label, r, ev in out:
        print(f"| {label} | {r.wire.per_step_bytes / 1e6:.4f} | "
              f"{ev['top1']:.4f} | {r.mean_step_s * 1e3:.0f} |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
