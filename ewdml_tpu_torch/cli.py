"""CLI entry (``ewdml_tpu/cli.py``), the sync training path.

    python -m ewdml_tpu_torch.cli --network VGG11 --dataset Cifar10 \\
        --synthetic-data --num-workers 4 --method 5 --topk-ratio 0.01 \\
        --max-steps 5

runs on the GPU (``--platform cpu`` runs on the CPU). The flags are the JAX
package's; ``--mode async`` and ``--federated`` are later slices.
"""

from __future__ import annotations

import logging
import sys

from ewdml_tpu_torch.core.config import from_args
from ewdml_tpu_torch.train.loop import Trainer


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    cfg = from_args(argv)
    trainer = Trainer(cfg)
    result = trainer.train()
    print(
        f"done: steps={result.steps} loss={result.final_loss:.4f} "
        f"top1={result.final_top1:.4f} step_time={result.mean_step_s * 1e3:.2f}ms "
        f"wire_per_step={result.wire.per_step_bytes / 1e6:.4f}MB"
    )
    ev = trainer.evaluate()
    print(f"eval: loss={ev['loss']:.4f} top1={ev['top1']:.4f} top5={ev['top5']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
