"""The paper's negative result, reproduced on demand
(``examples/weight_compression_negative.py`` of the JAX package).

``Final Report.pdf`` p.5 (Method 2): compressing the server's *weight*
broadcast with lossy QSGD prevents convergence, the finding that moved the
paper to gradient-only compression (Method 3 on). QSGD's per-element error
is about ``||X||_2 / s``, and for an n-element tensor of like-sized entries
``||X||_2 ~ sqrt(n) |x|``: the noise is ``sqrt(n)/s`` times the signal.
Gradients tolerate it (zero-mean noise, averaged over workers and steps);
weights do not, since every worker adopts the noisy weights each step and
the noise floor never decays. At VGG11 width (a 9.4M-element fc,
``sqrt(n)/s ~ 24``) training diverges; at LeNet width (400k, ``~5``) it only
degrades.

Two runs of the same config: the lossy weight broadcast (``--ps-mode
weights --lossy-weights-down``) and Method 2 (the same quantizer on the
gradients). The JAX script's setting is the default here: VGG11, 2 workers,
batch 8, lr 0.01, 40 steps, s = 127, synthetic CIFAR-10.

    python -m ewdml_tpu_torch.examples.weight_compression_negative
    python -m ewdml_tpu_torch.examples.weight_compression_negative \\
        --platform cpu --network LeNet --dataset mnist10k --max-steps 5

Runs on the card unless ``--platform cpu`` is given. Exits 0 when the
lossy run diverges (its last finite loss above 5x Method 2's final loss),
1 when the result is inconclusive at this scale. The JAX script compares
the final losses; a lossy run that overflows to NaN is judged here by the
last finite loss on its curve, and one with no finite loss on its curve
reads as inconclusive.
"""

from __future__ import annotations

import argparse
import math
import sys


def compare(ns) -> list:
    """Train both runs of ``ns`` (the parsed flags); returns
    ``[(label, TrainResult)]``, the lossy weight broadcast first."""
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.train.loop import Trainer

    experiments = [
        # The failed first attempt: the server broadcasts dec(compress(W)).
        ("lossy-weights-down",
         dict(compress_grad="qsgd", ps_mode="weights", relay_compress=True,
              lossy_weights_down=True)),
        # The published Method 2: the same quantizer, gradients only.
        ("method2-grads", dict(method=2)),
    ]
    rows = []
    for label, kw in experiments:
        cfg = TrainConfig(
            network=ns.network, dataset=ns.dataset, batch_size=ns.batch_size,
            lr=ns.lr, synthetic_data=not ns.real_data,
            max_steps=ns.max_steps, epochs=10**6, eval_freq=0,
            log_every=max(1, ns.max_steps // 5), bf16_compute=False,
            num_workers=ns.num_workers, quantum_num=127,
            platform=ns.platform, **kw)
        trainer = Trainer(cfg)
        try:
            r = trainer.train()
        finally:
            trainer.close()
        curve = " ".join(f"{loss:.2f}" for _, loss, _ in r.history)
        print(f"{label}: final={r.final_loss:.3f} top1={r.final_top1:.3f} "
              f"last_finite={last_finite(r):.3f} curve: {curve}", flush=True)
        rows.append((label, r))
    return rows


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="VGG11")
    p.add_argument("--dataset", default="Cifar10")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--max-steps", type=int, default=40)
    p.add_argument("--num-workers", type=int, default=2)
    p.add_argument("--platform", default=None)
    p.add_argument("--real-data", action="store_true")
    return p


def last_finite(result) -> float:
    """The run's final loss, or, where that is not finite, the last finite
    loss on its curve (NaN when there is none)."""
    for loss in [result.final_loss] + [v for _, v, _ in result.history[::-1]]:
        if math.isfinite(loss):
            return loss
    return math.nan


def diverged(lossy: float, grads: float) -> bool:
    """The verdict on the lossy run's last finite loss and Method 2's final
    loss: the first above 5x the second (a NaN is never above)."""
    return lossy > 5 * max(0.01, grads)


def main(argv=None) -> int:
    rows = compare(parser().parse_args(argv))
    lossy, grads = rows[0][1], rows[1][1]
    print()
    if diverged(last_finite(lossy), grads.final_loss):
        print("NEGATIVE RESULT REPRODUCED: weight compression "
              f"fails ({last_finite(lossy):.2f}) while the same quantizer on "
              f"gradients converges ({grads.final_loss:.2f}).", flush=True)
        return 0
    print("inconclusive at this scale: at small n the sqrt(n)/s noise "
          "ratio only degrades accuracy; use --network VGG11", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
