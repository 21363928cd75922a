"""Horovod-style training script (``examples/horovod_style.py``): the
reference's ``horvod_pytorch.py:119-205`` (init, lr × size, broadcast,
``DistributedOptimizer`` with QSGD compression) and ``tensorflow_mnist.py``
(the Keras callback set), line for line, on the port.

    python -m ewdml_tpu_torch.examples.horovod_style --epochs 2
    python -m ewdml_tpu_torch.examples.horovod_style --platform cpu \\
        --num-workers 8 --epochs 2

The JAX script's flags, plus ``--num-workers`` (W emulated workers; the
JAX script takes W from its mesh) and ``--dataset`` with
``--no-synthetic`` (the real split under ``--data-dir``, e.g. the
committed ``mnist10k``; it refuses to fall back to synthetic data; by
default the synthetic MNIST split of the JAX script). Runs on the card
unless ``--platform cpu`` is given; writes ``./checkpoint-<epoch>.npz``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--platform", default=None)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--dataset", default="MNIST")
    p.add_argument("--synthetic", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--data-dir", default="data/")
    ns = p.parse_args(argv)

    import ewdml_tpu_torch.hvd as hvd
    from ewdml_tpu_torch.data import datasets
    from ewdml_tpu_torch.hvd import keras as K
    from ewdml_tpu_torch.models import build_model, input_shape_for
    from ewdml_tpu_torch.optim import SGD

    hvd.init(ns.num_workers, platform=ns.platform)   # horvod_pytorch.py:125
    print(f"world size: {hvd.size()}, rank: {hvd.rank()}")

    train = datasets.load(ns.dataset, ns.data_dir, train=True,
                          synthetic=ns.synthetic, synthetic_size=1024,
                          require_real=not ns.synthetic)
    test = datasets.load(ns.dataset, ns.data_dir, train=False,
                         synthetic=ns.synthetic, synthetic_size=256,
                         require_real=not ns.synthetic)

    model = K.Model(build_model("LeNet", 10), input_shape_for(ns.dataset))
    # lr x size + compressed DistributedOptimizer (horvod_pytorch.py:173,197).
    model.compile(SGD(ns.lr, momentum=0.9),
                  compression=hvd.Compression.qsgd(quantum_num=127),
                  scale_lr=True)
    history = model.fit(
        train.images, train.labels,
        batch_size=ns.batch_size, epochs=ns.epochs,
        callbacks=[
            K.BroadcastGlobalVariablesCallback(0),   # tensorflow_mnist.py:55
            K.MetricAverageCallback(),               # :62
            K.LearningRateWarmupCallback(warmup_epochs=min(3, ns.epochs)),
            K.ModelCheckpoint("./checkpoint-{epoch}.npz"),  # :71 (rank 0)
        ],
    )
    print("loss history:", [round(v, 4) for v in history.history["loss"]])
    print("eval:", model.evaluate(test.images, test.labels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
