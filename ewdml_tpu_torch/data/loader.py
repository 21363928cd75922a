"""Batch iteration with per-worker sharding (``ewdml_tpu/data/loader.py``).

Each global batch is laid out so that splitting its leading dimension into
W equal parts gives every worker a distinct shard. The index stream is the
JAX package's for the same seed, so both packages train on the same
batches. ``redundant_batches=True`` reproduces the reference's behaviour
(every worker draws an independently shuffled batch).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ewdml_tpu_torch.data.augment import augment_batch
from ewdml_tpu_torch.data.datasets import Dataset


def global_batches(
    ds: Dataset,
    per_worker_batch: int,
    num_workers: int,
    seed: int = 0,
    redundant_batches: bool = False,
    drop_last: bool = True,
    feed: str = "f32",
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (images, labels) with leading dim = per_worker_batch * num_workers.

    ``feed='u8'`` yields raw uint8 pixels when the dataset carries them (the
    step normalizes on the device); otherwise normalized f32."""
    rng = np.random.RandomState(seed)
    use_raw = feed == "u8" and ds.raw is not None
    global_batch = per_worker_batch * num_workers
    while True:  # epoch loop; the caller bounds total steps
        if redundant_batches:
            orders = [rng.permutation(len(ds)) for _ in range(num_workers)]
            steps = len(ds) // per_worker_batch
            for s in range(steps):
                idx = np.concatenate([
                    o[s * per_worker_batch:(s + 1) * per_worker_batch]
                    for o in orders
                ])
                yield _materialize(ds, idx, rng, use_raw)
        else:
            order = rng.permutation(len(ds))
            if not drop_last and len(order) % global_batch:
                steps = -(-len(order) // global_batch)
                order = np.resize(order, steps * global_batch)
            steps = len(order) // global_batch
            for s in range(steps):
                idx = order[s * global_batch:(s + 1) * global_batch]
                yield _materialize(ds, idx, rng, use_raw)


def _materialize(ds: Dataset, idx: np.ndarray, rng,
                 use_raw: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    images = (ds.raw if use_raw else ds.images)[idx]
    if ds.augment:
        images = augment_batch(rng, images)
    return images, ds.labels[idx]


def eval_batches(ds: Dataset, batch: int):
    """Fixed-order full pass for evaluation; the final partial batch is
    padded and masked."""
    n = len(ds)
    for s in range(0, n, batch):
        images = ds.images[s:s + batch]
        labels = ds.labels[s:s + batch]
        valid = len(images)
        if valid < batch:
            pad = batch - valid
            images = np.concatenate([images, np.zeros((pad,) + images.shape[1:],
                                                      images.dtype)])
            labels = np.concatenate([labels, np.zeros((pad,), labels.dtype)])
        mask = np.arange(batch) < valid
        yield images, labels, mask
