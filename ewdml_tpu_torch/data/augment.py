"""Train-time augmentation: pad-4 reflect -> random crop -> horizontal flip
(reference ``util.py:37-47``; ``ewdml_tpu/data/augment.py``), vectorized
over the whole global batch in numpy on the host. The same draws from the
same ``RandomState`` give the same crops and flips as the JAX package."""

from __future__ import annotations

import numpy as np


def augment_batch(rng: np.random.RandomState, images: np.ndarray) -> np.ndarray:
    """images: [B, H, W, C], normalized float32 or raw uint8."""
    b, h, w, c = images.shape
    ys = rng.randint(0, 9, size=b)
    xs = rng.randint(0, 9, size=b)
    flips = rng.rand(b) < 0.5
    padded = np.pad(images, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    # [B, 9, 9, C, H, W] view of all crop positions; one gather picks each
    # image's crop.
    windows = np.lib.stride_tricks.sliding_window_view(padded, (h, w), axis=(1, 2))
    crops = windows[np.arange(b), ys, xs]          # [B, C, H, W]
    crops = np.moveaxis(crops, 1, -1)              # [B, H, W, C]
    flipped = crops[:, :, ::-1]
    return np.where(flips[:, None, None, None], flipped, crops).astype(images.dtype)
