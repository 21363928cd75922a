"""Repeated-window timing with dispersion (``ewdml_tpu/utils/timing.py``).

A number of record is N timed windows, reported as median and IQR; two
configurations compared are timed in interleaved windows in one run.
A window ends in a device synchronization: PyTorch returns before the card
finishes, so a clock read without one times the enqueue.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ewdml_tpu_torch.obs import clock


def synchronize() -> None:
    """Wait for the card's work (nothing to wait for on the CPU)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_window(step: Callable[[], None],
                 block: Optional[Callable[[], None]] = None,
                 iters: int = 10) -> float:
    """One window: ``iters`` calls of ``step``, then ``block`` (default
    :func:`synchronize`). Returns milliseconds per step."""
    block = block or synchronize
    t0 = clock.monotonic()
    for _ in range(iters):
        step()
    block()
    return (clock.monotonic() - t0) / iters * 1000.0


def timed_windows(step: Callable[[], None],
                  block: Optional[Callable[[], None]] = None,
                  windows: int = 5, iters: int = 10) -> list:
    """``windows`` timed windows of ``iters`` steps each."""
    return [timed_window(step, block, iters) for _ in range(windows)]


def median_iqr(samples: Sequence[float]) -> tuple:
    """(median, q25, q75), numpy's default percentile interpolation."""
    s = np.asarray(sorted(samples), dtype=np.float64)
    return (float(np.median(s)), float(np.percentile(s, 25)),
            float(np.percentile(s, 75)))


def summarize(samples: Sequence[float], round_to: int = 3) -> dict:
    """The JSON shape every number of record carries."""
    med, q25, q75 = median_iqr(samples)
    return {"median": round(med, round_to),
            "iqr": [round(q25, round_to), round(q75, round_to)],
            "windows": len(samples),
            "samples": [round(s, round_to) for s in samples]}


def paired_ratio(a: Sequence[float], b: Sequence[float],
                 round_to: int = 4) -> dict:
    """Window-paired ratio a/b of interleaved A/B windows."""
    return summarize([x / y for x, y in zip(a, b)], round_to)
