"""Streaming per-unit gradient-moment estimator (Variance-based GC signal;
``ewdml_tpu/adapt/variance.py``, copied).

The controller needs one scalar "how noisy is this layer's gradient" per
transport unit. The step body computes per-leaf first and second raw
moments over the gradient's elements — ``m1 = mean(g)``, ``m2 = mean(g²)``
— and averages them over the workers, so every sync replica sees the
IDENTICAL ``[U, 2]`` sample (rank-shared by construction; on the PS paths
the server computes the same moments from the applied mean gradient). The
host folds those samples into an exponential moving average here.

Numerics are deliberately boring: plain float64 numpy EMAs updated in a
fixed order, so two runs fed identical samples produce bit-identical
estimates — the property the replayable decision ledger rests on. The
debiasing mirrors Adam's: an EMA started at zero underestimates by
``1 - (1 - alpha)^count``, and dividing by that factor makes the streaming
estimate match the explicit weighted (two-pass) computation exactly — the
test oracle in ``tests/test_torch_adapt.py``.
"""

from __future__ import annotations

import numpy as np

#: Default EMA weight per decision-window sample. Samples arrive once per
#: adapt window (not per step), so a fairly heavy weight keeps the signal
#: responsive over the handful of windows short runs see.
DEFAULT_ALPHA = 0.2


class StreamingMoments:
    """EMA of per-unit ``(E[g], E[g²])`` with Adam-style debiasing."""

    def __init__(self, n_units: int, alpha: float = DEFAULT_ALPHA):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.count = 0
        self.m1 = np.zeros((n_units,), np.float64)
        self.m2 = np.zeros((n_units,), np.float64)

    def update(self, sample) -> None:
        """Fold one ``[U, 2]`` sample (columns: mean, mean-of-squares)."""
        sample = np.asarray(sample, np.float64)
        if sample.shape != (self.m1.size, 2):
            raise ValueError(
                f"expected sample shape {(self.m1.size, 2)}, "
                f"got {sample.shape}")
        a = self.alpha
        self.m1 = (1.0 - a) * self.m1 + a * sample[:, 0]
        self.m2 = (1.0 - a) * self.m2 + a * sample[:, 1]
        self.count += 1

    @property
    def debias(self) -> float:
        """Sum of the EMA weights after ``count`` updates."""
        return 1.0 - (1.0 - self.alpha) ** self.count

    def moments(self):
        """Debiased ``(m1, m2)`` per unit (zeros before the first sample)."""
        if self.count == 0:
            return self.m1.copy(), self.m2.copy()
        d = self.debias
        return self.m1 / d, self.m2 / d

    def variance(self) -> np.ndarray:
        """Per-unit element variance estimate ``E[g²] - E[g]²``, clipped at
        zero (the EMA of two moments is not jointly consistent, so tiny
        negative values can appear on near-constant gradients)."""
        m1, m2 = self.moments()
        return np.maximum(m2 - m1 * m1, 0.0)


def two_pass_reference(samples, alpha: float = DEFAULT_ALPHA):
    """Batch (two-pass) oracle for :class:`StreamingMoments`: compute the
    explicit EMA weights ``alpha * (1-alpha)^(T-t)`` over the stored sample
    list, normalize by their sum, and take the weighted moments. The
    streaming estimator must match this within float tolerance — the
    ``tests/test_torch_adapt.py`` contract."""
    samples = np.asarray(samples, np.float64)  # [T, U, 2]
    T = samples.shape[0]
    if T == 0:
        u = samples.shape[1] if samples.ndim == 3 else 0
        z = np.zeros((u,), np.float64)
        return z, z.copy(), z.copy()
    w = alpha * (1.0 - alpha) ** np.arange(T - 1, -1, -1, dtype=np.float64)
    w = w / w.sum()
    m1 = np.tensordot(w, samples[:, :, 0], axes=1)
    m2 = np.tensordot(w, samples[:, :, 1], axes=1)
    return m1, m2, np.maximum(m2 - m1 * m1, 0.0)
