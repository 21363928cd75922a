"""Seeded, replayable cohort sampling over a registered client pool
(``ewdml_tpu/federated/sampler.py``, numpy only, copied).

Every draw is a pure function of ``(seed, round, attempt, eligible set)``:
no RNG state carries between rounds, so a re-run under the same config and
the same dropout history reproduces the same cohort sequence bit for bit,
which makes the round ledger (``federated/ledger.py``) a replay oracle.
``attempt`` 0 is a round's primary draw and 1, 2, ... its replacement
resamples after reported dropouts, each an independent stream.
"""

from __future__ import annotations

import numpy as np


class CohortSampler:
    """Cohort draws of size ``cohort`` from the eligible client set."""

    def __init__(self, pool_size: int, cohort: int, seed: int):
        if not 1 <= cohort <= pool_size:
            raise ValueError(
                f"cohort must be in [1, pool_size={pool_size}], got {cohort}")
        self.pool_size = int(pool_size)
        self.cohort = int(cohort)
        self.seed = int(seed)

    def _rng(self, round_idx: int, attempt: int) -> np.random.Generator:
        return np.random.default_rng(
            [self.seed & 0x7FFFFFFF, 0xC0C0, int(round_idx), int(attempt)])

    def sample(self, round_idx: int, eligible) -> list[int]:
        """The round's primary cohort: ``cohort`` distinct clients drawn
        without replacement from ``eligible`` (sorted first, so the
        iteration order of a set cannot reach the draw)."""
        pool = sorted(int(c) for c in eligible)
        if len(pool) < self.cohort:
            raise RuntimeError(
                f"round {round_idx}: only {len(pool)} eligible clients "
                f"remain for a cohort of {self.cohort} (pool exhausted by "
                f"dropout)")
        picked = self._rng(round_idx, 0).choice(
            np.asarray(pool, np.int64), size=self.cohort, replace=False)
        return sorted(int(c) for c in picked)

    def resample_one(self, round_idx: int, attempt: int, eligible) -> int:
        """One replacement for an in-round dropout (``attempt`` >= 1
        numbers the round's resamples); -1 when no eligible client is
        left."""
        pool = sorted(int(c) for c in eligible)
        if not pool:
            return -1
        return int(self._rng(round_idx, attempt).choice(
            np.asarray(pool, np.int64)))
