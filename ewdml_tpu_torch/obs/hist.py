"""The fixed-log-bucket quantile histogram (``ewdml_tpu/obs/hist.py``).

Bucket ``i`` covers ``[LO * G**i, LO * G**(i+1))`` with growth
``G = 2**(1/8)`` over ``[1e-9, ~1e5)`` seconds. ``observe`` is O(1) and
the memory never grows; bucket counts of two histograms merge by addition.
A quantile is the bucket's geometric midpoint clamped to the observed
min/max, so its relative error is at most ``sqrt(G) - 1`` (~4.4%); values
out of range land in an underflow or overflow bucket and resolve to the
observed min or max. The same layout and arithmetic as the JAX package's,
so both give equal quantiles on the same samples.

Thread safety is the caller's (``registry.Histogram`` holds a lock around
``observe``).
"""

from __future__ import annotations

import math

import numpy as np

#: Bucket growth factor: 8 sub-buckets per octave. Quantile relative error
#: is bounded by sqrt(G) - 1 ~ 4.4% (geometric-midpoint estimate).
GROWTH = 2.0 ** 0.125

#: Smallest bucketed value (seconds): below this is the underflow bucket
#: (zeros, negatives, sub-ns noise) and resolves to the observed min.
LO = 1e-9

#: Number of finite buckets: ceil(log_G(1e5 / LO)) — covers up to ~1e5 s.
N_BUCKETS = int(math.ceil(math.log(1e5 / LO) / math.log(GROWTH)))

_LOG_G = math.log(GROWTH)
_LOG_LO = math.log(LO)


class QuantileHistogram:
    """Mergeable log-bucket histogram with exact count/sum/min/max."""

    __slots__ = ("buckets", "count", "nonfinite", "total", "min", "max")

    def __init__(self):
        # [underflow, N_BUCKETS finite buckets, overflow]
        self.buckets = np.zeros(N_BUCKETS + 2, np.int64)
        self.count = 0
        self.nonfinite = 0
        self.total = 0.0
        self.min = None
        self.max = None

    @staticmethod
    def _index(v: float) -> int:
        """Bucket index for ``v`` (0 = underflow, N_BUCKETS+1 = overflow)."""
        if v < LO:
            return 0
        i = int((math.log(v) - _LOG_LO) / _LOG_G) + 1
        return i if i <= N_BUCKETS else N_BUCKETS + 1

    def observe(self, v) -> None:
        v = float(v)
        if not math.isfinite(v):
            # Non-finite observations are COUNTED but excluded from
            # sum/min/max: the semantics of a NaN/inf value belong to the
            # health watchdog, and poisoning the totals (and the
            # strict-JSON snapshot) helps nobody. +inf lands in the
            # overflow bucket, NaN/-inf in underflow.
            self.buckets[-1 if v == math.inf else 0] += 1
            self.count += 1
            self.nonfinite += 1
            return
        self.buckets[self._index(v)] += 1
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def merge(self, other: "QuantileHistogram") -> "QuantileHistogram":
        """Element-wise bucket sum (associative + commutative): shards of
        one metric recorded in different processes fold into one
        distribution."""
        self.buckets += other.buckets
        self.count += other.count
        self.nonfinite += other.nonfinite
        self.total += other.total
        if other.min is not None:
            self.min = other.min if self.min is None \
                else min(self.min, other.min)
        if other.max is not None:
            self.max = other.max if self.max is None \
                else max(self.max, other.max)
        return self

    def quantile(self, q: float):
        """Estimate of the ``q``-quantile (0 <= q <= 1); None when empty.

        Reads a snapshot of the bucket vector, so a concurrent writer can
        shift the estimate by the races' few counts but never break it."""
        counts = self.buckets.copy()
        n = int(counts.sum())
        if n == 0:
            return None
        # The smallest value with >= ceil(q*n) samples at or below it —
        # HDR's "value at percentile" (p99 of 3 samples is the largest).
        rank = max(1, math.ceil(q * n))
        cum = 0
        idx = counts.size - 1
        for i, c in enumerate(counts):
            cum += int(c)
            if cum >= rank:
                idx = i
                break
        # One read each: a lock-free scrape can land between a first
        # observe's min and max assignments — locals keep the clamp from
        # mixing a set min with a still-None max (never-raises contract).
        mn, mx = self.min, self.max
        if idx == 0:           # underflow: below LO — exact floor; None
            # when only non-finite values landed here (NaN-only history
            # must not fabricate a 0.0 latency — symmetric with overflow)
            if mn is None:
                return None
            est = mn
        elif idx == counts.size - 1:  # overflow: above the top edge —
            # exact observed max; None when only non-finite values landed
            # here (nothing finite to clamp to, and inf would poison the
            # strict-JSON snapshot)
            if mx is None:
                return None
            est = mx
        else:
            lo_edge = LO * GROWTH ** (idx - 1)
            est = lo_edge * math.sqrt(GROWTH)  # geometric midpoint
        if mn is not None and mx is not None:
            est = min(max(est, mn), mx)
        return est

    def summary(self) -> dict:
        """JSON-able snapshot: count/sum/min/max/mean and p50/p95/p99."""
        count = self.count
        finite = count - self.nonfinite
        out = {
            "count": count,
            "sum": round(self.total, 6),
            "min": self.min,
            "max": self.max,
            # Mean over FINITE observations only: non-finite values are
            # counted (they happened) but must neither poison the mean to
            # NaN nor silently bias it toward zero.
            "mean": round(self.total / finite, 6) if finite else None,
        }
        for key, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            v = self.quantile(q)
            out[key] = None if v is None else round(float(v), 9)
        return out
