"""Counters, gauges and quantile histograms behind one ``snapshot()``
(``ewdml_tpu/obs/registry.py``).

The JAX package keeps one registry per process; here a registry is an
object its owner creates (a :class:`~ewdml_tpu_torch.train.loop.Trainer`'s
``metrics``, the evaluator's), so two runs in one process never share
counts. The absorbers fold the legacy instruments in: a ``StepTimer``'s
totals, the straggler policy's snapshot, a parameter server's stats, a
federated coordinator's snapshot.
Thread-safe; every update is O(1) dict work under one lock.
"""

from __future__ import annotations

import threading

from ewdml_tpu_torch.obs import clock
from ewdml_tpu_torch.obs.hist import QuantileHistogram

#: One mutex guards every metric update: ``value += n`` is a read, a
#: modify and a write, and the async workers' threads update concurrently.
_MUTEX = threading.Lock()


class Counter:
    """A monotonically increasing total."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        with _MUTEX:
            self.value += n


class Gauge:
    """The last value set, with the time it was set."""

    __slots__ = ("value", "ts")

    def __init__(self):
        self.value = None
        self.ts = None

    def set(self, v):
        with _MUTEX:
            self.value = v
            self.ts = clock.monotonic()


class Histogram(QuantileHistogram):
    """A quantile histogram (``obs/hist.py``) whose ``observe`` holds the
    registry mutex."""

    __slots__ = ()

    def observe(self, v):
        with _MUTEX:
            QuantileHistogram.observe(self, v)


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            return h

    def snapshot(self) -> dict:
        """JSON-able view of everything recorded. The lookup lock is held
        only to copy the metric dicts; each value is read after."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._hists.items())
        return {
            "counters": {k: c.value for k, c in counters},
            "gauges": {k: g.value for k, g in gauges},
            "histograms": {k: h.summary() for k, h in hists},
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def absorb_step_timer(self, timing: dict) -> None:
        """Add one ``StepTimer.as_dict()`` to the per-phase totals
        (``train.compile_s``, ``train.data_s``, ``train.step_s``,
        ``train.steps``), summed over ``train()`` calls."""
        for key in ("compile_s", "data_s", "step_s", "steps"):
            v = timing.get(key)
            if v:
                # ewdml: allow[metric-name] -- bounded: key iterates the
                # literal 4-tuple above, so the name set is closed
                self.counter(f"train.{key}").inc(v)

    def absorb_policy(self, snap) -> None:
        """A straggler-policy snapshot (``parallel/policy.PolicySnapshot``)."""
        self.gauge("ps.kills_sent").set(snap.kills_sent)
        self.gauge("ps.excluded").set(len(snap.excluded))
        self.gauge("ps.contacts").set(snap.contacts)

    def absorb_federated(self, snap: dict) -> None:
        """A federated coordinator's snapshot (``federated/coordinator.py``),
        as gauges: a snapshot carries run totals, so a second absorb sets,
        never adds. ``max_cohort`` is None (skipped) under decode mode."""
        for key in ("pool", "round", "rounds_done", "cohort", "accept",
                    "dropouts", "resampled", "quota_dropped", "max_cohort"):
            v = snap.get(key)
            if v is not None:
                # ewdml: allow[metric-name] -- bounded: key iterates the
                # literal tuple above, so the name set is closed
                self.gauge(f"federated.{key}").set(v)

    def absorb_ps_stats(self, stats) -> None:
        """A parameter server's run totals (``parallel/ps.PSStats``), as
        gauges: a second absorb of the same run sets, never adds."""
        for key in ("pushes", "updates", "dropped_stale", "dropped_plan_stale",
                    "dropped_straggler", "worker_crashes", "kills_sent",
                    "bytes_up", "bytes_down"):
            # ewdml: allow[metric-name] -- bounded: key iterates the
            # literal PSStats field tuple above, so the name set is closed
            self.gauge(f"ps.{key}").set(getattr(stats, key))
