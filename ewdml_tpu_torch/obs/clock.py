"""The one monotonic clock of the port's timers and trace timestamps
(``ewdml_tpu/obs/clock.py``).

The loop's window fences, the straggler policy's contact gaps, the
parameter server's apply wall and every ``obs.trace`` timestamp read it. On
CPython/Linux ``time.perf_counter`` reads ``CLOCK_MONOTONIC``, whose epoch is
machine-wide, so two processes on one host share the timebase and their
trace shards merge with a zero offset (``ewdml_tpu/obs/merge.py``).
"""

from __future__ import annotations

import time

#: Monotonic seconds (float) — the timer-facing view.
monotonic = time.perf_counter

#: Monotonic nanoseconds (int) — the trace-facing view (same clock).
monotonic_ns = time.perf_counter_ns


def wall_ns() -> int:
    """Wall-clock nanoseconds: only the cross-host alignment anchor of a
    trace shard, never a duration."""
    return time.time_ns()
