"""The one monotonic clock of the port's timers (``ewdml_tpu/obs/clock.py``).

The straggler policy's contact gaps and the parameter server's apply wall
read it. On CPython/Linux ``time.perf_counter`` reads ``CLOCK_MONOTONIC``.
"""

from __future__ import annotations

import time

#: Monotonic seconds (float).
monotonic = time.perf_counter
