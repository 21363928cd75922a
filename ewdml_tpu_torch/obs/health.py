"""The run-health watchdog's exit contract (``ewdml_tpu/obs/health.py``).

Only the constants are ported: the exit status of a run the watchdog
aborted and its exception, which the experiments runner journals as a
retryable cell event. The watchdog itself (``--health warn|abort``) is a
later slice and is rejected by name (``train/trainer.py``, ROADMAP Queue 1
item 4).
"""

from __future__ import annotations

#: Exit status of a run the watchdog aborted: distinct from the straggler
#: kill (77) and the injected crash (13), so a supervisor journals it as a
#: retryable health event, not a code bug.
HEALTH_EXIT_CODE = 76


class HealthAbort(RuntimeError):
    """The watchdog's abort verdict (``--health abort``)."""

    def __init__(self, kind: str, step, detail: str):
        super().__init__(f"health abort [{kind}] at step {step}: {detail}")
        self.kind = kind
        self.step = step
        self.detail = detail
