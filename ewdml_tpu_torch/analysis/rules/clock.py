"""clock: every timestamp of record reads ``ewdml_tpu_torch.obs.clock``.

``obs/clock.py`` is the ONE monotonic source because timers and trace
timestamps that read different clocks drift apart; a fresh ``time.monotonic``
call site silently reopens that seam (a merged timeline and a phase total
disagreeing about what a second is). This rule flags any read of the
stdlib clock surface — ``time.time/monotonic/perf_counter`` and their
``_ns`` twins — outside the clock module itself. ``time.sleep`` is fine
(a delay, not a timestamp); wall-clock provenance stamps should go
through ``clock.wall_ns`` or carry an ``allow[clock]`` with the reason.
"""

from __future__ import annotations

import ast
import os

from ewdml_tpu_torch.analysis.engine import Rule, walk

#: The stdlib clock-reading surface (calls AND bare references — aliasing
#: ``t = time.perf_counter`` smuggles the clock just as well).
CLOCK_ATTRS = frozenset({
    "time", "time_ns", "monotonic", "monotonic_ns",
    "perf_counter", "perf_counter_ns", "process_time", "process_time_ns",
    "thread_time", "thread_time_ns", "clock_gettime", "clock_gettime_ns",
})

#: The module that is allowed to read the stdlib clock.
CLOCK_MODULE_SUFFIX = "obs/clock.py"


class ClockRule(Rule):
    id = "clock"
    title = ("no time.time/monotonic/perf_counter outside obs/clock.py — "
             "the ONE monotonic source")

    def check(self, ctx):
        # Match on the absolute path too: a single-file lint of
        # `.../obs/clock.py` keys its rel as bare `clock.py`.
        if (ctx.rel.endswith(CLOCK_MODULE_SUFFIX)
                or ctx.abspath.replace(os.sep, "/").endswith(
                    "/" + CLOCK_MODULE_SUFFIX)):
            return []
        # `import time as t` aliases count too — the alias smuggles the
        # same clock (the from-import branch below covers the other
        # renaming route).
        time_names = {"time"}
        for node in walk(ctx.tree):
            if isinstance(node, ast.Import):
                time_names.update(a.asname for a in node.names
                                  if a.name == "time" and a.asname)
        out = []
        for node in walk(ctx.tree):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in time_names
                    and node.attr in CLOCK_ATTRS):
                out.append(ctx.violation(
                    self.id, node,
                    f"{node.value.id}.{node.attr} bypasses the one "
                    f"monotonic source "
                    f"(obs/clock.py); use ewdml_tpu_torch.obs.clock "
                    f"monotonic/monotonic_ns (durations) or wall_ns "
                    f"(provenance stamps)"))
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name in CLOCK_ATTRS:
                        out.append(ctx.violation(
                            self.id, node,
                            f"'from time import {alias.name}' bypasses the "
                            f"one monotonic source; import "
                            f"ewdml_tpu_torch.obs.clock instead"))
        return out
