"""trace-name: span/instant names passed to ``obs.trace`` are literal
``component/op`` strings.

The round analyzer (``obs/rounds.py``), the report's span tables, and the
Perfetto flow linker all key on span NAMES — ``worker/push`` must mean the
same thing in every shard of every run, which makes the name set a closed
vocabulary exactly like the metric names. An f-string name
interpolating run state (a step number, a layer, a worker index) breaks
every grouping consumer at once AND bloats the ring with
distinct-per-event strings; run state belongs in span ARGS, which every
site already passes.

Flags any ``span()`` / ``instant()`` / ``complete()`` / ``counter()``
call on the trace surface — ``otrace.<m>(...)`` / ``trace.<m>(...)`` and
the names imported from ``ewdml_tpu_torch.obs.trace`` — whose first argument is
not a string literal matching ``component/op`` (lowercase slashed, at
least one slash: ``worker/pull``, ``train/bucket_exchange``). A call
whose interpolation IS provably bounded suppresses with the reason saying
why (``# ewdml: allow[trace-name] -- bounded: ...``) — the per-op server
dispatch span (clamped to the ``_OPS`` vocabulary) and the watchdog's
``health/<kind>`` (closed ``KINDS`` tuple) are the two such sites.
"""

from __future__ import annotations

import ast
import re

from ewdml_tpu_torch.analysis.engine import Rule, walk

#: The trace event-emitting surface taking a name first argument.
METHODS = frozenset({"span", "instant", "complete", "counter"})

#: Receiver names that denote the trace module at call sites. The repo
#: idiom is ``from ewdml_tpu_torch.obs import trace as otrace``.
BASES = frozenset({"otrace", "trace"})

#: ``component/op``: lowercase slashed path, at least one slash.
NAME_RE = re.compile(r"[a-z][a-z0-9_]*(/[a-z0-9_.-]+)+")

#: The trace module itself defines the API — its internals are not call
#: sites of it.
TRACE_MODULE_SUFFIX = "obs/trace.py"


class TraceNameRule(Rule):
    id = "trace-name"
    title = ("obs.trace span/instant names must be literal component/op "
             "strings — grouping consumers (rounds, report, flow links) "
             "key on a closed name vocabulary")

    def check(self, ctx):
        if ctx.rel.endswith(TRACE_MODULE_SUFFIX):
            return []
        imported: set[str] = set()
        for node in walk(ctx.tree):
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.endswith("obs.trace")):
                for alias in node.names:
                    if alias.name in METHODS:
                        imported.add(alias.asname or alias.name)
        out = []
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in METHODS:
                if not (isinstance(fn.value, ast.Name)
                        and fn.value.id in BASES):
                    continue
                label = f"{fn.value.id}.{fn.attr}"
            elif isinstance(fn, ast.Name) and fn.id in imported:
                label = fn.id
            else:
                continue
            if not node.args:
                continue
            arg = node.args[0]
            bad = self._bad_literal(arg)
            if bad is None:
                continue
            if isinstance(bad, str):
                out.append(ctx.violation(
                    self.id, node,
                    f"trace name {bad!r} is not component/op "
                    f"(lowercase slashed, e.g. 'worker/pull')"))
                continue
            kind = ("f-string" if isinstance(arg, ast.JoinedStr)
                    else "non-literal")
            out.append(ctx.violation(
                self.id, node,
                f"{kind} trace name in {label}(): names must be literal "
                f"component/op strings (the rounds analyzer, span tables, "
                f"and flow linker group by name — run state belongs in "
                f"span args); clamp interpolations to a closed vocabulary "
                f"and allow[trace-name] with the reason"))
        return out

    def _bad_literal(self, arg):
        """None = acceptable (literal valid name, or a conditional whose
        every branch is one — still a closed set); a str = the offending
        literal; True = not a literal at all."""
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return None if NAME_RE.fullmatch(arg.value) else arg.value
        if isinstance(arg, ast.IfExp):
            return (self._bad_literal(arg.body)
                    or self._bad_literal(arg.orelse))
        return True
