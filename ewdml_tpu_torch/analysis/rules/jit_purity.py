"""jit-purity: no host side effects inside captured step bodies.

A ``print``, logger call, stdlib clock read, or lock acquisition inside a
body that a CUDA graph captures executes at CAPTURE time (once, while the
graph records), never at replay — the classic silent bug: the timestamp
measures the capture, the lock guards nothing, the log line fires once
and never again. Worse, a lock taken during capture can deadlock against
the host thread that triggered it. (The rule keeps the reference's id,
``jit-purity``: the JAX package's traced body is the port's captured one.)

A function body counts as captured when any of:

- it is called inside a ``with torch.cuda.graph(...)`` block (the block's
  own statements are captured too);
- its NAME is passed to ``WindowStep(...)`` (``train/window.py``: K steps
  in one graph a window) or to ``torch.cuda.make_graphed_callables``, in
  the same module — including ``self._method``;
- its name matches the repo's step-body convention
  (``_step_body``/``step_body``/``body``/``feed_body``/``window_body``) —
  those are captured a layer up, out of lexical reach.

Nested defs inside a captured body are part of the captured program and
are covered by the same walk.
"""

from __future__ import annotations

import ast
import re

from ewdml_tpu_torch.analysis.engine import Rule, walk

#: The repo's step-body naming convention (trainer/keras): built by
#: ``_make_step_body``-style factories and captured at a distance.
BODY_NAME_RE = re.compile(r"^(_?step_body|body|feed_body|window_body)$")

LOGGING_NAMES = frozenset({"logging", "logger", "log"})

#: Callables whose first argument is captured into a CUDA graph.
CAPTURING_CALLS = frozenset({"WindowStep", "make_graphed_callables"})


def _trailing_name(node) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_graph_ctx(expr) -> bool:
    """``torch.cuda.graph(...)`` / ``cuda.graph(...)`` as a with-item."""
    return (isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "graph"
            and _trailing_name(expr.func.value) == "cuda")


def _captured_names(tree) -> set:
    """Names (and ``self.<attr>`` attrs) handed to a capturing call, or
    called inside a ``with torch.cuda.graph(...)`` block, anywhere in the
    module."""
    names = set()
    for node in walk(tree):
        if (isinstance(node, ast.Call)
                and _trailing_name(node.func) in CAPTURING_CALLS
                and node.args):
            name = _trailing_name(node.args[0])
            if name is not None:
                names.add(name)
        elif (isinstance(node, (ast.With, ast.AsyncWith))
              and any(_is_graph_ctx(i.context_expr) for i in node.items)):
            for stmt in node.body:
                for sub in walk(stmt):
                    if isinstance(sub, ast.Call):
                        name = _trailing_name(sub.func)
                        if name is not None:
                            names.add(name)
    return names


def _graph_blocks(tree) -> list:
    """The ``with torch.cuda.graph(...)`` statements of the module."""
    return [node for node in walk(tree)
            if isinstance(node, (ast.With, ast.AsyncWith))
            and any(_is_graph_ctx(i.context_expr) for i in node.items)]


def _lockish(expr) -> str | None:
    """Attribute/name that smells like a lock (``self._lock``,
    ``update_lock``) in a with-item or acquire target."""
    if isinstance(expr, ast.Attribute) and "lock" in expr.attr.lower():
        return expr.attr
    if isinstance(expr, ast.Name) and "lock" in expr.id.lower():
        return expr.id
    return None


class JitPurityRule(Rule):
    id = "jit-purity"
    title = ("no print/logging/time/lock acquisition inside captured "
             "step bodies (CUDA graph capture runs them once)")

    def check(self, ctx):
        captured = _captured_names(ctx.tree)
        out = []
        seen: set[int] = set()  # don't double-walk nested captured defs
        for node in walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if ((node.name in captured or BODY_NAME_RE.match(node.name))
                    and id(node) not in seen):
                for sub in walk(node):
                    seen.add(id(sub))
                out.extend(self._check_body(ctx, node.name, node))
        for block in _graph_blocks(ctx.tree):
            if id(block) in seen:
                continue
            for stmt in block.body:
                for sub in walk(stmt):
                    seen.add(id(sub))
            out.extend(self._check_body(
                ctx, "torch.cuda.graph", ast.Module(body=block.body,
                                                    type_ignores=[])))
        return out

    def _check_body(self, ctx, name, fdef):
        out = []
        for node in walk(fdef):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Name) and f.id == "print":
                    out.append(ctx.violation(
                        self.id, node,
                        f"print() inside captured body {name!r} runs once "
                        f"at capture and never at replay; print from the "
                        f"host loop"))
                elif (isinstance(f, ast.Attribute)
                      and isinstance(f.value, ast.Name)):
                    base = f.value.id
                    if base in LOGGING_NAMES:
                        out.append(ctx.violation(
                            self.id, node,
                            f"{base}.{f.attr}() inside captured body "
                            f"{name!r} fires once at capture and never at "
                            f"replay; log from the host loop"))
                    elif base in ("time", "clock"):
                        out.append(ctx.violation(
                            self.id, node,
                            f"{base}.{f.attr}() inside captured body "
                            f"{name!r} measures the CAPTURE, once, never a "
                            f"replay; time around the replay on the host"))
                if isinstance(f, ast.Attribute) and f.attr == "acquire":
                    out.append(ctx.violation(
                        self.id, node,
                        f"lock acquire inside captured body {name!r}: "
                        f"held once at capture, never at replay (and can "
                        f"deadlock the capturing thread)"))
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lock = _lockish(item.context_expr)
                    if lock:
                        out.append(ctx.violation(
                            self.id, item.context_expr,
                            f"'with {lock}' inside captured body "
                            f"{name!r}: the lock is held once at capture, "
                            f"never at replay"))
        return out
