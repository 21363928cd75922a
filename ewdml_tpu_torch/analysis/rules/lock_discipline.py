"""lock: annotated lock-guarded attributes are only touched under the lock.

The bug shape of the parameter server's hand-fixed races: state mutated
under ``self._lock`` in one method, then READ bare in another (a
plan-switch recheck, a pull-reply pairing). The
contract is declared in the code itself — the attribute's defining
assignment (normally in ``__init__``) carries::

    self._pending = []   # ewdml: guarded-by[_lock]

and from then on every ``self._pending`` load or store anywhere else in
the class must sit lexically inside ``with self._lock:`` (any with-item
position; multi-item ``with self._lock, other:`` counts). Deliberate
unlocked reads carry ``allow[lock]`` with the reason.

Interprocedural seam: a method annotated
``# ewdml: requires[_lock]`` (def line or the comment block above it) is
analyzed as HOLDING the lock throughout its body — the helper may touch
guarded attrs without its own ``with``. The promise that every caller
actually holds the lock is checked by the whole-program
``guarded-by-flow`` rule; together they make lock-held helper methods
expressible instead of suppressed.

Conservative by design:

- ``__init__`` is exempt (construction is single-threaded by contract);
- a nested ``def``/``lambda`` inside a method does NOT inherit the
  enclosing ``with`` (nor the method's ``requires[]``) — a closure can
  escape the lock scope and run later;
- only ``self.<lock>`` with-items count as holding (``self.server._lock``
  guards a DIFFERENT object's attributes — annotate in that class).
"""

from __future__ import annotations

import ast

from ewdml_tpu_torch.analysis import engine
from ewdml_tpu_torch.analysis.engine import Rule, walk


def _own_nodes(cls):
    """Walk a ClassDef without descending into nested ClassDefs (an inner
    class has its own ``self``)."""
    stack = list(cls.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, ast.ClassDef):
                stack.append(child)


def _self_attr(node) -> str | None:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class LockDisciplineRule(Rule):
    id = "lock"
    title = ("attributes annotated guarded-by[lock] are only accessed "
             "under 'with self.<lock>'")

    def check(self, ctx):
        out = []
        for cls in walk(ctx.tree):
            if isinstance(cls, ast.ClassDef):
                out.extend(self._check_class(ctx, cls))
        return out

    def _check_class(self, ctx, cls):
        # Pass 1: guarded-attribute declarations (annotation comment on the
        # defining assignment's line).
        guarded: dict[str, str] = {}
        for node in _own_nodes(cls):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    lock = ctx.guarded_annotation(node.lineno)
                    if lock:
                        guarded[attr] = lock
        if not guarded:
            return []
        out = []
        for stmt in cls.body:
            if (isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and stmt.name != "__init__"):
                # requires[lock] methods hold the lock by caller contract
                # (guarded-by-flow verifies the callers).
                held = engine.method_requires(ctx, stmt)
                self._visit(ctx, guarded, stmt.body, frozenset(held), out)
        return out

    def _visit(self, ctx, guarded, nodes, held, out):
        for node in nodes:
            self._visit_node(ctx, guarded, node, held, out)

    def _visit_node(self, ctx, guarded, node, held, out):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            newly = set()
            for item in node.items:
                attr = _self_attr(item.context_expr)
                if attr is not None and attr in set(guarded.values()):
                    newly.add(attr)
                else:
                    # the with-item expression itself evaluates unlocked
                    self._scan_expr(ctx, guarded, item.context_expr, held,
                                    out)
            self._visit(ctx, guarded, node.body, held | newly, out)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Closures escape the lexical lock scope: assume unlocked.
            self._visit(ctx, guarded, node.body, frozenset(), out)
            return
        if isinstance(node, ast.Lambda):
            self._visit_node(ctx, guarded, node.body, frozenset(), out)
            return
        if isinstance(node, ast.Attribute):
            attr = _self_attr(node)
            if attr is not None:
                if attr in guarded and guarded[attr] not in held:
                    out.append(ctx.violation(
                        self.id, node,
                        f"self.{attr} is annotated guarded-by"
                        f"[{guarded[attr]}]; access it inside "
                        f"'with self.{guarded[attr]}:' (or allow[lock] "
                        f"with the reason the unlocked access is safe)"))
                return  # terminal: value is the bare `self` Name
            # Not a direct self.<attr>: descend so the receiver of e.g.
            # `self._pending.append(x)` (Attribute-of-Attribute) is seen —
            # the method-call mutation is the race's exact shape.
            self._visit_node(ctx, guarded, node.value, held, out)
            return
        for child in ast.iter_child_nodes(node):
            self._visit_node(ctx, guarded, child, held, out)

    def _scan_expr(self, ctx, guarded, expr, held, out):
        self._visit_node(ctx, guarded, expr, held, out)
