"""lock-order: the repo-wide lock acquisition graph has no cycles, no
re-acquisition of a non-reentrant lock, and honors the canonical order.

The PS is a multi-lock server (``_lock`` / ``_update_lock`` /
``_lock_bn``; the first two are ``TimedLock``) and any change to its
planes may reshuffle who acquires what — a reordered nesting deadlocks only at
runtime, under load, cross-process. This rule makes the ordering an
executable whole-program invariant:

- **Graph**: for every class, each ``with self.<lockB>:`` entered while
  ``<lockA>`` is lexically held adds the edge ``A -> B``; ``self._m()``
  calls are followed ONE level (a helper's acquisitions count at the
  call site), and a method annotated ``# ewdml: requires[L]`` is
  analyzed with ``L`` held from entry (its callers are checked by
  ``guarded-by-flow``).
- **Cycle** = potential deadlock: two threads entering the cycle at
  different points block each other forever. Reported once per cycle.
- **Re-acquire**: entering a non-reentrant lock (``Lock`` /
  ``TimedLock`` — everything but ``RLock``) already held on the path is
  a self-deadlock, reported even without a second thread.
- **Canonical order, pinned as data**: :data:`CANONICAL_ORDER` records
  the repo's documented discipline — ``_update_lock`` before ``_lock``
  (the PS apply path holds the update serializer and takes the state
  lock inside it, never the reverse; see ``ParameterServer.__init__``).
  An edge against the canonical order is an error even before a second
  site completes the cycle — the whole point is to fail at lint time,
  not when the reverse nesting lands months later.

Only ``with self.<attr>:`` acquisitions of attrs resolved as locks by
:mod:`~ewdml_tpu_torch.analysis.project` count; bare ``.acquire()`` calls are
out of scope (jit-purity already polices those inside traced bodies).
"""

from __future__ import annotations

import ast

from ewdml_tpu_torch.analysis.engine import ProjectRule
from ewdml_tpu_torch.analysis.project import _self_attr

#: The repo's documented acquisition order, by lock attribute name,
#: outermost first: a lock may only be acquired while holding locks that
#: appear EARLIER in this tuple. Applies within any one class that uses
#: these names (the PS family); extend the tuple when a new ordered lock
#: joins the discipline.
CANONICAL_ORDER = ("_update_lock", "_lock")


class LockOrderRule(ProjectRule):
    id = "lock-order"
    title = ("lock acquisition graph: no cycles, no re-acquiring a "
             "non-reentrant lock, canonical _update_lock < _lock order")

    def check_project(self, pctx):
        out = []
        for cls in pctx.classes:
            if cls.lock_attrs:
                self._check_class(cls, out)
        return out

    def _check_class(self, cls, out):
        rank = {name: i for i, name in enumerate(CANONICAL_ORDER)}
        edges: dict[tuple, object] = {}  # (held, acquired) -> anchor node

        def record(held, lock, node, via=None):
            where = f" (via self.{via}())" if via else ""
            if lock in held and not cls.lock_attrs.get(lock, False):
                out.append(cls.ctx.violation(
                    self.id, node,
                    f"{cls.node.name}: re-acquiring non-reentrant "
                    f"self.{lock} while already holding it{where} — "
                    f"self-deadlock"))
                return
            for h in held:
                if h != lock:
                    edges.setdefault((h, lock), (node, via))
                    if (h in rank and lock in rank
                            and rank[h] > rank[lock]):
                        out.append(cls.ctx.violation(
                            self.id, node,
                            f"{cls.node.name}: acquiring self.{lock} "
                            f"while holding self.{h}{where} violates the "
                            f"canonical "
                            f"{' < '.join(CANONICAL_ORDER)} order "
                            f"(analysis/rules/lock_order.CANONICAL_ORDER)"))

        def walk(nodes, held):
            for node in nodes:
                walk_node(node, held)

        def walk_node(node, held):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                # Items evaluate left-to-right, each with the earlier
                # items' locks already held (`with self._a, self._b:` IS
                # the a -> b edge); non-lock item expressions may call
                # helpers, so they are walked, not skipped.
                newly: set = set()
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None and attr in cls.lock_attrs:
                        record(held | newly, attr, item.context_expr)
                        newly = newly | {attr}
                    else:
                        walk_node(item.context_expr, held | newly)
                        if item.optional_vars is not None:
                            walk_node(item.optional_vars, held | newly)
                walk(node.body, held | newly)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                # A closure escapes the lexical lock scope: analyze its
                # body as if unlocked (matches the lock rule's model).
                body = node.body if isinstance(node.body, list) \
                    else [node.body]
                walk(body, frozenset())
                return
            if isinstance(node, ast.Call) and held:
                callee = _self_attr(node.func)
                m = cls.methods.get(callee) if callee else None
                if m is not None:
                    # One level: the helper's acquisitions count here,
                    # minus what its requires[] contract says callers
                    # (us) already hold. Depth stops at walk_call_target
                    # (it never follows the helper's own calls).
                    inline_held = held | m.requires
                    for sub in m.node.body:
                        walk_call_target(sub, inline_held, callee, node)
            for child in ast.iter_child_nodes(node):
                walk_node(child, held)

        def walk_call_target(node, held, via, call_node):
            """Depth-1 walk of a called helper: record acquisitions
            anchored at the CALL site (that's where the nesting lives),
            without following the helper's own calls further."""
            if isinstance(node, (ast.With, ast.AsyncWith)):
                newly: set = set()
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None and attr in cls.lock_attrs:
                        record(held | newly, attr, call_node, via=via)
                        newly = newly | {attr}
                for sub in node.body:
                    walk_call_target(sub, held | newly, via, call_node)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return
            for child in ast.iter_child_nodes(node):
                walk_call_target(child, held, via, call_node)

        for name, m in cls.methods.items():
            walk(m.node.body, frozenset(m.requires))

        # Cycle detection over the class's edge set (iterative DFS with
        # a three-color marking; each cycle reported once, anchored at
        # the edge that closes it).
        adj: dict[str, list] = {}
        for (a, b), anchor in edges.items():
            adj.setdefault(a, []).append((b, anchor))
        color: dict[str, int] = {}
        reported = set()

        def dfs(lock, stack):
            color[lock] = 1
            for nxt, (node, via) in adj.get(lock, []):
                if color.get(nxt, 0) == 1:
                    cycle = tuple(stack[stack.index(nxt):] + [nxt]) \
                        if nxt in stack else (lock, nxt)
                    key = frozenset(cycle)
                    if key not in reported:
                        reported.add(key)
                        where = f" (via self.{via}())" if via else ""
                        out.append(cls.ctx.violation(
                            self.id, node,
                            f"{cls.node.name}: lock-order cycle "
                            f"{' -> '.join(cycle)}{where} — two threads "
                            f"entering at different points deadlock"))
                elif color.get(nxt, 0) == 0:
                    dfs(nxt, stack + [nxt])
            color[lock] = 2

        for lock in sorted(adj):
            if color.get(lock, 0) == 0:
                dfs(lock, [lock])
