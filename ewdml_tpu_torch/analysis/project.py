"""Whole-program context: the second pass the cross-file rules consume.

The engine parses each file once into a :class:`~ewdml_tpu_torch.analysis
.engine.FileContext`; per-file rules see one file at a time. Some failure
modes are cross-file, though (the event-loop ``ps_net`` plane, N-worker
elastic membership): a reordered lock acquisition or a renamed reply key fails only at runtime, under load,
cross-process. :class:`ProjectContext` is the shared whole-program view —
built ONCE over every parsed file, consumed by the ``lock-order``,
``guarded-by-flow``, and ``wire-protocol`` rules:

- **Classes** (:class:`ClassInfo`): per class, the top-level methods, the
  resolved lock attributes (``self.X = threading.Lock()`` / ``RLock()`` /
  ``reqctx.TimedLock()`` — attribute-TYPE resolution by constructor name,
  with reentrancy: only ``RLock`` may be re-acquired on one thread), a
  ONE-LEVEL intra-class call graph (``self._method(...)`` edges — one
  level deep by contract: the rules follow a helper call but not the
  helper's helpers, keeping the analysis predictable and the pass fast),
  per-method ``self.<attr>`` load/store sets, and thread-entry methods
  (``run`` on a ``threading.Thread`` subclass, or any method referenced
  as ``target=self.m`` in a ``Thread(...)`` call).
- **Method annotations**: ``# ewdml: requires[<lock>]`` on a ``def`` line
  (or the contiguous comment block above it, decorators included)
  declares that every caller must already hold the lock — the
  interprocedural seam ``guarded-by-flow`` checks and the per-file
  ``lock`` rule credits.

Everything is resolved by NAME, conservatively: only ``self.<attr>``
receivers count (another object's lock guards another object's state),
and nested classes own their own ``self``.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from ewdml_tpu_torch.analysis.engine import method_requires, walk

#: Constructor names that resolve an attribute as a lock, with whether
#: one thread may re-acquire it (reentrancy). ``TimedLock`` is the
#: ``obs/reqctx`` drop-in around ``threading.Lock`` — same semantics,
#: NOT reentrant. ``Condition`` wraps an RLock by default (re-acquirable;
#: ``with cond:`` takes that lock), so the federated coordinator's
#: barrier state is checkable like any other guarded attribute.
LOCK_CONSTRUCTORS = {"Lock": False, "RLock": True, "TimedLock": False,
                     "Condition": True}


def _self_attr(node) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _called_name(func) -> Optional[str]:
    """Trailing name of a callee: ``threading.Lock`` -> ``Lock``,
    ``reqctx.TimedLock`` -> ``TimedLock``, bare ``RLock`` -> ``RLock``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def own_nodes(cls):
    """Walk a ClassDef without descending into nested ClassDefs (an inner
    class has its own ``self``)."""
    stack = list(cls.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, ast.ClassDef):
                stack.append(child)


@dataclasses.dataclass
class MethodInfo:
    node: ast.FunctionDef
    #: lock names this method's annotation declares every caller holds.
    requires: frozenset
    #: ``self.<m>()`` call nodes, by callee name (the one-level edges).
    self_calls: dict
    #: ``self.<attr>`` names read (Load) / written (Store/AugAssign/Del).
    attr_loads: set
    attr_stores: set


class ClassInfo:
    """One class's whole-program facts (locks, calls, attrs, threads)."""

    def __init__(self, ctx, node: ast.ClassDef):
        self.ctx = ctx
        self.node = node
        self.qualname = f"{ctx.rel}::{node.name}"
        self.methods: dict[str, MethodInfo] = {}
        #: attr name -> reentrant? (resolved lock constructors only)
        self.lock_attrs: dict[str, bool] = {}
        #: methods that run on their own thread: ``run`` of a Thread
        #: subclass, and any ``target=self.m`` Thread argument.
        self.thread_entries: set[str] = set()
        self._build()

    def _build(self) -> None:
        is_thread_subclass = any(
            (_called_name(b) == "Thread") for b in self.node.bases)
        for stmt in self.node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[stmt.name] = self._method_info(stmt)
        if is_thread_subclass and "run" in self.methods:
            self.thread_entries.add("run")
        for node in own_nodes(self.node):
            if not isinstance(node, ast.Assign):
                # Lock-attr declarations are plain assignments in practice
                # (and the guarded-by rule keys off the same shape).
                continue
            if (isinstance(node.value, ast.Call)
                    and _called_name(node.value.func) in LOCK_CONSTRUCTORS):
                reentrant = LOCK_CONSTRUCTORS[_called_name(node.value.func)]
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        self.lock_attrs[attr] = reentrant
        # target=self.m handed to a Thread(...) constructor anywhere in
        # the class body: m runs on its own thread.
        for node in own_nodes(self.node):
            if (isinstance(node, ast.Call)
                    and _called_name(node.func) == "Thread"):
                for kw in node.keywords:
                    if kw.arg == "target":
                        m = _self_attr(kw.value)
                        if m is not None and m in self.methods:
                            self.thread_entries.add(m)

    def _method_info(self, fn) -> MethodInfo:
        self_calls: dict[str, list] = {}
        loads, stores = set(), set()
        for node in walk(fn):
            if isinstance(node, ast.Call):
                callee = _self_attr(node.func)
                if callee is not None:
                    self_calls.setdefault(callee, []).append(node)
            elif isinstance(node, ast.Attribute):
                attr = _self_attr(node)
                if attr is None:
                    continue
                if isinstance(node.ctx, ast.Load):
                    loads.add(attr)
                else:
                    stores.add(attr)
        return MethodInfo(fn, method_requires(self.ctx, fn), self_calls,
                          loads, stores)

    def attr_touches(self, entry: str) -> tuple[set, set]:
        """(loads, stores) of ``self.<attr>`` reachable from method
        ``entry`` — the method itself plus its one-level callees."""
        m = self.methods.get(entry)
        if m is None:
            return set(), set()
        loads, stores = set(m.attr_loads), set(m.attr_stores)
        for callee in m.self_calls:
            sub = self.methods.get(callee)
            if sub is not None:
                loads |= sub.attr_loads
                stores |= sub.attr_stores
        return loads, stores


class ProjectContext:
    """The whole-program view: every FileContext, plus class facts."""

    def __init__(self, contexts):
        self.contexts = list(contexts)
        self.by_rel = {c.rel: c for c in self.contexts}
        self.classes: list[ClassInfo] = []
        for ctx in self.contexts:
            for node in walk(ctx.tree):
                if isinstance(node, ast.ClassDef):
                    self.classes.append(ClassInfo(ctx, node))
