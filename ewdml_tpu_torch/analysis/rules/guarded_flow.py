"""guarded-by-flow: the ``lock`` rule, interprocedurally.

Two checks ride the whole-program :class:`ProjectContext`:

1. **requires[] call-site conformance.** The per-file ``lock`` rule now
   credits ``# ewdml: requires[<lock>]`` on a method — the helper may
   touch guarded attrs without its own ``with`` because it promises
   every caller already holds the lock. THIS rule checks the promise:
   every intra-class ``self._helper()`` call site must provably hold the
   lock (lexically inside ``with self.<lock>:``, or inside a method that
   itself carries ``requires[<lock>]``). Closures/lambdas hold nothing
   (they escape the lexical scope — the lock rule's model). Cross-class
   and external callers are out of reach by design; the annotation is
   the documented contract they must read.

2. **Thread escape.** An attribute STORED on one side and touched on the
   other of a thread boundary — a ``Thread`` subclass's ``run``, or any
   method spawned via ``Thread(target=self.m)``, versus the class's
   ordinary (main-path) methods, each followed one call level — is a
   data race waiting for load, unless its defining assignment declares
   how it's safe: ``# ewdml: guarded-by[<lock>]`` (the lock rule then
   polices every access) or ``# ewdml: atomic`` (single GIL-atomic
   reference store, torn values impossible, racy reads tolerated by
   design). Read-only sharing (config attrs) is not flagged; neither are
   ``__init__`` stores (construction precedes the thread). A private
   helper (``_name``, not a dunder) that only thread entries call runs on
   their thread: it is on the thread's side, not the main path's (the
   port splits ``AsyncWorker.run``'s body into such helpers where the JAX
   package inlines it).
"""

from __future__ import annotations

import ast

from ewdml_tpu_torch.analysis.engine import ProjectRule
from ewdml_tpu_torch.analysis.project import _self_attr, own_nodes


class GuardedFlowRule(ProjectRule):
    id = "guarded-by-flow"
    title = ("requires[lock] helpers are only called with the lock held; "
             "thread-shared attrs declare guarded-by[] or atomic")

    def check_project(self, pctx):
        out = []
        for cls in pctx.classes:
            self._check_requires(cls, out)
            self._check_thread_escape(cls, out)
        return out

    # -- 1. requires[] conformance ---------------------------------------

    def _check_requires(self, cls, out):
        required = {name: m.requires for name, m in cls.methods.items()
                    if m.requires}
        if not required:
            return
        for caller_name, caller in cls.methods.items():
            self._scan_calls(cls, required, caller.node.body,
                             frozenset(caller.requires), caller_name, out)

    def _scan_calls(self, cls, required, nodes, held, caller_name, out):
        for node in nodes:
            self._scan_call_node(cls, required, node, held, caller_name, out)

    def _scan_call_node(self, cls, required, node, held, caller_name, out):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            # Items evaluate left-to-right with earlier locks held; a
            # non-lock item expression may itself call a requires[]
            # helper, so it is scanned rather than skipped.
            newly: set = set()
            for item in node.items:
                attr = _self_attr(item.context_expr)
                if attr is not None and attr in cls.lock_attrs:
                    newly = newly | {attr}
                else:
                    self._scan_call_node(cls, required, item.context_expr,
                                         held | newly, caller_name, out)
            self._scan_calls(cls, required, node.body, held | newly,
                             caller_name, out)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Closures escape the lock scope: analyze unlocked.
            self._scan_calls(cls, required, node.body, frozenset(),
                             caller_name, out)
            return
        if isinstance(node, ast.Lambda):
            self._scan_call_node(cls, required, node.body, frozenset(),
                                 caller_name, out)
            return
        if isinstance(node, ast.Call):
            callee = _self_attr(node.func)
            if callee in required:
                for lock in sorted(required[callee] - held):
                    out.append(cls.ctx.violation(
                        self.id, node,
                        f"{cls.node.name}.{callee}() requires[{lock}] "
                        f"but this call in {caller_name}() does not "
                        f"provably hold self.{lock} — wrap the call in "
                        f"'with self.{lock}:' or annotate "
                        f"{caller_name} with requires[{lock}]"))
        for child in ast.iter_child_nodes(node):
            self._scan_call_node(cls, required, child, held, caller_name,
                                 out)

    # -- 2. thread escape --------------------------------------------------

    def _check_thread_escape(self, cls, out):
        if not cls.thread_entries:
            return
        thread_side = cls.thread_entries | self._thread_helpers(cls)
        main = [name for name in cls.methods
                if name != "__init__" and name not in thread_side]
        if not main:
            return
        t_loads, t_stores = set(), set()
        for entry in cls.thread_entries:
            lo, st = cls.attr_touches(entry)
            t_loads |= lo
            t_stores |= st
        m_loads, m_stores = set(), set()
        for name in main:
            lo, st = cls.attr_touches(name)
            m_loads |= lo
            m_stores |= st
        # Shared AND written on at least one side (read-read is safe).
        shared = (((t_loads | t_stores) & m_stores)
                  | (t_stores & (m_loads | m_stores)))
        if not shared:
            return
        declared = self._declared_attrs(cls)
        for attr in sorted(shared):
            if attr in cls.lock_attrs:
                continue  # locks themselves are the synchronization
            decls = declared.get(attr, [])
            if any(cls.ctx.guarded_annotation(d.lineno)
                   or cls.ctx.atomic_annotation(d.lineno) for d in decls):
                continue
            anchor = decls[0] if decls else cls.node
            out.append(cls.ctx.violation(
                self.id, anchor,
                f"{cls.node.name}.{attr} is touched from a thread entry "
                f"({', '.join(sorted(cls.thread_entries))}) AND written "
                f"on the main path (or vice versa) with no declared "
                f"discipline — annotate the defining assignment "
                f"guarded-by[<lock>] (and lock the accesses) or atomic "
                f"(single reference store, racy reads tolerated)"))

    @staticmethod
    def _thread_helpers(cls) -> set:
        """Private methods called by a thread entry and by no other
        method of the class."""
        callers: dict = {}
        for name, m in cls.methods.items():
            for callee in m.self_calls:
                callers.setdefault(callee, set()).add(name)
        return {name for name, who in callers.items()
                if name in cls.methods and name.startswith("_")
                and not name.startswith("__")
                and who <= cls.thread_entries}

    def _declared_attrs(self, cls) -> dict:
        """attr -> its assignment nodes, lowest line first (any one may
        carry the guarded-by/atomic annotation; the violation anchors at
        the first — normally the ``__init__`` declaration)."""
        out: dict = {}
        for node in own_nodes(cls.node):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        out.setdefault(attr, []).append(node)
        for nodes in out.values():
            nodes.sort(key=lambda n: n.lineno)
        return out
