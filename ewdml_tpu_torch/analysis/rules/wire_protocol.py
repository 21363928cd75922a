"""wire-protocol: both ps_net endpoints must agree, statically.

The TCP protocol is a hand-maintained two-endpoint contract: the worker
writes request dicts (``RetryingConnection.call`` / ``client_call`` /
``make_request`` sites), the server's dispatch branches read them and
write reply frames, the worker reads the reply keys back. A renamed
reply key or a dropped handler fails only at runtime, under load,
cross-process. This rule extracts the contract from BOTH endpoints
(:func:`extract`) and errors on any asymmetry.

Extraction (by shape, not by name — the fixtures and a future second
protocol work the same way):

- **Dispatch function**: any function with >= 2 ``op == "lit"`` branches
  that write frames (in the branch, or through a server-class method it
  calls), where the op var is a parameter named ``op`` or is
  assigned from ``X.get("op")`` / ``X["op"]``. Its class is a SERVER
  class, and so is every in-scope base class of it (the port's shared
  ``_Endpoint`` builds the kill and push-ack frames every endpoint
  sends). Branch-scoped ``header.get("k")`` / ``header["k"]`` /
  ``"k" in header`` reads are that op's request reads, and so are the
  reads a server-class method makes of the parameter the branch hands
  the header to, one level (``self._push_record(header, sections)``:
  the read the JAX package makes inline in the branch). Reads elsewhere
  in the server classes on request-header vars (params named
  ``header``, or vars unpacked from ``parse_request``) are global reads
  (defensive ``.get`` across ops — exempt from the never-sent check).
  Frames (``make_request({...})``) inside a branch — or in a
  server-class method the branch calls, one level — are that op's
  replies; a reply dict also takes the ``reply["k"] = v`` stores of a
  server-class method it is handed to, one level
  (``self._plan_reply(header, reply)``); frames outside any branch (the
  unknown-op error frame) join every op.
- **Client sends**: ``conn.call({...})`` / ``client_call(addr, {...})``
  sites plus any non-server ``make_request({"op": ...})`` frame. A send
  may be wrapped in a pass-through check — a module-level function that
  returns its first argument (``_expect(conn.call(req)[0], "x_ok")``);
  the header it returns is the reply's. Dict literals resolve through a
  local variable (including later ``var["k"] = v`` stores in the same
  function); ``{**base, "k": v}`` frames are OPEN — their literal keys
  become protocol-wide request augmentation keys (the wire layer's
  ``retry`` / ``req``), the ``**`` part is unknowable and never flagged.
- **Reply reads**: the header var unpacked from a ``.call()`` result is
  tracked linearly through the function (rebinding reattributes); its
  reads — plus reads in a self-method the var is passed to, one level,
  and reads through a pass-through call (``_expect(header, "x_ok")
  .get("k")``) — belong to that send's op. A client-side
  ``X.get("op") == "lit"`` branch attributes its reads to that REPLY op
  (the kill verdict path).

Conformance findings (each anchored at a concrete line, suppressible
with ``allow[wire-protocol] -- reason`` like any other):

- an op is sent but no dispatch branch handles it (dropped handler);
- a handler branch reads a request key no sender writes (renamed field);
- a sent request key the server never reads (dead weight on the wire);
- a reply key the client reads that the op's handler never writes
  (renamed reply key);
- a written reply key no reader consumes — checked only for ops that
  HAVE an in-scope reader (control ops answered to out-of-tree clients
  are not guessed about), and only when the op has no read-miss (a
  rename shows up as ONE finding, its read side, not two);
- the declared ``_OPS`` metric vocabulary disagrees with the extracted
  contract (handled + server-initiated frame ops).
"""

from __future__ import annotations

import ast
from typing import Optional

from ewdml_tpu_torch.analysis.engine import ProjectRule, walk


def _str_const(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _self_method_calls(node):
    """``self.<m>(...)`` call nodes under ``node``."""
    for n in walk(node):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == "self"):
            yield n


def _param_at(fn, index: int) -> Optional[str]:
    """The name of ``fn``'s ``index``-th positional parameter after
    ``self`` (None past the end)."""
    params = [a.arg for a in fn.args.args if a.arg != "self"]
    return params[index] if index < len(params) else None


class _Dict:
    """A resolved request/reply dict: literal keys (node per key for
    anchoring) + whether a ``**`` made it open-ended. ``where`` names the
    file of a key absorbed from another file's helper method."""

    def __init__(self):
        self.keys: dict[str, ast.AST] = {}
        self.where: dict = {}
        self.open = False
        self.ctx = None

    @property
    def op(self) -> Optional[str]:
        node = self.keys.get("op")
        return _str_const(getattr(node, "_wp_value", None)) \
            if node is not None else None


def _stores_to(name: str, fn) -> list:
    """``(lineno, col, slice, value)`` of every ``name["k"] = v`` in
    ``fn``."""
    out = []
    for node in walk(fn):
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == name):
            out.append((node.lineno, node.col_offset,
                        node.targets[0].slice, node.value))
    return out


def _resolve_dict(arg, fn, before=None, methods=None) -> Optional[_Dict]:
    """Resolve ``arg`` (a Call argument) to a dict: an inline literal, or
    a Name assigned a dict literal in ``fn``. Attribution is POSITIONAL:
    a rebound request var (`req = {...}; send; req = {...}; send`) must
    resolve each send to its most recent preceding binding — merging
    every binding would invent keys on the wrong op and mask real drift.
    ``before`` is the consuming call's ``(lineno, col)``; the chosen
    binding is the last one at or before it (falling back to the last
    binding overall for loop wrap-around), and only ``name["k"] = v``
    stores BETWEEN that binding and the call are absorbed — including
    those of a ``methods`` entry (name -> ``(ctx, def)``) the dict is
    handed to in between, one level."""
    d = _Dict()

    def absorb(lit: ast.Dict):
        for k, v in zip(lit.keys, lit.values):
            if k is None:
                d.open = True  # {**base, ...}
                continue
            key = _str_const(k)
            if key is not None:
                k._wp_value = v
                d.keys[key] = k
            else:
                d.open = True  # computed key: unknowable

    def absorb_store(sl, value, where=None):
        key = _str_const(sl)
        if key is not None:
            sl._wp_value = value
            d.keys[key] = sl
            if where is not None:
                d.where[key] = where
        else:
            d.open = True

    if isinstance(arg, ast.Dict):
        absorb(arg)
        return d
    if not isinstance(arg, ast.Name):
        return None
    binds = []   # (lineno, col, Dict literal)
    for node in walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == arg.id:
                    binds.append((node.lineno, node.col_offset, node.value))
    if not binds:
        return None
    prior = [b for b in binds if before is None or b[:2] <= before]
    pick = max(prior) if prior else max(binds)

    def between(ln, col):
        if (ln, col) < pick[:2]:
            return False  # against an earlier binding
        # after the call: next round's keys
        return not (before is not None and prior and (ln, col) > before)

    absorb(pick[2])
    for ln, col, sl, value in _stores_to(arg.id, fn):
        if between(ln, col):
            absorb_store(sl, value)
    for call in _self_method_calls(fn):
        entry = (methods or {}).get(call.func.attr)
        if entry is None or not between(call.lineno, call.col_offset):
            continue
        mctx, mfn = entry
        for i, a in enumerate(call.args):
            param = _param_at(mfn, i)
            if isinstance(a, ast.Name) and a.id == arg.id and param:
                for _ln, _col, sl, value in _stores_to(param, mfn):
                    absorb_store(sl, value, mctx)
    return d


def _is_var(node, var: str, passthrough) -> bool:
    """``node`` is ``var``, or ``var`` returned by a pass-through call."""
    if isinstance(node, ast.Name):
        return node.id == var
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in passthrough and node.args
            and isinstance(node.args[0], ast.Name)
            and node.args[0].id == var)


def _dict_reads(var: str, node, passthrough=frozenset()) -> list:
    """(key, anchor) request/reply-key reads of ``var`` inside ``node``:
    ``var.get("k")``, ``var["k"]``, ``"k" in var`` (``var`` also seen
    through a pass-through call)."""
    out = []
    for n in walk(node):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "get"
                and _is_var(n.func.value, var, passthrough) and n.args):
            key = _str_const(n.args[0])
            if key is not None:
                out.append((key, n))
        elif (isinstance(n, ast.Subscript)
              and _is_var(n.value, var, passthrough)
              and isinstance(n.ctx, ast.Load)):
            key = _str_const(n.slice)
            if key is not None:
                out.append((key, n))
        elif isinstance(n, ast.Compare) and len(n.ops) == 1 \
                and isinstance(n.ops[0], (ast.In, ast.NotIn)) \
                and _is_var(n.comparators[0], var, passthrough):
            key = _str_const(n.left)
            if key is not None:
                out.append((key, n))
    return out


def _call_request_arg(call: ast.Call):
    """The request-dict argument of a protocol send: ``X.call(dict, ...)``
    (first arg) or ``client_call(addr, dict, ...)`` (second). None when
    the call is neither — ONE definition, so a future entry point is
    added in exactly one place."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "call" and call.args:
        return call.args[0]
    if isinstance(f, ast.Name) and f.id == "client_call" \
            and len(call.args) >= 2:
        return call.args[1]
    return None


def _send_call(value, passthrough) -> Optional[ast.Call]:
    """The protocol send ``value`` evaluates: the send itself, its
    ``[0]`` (the reply header), or either handed through a pass-through
    call (``_expect(conn.call(req)[0], "x_ok")``)."""
    if (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
            and value.func.id in passthrough and value.args):
        value = value.args[0]
    if (isinstance(value, ast.Subscript)
            and isinstance(value.slice, ast.Constant)
            and value.slice.value == 0):
        value = value.value
    if isinstance(value, ast.Call) and _call_request_arg(value) is not None:
        return value
    return None


def _op_branches(fn) -> list:
    """``(op_literal, test_node, body)`` for each ``if <opvar> == "lit"``
    (or ``X.get("op") == "lit"``) branch in ``fn``. The op var is a
    parameter named ``op`` or any name assigned from ``X.get("op")`` /
    ``X["op"]``."""
    opvars = {a.arg for a in fn.args.args if a.arg == "op"} \
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) else set()
    for node in walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            v = node.value
            if (isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
                    and v.func.attr == "get" and v.args
                    and _str_const(v.args[0]) == "op"):
                opvars.add(node.targets[0].id)
            elif (isinstance(v, ast.Subscript)
                  and _str_const(v.slice) == "op"):
                opvars.add(node.targets[0].id)
    out = []
    for node in walk(fn):
        if not isinstance(node, ast.If):
            continue
        t = node.test
        if not (isinstance(t, ast.Compare) and len(t.ops) == 1
                and isinstance(t.ops[0], ast.Eq)):
            continue
        lit = _str_const(t.comparators[0])
        if lit is None:
            continue
        left = t.left
        is_opvar = isinstance(left, ast.Name) and left.id in opvars
        is_get = (isinstance(left, ast.Call)
                  and isinstance(left.func, ast.Attribute)
                  and left.func.attr == "get" and left.args
                  and _str_const(left.args[0]) == "op")
        if is_opvar or is_get:
            out.append((lit, node, node.body))
    return out


def _frames_in(node, resolver_fn, methods=None) -> list:
    """``_Dict`` frames from ``make_request({...})`` calls under ``node``
    (dict resolved against ``resolver_fn``'s scope)."""
    out = []
    for n in walk(node):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "make_request" and n.args):
            d = _resolve_dict(n.args[0], resolver_fn,
                              before=(n.lineno, n.col_offset),
                              methods=methods)
            if d is not None:
                out.append(d)
    return out


def _passthrough_functions(contexts) -> frozenset:
    """Names of module-level functions that return their first parameter
    on every path (``_expect(header, op)``): a check around a value,
    transparent to what the value is."""
    out = set()
    for ctx in contexts:
        for fn in ctx.tree.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or not fn.args.args:
                continue
            first = fn.args.args[0].arg
            returns = [n for n in walk(fn) if isinstance(n, ast.Return)]
            if returns and all(isinstance(r.value, ast.Name)
                               and r.value.id == first for r in returns):
                out.add(fn.name)
    return frozenset(out)


class _Send:
    def __init__(self, op, d, node, ctx, fn, var):
        self.op = op          # request op literal
        self.dict = d         # _Dict of request keys
        self.node = node      # the .call(...) node (anchor)
        self.ctx = ctx
        self.fn = fn          # enclosing function
        self.reply_var = var  # name bound to the reply header, or None
        self.reply_reads: dict[str, ast.AST] = {}


class Contract:
    """The protocol both endpoints implement, as extracted."""

    def __init__(self):
        self.handled: dict[str, tuple] = {}      # op -> (ctx, fn, body)
        #: op -> {key: (ctx, anchor)} request reads of its branches
        self.branch_reads: dict[str, dict] = {}
        self.reply_frames: dict[str, list] = {}  # op -> [_Dict]
        self.shared_frames: list = []            # outside-branch frames
        self.global_reads: set = set()
        self.server_classes: set = set()         # (rel, class name)
        self.vocab = None                        # (_OPS set, ctx, node)
        self.sends: list[_Send] = []
        self.augment: set = set()
        #: reply op -> keys read in a client ``X.get("op") == op`` branch
        self.client_branch_reads: dict[str, set] = {}

    # -- the contract as data (what the parity test compares) -----------

    def server_initiated(self) -> set:
        frame_ops = {f.op for fs in self.reply_frames.values() for f in fs
                     if f.op} | {f.op for f in self.shared_frames if f.op}
        return {o for o in frame_ops if o in self.client_branch_reads}

    def ops(self) -> set:
        """Handled ops plus the server-initiated frame ops."""
        return set(self.handled) | self.server_initiated()

    def request_keys(self, op: str) -> set:
        """Keys of ``op``'s request: those sent and those its handlers
        read (``op`` itself excluded)."""
        keys = set(self.branch_reads.get(op, {}))
        for s in self.sends:
            if s.op == op:
                keys |= set(s.dict.keys)
        return keys - {"op"}

    def reply_keys(self, op: str) -> set:
        """Keys of ``op``'s reply frames and those its senders read
        (``op`` itself excluded)."""
        keys = set()
        for f in self.reply_frames.get(op, []):
            keys |= set(f.keys)
        for s in self.sends:
            if s.op == op:
                keys |= set(s.reply_reads)
        return keys - {"op"}


class _Scope:
    """Project-wide lookups the extraction shares: every function, the
    classes by name (for base-class resolution), the pass-through
    functions, and each file's parent map."""

    def __init__(self, pctx):
        self.functions = []  # (ctx, fn) — every function in every file
        self.classes: dict[str, list] = {}
        for ctx in pctx.contexts:
            for node in walk(ctx.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.functions.append((ctx, node))
                elif isinstance(node, ast.ClassDef):
                    self.classes.setdefault(node.name, []).append(
                        (ctx, node))
        self.passthrough = _passthrough_functions(pctx.contexts)
        self._cache: dict = {}

    @staticmethod
    def enclosing_class(ctx, fn) -> Optional[ast.ClassDef]:
        parents = getattr(ctx, "_wp_parents", None)
        if parents is None:
            parents = {}
            for node in walk(ctx.tree):
                for child in ast.iter_child_nodes(node):
                    parents[id(child)] = node
            ctx._wp_parents = parents
        node = parents.get(id(fn))
        while node is not None:
            if isinstance(node, ast.ClassDef):
                return node
            node = parents.get(id(node))
        return None

    def chain(self, ctx, cls) -> list:
        """``(ctx, ClassDef)`` of ``cls`` and its in-scope base classes,
        nearest first (bases resolved by trailing name)."""
        if cls is None:
            return []
        out, seen, todo = [], set(), [(ctx, cls)]
        while todo:
            c_ctx, c = todo.pop(0)
            if id(c) in seen:
                continue
            seen.add(id(c))
            out.append((c_ctx, c))
            for b in c.bases:
                name = b.attr if isinstance(b, ast.Attribute) else \
                    getattr(b, "id", None)
                todo.extend(self.classes.get(name, []))
        return out

    def class_methods(self, ctx, cls) -> dict:
        """:meth:`methods` of ``cls``'s chain, cached per class."""
        key = ("methods", id(cls))
        if key not in self._cache:
            self._cache[key] = self.methods(self.chain(ctx, cls))
        return self._cache[key]

    def class_wrappers(self, ctx, cls) -> dict:
        """The send wrappers among ``cls``'s methods, cached per class."""
        key = ("wrappers", id(cls))
        if key not in self._cache:
            self._cache[key] = _send_wrappers(
                self.class_methods(ctx, cls), self.passthrough)
        return self._cache[key]

    @staticmethod
    def methods(chain) -> dict:
        """name -> ``(ctx, def)`` over a class chain, nearest first."""
        out = {}
        for c_ctx, c in chain:
            for n in c.body:
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.setdefault(n.name, (c_ctx, n))
        return out


def extract(pctx) -> Contract:
    """Both endpoints' halves of the protocol over a
    :class:`~ewdml_tpu_torch.analysis.project.ProjectContext`."""
    scope = _Scope(pctx)
    pt = scope.passthrough
    con = Contract()
    # -- server side: dispatch functions (>=2 frame-writing branches).
    # Branch extraction is two ast.walks per function — computed once
    # here and reused by the client-side loop below (the pre-commit
    # hot path runs this over every file).
    branch_cache: dict[int, list] = {}
    dispatch = []
    for ctx, fn in scope.functions:
        branches = branch_cache[id(fn)] = _op_branches(fn)
        if len(branches) < 2:
            continue
        cls = scope.enclosing_class(ctx, fn)
        chain = scope.chain(ctx, cls)
        methods = scope.methods(chain)
        # Frames are computed ONCE per branch here and reused below for
        # reply collection (each _frames_in re-walks the whole function
        # per site via _resolve_dict).
        per_branch = []
        for op, test, body in branches:
            frames = []
            for b in body:
                frames.extend(_frames_in(b, fn, methods))
            for f in frames:
                # Remember which FILE wrote the frame: with several
                # dispatchers handling one op (apply server + pull
                # replica), a frame-key violation must anchor to the
                # file holding the literal, or its allow[] comment can
                # never attach.
                f.ctx = ctx
            # one level: frames in server-class methods the branch calls
            frames.extend(_called_method_frames(methods, body))
            per_branch.append((op, test, body, frames))
        if len({op for op, _t, _b, f in per_branch if f}) >= 2:
            dispatch.append((ctx, fn, cls, chain, methods, per_branch))
    for _ctx, _fn, _cls, chain, _m, _pb in dispatch:
        con.server_classes.update((c_ctx.rel, c.name) for c_ctx, c in chain)
    for ctx, fn, cls, chain, methods, per_branch in dispatch:
        header_vars = _header_vars(fn)
        covered = []
        for op, test, body, frames in per_branch:
            con.handled[op] = (ctx, fn, body)
            covered.extend(body)
            reads = con.branch_reads.setdefault(op, {})
            module = ast.Module(body=body, type_ignores=[])
            for var in header_vars:
                for key, anchor in _dict_reads(var, module, pt):
                    reads.setdefault(key, (ctx, anchor))
            # one level: the header handed to a server-class method
            for key, where in _called_method_reads(methods, module,
                                                   header_vars, pt):
                reads.setdefault(key, where)
            con.reply_frames.setdefault(op, []).extend(frames)
        # reads/frames OUTSIDE any branch: global / shared
        in_branch = set()
        for b in covered:
            for n in walk(b):
                in_branch.add(id(n))
        for var in header_vars:
            for key, anchor in _dict_reads(var, fn, pt):
                if id(anchor) not in in_branch:
                    con.global_reads.add(key)
        for d in _frames_in(fn, fn, methods):
            if all(id(a) not in in_branch for a in d.keys.values()):
                d.ctx = ctx
                con.shared_frames.append(d)
        # sibling server-class reads (the socket handler loop, the outer
        # segmentation wrapper, a base class's helpers) are global too
        for _c_ctx, c in chain:
            for sib in walk(c):
                if (not isinstance(sib, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                        or sib is fn):
                    continue
                for var in _header_vars(sib):
                    for key, _ in _dict_reads(var, sib, pt):
                        con.global_reads.add(key)
        v = _ops_vocabulary(ctx)
        if v is not None:
            con.vocab = v
    if not con.handled:
        return con
    # -- client side: sends, reply reads, augmentation keys
    for ctx, fn in scope.functions:
        cls = scope.enclosing_class(ctx, fn)
        if cls is not None and (ctx.rel, cls.name) in con.server_classes:
            continue
        con.sends.extend(_sends_in(scope, ctx, fn, cls))
        for d in _frames_in(fn, fn):
            if d.open:
                con.augment.update(d.keys)
            elif d.op is not None:
                # a closed client frame is a send too (the fault
                # injectors' hand-rolled requests)
                con.sends.append(_Send(d.op, d, next(iter(d.keys.values())),
                                       ctx, fn, None))
        branches = branch_cache[id(fn)]
        dict_vars = _local_dict_vars(fn, pt) if branches else ()
        for op, _test, body in branches:
            reads = con.client_branch_reads.setdefault(op, set())
            for n in body:
                for var in dict_vars:
                    reads.update(k for k, _ in _dict_reads(var, n, pt))
    return con


def _header_vars(fn) -> set:
    """Names in ``fn`` that hold a request header: params named
    ``header``, and vars unpacked from ``parse_request(...)``."""
    out = set()
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        out.update(a.arg for a in fn.args.args if a.arg == "header")
    for node in walk(fn):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Name)
                and node.value.func.id == "parse_request"
                and node.targets
                and isinstance(node.targets[0], ast.Tuple)
                and node.targets[0].elts
                and isinstance(node.targets[0].elts[0], ast.Name)):
            out.add(node.targets[0].elts[0].id)
    return out


def _local_dict_vars(fn, passthrough) -> set:
    """Candidate reply-header names in a client function: anything
    unpacked from a ``.call`` / ``parse_request`` result."""
    out = set()
    for node in walk(fn):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        f = node.value.func
        is_call = (_send_call(node.value, passthrough) is not None
                   or (isinstance(f, ast.Name)
                       and f.id in ("client_call", "parse_request")))
        if not is_call:
            continue
        t = node.targets[0]
        if isinstance(t, ast.Tuple) and t.elts \
                and isinstance(t.elts[0], ast.Name):
            out.add(t.elts[0].id)
        elif isinstance(t, ast.Name):
            out.add(t.id)
    return out


def _called_method_frames(methods, body) -> list:
    """Frames written by server-class methods a branch calls (one level —
    the ``_kill_frame`` pattern), each tagged with its method's file."""
    out = []
    for b in body:
        for n in _self_method_calls(b):
            entry = methods.get(n.func.attr)
            if entry is None:
                continue
            mctx, mfn = entry
            for f in _frames_in(mfn, mfn, methods):
                f.ctx = mctx
                out.append(f)
    return out


def _called_method_reads(methods, body, header_vars, passthrough) -> list:
    """``(key, (ctx, anchor))`` reads a server-class method makes of the
    parameter a branch hands a header var to, one level
    (``self._push_record(header, sections)``)."""
    out = []
    for n in _self_method_calls(body):
        entry = methods.get(n.func.attr)
        if entry is None:
            continue
        mctx, mfn = entry
        for i, a in enumerate(n.args):
            param = _param_at(mfn, i)
            if isinstance(a, ast.Name) and a.id in header_vars and param:
                out.extend((key, (mctx, anchor)) for key, anchor
                           in _dict_reads(param, mfn, passthrough))
    return out


def _ops_vocabulary(ctx) -> Optional[tuple]:
    """``_OPS = frozenset({...})`` in the dispatch file, if any."""
    for node in walk(ctx.tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_OPS"
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Name)
                and node.value.func.id == "frozenset"
                and node.value.args
                and isinstance(node.value.args[0], (ast.Set, ast.List,
                                                    ast.Tuple))):
            ops = {_str_const(e) for e in node.value.args[0].elts}
            if None not in ops:
                return ops, ctx, node
    return None


def _send_wrappers(methods, passthrough) -> dict:
    """name -> ``(index, reads)`` of the methods that send their
    ``index``-th parameter as a request and bind the reply
    (``_call(header, ok)``), with the reads they make of that reply."""
    out = {}
    for name, (_mctx, mfn) in methods.items():
        params = [a.arg for a in mfn.args.args if a.arg != "self"]
        for n in walk(mfn):
            if not (isinstance(n, ast.Assign)
                    and isinstance(n.value, ast.Call)):
                continue
            call = _send_call(n.value, passthrough)
            arg = _call_request_arg(call) if call is not None else None
            if not (isinstance(arg, ast.Name) and arg.id in params):
                continue
            var = _bound_name(n.targets[0])
            out[name] = (params.index(arg.id),
                         _dict_reads(var, mfn, passthrough) if var else [])
            break
    return out


def _bound_name(target) -> Optional[str]:
    """The reply header's name in an assignment target: ``header`` of
    ``header, _ = ...`` or of ``header = ...``."""
    if isinstance(target, ast.Tuple) and target.elts \
            and isinstance(target.elts[0], ast.Name):
        return target.elts[0].id
    if isinstance(target, ast.Name):
        return target.id
    return None


def _sends_in(scope, ctx, fn, cls) -> list:
    """``conn.call({...})`` / ``client_call(addr, {...})`` sites in
    ``fn`` — and calls of a send wrapper (``self._call({...}, ok)``) —
    with the reply var's reads attributed LINEARLY (a rebinding of the
    same name reattributes later reads), following the header one level
    into ``self._m(header)`` calls. An unbound send's reply may still be
    read in place (``self._call({...}, ok)["k"]``)."""
    pt = scope.passthrough
    methods = scope.class_methods(ctx, cls)
    wrappers = scope.class_wrappers(ctx, cls)
    stmts = list(walk(fn))

    def request_arg(call):
        """``(request arg, the wrapper's own reply reads)`` of a send or a
        send-wrapper call (else None)."""
        arg = _call_request_arg(call)
        if arg is not None:
            return arg, ()
        if (isinstance(call.func, ast.Attribute)
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id == "self"
                and call.func.attr in wrappers):
            index, reads = wrappers[call.func.attr]
            if index < len(call.args):
                return call.args[index], reads
        return None

    bound = {}  # id(send call) -> (statement, reply var)
    for n in stmts:
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            value, var = n.value, _bound_name(n.targets[0])
        elif isinstance(n, ast.Expr) and isinstance(n.value, ast.Call):
            value, var = n.value, None  # bare call: no reply binding
        else:
            continue
        call = _send_call(value, pt)
        if call is None and request_arg(value) is not None:
            call = value
        if call is not None:
            bound[id(call)] = (n, var)
    parents = None
    sends, call_nodes = [], []
    for c in stmts:
        if not isinstance(c, ast.Call):
            continue
        found = request_arg(c)
        if found is None:
            continue
        arg, wrapper_reads = found
        anchor, var = bound.get(id(c), (c, None))
        d = _resolve_dict(arg, fn, before=(anchor.lineno, anchor.col_offset))
        if d is None or d.op is None:
            continue
        s = _Send(d.op, d, anchor, ctx, fn, var)
        for key, a in wrapper_reads:
            s.reply_reads.setdefault(key, a)
        if id(c) not in bound:
            if parents is None:
                parents = {id(ch): p for p in stmts
                           for ch in ast.iter_child_nodes(p)}
            for key, a in _reads_in_place(c, parents):
                s.reply_reads.setdefault(key, a)
        sends.append(s)
        call_nodes.append((anchor, var, s))
    # Linear attribution: a read belongs to the most recent preceding
    # binding of its name (rebinding the var reattributes later reads).
    for var in {v for _, v, _ in call_nodes if v}:
        reads = _dict_reads(var, fn, pt)
        passes = [  # header handed to a self-method, one level
            (n, n.func.attr) for n in _self_method_calls(fn)
            if any(isinstance(a, ast.Name) and a.id == var
                   for a in n.args)]
        var_binds = [(n.lineno, n.col_offset, s)
                     for n, v, s in call_nodes if v == var]
        for key, anchor in reads:
            owner = _owner(var_binds, anchor)
            if owner is not None:
                owner.reply_reads.setdefault(key, anchor)
        for node, mname in passes:
            owner = _owner(var_binds, node)
            entry = methods.get(mname)
            if owner is None or entry is None:
                continue
            # map to the callee's first non-self param name
            param = _param_at(entry[1], 0)
            if param is None:
                continue
            for key, anchor in _dict_reads(param, entry[1], pt):
                owner.reply_reads.setdefault(key, anchor)
    return sends


def _reads_in_place(call, parents) -> list:
    """``(key, anchor)`` reads made on ``call``'s result itself, its
    ``[0]`` (the header of a ``(header, sections)`` reply) included:
    ``call(...)["k"]``, ``call(...).get("k")``."""
    node = call
    parent = parents.get(id(node))
    if (_call_request_arg(call) is not None
            and isinstance(parent, ast.Subscript)
            and isinstance(parent.slice, ast.Constant)
            and parent.slice.value == 0):
        node, parent = parent, parents.get(id(parent))
    if (isinstance(parent, ast.Subscript) and parent.value is node
            and _str_const(parent.slice) is not None):
        return [(_str_const(parent.slice), parent)]
    if (isinstance(parent, ast.Attribute) and parent.attr == "get"):
        get = parents.get(id(parent))
        if (isinstance(get, ast.Call) and get.func is parent and get.args
                and _str_const(get.args[0]) is not None):
            return [(_str_const(get.args[0]), get)]
    return []


def _owner(var_binds, node):
    """The send whose binding most recently precedes ``node``."""
    pos = (node.lineno, node.col_offset)
    best = None
    for ln, col, s in var_binds:
        if (ln, col) <= pos:
            if best is None or (ln, col) > best[:2]:
                best = (ln, col, s)
    if best is None and var_binds:
        # read lexically BEFORE any binding (loop wrap-around):
        # attribute to the last binding in the loop body
        best = max(var_binds, key=lambda x: x[:2])
    return best[2] if best else None


def contract_of(paths) -> Contract:
    """:func:`extract` over the ``*.py`` files under ``paths`` (for
    comparing two endpoint sets' contracts; unparseable files are
    skipped)."""
    import os

    from ewdml_tpu_torch.analysis.engine import FileContext, iter_py_files
    from ewdml_tpu_torch.analysis.project import ProjectContext

    contexts = []
    for f in iter_py_files(paths):
        try:
            with open(f, encoding="utf-8") as fh:
                contexts.append(FileContext(f, os.path.basename(f),
                                            fh.read()))
        except (SyntaxError, UnicodeDecodeError):
            continue
    return extract(ProjectContext(contexts))


class WireProtocolRule(ProjectRule):
    id = "wire-protocol"
    title = ("ps_net endpoint conformance: ops handled, request/reply "
             "keys written on one side and read on the other")

    def check_project(self, pctx):
        con = extract(pctx)
        if not con.handled:
            return []  # no server in scope: nothing to conform against
        out = []
        sent_keys: dict[str, set] = {}
        read_by_op: dict[str, set] = {}
        for s in con.sends:
            sent_keys.setdefault(s.op, set()).update(s.dict.keys)
            read_by_op.setdefault(s.op, set()).update(s.reply_reads)
            # -- dropped handler
            if s.op not in con.handled:
                out.append(s.ctx.violation(
                    self.id, s.node,
                    f"op '{s.op}' is sent here but NO dispatch branch "
                    f"handles it — the server answers 'unknown op' at "
                    f"runtime (dropped/renamed handler)"))
        for s in con.sends:
            if s.op not in con.handled:
                continue  # already reported; key checks would cascade
            frames = con.reply_frames.get(s.op, []) + con.shared_frames
            frame_keys = set().union(*[f.keys for f in frames]) \
                if frames else set()
            frame_open = any(f.open for f in frames)
            for key, anchor in s.reply_reads.items():
                if key not in frame_keys and not frame_open:
                    out.append(s.ctx.violation(
                        self.id, anchor,
                        f"reply key '{key}' is read here but the "
                        f"'{s.op}' handler never writes it "
                        f"(renamed/dropped reply key)"))
        # -- request keys: per handled op with known senders
        for op in con.handled:
            if op not in sent_keys:
                continue  # no in-scope sender (control clients live
                #            outside the package): nothing to compare
            sent = sent_keys[op] | con.augment | {"op"}
            reads = con.branch_reads.get(op, {})
            miss = [k for k in reads if k not in sent]
            for k in miss:
                rctx, anchor = reads[k]
                out.append(rctx.violation(
                    self.id, anchor,
                    f"'{op}' handler reads request key '{k}' that no "
                    f"sender writes (renamed/dropped request field)"))
            if not miss:
                for s in con.sends:
                    if s.op != op:
                        continue
                    for k, anchor in s.dict.keys.items():
                        if (k != "op" and k not in reads
                                and k not in con.global_reads):
                            out.append(s.ctx.violation(
                                self.id, anchor,
                                f"request key '{k}' is sent with op "
                                f"'{op}' but the server never reads it "
                                f"(dead weight on the wire)"))
        # -- unread reply keys (only ops with an in-scope reader, only
        #    when the op has no read-miss: a rename is ONE finding)
        for op, frames in con.reply_frames.items():
            readers = read_by_op.get(op, set())
            if not readers:
                continue
            # The read-miss guard must see the SAME frame set the
            # read-miss check used (shared outside-branch frames
            # included) — otherwise a read satisfied only by a shared
            # frame would read as a miss here and silently disable the
            # unread check for the whole op.
            all_keys = set().union(
                *[f.keys for f in frames + con.shared_frames]) \
                if frames or con.shared_frames else set()
            if any(k not in all_keys for k in readers):
                continue  # a rename reports ONCE, on its read side
            for f in frames:
                fop = f.op
                for k, anchor in f.keys.items():
                    if k == "op" or k in readers:
                        continue
                    if fop and k in con.client_branch_reads.get(fop, ()):
                        continue  # read in a reply-op branch (kill path)
                    ctx = (f.where.get(k) or f.ctx
                           or con.handled[op][0])
                    out.append(ctx.violation(
                        self.id, anchor,
                        f"reply key '{k}' of the '{op}' handler is "
                        f"written but never read by any client in scope "
                        f"(unread field — drop it or say who consumes "
                        f"it)"))
        # -- declared vocabulary conformance
        if con.vocab is not None:
            ops_set, vctx, vnode = con.vocab
            expect = con.ops()
            for op in sorted(set(con.handled) - ops_set):
                out.append(vctx.violation(
                    self.id, vnode,
                    f"op '{op}' is handled but missing from the declared "
                    f"_OPS vocabulary (its metrics would be clamped to "
                    f"'other')"))
            for op in sorted(ops_set - expect):
                out.append(vctx.violation(
                    self.id, vnode,
                    f"_OPS declares '{op}' but no handler or "
                    f"server-initiated frame implements it (stale "
                    f"vocabulary entry)"))
        return out
