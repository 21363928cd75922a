"""The port's whole-program analysis on the port's own idioms, the real
parameter server's resolved facts, and the port's wire contract against
the JAX package's (``ewdml_tpu_torch/analysis``).

Oracles (exact):
- a port-shaped fixture and its JAX-shaped twin give the same
  ``(rule, message)`` findings under every mutation — a reply frame built
  by a base-class helper, a request read made by the helper a branch hands
  its header to (``_push_record``), reply keys stored by a helper
  (``_plan_reply``), a send wrapped in a pass-through check
  (``_expect``) or sent through a wrapper method (``_call``), a thread's
  body split into private helpers — and the twin gives the reference
  engine's findings too;
- ``ParameterServer``'s locks, ``_apply_adapt_plan``'s ``requires[]`` and
  ``AsyncWorker``'s thread entry resolve as in the JAX package;
- the port's extractor over both packages' endpoint files finds the same
  ops, equal to ``_OPS``, and the same request and reply keys per op,
  apart from the port-only keys named here;
- a plain ``push`` frame never reads the subtree fields an ``agg_push``
  carries (a fault the wire rule found).
"""

import os
import textwrap

import pytest
import torch

from ewdml_tpu.analysis import engine as ref_engine
from ewdml_tpu.analysis.rules import make_rules as ref_rules
from ewdml_tpu_torch.analysis import engine as port_engine
from ewdml_tpu_torch.analysis.engine import FileContext
from ewdml_tpu_torch.analysis.project import ProjectContext
from ewdml_tpu_torch.analysis.rules import make_rules as port_rules
from ewdml_tpu_torch.analysis.rules.wire_protocol import contract_of

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ewdml_tpu_torch")

#: Reply keys only the port writes: the ``stats`` reply's per-kernel
#: launch counts and its count of decodes that fell back to the plain
#: version on the card.
PORT_ONLY_REPLY_KEYS = {"stats": {"kernel_launches", "plain_decodes_on_card"}}
#: Request keys only the port reads or sends (none).
PORT_ONLY_REQUEST_KEYS: dict = {}


def lint_tree(tmp_path, files: dict, engine=port_engine, rules=port_rules):
    for name, src in files.items():
        f = tmp_path / name
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(textwrap.dedent(src))
    return engine.run_lint([str(tmp_path)], rules=rules())


def findings(rep) -> list:
    return sorted((v.rule, v.message) for v in rep.new)


# -- the wire rule on the port's idioms ---------------------------------------

#: The JAX package's shape: every read and frame inline in the branch.
INLINE_SERVER = """\
    from wire import make_request, parse_request

    class Server:
        def _dispatch(self, header, sections):
            op = header.get("op")
            if op == "get":
                reply = {"op": "get_ok", "value": 1}
                reply["version"] = header.get("want", 0)
                return make_request(reply)
            if op == "put":
                _ = header["value"]
                return make_request({"op": "put_ok", "stored": True})
            if op == "bye":
                return make_request({"op": "bye_ok"})
            return make_request({"op": "error", "detail": "?"})
"""

#: The port's shape: the put branch's read in a helper handed the header,
#: its ack built by a base class, the get reply's key stored by a helper.
PORT_SERVER = """\
    from wire import make_request, parse_request

    class Endpoint:
        def _put_ok_frame(self, stored):
            return make_request({"op": "put_ok", "stored": stored})

        def _put_record(self, header, sections):
            return header["value"], sections

    class Server(Endpoint):
        def _version_reply(self, header, reply):
            reply["version"] = header.get("want", 0)

        def _dispatch(self, header, sections):
            op = header.get("op")
            if op == "get":
                reply = {"op": "get_ok", "value": 1}
                self._version_reply(header, reply)
                return make_request(reply)
            if op == "put":
                _ = self._put_record(header, sections)
                return self._put_ok_frame(True)
            if op == "bye":
                return make_request({"op": "bye_ok"})
            return make_request({"op": "error", "detail": "?"})
"""

INLINE_CLIENT = """\
    class Client:
        def run(self, conn):
            header, _ = conn.call({"op": "get", "want": 3})
            assert header["op"] == "get_ok"
            value = header["value"]
            version = header.get("version")
            req = {"op": "put", "value": value}
            header, _ = conn.call(req)
            assert header["op"] == "put_ok"
            if not header.get("stored"):
                raise RuntimeError(version)
            conn.call({"op": "bye"})
"""

#: The port's client: a pass-through check around a send, and a send
#: wrapper whose reply is read in place.
PORT_CLIENT = """\
    def _expect(header, op):
        if header.get("op") != op:
            raise RuntimeError(header)
        return header

    class Client:
        def _call(self, conn, req, ok):
            reply, _ = conn.call(req)
            return _expect(reply, ok)

        def run(self, conn):
            header = _expect(conn.call({"op": "get", "want": 3})[0],
                             "get_ok")
            value = header["value"]
            version = header.get("version")
            req = {"op": "put", "value": value}
            if not self._call(conn, req, "put_ok").get("stored"):
                raise RuntimeError(version)
            self._call(conn, {"op": "bye"}, "bye_ok")
"""

#: (side, old, new) edits applied to both shapes alike; each names one
#: drift the rule must report the same way whatever the shape.
MUTATIONS = {
    "conforming": [],
    "renamed_request_read": [("server", 'header["value"]',
                              'header["payload"]')],
    "renamed_reply_write": [("server", '"stored":', '"saved":')],
    "renamed_helper_store": [("server", 'reply["version"]',
                              'reply["ver"]')],
    "dead_request_key": [("client", '"want": 3', '"want": 3, "junk": 0')],
    "renamed_reply_read": [("client", 'header["value"]', 'header["val"]')],
    "renamed_in_place_read": [("client", '.get("stored")',
                               '.get("saved")')],
    "dropped_handler": [("server", '        if op == "bye":\n'
                        '            return make_request({"op": '
                        '"bye_ok"})\n', "")],
}


def _mutate(server: str, client: str, name: str):
    sides = {"server": textwrap.dedent(server),
             "client": textwrap.dedent(client)}
    for side, old, new in MUTATIONS[name]:
        assert old in sides[side], (side, old)
        sides[side] = sides[side].replace(old, new)
    return {"server.py": sides["server"], "client.py": sides["client"]}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_port_shaped_endpoints_match_their_inline_twin(tmp_path, mutation):
    """Exact: the port's helpers, base classes, pass-through check and
    send wrapper hide nothing the inline shape shows: the same findings
    from the port's engine on both shapes and from the reference engine
    on the inline one."""
    port = findings(lint_tree(tmp_path / "port",
                              _mutate(PORT_SERVER, PORT_CLIENT, mutation)))
    inline = findings(lint_tree(
        tmp_path / "inline", _mutate(INLINE_SERVER, INLINE_CLIENT, mutation)))
    ref = findings(lint_tree(
        tmp_path / "ref", _mutate(INLINE_SERVER, INLINE_CLIENT, mutation),
        engine=ref_engine, rules=ref_rules))
    assert port == inline == ref
    assert (port == []) == (mutation == "conforming")
    assert all(rule == "wire-protocol" for rule, _ in port)


# -- guarded-by-flow on a thread body split into helpers ----------------------

THREAD_HELPERS = """\
    import threading

    class Worker(threading.Thread):
        def __init__(self):
            super().__init__()
            self.progress = 0

        def run(self):
            self.{helper}()
            print(self.progress)

        def {helper}(self):
            self.progress = 1
{extra}"""

THREAD_INLINE = """\
    import threading

    class Worker(threading.Thread):
        def __init__(self):
            super().__init__()
            self.progress = 0

        def run(self):
            self.progress = 1
            print(self.progress)
{extra}"""

REPORT = """\

        def report(self):
            return self.progress
"""


@pytest.mark.parametrize("extra", ["", REPORT], ids=["own", "shared"])
def test_private_thread_helpers_run_on_the_thread(tmp_path, extra):
    """Exact: a private helper only ``run`` calls is on the thread's side
    (the port's split ``AsyncWorker.run``): findings as for the inline
    body, in both engines; a main-path reader still fires. A public
    helper stays on the main path (someone outside may call it)."""
    inline = {"w.py": THREAD_INLINE.format(extra=extra)}
    want = findings(lint_tree(tmp_path / "ref", inline, engine=ref_engine,
                              rules=ref_rules))
    assert findings(lint_tree(tmp_path / "inline", inline)) == want
    split = {"w.py": THREAD_HELPERS.format(helper="_advance", extra=extra)}
    assert findings(lint_tree(tmp_path / "split", split)) == want
    assert (want == []) == (extra == "")
    public = {"w.py": THREAD_HELPERS.format(helper="advance", extra=extra)}
    assert [r for r, _ in findings(lint_tree(tmp_path / "public",
                                             public))] == ["guarded-by-flow"]


# -- the real port ------------------------------------------------------------

def test_real_project_context_resolves_the_ps():
    """Exact, as the JAX package's: the PS locks resolve as non-reentrant
    TimedLocks, the adapt-plan helper carries its requires[] contract,
    AsyncWorker.run is a thread entry."""
    path = os.path.join(PORT, "parallel", "ps.py")
    with open(path) as f:
        ctx = FileContext(path, "ewdml_tpu_torch/parallel/ps.py", f.read())
    classes = {c.node.name: c for c in ProjectContext([ctx]).classes}
    ps = classes["ParameterServer"]
    assert ps.lock_attrs == {"_lock": False, "_update_lock": False}
    assert ps.methods["_apply_adapt_plan"].requires == {"_update_lock"}
    assert classes["AsyncWorker"].thread_entries == {"run"}


def _endpoints(package: str) -> list:
    return [os.path.join(REPO, package, *p.split("/")) for p in
            ("parallel/ps_net.py", "parallel/replica.py",
             "parallel/aggtree.py", "federated/loop.py")]


def test_wire_contract_matches_the_reference():
    """Exact: one extractor over both packages' endpoint files. The ops
    (handled plus server-initiated) are equal and equal each package's
    ``_OPS``; per op, the request keys (sent or read) and the reply keys
    (written or read) are equal apart from the port-only keys."""
    ref = contract_of(_endpoints("ewdml_tpu"))
    port = contract_of(_endpoints("ewdml_tpu_torch"))
    assert port.ops() == ref.ops() == port.vocab[0] == ref.vocab[0]
    assert {s.op for s in port.sends} == {s.op for s in ref.sends}
    for op in sorted(ref.ops()):
        extra = PORT_ONLY_REQUEST_KEYS.get(op, set())
        assert port.request_keys(op) - extra == ref.request_keys(op), op
        extra = PORT_ONLY_REPLY_KEYS.get(op, set())
        assert port.reply_keys(op) - extra == ref.reply_keys(op), op
        assert extra <= port.reply_keys(op), op


def test_plain_push_reads_no_subtree_fields():
    """Exact: a ``push`` frame is a leaf push whatever else its header
    holds, as in the JAX package: ``weight`` and ``members`` are read
    only from an ``agg_push`` (the branch passes them)."""
    from ewdml_tpu_torch.parallel.ps_net import _Endpoint

    header = {"op": "push", "worker": 3, "version": 7, "loss": 0.5,
              "push_id": "3:7", "plan_version": 1, "round": 2,
              "weight": 5, "members": [1, 2]}
    rec = _Endpoint._push_record(None, header, [b"x"], round_id=2)
    assert (rec.worker, rec.version, rec.loss, rec.push_id,
            rec.plan_version, rec.round_id) == (3, 7, 0.5, "3:7", 1, 2)
    assert rec.weight == 1 and tuple(rec.members) == ()
    sub = _Endpoint._push_record(None, header, [b"x"], weight=5,
                                 members=(1, 2))
    assert sub.weight == 5 and tuple(sub.members) == (1, 2)
    assert sub.round_id == -1
