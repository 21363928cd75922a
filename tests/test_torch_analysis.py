"""The port's static-analysis engine and rule pack
(``ewdml_tpu_torch/analysis``) against the JAX package's
(``ewdml_tpu/analysis``).

Oracle: exact. Every fixture shape of the reference's own analysis tests
whose rule keeps its semantics goes through both engines, with
``ewdml_tpu.`` replaced by ``ewdml_tpu_torch.`` in the port's copy, and
the two must report the same ``(rule, file, line, col)`` findings, the
same suppressed count and the same verdict. ``prng`` and ``jit-purity``
speak torch in the port: their fixtures come in line-aligned pairs, the
JAX spelling through the reference engine and the torch spelling through
the port's. Then the headline: the whole port lints clean against its
empty committed baseline, inside the reference's time budget.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from ewdml_tpu.analysis import cli as ref_cli
from ewdml_tpu.analysis import engine as ref_engine
from ewdml_tpu.analysis.rules import make_rules as ref_rules
from ewdml_tpu_torch.analysis import cli as port_cli
from ewdml_tpu_torch.analysis import engine as port_engine
from ewdml_tpu_torch.analysis.rules import make_rules as port_rules
from ewdml_tpu_torch.obs import clock
from test_analysis import CONFIG_FIXTURE, LOCK_FIXTURE
from test_analysis_project import (CYCLE_FIXTURE, REQUIRES_FIXTURE,
                                   THREAD_FIXTURE, WIRE_CLIENT, WIRE_SERVER)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ewdml_tpu_torch")

ENGINES = {"ref": (ref_engine, ref_rules), "port": (port_engine, port_rules)}


def port_source(src: str) -> str:
    return src.replace("ewdml_tpu.", "ewdml_tpu_torch.")


def run_case(tmp_path, side: str, files: dict, single: bool = False,
             rules=None, scope=None, **kw):
    """Write ``files`` under ``<tmp>/<side>/pkg`` and lint them with one
    side's engine: the one file alone (``single``, the reference's
    ``lint_source``) or the whole tree (``lint_tree``). ``rules`` names a
    subset of rule ids; ``scope`` the file names of a ``file_scope``."""
    engine, make_rules = ENGINES[side]
    root = tmp_path / side / "pkg"
    for name, src in files.items():
        f = root / name
        f.parent.mkdir(parents=True, exist_ok=True)
        src = textwrap.dedent(src)
        f.write_text(port_source(src) if side == "port" else src)
    paths = [str(root / next(iter(files)))] if single else [str(root)]
    pack = make_rules()
    if rules is not None:
        pack = [r for r in pack if r.id in rules]
    if scope is not None:
        kw["file_scope"] = {str(root / n) for n in scope}
    return engine.run_lint(paths, rules=pack, **kw)


def summary(rep):
    return (sorted((v.rule, v.path, v.line, v.col) for v in rep.new),
            rep.suppressed, rep.ok, rep.files)


def src(name="snippet.py", text="", **kw):
    return dict(files={name: text}, single=True, **kw)


def tree(files, **kw):
    return dict(files=files, **kw)


def _wire(server=WIRE_SERVER, client=WIRE_CLIENT, **kw):
    return tree({"server.py": server, "client.py": client}, **kw)


# Each case is one fixture shape of tests/test_analysis.py or
# tests/test_analysis_project.py, by the test it comes from.
CASES = {
    # -- clock
    "clock_fires_on_stdlib_clock_reads": src(text="""\
        import time
        t0 = time.perf_counter()
        stamp = time.time()
        dur = time.monotonic_ns()
    """),
    "clock_fires_on_from_import_and_alias": src(text="""\
        from time import perf_counter
        import time
        mono = time.monotonic
    """),
    "clock_fires_through_import_as_alias": src(text="""\
        import time as t
        t0 = t.perf_counter()
        t.sleep(1)
    """),
    "clock_clean_spelling_and_sleep": src(text="""\
        import time
        from ewdml_tpu.obs import clock
        t0 = clock.monotonic()
        stamp = clock.wall_ns()
        time.sleep(0.1)
    """),
    "clock_module_itself_exempt": src("obs/clock.py", """\
        import time
        monotonic = time.perf_counter
    """),
    "clock_suppression": src(text="""\
        import time
        t = time.time()  # ewdml: allow[clock] -- provenance stamp
    """),
    # -- config-hash
    "config_clean_when_registries_cover": src(text=CONFIG_FIXTURE),
    "config_fires_on_unregistered_field": src(
        text=CONFIG_FIXTURE + "        batch_size: int = 128\n"),
    "config_fires_on_field_in_both": src(text=CONFIG_FIXTURE.replace(
        '("train_dir",)', '("train_dir", "lr")')),
    "config_fires_on_stale_registry_entry": src(text=CONFIG_FIXTURE.replace(
        '("lr", "seed")', '("lr", "seed", "gone")')),
    "config_fires_on_missing_registries": src(text="""\
        import dataclasses

        @dataclasses.dataclass
        class TrainConfig:
            lr: float = 0.01
    """),
    "config_other_files_ignored": src(text="""\
        class NotTheConfig:
            lr: float = 0.01
    """),
    "config_suppression": src(
        text=CONFIG_FIXTURE + "        extra: int = 0"
        "  # ewdml: allow[config-hash] -- fixture demonstrating allow\n"),
    # -- lock
    "lock_clean_when_locked": src(text=LOCK_FIXTURE),
    "lock_fires_on_unlocked_read_and_write": src(text=LOCK_FIXTURE + """\

        def peek(self):
            return len(self._pending)

        def reset(self):
            self._pending = []
"""),
    "lock_fires_on_unlocked_method_call_mutation": src(
        text=LOCK_FIXTURE + """\

        def sneak(self, buf):
            self._pending.append(buf)
            self._pending[0].extend(buf)
"""),
    "lock_closure_does_not_inherit_lock": src(text=LOCK_FIXTURE + """\

        def sched(self):
            with self._lock:
                def later():
                    return self._pending
                return later
"""),
    "lock_init_exempt_and_unannotated_free": src(text="""\
        class Free:
            def __init__(self):
                self.stats = {}

            def bump(self):
                self.stats["n"] = 1
    """),
    "lock_suppression": src(text=LOCK_FIXTURE + """\

        def peek(self):
            # ewdml: allow[lock] -- racy len() is fine for logging
            return len(self._pending)
"""),
    # -- metric-name
    "metric_fires_on_fstring_and_nonliteral_names": src(text="""\
        from ewdml_tpu.obs import registry as oreg

        def record(op, name):
            oreg.histogram(f"ps_net.{op}.latency_s").observe(1)
            oreg.counter(name).inc()
            oreg.gauge("ps." + name).set(2)
    """),
    "metric_fires_on_bad_literal_shape_and_from_import": src(text="""\
        from ewdml_tpu.obs.registry import counter, histogram

        counter("NoDots").inc()
        histogram("Upper.Case").observe(1)
        counter("net.bytes_sent").inc()
    """),
    "metric_clean_literal_dotted_names": src(text="""\
        from ewdml_tpu.obs import registry as oreg

        oreg.counter("net.bytes_sent").inc()
        oreg.gauge("ps_net.connections").set(1)
        oreg.histogram("ps_net.push.latency_s").observe(0.1)
        # unrelated .counter() receivers are not the registry surface
        class T:
            def counter(self, x):
                return x
        T().counter(object())
    """),
    "metric_trace_counter_is_not_the_registry": src(text="""\
        from ewdml_tpu.obs import trace as otrace

        otrace.counter(f"bytes-{1}", 42)
    """),
    "metric_suppression_with_bounded_reason": src(text="""\
        from ewdml_tpu.obs import registry as oreg

        for key in ("a_s", "b_s"):
            # ewdml: allow[metric-name] -- bounded: literal tuple
            oreg.counter(f"train.{key}").inc()
    """),
    "metric_registry_module_self_calls_covered": src("obs/registry.py", """\
        class MetricsRegistry:
            def absorb(self, timing):
                for key in timing:
                    self.counter(f"train.{key}").inc(1)
    """),
    "metric_self_calls_elsewhere_are_not": src("other.py", """\
        class Other:
            def absorb(self, timing):
                for key in timing:
                    self.counter(f"train.{key}").inc(1)
    """),
    # -- trace-name
    "trace_fires_on_fstring_and_nonliteral_names": src(text="""\
        from ewdml_tpu.obs import trace as otrace

        def record(op, name):
            with otrace.span(f"worker/{op}", step=1):
                pass
            otrace.instant(name)
            otrace.complete("ps_net/" + op, 0, 1)
    """),
    "trace_fires_on_bad_literal_shape_and_from_import": src(text="""\
        from ewdml_tpu.obs.trace import instant, span

        span("noslash")
        instant("Upper/Case")
        span("worker/pull")
    """),
    "trace_clean_literals_and_bounded_ternary": src(text="""\
        from ewdml_tpu.obs import trace as otrace

        with otrace.span("worker/push", step=2, req="1.a"):
            pass
        otrace.instant("net/retry", attempt=1)
        otrace.complete("ps_net/recv", 0, 5)
        otrace.counter("train/loss", 0.5)
        win = True
        with otrace.span("train/window" if win else "train/step"):
            pass
        # unrelated .span() receivers are not the trace surface
        class T:
            def span(self, x):
                return x
        T().span(object())
    """),
    "trace_registry_names_are_not_this_rule": src(text="""\
        from ewdml_tpu.obs import registry as oreg

        def f(op):
            oreg.histogram(f"ps_net.{op}.latency_s").observe(1)
    """),
    "trace_suppression_with_bounded_reason": src(text="""\
        from ewdml_tpu.obs import trace as otrace

        for kind in ("nan", "stall"):
            # ewdml: allow[trace-name] -- bounded: literal tuple
            otrace.instant(f"health/{kind}")
    """),
    "trace_module_itself_exempt": src("obs/trace.py", """\
        def span(name):
            return name

        span("whatever shape")
    """),
    # -- engine
    "engine_reasonless_allow_is_a_finding": src(text="""\
        import time
        t = time.time()  # ewdml: allow[clock]
    """),
    "engine_allow_only_covers_named_rule": src(text="""\
        import time
        t = time.time()  # ewdml: allow[prng] -- wrong rule named
    """),
    "engine_parse_error_is_a_finding": src(text="def broken(:\n"),
    "engine_marker_inside_string_is_not_a_comment": src(text="""\
        import time
        s = "# ewdml: allow[clock] -- not a comment"
        t = time.time()
    """),
    # -- lock-order
    "order_seeded_two_lock_cycle_fires_once": tree(
        {"pair.py": CYCLE_FIXTURE}),
    "order_consistent_nesting_clean": tree({"pair.py": CYCLE_FIXTURE.replace(
        "with self.mu_b:\n                with self.mu_a:",
        "with self.mu_a:\n                with self.mu_b:")}),
    "order_reacquire_through_helper_call_fires": tree({"s.py": """\
        import threading

        class S:
            def __init__(self):
                self.mu = threading.Lock()

            def outer(self):
                with self.mu:
                    self._inner()

            def _inner(self):
                with self.mu:
                    pass
    """}),
    "order_rlock_reacquire_clean": tree({"s.py": """\
        import threading

        class S:
            def __init__(self):
                self.mu = threading.RLock()

            def outer(self):
                with self.mu:
                    self._inner()

            def _inner(self):
                with self.mu:
                    pass
    """}),
    "order_canonical_order_pinned_as_data": tree({"s.py": """\
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._update_lock = threading.Lock()

            def bad(self):
                with self._lock:
                    with self._update_lock:
                        pass
    """}),
    "order_requires_annotation_feeds_the_graph": tree({"s.py": """\
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._update_lock = threading.Lock()

            # ewdml: requires[_lock]
            def helper(self):
                with self._update_lock:
                    pass

            def caller(self):
                with self._lock:
                    self.helper()
    """}),
    "order_multi_item_with_is_an_ordered_acquisition": tree({"s.py": """\
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._update_lock = threading.Lock()

            def bad(self):
                with self._lock, self._update_lock:
                    pass
    """}),
    "order_with_item_helper_call_is_followed": tree({"s.py": """\
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._update_lock = threading.Lock()

            def _snap(self):
                with self._update_lock:
                    return object()

            def bad(self):
                with self._lock, self._snap():
                    pass
    """}),
    "order_suppression": tree({"s.py": """\
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._update_lock = threading.Lock()

            def bad(self):
                with self._lock:
                    # ewdml: allow[lock-order] -- fixture: documented
                    # single-threaded startup path
                    with self._update_lock:
                        pass
    """}),
    # -- guarded-by-flow: requires[] conformance
    "requires_tn_guarded_attr_in_helper_and_locked_caller": tree(
        {"s.py": REQUIRES_FIXTURE}),
    "requires_tp_unlocked_caller_fires": tree({"s.py": REQUIRES_FIXTURE + """\

        def sneaky_caller(self):
            return self._drain()
"""}),
    "requires_tn_caller_with_own_requires": tree(
        {"s.py": REQUIRES_FIXTURE + """\

        # ewdml: requires[_lock]
        def relay(self):
            return self._drain()
"""}),
    "requires_call_inside_a_with_item_is_checked": tree(
        {"s.py": REQUIRES_FIXTURE + """\

        def item_caller(self, cm):
            with cm(self._drain()):
                pass
"""}),
    "requires_closure_does_not_inherit_the_lock": tree(
        {"s.py": REQUIRES_FIXTURE + """\

        def scheduler(self):
            with self._lock:
                def later():
                    return self._drain()
                return later
"""}),
    "requires_without_it_the_helper_itself_fires_lock": tree(
        {"s.py": REQUIRES_FIXTURE.replace(
            "        # ewdml: requires[_lock]\n", "")}),
    "requires_suppression": tree({"s.py": REQUIRES_FIXTURE + """\

        def audited_caller(self):
            # ewdml: allow[guarded-by-flow] -- fixture: single-threaded
            # teardown, lock provably uncontended
            return self._drain()
"""}),
    # -- guarded-by-flow: thread escape
    "thread_tp_thread_written_attr_read_on_main_path": tree(
        {"w.py": THREAD_FIXTURE.format(ann="")}),
    "thread_tn_atomic_annotation": tree(
        {"w.py": THREAD_FIXTURE.format(ann="  # ewdml: atomic")}),
    "thread_tn_read_only_sharing": tree({"w.py": THREAD_FIXTURE.replace(
        "self.progress = 1", "print(self.progress)").format(ann="")}),
    "thread_tp_thread_target_spawn": tree({"w.py": """\
        import threading

        class Pump:
            def __init__(self):
                self.state = None
                t = threading.Thread(target=self._loop, daemon=True)
                t.start()

            def _loop(self):
                self.state = "hot"

            def read(self):
                return self.state
    """}),
    "thread_tn_guarded_by_hands_off_to_lock_rule": tree({"w.py": """\
        import threading

        class Pump:
            def __init__(self):
                self._lock = threading.Lock()
                self.state = None  # ewdml: guarded-by[_lock]
                t = threading.Thread(target=self._loop, daemon=True)
                t.start()

            def _loop(self):
                with self._lock:
                    self.state = "hot"

            def read(self):
                with self._lock:
                    return self.state
    """}),
    "thread_suppression_on_defining_assignment": tree(
        {"w.py": THREAD_FIXTURE.format(
            ann="  # ewdml: allow[guarded-by-flow] -- fixture: join() "
                "precedes every report() call")}),
    # -- wire-protocol
    "wire_conforming_pair_is_clean": _wire(),
    "wire_dropped_handler_fires_exactly_once": _wire(
        server=WIRE_SERVER.replace(
            '            if op == "put":\n'
            '                _ = header["value"]\n'
            '                return make_request({"op": "put_ok", '
            '"stored": True})\n', "")),
    "wire_renamed_reply_key_fires_exactly_once": _wire(
        server=WIRE_SERVER.replace('"value": 1', '"val": 1')),
    "wire_unread_reply_field_fires_exactly_once": _wire(
        server=WIRE_SERVER.replace('"value": 1,', '"value": 1, "extra": 9,')),
    "wire_renamed_request_key_fires_exactly_once": _wire(
        server=WIRE_SERVER.replace('header["value"]', 'header["payload"]')),
    "wire_dead_request_key_fires": _wire(
        client=WIRE_CLIENT.replace('"want": 3', '"want": 3, "junk": 0')),
    "wire_ops_vocabulary_missing_op": _wire(server=WIRE_SERVER.replace(
        "from wire import make_request, parse_request",
        "from wire import make_request, parse_request\n\n"
        '    _OPS = frozenset({"get", "bye"})')),
    "wire_ops_vocabulary_stale_op": _wire(server=WIRE_SERVER.replace(
        "from wire import make_request, parse_request",
        "from wire import make_request, parse_request\n\n"
        '    _OPS = frozenset({"get", "put", "bye", "zap"})')),
    "wire_rebound_request_var_resolves_per_send": _wire(client="""\
        class Client:
            def run(self, conn):
                req = {"op": "put", "value": 4}
                header, _ = conn.call(req)
                assert header["op"] == "put_ok"
                if not header.get("stored"):
                    return None
                req = {"op": "get", "want": 1}
                header, _ = conn.call(req)
                assert header["op"] == "get_ok"
                return header["value"], header.get("version")
    """),
    "wire_unread_check_not_disabled_by_shared_frame_reads": _wire(
        server=WIRE_SERVER.replace('"value": 1,', '"value": 1, "extra": 9,')
        .replace('{"op": "error", "detail": "?"}',
                 '{"op": "error", "detail": "?", "msg": "x"}'),
        client=WIRE_CLIENT.replace(
            'version = header.get("version")',
            'version = header.get("version")\n'
            '            note = header.get("msg")')),
    "wire_suppression": _wire(server=WIRE_SERVER.replace(
        '"value": 1,',
        '"value": 1,\n'
        '                     # ewdml: allow[wire-protocol] -- '
        'consumed by an out-of-tree control client\n'
        '                     "extra": 9,')),
    # -- stale-allow
    "stale_unused_allow_is_a_finding": tree({"m.py": """\
        import time
        # ewdml: allow[clock] -- historical; the call below was fixed
        x = 1
    """}),
    "stale_used_allow_is_not_stale": tree({"m.py": """\
        import time
        t = time.time()  # ewdml: allow[clock] -- provenance stamp
    """}),
    "stale_allow_for_a_rule_that_did_not_run_is_not_judged": src(
        "m.py", "# ewdml: allow[wire-protocol] -- judged by the full run\n"
        "x = 1\n", rules=["clock"]),
    "stale_pseudo_rule_allow_is_reported": tree({"m.py": """\
        x = 1  # ewdml: allow[parse] -- wishful thinking
    """}),
    "stale_typoed_rule_id_is_reported": tree({"m.py": """\
        x = 1  # ewdml: allow[clokc] -- misspelled id
    """}),
    "stale_project_allow_in_subset_run_is_not_judged": src(
        "client_only.py", "# ewdml: allow[wire-protocol] -- server half "
        "is out of view here\nx = 1\n", project_complete=False),
    "stale_project_allow_in_full_run_is_judged": src(
        "client_only.py", "# ewdml: allow[wire-protocol] -- server half "
        "is out of view here\nx = 1\n"),
    "stale_fixed_violation_makes_its_allow_stale": src(
        "m.py", "import time\nt = 0  # ewdml: allow[clock] -- stamp\n"),
    # -- --changed scoping
    "changed_file_scope_restricts_per_file_rules": tree(
        {"a.py": "import time\nt = time.time()\n",
         "b.py": "import time\nt = time.time()\n"}, scope=["a.py"]),
    "changed_scoped_mode_never_blinds_project_rules": _wire(
        server=WIRE_SERVER.replace('"value": 1', '"val": 1'), scope=[]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_findings_match_reference(tmp_path, name):
    """Exact: the same findings, suppressions and verdict from both
    engines on one of the reference's fixture shapes."""
    case = CASES[name]
    ref = summary(run_case(tmp_path, "ref", **case))
    port = summary(run_case(tmp_path, "port", **case))
    assert port == ref


# -- prng and jit-purity: line-aligned JAX / torch pairs ---------------------

PAIRS = {
    "prng_global_draws_and_literal_keys": ("""\
        import numpy as np
        import jax
        x = np.random.rand(3)
        np.random.seed(0)
        k = jax.random.key(0)
        k2 = jax.random.PRNGKey(42)
    """, """\
        import numpy as np
        from ewdml_tpu_torch.utils import prng
        x = np.random.rand(3)
        np.random.seed(0)
        k = prng.key(0)
        k2 = torch.Generator().manual_seed(42)
    """),
    "prng_torch_global_generators": ("""\
        import numpy as np
        np.random.seed(0)
        x = np.random.randn(3)
        y = rng.randn(3)
        z = np.random.randint(0, 9)
    """, """\
        import torch
        torch.manual_seed(0)
        x = torch.randn(3)
        y = torch.randn(3, generator=g)
        z = torch.randint(0, 9, (1,))
    """),
    "prng_unseeded_constructors": ("""\
        import numpy as np
        rng = np.random.default_rng()
        rs = np.random.RandomState()
    """, None),
    "prng_clean_seeded_constructors_and_derived_keys": ("""\
        import numpy as np
        import jax
        rng = np.random.RandomState(1234)
        gen = np.random.default_rng(7)
        k = jax.random.key(cfg_seed)
        k2 = jax.random.fold_in(jax.random.key(seed ^ 0x5EED), 3)
    """, """\
        import numpy as np
        from ewdml_tpu_torch.utils import prng
        rng = np.random.RandomState(1234)
        gen = np.random.default_rng(7)
        k = prng.key(cfg_seed)
        k2 = prng.fold_in(prng.key(seed ^ 0x5EED), 3)
    """),
    "prng_suppression_standalone_comment_block": ("""\
        import jax
        template = compress(
            # ewdml: allow[prng] -- schema template; bytes
            # discarded, only shapes register
            zeros, jax.random.key(0))
    """, """\
        from ewdml_tpu_torch.utils.prng import key
        template = compress(
            # ewdml: allow[prng] -- schema template; bytes
            # discarded, only shapes register
            zeros, key(0))
    """),
    "jit_fires_inside_step_body_and_decorated": ("""\
        import jax, time, logging
        logger = logging.getLogger(__name__)

        def body(state, x):
            print("tracing!")
            logger.info("once")
            t = time.perf_counter()
            with state.lock:
                pass
            return state

        @jax.jit
        def apply_bufs(p, b):
            mu.acquire()
            return p

        step = None
    """, """\
        import torch, time, logging
        logger = logging.getLogger(__name__)

        def body(state, x):
            print("capturing!")
            logger.info("once")
            t = time.perf_counter()
            with state.lock:
                pass
            return state

        # captured below, K steps in one graph
        def apply_bufs(p, b):
            mu.acquire()
            return p

        step = WindowStep(apply_bufs, cfg, world, 4)
    """),
    "jit_fires_via_jit_called_name": ("""\
        import jax

        def _apply(params, buf):
            print("boo")
            return params

        apply_delta = jax.jit(_apply)
    """, """\
        import torch

        def _apply(params, buf):
            print("boo")
            return params

        apply_delta = torch.cuda.make_graphed_callables(_apply, (p, b))
    """),
    "jit_fires_in_a_function_called_under_graph_capture": ("""\
        import jax, logging

        def _fwd(x):
            logging.info("shape %s", x.shape)
            return x

        def capture(x):
            fwd = jax.jit(_fwd)
            return fwd(x)
    """, """\
        import torch, logging

        def _fwd(x):
            logging.info("shape %s", x.shape)
            return x

        def capture(x, graph):
            with torch.cuda.graph(graph):
                return _fwd(x)
    """),
    "jit_clean_pure_body_and_host_code": ("""\
        import jax, time

        def body(state, x):
            y = jax.numpy.tanh(x)
            jax.debug.print("traced-safe {}", y)
            return state, y

        def host_loop(step):
            print("host print is fine")
            time.sleep(1)
    """, """\
        import torch, time

        def body(state, x):
            y = torch.tanh(x)
            y = y * 1
            return state, y

        def host_loop(step):
            print("host print is fine")
            time.sleep(1)
    """),
    "jit_suppression": ("""\
        def step_body(state):
            print("x")  # ewdml: allow[jit-purity] -- fixture
            return state
    """, None),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_prng_and_jit_purity_pairs_match_reference(tmp_path, name):
    """Exact: the JAX spelling through the reference engine and its
    line-aligned torch twin through the port's give the same findings
    (``None``: the twin is the same source)."""
    jax_src, torch_src = PAIRS[name]
    ref = run_case(tmp_path, "ref", {"snippet.py": jax_src}, single=True)
    f = tmp_path / "port.py"
    f.write_text(textwrap.dedent(torch_src or jax_src))
    port = port_engine.run_lint([str(f)], rules=port_rules())
    if "clean" not in name and "suppression" not in name:
        assert ref.new  # the pair exercises the rule, not just silence
    assert ([(v.rule, v.line, v.col) for v in port.new]
            == [(v.rule, v.line, v.col) for v in ref.new])
    assert port.suppressed == ref.suppressed


def test_jit_purity_flags_statements_inside_the_capture_block(tmp_path):
    """Exact: a side effect written in the ``with torch.cuda.graph``
    block itself also runs once at capture (port-only: the JAX package
    has no such block)."""
    f = tmp_path / "cap.py"
    f.write_text(textwrap.dedent("""\
        import torch, time

        def capture(graph, step, x):
            with torch.cuda.graph(graph):
                t0 = time.perf_counter()
                y = step(x)
            return y
    """))
    rep = port_engine.run_lint([str(f)], rules=port_rules())
    assert [(v.rule, v.line) for v in rep.new] == [("clock", 5),
                                                   ("jit-purity", 5)]
    assert "capture" in rep.new[1].message


# -- the baseline, the reports and the CLI -----------------------------------

def _baseline_steps(engine, make_rules, d):
    f = d / "mod.py"
    bl = d / "baseline.json"
    out = []
    f.write_text("import time\nt0 = time.time()\nt1 = time.monotonic()\n")
    rep = engine.run_lint([str(f)], rules=make_rules())
    engine.write_baseline(str(bl), rep.new)
    for text in ("import time\nt0 = time.time()\nt1 = time.monotonic()\n",
                 "import time\nt0 = time.time()\n",
                 "import time\n\n\nx = 1\nt0 = time.time()\nt1 = 2\n"):
        f.write_text(text)
        for scope in (None, set()):
            rep = engine.run_lint([str(f)], rules=make_rules(),
                                  baseline_path=str(bl), file_scope=scope)
            out.append((rep.ok, len(rep.new), len(rep.baselined),
                        [k.split("::", 1)[1] for k in rep.stale]))
    out.append(json.loads(bl.read_text()))
    return out


def test_baseline_roundtrip_matches_reference(tmp_path):
    """Exact: add -> shrink -> stale, line drift and the scoped run's
    skipped staleness go the same way in both engines, and the baseline
    files they write are the same."""
    sides = {}
    for side, (engine, make_rules) in ENGINES.items():
        d = tmp_path / side
        d.mkdir()
        sides[side] = _baseline_steps(engine, make_rules, d)
    assert sides["port"] == sides["ref"]
    assert sides["port"][0] == (True, 0, 2, [])
    assert not sides["port"][2][0]  # a fixed violation: its entry is stale


def test_render_json_shape_matches_reference(tmp_path):
    """Exact: the JSON report has the reference's keys and rows."""
    payloads = []
    for side in ENGINES:
        rep = run_case(tmp_path, side, {"m.py": "import time\n"
                                        "t = time.time()\n"}, single=True)
        payloads.append(json.loads(ENGINES[side][0].render_json(rep)))
    ref, port = payloads
    assert set(port) == set(ref)
    assert ([{k: v for k, v in row.items() if k != "message"}
             for row in port["violations"]]
            == [{k: v for k, v in row.items() if k != "message"}
                for row in ref["violations"]])


def _rule_ids(cli, capsys) -> list:
    assert cli.main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.splitlines()
    return [ln.split()[0] for ln in lines if not ln.startswith("suppress:")]


def test_list_rules_gives_the_reference_ids(capsys):
    """Exact: ``--list-rules`` names the same ten rules, in the same
    order, in both packages."""
    ref = _rule_ids(ref_cli, capsys)
    port = _rule_ids(port_cli, capsys)
    assert port == ref
    assert set(port) == {"clock", "prng", "config-hash", "jit-purity",
                         "lock", "metric-name", "trace-name", "lock-order",
                         "guarded-by-flow", "wire-protocol"}


def test_write_baseline_needs_a_target_and_skips_pseudo_findings(tmp_path,
                                                                 capsys):
    """Exact, both CLIs: --write-baseline over explicit paths refuses the
    committed package baseline (rc 2, the file untouched); with a target
    it writes the clock finding, never the stale allow, which stays red."""
    results = []
    for side, cli in (("ref", ref_cli), ("port", port_cli)):
        pkg = tmp_path / side / "pkg"
        pkg.mkdir(parents=True)
        (pkg / "m.py").write_text(
            "import time\nt = time.time()\n"
            "x = 1  # ewdml: allow[clock] -- unused: nothing to cover\n")
        before = open(cli.default_baseline_path()).read()
        rcs = [cli.main(["--write-baseline", str(pkg)])]
        assert open(cli.default_baseline_path()).read() == before
        bl = tmp_path / side / "bl.json"
        rcs.append(cli.main(["--write-baseline", "--baseline", str(bl),
                             str(pkg)]))
        capsys.readouterr()
        rcs.append(cli.main(["--baseline", str(bl), str(pkg)]))
        out = capsys.readouterr().out
        results.append((rcs, "[stale-allow]" in out, "1 baselined" in out,
                        "stale entry" in out))
    assert results[1] == results[0] == ([2, 0, 1], True, True, False)


def test_changed_mode_scopes_to_the_git_diff_in_both(tmp_path, capsys):
    """Exact: ``--changed`` lints only the git-changed file with either
    CLI; outside a work tree it falls back to the full run."""
    d = tmp_path / "pkg"
    d.mkdir()
    (d / "old.py").write_text("import time\nt = time.time()\n")

    def git(*args):
        return subprocess.run(
            ["git", "-C", str(tmp_path), "-c", "user.email=t@t",
             "-c", "user.name=t", *args],
            capture_output=True, text=True, timeout=60)

    if git("init", "-q").returncode != 0:
        pytest.skip("git unavailable")
    git("add", "-A")
    assert git("commit", "-q", "-m", "seed").returncode == 0
    (d / "new.py").write_text("import time\nt = time.time()\n")
    seen = []
    for cli in (ref_cli, port_cli):
        rc_full = cli.main([str(d)])
        full = capsys.readouterr().out
        rc = cli.main(["--changed", str(d)])
        out = capsys.readouterr().out
        seen.append((rc_full, "old.py" in full, "new.py" in full,
                     rc, "old.py" in out, "new.py" in out))
    assert seen[1] == seen[0] == (1, True, True, 1, False, True)
    assert port_cli._git_unquote('"a\\303\\244.py"') == "a\u00e4.py"


def test_cli_exit_codes_through_both_entry_points(tmp_path):
    """Exact: ``python -m ewdml_tpu_torch.cli lint`` and ``python -m
    ewdml_tpu_torch.analysis`` exit 1 on a dirty tree naming the rule,
    0 once it is clean, 2 on a missing path."""
    dirty = tmp_path / "pkg"
    dirty.mkdir()
    (dirty / "bad.py").write_text("import time\nt = time.time()\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    cli = [sys.executable, "-m", "ewdml_tpu_torch.cli", "lint"]
    mod = [sys.executable, "-m", "ewdml_tpu_torch.analysis"]

    def run(argv):
        return subprocess.run(argv, capture_output=True, text=True,
                              cwd=REPO, env=env, timeout=120)

    r = run(cli + [str(dirty)])
    assert r.returncode == 1 and "[clock]" in r.stdout, r.stdout + r.stderr
    (dirty / "bad.py").write_text("x = 1\n")
    r = run(mod + [str(dirty)])
    assert r.returncode == 0, r.stdout + r.stderr
    r = run(mod + [str(tmp_path / "missing")])
    assert r.returncode == 2


def test_analysis_imports_only_the_standard_library():
    """Exact: every module of the port's analysis package loads in a fresh
    interpreter without torch, numpy, jax or the JAX package."""
    probe = textwrap.dedent("""\
        import importlib, pkgutil, sys
        import ewdml_tpu_torch.analysis as a
        names = [m.name for m in pkgutil.walk_packages(
            a.__path__, "ewdml_tpu_torch.analysis.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("torch", "numpy", "jax", "jaxlib", "ewdml_tpu"))
        print(len(names), bad)
        sys.exit(1 if bad else 0)
    """)
    p = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr[-3000:]
    assert int(p.stdout.split()[0]) >= 15


# -- the whole port ----------------------------------------------------------

def _carried_allows() -> int:
    """``allow[...]`` comments in the port outside the analysis package."""
    n = 0
    for f in port_engine.iter_py_files([PORT]):
        if os.sep + "analysis" + os.sep in f:
            continue
        with open(f, encoding="utf-8") as fh:
            n += len(re.findall(r"#\s*ewdml:\s*allow\[", fh.read()))
    return n


def test_port_lints_clean_inside_budget():
    """THE acceptance gate, as the reference's: zero findings over the
    whole port against its committed baseline, which is empty, no stale
    entry, every carried allow used, in under 15 s."""
    baseline = port_cli.default_baseline_path()
    with open(baseline) as f:
        assert json.load(f)["entries"] == {}
    t0 = clock.monotonic()
    rep = port_engine.run_lint([PORT], rules=port_rules(),
                               baseline_path=baseline)
    elapsed = clock.monotonic() - t0
    assert rep.new == [], "\n".join(v.render() for v in rep.new)
    assert rep.stale == [], rep.stale
    assert rep.files > 90
    allows = _carried_allows()
    assert allows >= 17
    assert rep.suppressed >= allows
    assert elapsed < 15.0, f"port lint took {elapsed:.1f}s"
