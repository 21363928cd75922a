"""Span and event tracing over a preallocated ring buffer
(``ewdml_tpu/obs/trace.py``; the same shard format and environment).

- **A no-op by default.** Until :func:`configure` runs (``--trace-dir`` or
  ``EWDML_TRACE_DIR``), :func:`span` returns one shared null context
  manager and :func:`complete`, :func:`instant` and :func:`counter` return
  at once.
- **Bounded memory.** Events land in a ring of ``capacity`` slots; past it
  the oldest slot is overwritten in place.
- **One shard per process.** :func:`flush` rewrites
  ``shard-<role>-<pid>.jsonl`` in the trace directory: a meta line, then
  one JSON event per line. ``ewdml_tpu/obs/merge.py`` reads a port shard
  and a JAX shard alike and aligns them (same host: the same
  ``CLOCK_MONOTONIC``).

Timestamps are ``obs.clock.monotonic_ns`` values. An event's role is the
process role given to :func:`configure`, or the calling thread's, set by
:func:`set_role` (the in-process parameter server runs its workers as
threads of one process). ``EWDML_TRACE_ROLE`` names the role when a parent
process arms tracing for its children.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import socket
import threading

from ewdml_tpu_torch.obs import clock

#: Ring capacity (events), ~100 bytes each on disk.
DEFAULT_CAPACITY = 65536

_tracer = None            # the process's Tracer; None = tracing disabled
_tls = threading.local()  # per-thread role


class _NullSpan:
    """The shared context manager of disabled tracing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _role_for_event(tracer) -> str:
    return getattr(_tls, "role", None) or tracer.role


class _Span:
    """A span of enabled tracing: recorded (start, duration) on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = clock.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t1 = clock.monotonic_ns()
        t = self._tracer
        t._append(("span", self._name, self._t0, t1 - self._t0,
                   threading.current_thread().name, _role_for_event(t),
                   self._args))
        return False


class Tracer:
    """One per process: the ring buffer and the shard file."""

    def __init__(self, trace_dir: str, role: str,
                 capacity: int = DEFAULT_CAPACITY):
        self.trace_dir = os.path.abspath(trace_dir)
        self.role = role
        self.capacity = max(1, int(capacity))
        self._buf = [None] * self.capacity
        self._n = 0
        self._lock = threading.Lock()
        self.pid = os.getpid()
        self.host = socket.gethostname()
        #: The offset into another process's timebase from a wire
        #: handshake; the port has no wire handshake yet, so it stays None.
        self.offset_ns = None
        # A wall and a monotonic reading taken together: the cross-host
        # alignment anchor.
        self.wall_anchor_ns = clock.wall_ns()
        self.mono_anchor_ns = clock.monotonic_ns()
        os.makedirs(self.trace_dir, exist_ok=True)

    def _append(self, evt: tuple) -> None:
        with self._lock:
            self._buf[self._n % self.capacity] = evt
            self._n += 1

    def events(self) -> list:
        """The newest ``capacity`` events at most, oldest first."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                return list(self._buf[:n])
            i = n % cap
            return self._buf[i:] + self._buf[:i]

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def shard_path(self) -> str:
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", self.role)
        return os.path.join(self.trace_dir, f"shard-{safe}-{self.pid}.jsonl")

    def flush(self) -> str:
        """Rewrite this process's shard from the ring's contents."""
        meta = {
            "kind": "meta", "role": self.role, "pid": self.pid,
            "host": self.host, "offset_ns": self.offset_ns,
            "wall_anchor_ns": self.wall_anchor_ns,
            "mono_anchor_ns": self.mono_anchor_ns,
            "capacity": self.capacity, "dropped": self.dropped,
        }
        path = self.shard_path()
        with open(path, "w") as f:
            f.write(json.dumps(meta) + "\n")
            for kind, name, ts, value, tid, role, args in self.events():
                rec = {"kind": kind, "name": name, "ts": ts, "tid": tid,
                       "role": role}
                if kind == "span":
                    rec["dur"] = value
                elif kind == "counter":
                    rec["value"] = value
                if args:
                    rec["args"] = args
                f.write(json.dumps(rec, default=str) + "\n")
        return path


def enabled() -> bool:
    return _tracer is not None


def current() -> Tracer | None:
    return _tracer


def configure(trace_dir: str | None, role: str | None = None,
              capacity: int = DEFAULT_CAPACITY) -> Tracer | None:
    """Trace into ``trace_dir``. The first configure of a process wins and
    later calls return its tracer (a server and its worker threads share
    one ring); ``trace_dir`` None returns the current tracer, if any."""
    global _tracer
    if trace_dir is None or _tracer is not None:
        return _tracer
    role = role or os.environ.get("EWDML_TRACE_ROLE") or f"proc-{os.getpid()}"
    _tracer = Tracer(trace_dir, role, capacity=capacity)
    atexit.register(_atexit_flush)
    return _tracer


def maybe_configure_from_env(role: str | None = None) -> Tracer | None:
    """Configure from ``EWDML_TRACE_DIR``, where a parent armed tracing."""
    return configure(os.environ.get("EWDML_TRACE_DIR"), role=role)


def shutdown(flush: bool = True) -> None:
    """Flush (by default) and disable tracing, so that the next
    :func:`configure` starts a new tracer."""
    global _tracer
    t, _tracer = _tracer, None
    if t is not None and flush:
        t.flush()
    if hasattr(_tls, "role"):
        del _tls.role


def _atexit_flush() -> None:
    if _tracer is not None:
        _tracer.flush()


def set_role(role: str) -> None:
    """The calling thread's role for the events it records."""
    _tls.role = role


def span(name: str, **args):
    """A context manager timing a host-side phase (the shared null one
    while tracing is off)."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return _Span(t, name, args or None)


def complete(name: str, start_ns: int, dur_ns: int, **args) -> None:
    """Record a span that was timed already (a fence times first and
    records after, outside the timed region)."""
    t = _tracer
    if t is None:
        return
    t._append(("span", name, int(start_ns), int(dur_ns),
               threading.current_thread().name, _role_for_event(t),
               args or None))


def instant(name: str, **args) -> None:
    """A point event (a dispatch, a poll)."""
    t = _tracer
    if t is None:
        return
    t._append(("instant", name, clock.monotonic_ns(), 0,
               threading.current_thread().name, _role_for_event(t),
               args or None))


def counter(name: str, value) -> None:
    """A sample of a counter track."""
    t = _tracer
    if t is None:
        return
    t._append(("counter", name, clock.monotonic_ns(), value,
               threading.current_thread().name, _role_for_event(t), None))


def flush() -> str | None:
    t = _tracer
    return t.flush() if t is not None else None
