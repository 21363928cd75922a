"""Per-request server-side segment attribution (the causal wire profiler;
``ewdml_tpu/obs/reqctx.py``, copied: the port imports nothing of the JAX
package).

``ps_net.PSNetServer._dispatch`` activates one :class:`RequestSegments` per
request on the handling thread; everything the request touches DOWN the
stack then attributes its waits here without new plumbing:

- :class:`TimedLock` — a drop-in ``threading.Lock`` whose ``with`` entry
  times the blocked acquire into the active request's ``queue_ns``. The
  ``ParameterServer``'s ``_lock``/``_update_lock`` are TimedLocks, so the
  per-request "queue" segment is the real lock-convoy wait (including the
  K-of-N apply serialization behind ``_update_lock``) — the number the
  event-loop wire-plane rewrite has to beat.
- ``ps_net.make_request`` adds reply-encode time to ``serialize_ns``.

Segments are ALWAYS collected on the server (they feed the registry's
``ps_net.<op>.queue_s``/``handler_s`` histograms, which are live like the
r15 latency histograms); only the trace child spans are gated on
``--trace-dir``. Off the request path — the in-process async PS's worker
threads, the SPMD trainer — no context is active and a TimedLock costs
one thread-local read over a bare ``threading.Lock``.

Timestamps come from the shared ``obs.clock`` source.
"""

from __future__ import annotations

import threading

from ewdml_tpu_torch.obs import clock

_tls = threading.local()


class RequestSegments:
    """Accumulated wait/serialize attribution for ONE in-flight request.

    ``queue_ns`` sums every timed-lock wait; ``(queue_max_start_ns,
    queue_max_ns)`` keep the single longest wait so the trace can draw it
    as a real interval (the scattered remainder rides the parent span's
    ``queue_ns`` arg). ``serialize_ns`` is the reply-encode time with its
    start, contiguous by construction (one ``make_request`` per reply).
    """

    __slots__ = ("queue_ns", "queue_max_ns", "queue_max_start_ns",
                 "serialize_ns", "serialize_start_ns")

    def __init__(self):
        self.queue_ns = 0
        self.queue_max_ns = 0
        self.queue_max_start_ns = 0
        self.serialize_ns = 0
        self.serialize_start_ns = 0

    def add_queue(self, start_ns: int, dur_ns: int) -> None:
        self.queue_ns += dur_ns
        if dur_ns > self.queue_max_ns:
            self.queue_max_ns = dur_ns
            self.queue_max_start_ns = start_ns

    def add_serialize(self, start_ns: int, dur_ns: int) -> None:
        self.serialize_ns += dur_ns
        self.serialize_start_ns = start_ns


def activate(seg: RequestSegments) -> None:
    """Bind ``seg`` as this thread's active request (dispatch entry)."""
    _tls.seg = seg


def deactivate() -> None:
    _tls.seg = None


def current() -> RequestSegments | None:
    return getattr(_tls, "seg", None)


class TimedLock:
    """``threading.Lock`` work-alike that attributes blocked-acquire time
    to the active request's queue segment.

    Only the ``with`` protocol and ``acquire``/``release``/``locked`` are
    provided — the forms the PS uses. With no active request context the
    cost over a bare Lock is one thread-local read; timing happens only when a request is being
    attributed, and only the ACQUIRE side pays it.
    """

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()

    def __enter__(self):
        seg = getattr(_tls, "seg", None)
        if seg is None:
            self._lock.acquire()
        else:
            t0 = clock.monotonic_ns()
            self._lock.acquire()
            dt = clock.monotonic_ns() - t0
            if dt:
                seg.add_queue(t0, dt)
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        seg = getattr(_tls, "seg", None)
        if seg is None:
            return self._lock.acquire(blocking, timeout)
        t0 = clock.monotonic_ns()
        ok = self._lock.acquire(blocking, timeout)
        dt = clock.monotonic_ns() - t0
        if dt:
            seg.add_queue(t0, dt)
        return ok

    def release(self) -> None:
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()
