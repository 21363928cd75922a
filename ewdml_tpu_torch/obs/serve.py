"""Live metrics over HTTP: ``/metrics`` and ``/metrics.json``
(``ewdml_tpu/obs/serve.py``, the same text and the same document).

A stdlib ``ThreadingHTTPServer`` on a daemon thread serves one registry's
snapshot two ways:

- ``GET /metrics``: the Prometheus text exposition (counters, numeric
  gauges, histograms as summaries with p50/p95/p99 quantile samples), every
  sample labelled with the owner's role;
- ``GET /metrics.json`` (and ``/healthz``): the raw ``snapshot()`` with
  the role, pid, host and port.

The JAX package serves one process-global registry and the first
``configure`` of a process wins. The port has no global registry: each
owner (a trainer, the evaluator, a ``ps_net`` endpoint) keeps its own
``MetricsRegistry``, so an :class:`Exporter` is built on its owner's
registry, and its owner closes it. Two owners in one process never share a
registry or a port (``--metrics-port 0`` binds an ephemeral port each; a
fixed port bound twice raises).

Armed by ``--metrics-port`` (0 = ephemeral), or by ``EWDML_METRICS_PORT``
where a role's process entry point reads it (:func:`env_port`); an owner
holds a :class:`Live`. Unset, no thread, socket or state exists.
A scrape reads the registry under its ordinary mutex and never blocks a
writer longer than one metric's update. Binds 127.0.0.1 only: an
operator's scrape port, not a service.
"""

from __future__ import annotations

import json
import os
import re
import socket as _socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

#: Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*, dots become
#: underscores, everything is prefixed to one namespace.
_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
PREFIX = "ewdml_"

#: The environment variable a parent sets to arm its children.
ENV = "EWDML_METRICS_PORT"


def _prom_name(key: str) -> str:
    return PREFIX + _NAME_RE.sub("_", key)


def _prom_value(v) -> Optional[str]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None  # string gauges are JSON-only: samples are numeric
    if v != v:
        return "NaN"
    return repr(float(v)) if isinstance(v, float) else str(v)


def render_prometheus(snapshot: dict, role: str) -> str:
    """Registry snapshot -> Prometheus text exposition format 0.0.4."""
    label = f'{{role="{role}"}}'
    lines = []
    for name, value in snapshot.get("counters", {}).items():
        v = _prom_value(value)
        if v is None:
            continue
        n = _prom_name(name)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n}{label} {v}")
    for name, value in snapshot.get("gauges", {}).items():
        v = _prom_value(value)
        if v is None:
            continue
        n = _prom_name(name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n}{label} {v}")
    for name, summ in snapshot.get("histograms", {}).items():
        n = _prom_name(name)
        lines.append(f"# TYPE {n} summary")
        for key, q in (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99")):
            v = _prom_value(summ.get(key))
            if v is not None:
                lines.append(f'{n}{{role="{role}",quantile="{q}"}} {v}')
        lines.append(f"{n}_sum{label} {_prom_value(summ.get('sum', 0)) or 0}")
        lines.append(f"{n}_count{label} {summ.get('count', 0)}")
    return "\n".join(lines) + "\n"


class Exporter:
    """The HTTP server thread of one registry, on its bound port."""

    def __init__(self, registry, port: int, role: str):
        self.registry = registry
        self.role = role
        self.pid = os.getpid()
        self.host = _socket.gethostname()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = render_prometheus(outer.registry.snapshot(),
                                             outer.role).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path in ("/metrics.json", "/healthz"):
                    body = json.dumps({
                        "role": outer.role, "pid": outer.pid,
                        "host": outer.host, "port": outer.port,
                        "metrics": outer.registry.snapshot(),
                    }).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam stderr
                pass

        self._http = ThreadingHTTPServer(("127.0.0.1", int(port)), Handler)
        self._http.daemon_threads = True
        self.port = self._http.server_address[1]
        self._closed = False
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        name=f"ewdml-metrics-{role}",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop serving and release the port (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._http.shutdown()
        self._http.server_close()
        self._thread.join()


def env_port(metrics_port: Optional[int]) -> Optional[int]:
    """A process entry point's port: ``metrics_port`` when given, else
    ``EWDML_METRICS_PORT`` when a parent armed the live plane for its
    children (a parent arming several children on one host passes ``0``,
    so each binds its own port), else None. Only the entry points of the
    serving roles read the variable: a trainer or server built inside a
    library never arms itself from the environment."""
    if metrics_port is not None:
        return int(metrics_port)
    env = os.environ.get(ENV)
    return int(env) if env else None


class Live:
    """An owner's live metrics endpoint: an :class:`Exporter` of
    ``registry`` on ``metrics_port`` (0 = ephemeral), or nothing at all
    when it is None. ``port`` is the bound port (None when unarmed);
    :meth:`close` stops the exporter (idempotent; a no-op when unarmed)."""

    __slots__ = ("exporter", "port")

    def __init__(self, metrics_port: Optional[int], registry, role: str):
        self.exporter = (None if metrics_port is None
                         else Exporter(registry, int(metrics_port), role))
        self.port = None if self.exporter is None else self.exporter.port

    def close(self) -> None:
        if self.exporter is not None:
            self.exporter.close()
