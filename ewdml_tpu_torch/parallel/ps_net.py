"""The parameter server across processes, over TCP
(``ewdml_tpu/parallel/ps_net.py``).

The reference's parameter server crossed OS processes: a Gloo TCP
rendezvous with per-layer gather and broadcast between the master and the
worker processes. The in-process async PS (``parallel/ps.py``) checks the
policies; this module checks the deployment: the server owns the canonical
parameters in one process, workers in other processes pull and push over
sockets, and every message is serialised, sent, received, deserialised and
applied, with the bytes counted at the socket.

    python -m ewdml_tpu_torch.parallel.ps_net --role server --platform cpu \\
        --network LeNet --dataset mnist10k --synthetic-data --port 29500
    python -m ewdml_tpu_torch.parallel.ps_net --role worker --worker-index 0 \\
        --platform cpu --network LeNet --dataset mnist10k --synthetic-data \\
        --port 29500 --steps 10

Protocol (every frame is an 8-byte little-endian length, then one
``native.wire_encode`` message whose section 0 is a JSON header; the header
bytes are the JAX package's, so either package's worker talks to either
package's server):

- ``pull {worker, worker_version}`` -> ``{mode, version, nbytes}`` + the
  packed parameters, or the packed deltas under ``--ps-down delta``; under
  ``--server-agg homomorphic`` the reply carries the scale contract's CRC,
  which the worker checks and fails loud on;
- ``push {worker, version, loss, push_id}`` + the payload frame ->
  ``{accepted}`` (a push id already applied is acknowledged, not applied
  again);
- ``resync``, ``join`` (elastic admission), ``bn_stats``, ``save``,
  ``stats`` (the server's counters, the socket byte counts and the per-op
  queue/handler segments), ``shutdown``; an excluded worker's request is
  answered by ``kill`` (the reference's MPI tag 77); an unknown op by
  ``error``.

The wire retries: every worker request goes through
:class:`RetryingConnection` (``--net-timeout``, ``--net-retries``,
``--net-backoff``, seeded jitter, reconnect), so a restarted server or a
reset costs a retried call, not a worker. ``--fault-spec`` injects
``reset``, ``drop``, ``partition``, ``join``, ``crash`` and ``serverkill``.
``--server-state-dir`` makes the server durable (``parallel/ps.py``,
``parallel/server_state.py``): a server SIGKILLed by ``serverkill@N`` and
started again on the same directory resumes at the last journaled version.

Two wire planes answer with the same bytes: ``threads`` (a thread per
connection) and ``evloop`` (one ``selectors`` thread, a frame state machine
per connection, one :meth:`ParameterServer.push_batch` per tick). The
server and each worker keep their own ``MetricsRegistry``; under
``--metrics-port`` (0 = ephemeral) each serves it at ``/metrics`` and
``/metrics.json`` (``obs/serve.py``) and ``main`` prints
``PS_NET_METRICS <role> <port>``.

Two more roles scale the tier out (``--role replica``, ``--role
aggregator``):

- ``subscribe {since}`` -> ``{mode, version, keyframe, flat, block, s,
  keyframe_every, crc}`` + a keyframe and/or [levels, scales] delta pairs:
  the apply server's publication stream, which a pull replica
  (``parallel/replica.py``) replays to serve ``pull`` from its own copy;
  ``--replicas`` routes every worker pull there, ``--pull-delta`` ships
  int8 deltas between keyframes;
- ``agg_push {weight, members}`` + an int16 frame -> ``{accepted,
  dup_members}``: an aggregator's (``parallel/aggtree.py``) exact sum of
  its subtree's int8 pushes; ``--agg-tree`` routes every worker push to its
  home aggregator (``index % A``, the others as failover), and the root
  registers the widened schema.

``--federated`` makes the apply server a round coordinator
(``federated/coordinator.py``): ``fed_register {client}``, ``fed_begin
{round}`` (the server samples and journals the cohort), ``fed_drop {client,
round}`` (a dropout and its resample), ``fed_end {round}`` (the round
barrier; the event-loop plane parks it and never blocks) and ``fed_flush``
(the async drain); ``push`` carries ``round`` for ``--round-pipeline
overlap|async``. ``--role fed_driver`` owns the client pool and drives the
rounds (``federated/loop.NetTransport``)::

    python -m ewdml_tpu_torch.parallel.ps_net --role server --platform cpu \
        --network LeNet --dataset mnist10k --federated --server-agg \
        homomorphic --compress-grad qsgd --pool-size 12 --cohort 4 --port 29500
    python -m ewdml_tpu_torch.parallel.ps_net --role fed_driver ... (same)

``--adapt variance|replay`` (``ps_net.py:660-693,1050-1128,1984-2026``):
the server owns the controller and its ledger; every ``pull`` and
``resync`` reply carries the ``plan_version`` in force, and the plan's JSON
when the worker's stated version is stale. The worker rebuilds the same
planned compressor from it (homomorphic-wrapped from its own scale
template under ``--server-agg homomorphic``, the contract checked by CRC
per plan version) and stamps every push with its version.
``--metrics-port`` is a later slice, rejected by name at startup.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import random
import selectors
import socket
import socketserver
import struct
import threading
import time
from typing import Optional

import numpy as np
import torch

from ewdml_tpu_torch.obs import clock, reqctx
from ewdml_tpu_torch.obs import health as ohealth
from ewdml_tpu_torch.obs import serve as oserve
from ewdml_tpu_torch.obs import trace as otrace
from ewdml_tpu_torch.obs.registry import MetricsRegistry
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.parallel.faults import (CRASH_EXIT_CODE, FaultCrash,
                                             FaultSpec)
from ewdml_tpu_torch.parallel.policy import (KILL_EXIT_CODE, StragglerKilled,
                                             StragglerPolicy)

logger = logging.getLogger("ewdml_tpu_torch.ps_net")

_LEN = struct.Struct("<Q")

#: The protocol's ops: the bound on the per-op metric names (anything else
#: counts as "other").
_OPS = frozenset({"pull", "push", "stats", "save", "shutdown", "bn_stats",
                  "kill", "fed_register", "fed_begin", "fed_end",
                  "fed_drop", "fed_flush", "resync", "join", "subscribe",
                  "agg_push", "agg_register", "agg_stats"})

#: The per-request segments the server records beside the latency: queue
#: (timed-lock waits, or the evloop's tick buffer), handler (the rest of
#: the dispatch, reply encode excluded).
_SEGMENT_FIELDS = ("latency_s", "queue_s", "handler_s")

#: The federated round ops; a server built without --federated answers
#: them "server not federated".
_FED_OPS = frozenset({"fed_register", "fed_begin", "fed_end", "fed_drop",
                      "fed_flush"})

#: Serialises the scale template's gradient: its determinism settings are
#: process-wide, and endpoints in threads of one process may build at once.
_SCALE_GRAD_LOCK = threading.Lock()


def _op_hist(registry, op, field="latency_s"):
    """``registry``'s ``ps_net.<op>.<field>`` histogram, the op clamped to
    :data:`_OPS`."""
    label = op if op in _OPS else "other"
    assert field in _SEGMENT_FIELDS, field
    # ewdml: allow[metric-name] -- bounded: `label` is clamped to the
    # closed _OPS vocabulary above and `field` to _SEGMENT_FIELDS, so the
    # name set is finite by construction (the rule exists to stop
    # UNbounded f-string names).
    return registry.histogram(f"ps_net.{label}.{field}")


class ByteCounter:
    """Socket byte totals of one endpoint, mirrored into its registry's
    ``net.bytes_sent``/``net.bytes_received`` counters."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.sent = 0
        self.received = 0
        self._lock = threading.Lock()
        self._reg_sent = self._reg_received = None
        if registry is not None:
            self._reg_sent = registry.counter("net.bytes_sent")
            self._reg_received = registry.counter("net.bytes_received")

    def add(self, sent: int = 0, received: int = 0):
        with self._lock:
            self.sent += sent
            self.received += received
        if sent and self._reg_sent is not None:
            self._reg_sent.inc(sent)
        if received and self._reg_received is not None:
            self._reg_received.inc(received)


def send_frame(sock: socket.socket, msg, counter: Optional[ByteCounter] = None):
    data = _LEN.pack(len(msg)) + bytes(msg)
    sock.sendall(data)
    if counter:
        counter.add(sent=len(data))


def recv_frame(sock: socket.socket,
               counter: Optional[ByteCounter] = None) -> bytes:
    header = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(header)
    msg = _recv_exact(sock, n)
    if counter:
        counter.add(received=_LEN.size + n)
    return msg


def recv_frame_timed(sock: socket.socket,
                     counter: Optional[ByteCounter] = None
                     ) -> tuple[bytes, int]:
    """:func:`recv_frame` and the body's receive time (ns), from the length
    prefix's arrival to the last byte: the wait for the prefix is the
    connection's idle time, not the wire's."""
    header = _recv_exact(sock, _LEN.size)
    t0 = clock.monotonic_ns()
    (n,) = _LEN.unpack(header)
    msg = _recv_exact(sock, n)
    recv_ns = clock.monotonic_ns() - t0
    if counter:
        counter.add(received=_LEN.size + n)
    return msg, recv_ns


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    # One preallocated buffer filled by recv_into, however the peer
    # trickles the frame: O(frame) for a byte-at-a-time sender too.
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("peer closed")
        got += r
    return bytes(buf)


class _ReplyScratch:
    """The evloop plane's reusable reply buffer. Armed on the loop thread
    (:data:`_reply_scratch`), :func:`make_request` encodes into it with
    ``native.wire_encode_into`` and returns a memoryview; ``busy`` holds
    while a queued send still references it, and an encode meanwhile takes
    the allocating path. The bytes are ``wire_encode``'s either way."""

    def __init__(self, size: int = 1 << 16):
        self.buf = bytearray(size)
        self.busy = False

    def encode(self, secs: list) -> memoryview:
        from ewdml_tpu_torch import native

        need = native.wire_encoded_size([len(s) for s in secs])
        if need > len(self.buf):
            self.buf = bytearray(max(need, 2 * len(self.buf)))
        written = native.wire_encode_into(secs, self.buf)
        assert written == need, (written, need)
        self.busy = True
        return memoryview(self.buf)[:written]


#: The evloop's reply scratch, set on its thread only; every other caller
#: of make_request (clients, threads-plane handlers) allocates.
_reply_scratch = threading.local()


def make_request(header: dict, sections=()) -> bytes | memoryview:
    """One message: the JSON header (``json.dumps`` with its default
    separators, numpy scalars folded by ``item()``) and ``sections``. Inside
    a server request the encode counts as its serialize segment."""
    from ewdml_tpu_torch import native

    seg = reqctx.current()
    t0 = clock.monotonic_ns() if seg is not None else 0
    hdr = json.dumps(header,
                     default=lambda o: o.item() if hasattr(o, "item") else str(o))
    secs = [hdr.encode()] + list(sections)
    scratch = getattr(_reply_scratch, "cur", None)
    if scratch is not None and not scratch.busy:
        msg = scratch.encode(secs)
    else:
        msg = native.wire_encode(secs)
    if seg is not None:
        seg.add_serialize(t0, clock.monotonic_ns() - t0)
    return msg


def parse_request(msg) -> tuple:
    from ewdml_tpu_torch import native

    sections = native.wire_decode(msg)
    return json.loads(bytes(sections[0]).decode()), sections[1:]


class RetryingConnection:
    """A client connection that survives transient wire faults.

    One request/reply round trip per :meth:`call`. On a socket failure
    (refused, reset, truncated frame, the per-call timeout) the socket is
    dropped and the call retried on a fresh connection after
    ``backoff_s * 2**(attempt-1)`` seconds (with ``jitter_seed``: uniform
    on [0, that], seeded), ``retries`` times after the first try. Dropping
    the socket on every failure keeps a late reply from being read as the
    next call's. A ``kill`` reply raises :class:`StragglerKilled` at once.
    A re-sent request carries ``retry: attempt`` so that the server's
    policy does not judge its gap. ``addr`` is one ``(host, port)`` or a
    list (rotated on failure). ``registry`` takes the per-op client
    latency and the retry counters."""

    def __init__(self, addr, timeout_s: float = 30.0,
                 retries: int = 3, backoff_s: float = 0.5,
                 byte_counter: Optional[ByteCounter] = None,
                 retry_counters=None, sleep=time.sleep,
                 jitter_seed: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None):
        from ewdml_tpu_torch.train.metrics import RetryCounters

        addrs = list(addr) if isinstance(addr, list) else [addr]
        self._addrs = [(h, int(p)) for h, p in addrs]
        self._addr_i = 0
        self.timeout_s = float(timeout_s)
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.bytes = byte_counter
        self.registry = registry
        self.counters = (retry_counters if retry_counters is not None
                         else RetryCounters(registry=registry))
        self._sleep = sleep
        self._jitter = (random.Random(jitter_seed)
                        if jitter_seed is not None else None)
        # Attempts still to black-hole (``partition`` clause).
        self._blackhole = 0
        self._sock: Optional[socket.socket] = None
        self._ever_connected = False

    @property
    def addr(self) -> tuple:
        """The address the next attempt dials."""
        return self._addrs[self._addr_i]

    def _advance(self) -> None:
        if len(self._addrs) > 1:
            self._addr_i = (self._addr_i + 1) % len(self._addrs)
            otrace.instant("net/failover")

    def _ensure_sock(self) -> socket.socket:
        if self._sock is None:
            try:
                self._sock = socket.create_connection(
                    self.addr, timeout=self.timeout_s)
            except OSError:
                self._advance()
                raise
            self._sock.settimeout(self.timeout_s)
            if self._ever_connected:
                self.counters.inc_reconnects()
                otrace.instant("net/reconnect")
            self._ever_connected = True
        return self._sock

    def drop(self) -> None:
        """Close the socket, if any; the next call reconnects."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    close = drop

    def inject_reset(self) -> None:
        """Fault (``reset``): half-close the live socket so that the next
        call fails mid-round-trip and takes the retry, backoff and
        reconnect path. A no-op before the first connection."""
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_WR)
            except OSError:
                self.drop()

    def inject_blackhole(self, attempts: int = 1) -> None:
        """Fault (``partition``): the next ``attempts`` attempts send
        nothing and time out; the server sees nothing."""
        self._blackhole += int(attempts)

    def inject_truncated(self, msg) -> None:
        """Fault (``drop``): send half a frame, then abort the connection
        with an RST; the server must drop the session, and the next call
        retries on a fresh connection."""
        try:
            sock = self._ensure_sock()
            data = _LEN.pack(len(msg)) + bytes(msg)
            sock.sendall(data[:max(1, len(data) // 2)])
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
        except OSError:
            pass
        finally:
            self.drop()

    def call(self, header: dict, sections=(), *,
             req_id: Optional[str] = None) -> tuple[dict, list]:
        """One round trip with bounded retry and backoff. With tracing on,
        the header carries the request id as ``req``; off, the header is
        the untraced wire's."""
        if req_id is None:
            req_id = otrace.next_request_id()
        if req_id is not None:
            header = {**header, "req": req_id}
        msg = make_request(header, sections)
        last: Optional[BaseException] = None
        t_call = clock.monotonic()
        for attempt in range(self.retries + 1):
            if attempt:
                self.counters.inc_retries()
                otrace.instant("net/retry", op=header.get("op"),
                               attempt=attempt, req=req_id)
                backoff = self.backoff_s * (2 ** (attempt - 1))
                if self._jitter is not None:
                    backoff = self._jitter.uniform(0.0, backoff)
                self._sleep(backoff)
                msg = make_request({**header, "retry": attempt}, sections)
            try:
                if self._blackhole > 0:
                    self._blackhole -= 1
                    raise socket.timeout(
                        "injected partition (black-hole window)")
                sock = self._ensure_sock()
                send_frame(sock, msg, self.bytes)
                reply = recv_frame(sock, self.bytes)
            except OSError as e:  # ConnectionError, timeout, refused, reset
                last = e
                if self._sock is not None:
                    self._advance()
                self.drop()
                continue
            reply_header, reply_sections = parse_request(reply)
            if reply_header.get("op") == "kill":
                otrace.instant("net/kill", op=header.get("op"), req=req_id,
                               worker=reply_header.get("worker"))
                raise StragglerKilled(
                    int(reply_header.get("worker", -1)),
                    reply_header.get("reason", "killed by server"))
            if self.registry is not None:
                _op_hist(self.registry, header.get("op")).observe(
                    clock.monotonic() - t_call)
            return reply_header, reply_sections
        raise ConnectionError(
            f"{header.get('op')!r} to {self.addr} failed after "
            f"{self.retries + 1} attempts: {last}")


# -- shared setup ------------------------------------------------------------

@dataclasses.dataclass
class EndpointSetup:
    """What both endpoints derive identically from a config."""

    model: torch.nn.Module
    comp: object              # None when dense; homomorphic-wrapped if so
    params: list              # initial parameters, JAX leaf order and layout
    specs: list               # models/convert.LeafSpec per parameter
    grad_fn: object           # parallel/ps.make_grad_fn
    compress_tree: object     # None when dense
    template: list            # the push payload schema
    grads_scale: Optional[list]  # the scale contract's template, or None
    device: torch.device


def check_supported(cfg, role: str = "server") -> None:
    """Validate the wire plane's flags, and refuse by name ``--metrics-port``
    on ``--role fed_driver``, where the JAX package accepts it and arms no
    exporter (ROADMAP Queue 3 item 28). Every role of the TCP tier is
    ported."""
    from ewdml_tpu_torch.core.config import validate_wire_plane
    from ewdml_tpu_torch.train.trainer import _reject, unserved_metrics_row

    validate_wire_plane(cfg)
    # Every other role serves its registry under --metrics-port.
    if role == "fed_driver":
        _reject([unserved_metrics_row(cfg, "--role fed_driver")])


def build_endpoint_setup(cfg, device=None) -> EndpointSetup:
    """The state both endpoints must derive identically for the push
    schema to match (``ps_net.py:467-571``): the model (``cfg.seed``), the
    compressor, the initial parameters, the gradient function, and the
    payload template: the gradient of a zero batch at the initial
    parameters under dropout key ``key(0)``, compressed under ``key(0)``
    (bf16 under a ``bf16_wire`` policy when dense). Under ``--server-agg
    homomorphic`` the scale contract is negotiated here too, from the
    gradient of a seeded normal batch (``normal`` and ``randint`` at
    ``fold_in(key(seed), 0x7C13)``): a zero batch leaves conv kernels'
    gradients at zero; under ``--federated`` with ``--local-steps`` L > 1
    that template is scaled by L in f32 (``ps_net.py:549-557``). Template
    gradients run on copies of the model, so its BatchNorm statistics stay
    the initial ones."""
    from ewdml_tpu_torch.core.config import (validate_agg_tree,
                                             validate_federated,
                                             validate_replicas,
                                             validate_round_pipeline,
                                             validate_server_agg)
    from ewdml_tpu_torch.core.precision import wire_cast
    from ewdml_tpu_torch.core.world import resolve_device
    from ewdml_tpu_torch.models import (build_model, input_shape_for,
                                        num_classes_for)
    from ewdml_tpu_torch.models.convert import leaf_specs, to_jax
    from ewdml_tpu_torch.ops import make_compressor
    from ewdml_tpu_torch.ops.none import NoneCompressor
    from ewdml_tpu_torch.parallel import ps
    from ewdml_tpu_torch.train.state import leaf_params
    from ewdml_tpu_torch.utils import prng

    validate_server_agg(cfg)
    validate_federated(cfg)
    validate_replicas(cfg)
    validate_agg_tree(cfg)
    validate_round_pipeline(cfg)
    if cfg.overlap != "off":
        raise ValueError(
            "--overlap bucket applies to the sync trainer; the ps_net TCP "
            "deployment exchanges over the host wire, where the pipelining "
            "lever is the server's event loop")
    if cfg.pallas != "auto":
        kernels.configure(cfg.pallas)
    device = ps._indexed(resolve_device(cfg.platform, device))
    num_classes = num_classes_for(cfg.dataset)
    model = build_model(cfg.network, num_classes, dataset=cfg.dataset,
                        seed=cfg.seed).to(device)
    comp = make_compressor(cfg.compress_grad, cfg.quantum_num,
                           cfg.topk_ratio, cfg.topk_exact, cfg.qsgd_block)
    if isinstance(comp, NoneCompressor):
        comp = None
    specs = leaf_specs(model)
    params = [to_jax(p.detach(), s.kind).contiguous().clone()
              for p, s in zip(leaf_params(model, specs), specs)]
    grad_fn = ps.make_grad_fn(specs)
    h, w, c = input_shape_for(cfg.dataset)
    x = torch.zeros((cfg.batch_size, h, w, c), dtype=torch.float32,
                    device=device)
    y = torch.zeros((cfg.batch_size,), dtype=torch.int32, device=device)
    _, grads0 = grad_fn(copy.deepcopy(model), params, x, y,
                        # ewdml: allow[prng] -- warm/template gradient;
                        # BOTH endpoints must derive the identical
                        # schema, so the fixed key is part of the
                        # cross-process contract
                        prng.key(0))
    grads_scale = None
    if cfg.server_agg == "homomorphic" and comp is not None:
        from ewdml_tpu_torch.ops.homomorphic import make_homomorphic

        kx = prng.fold_in(prng.key(cfg.seed), 0x7C13)
        xs = prng.normal(kx, (cfg.batch_size, h, w, c), device)
        ys = prng.randint(prng.fold_in(kx, 1), (cfg.batch_size,), 0,
                          num_classes, device)
        # Every endpoint, in any process, must get this gradient bit for
        # bit. On the card, cuDNN's weight-gradient algorithms that add
        # with atomics are excluded while it runs. On the CPU it runs on
        # one intra-op thread: a multi-threaded conv backward's sum order
        # varies with the thread count and from run to run.
        cudnn = torch.backends.cudnn
        with _SCALE_GRAD_LOCK:
            saved = (cudnn.deterministic, cudnn.benchmark,
                     torch.get_num_threads())
            cudnn.deterministic, cudnn.benchmark = True, False
            if device.type == "cpu":
                torch.set_num_threads(1)
            try:
                _, grads_scale = grad_fn(
                    copy.deepcopy(model), params, xs, ys,
                    # ewdml: allow[prng] -- scale-contract template:
                    # server and worker must derive identical grids
                    # (fixed key IS the cross-process contract)
                    prng.key(0))
                if cfg.federated and cfg.local_steps > 1:
                    # A federated push is the pseudo-gradient (w0 - w)/lr:
                    # the sum of local_steps gradients, so the contract is
                    # sized for that unit, in f32, here where every
                    # endpoint derives it.
                    ls = kernels.f32_scalar(float(cfg.local_steps))
                    grads_scale = [g * ls for g in grads_scale]
            finally:
                cudnn.deterministic, cudnn.benchmark = saved[:2]
                if device.type == "cpu":
                    torch.set_num_threads(saved[2])
        comp = make_homomorphic(comp, grads_scale)
    compress_tree = ps.make_compress_tree(comp)
    template = grads0 if compress_tree is None else compress_tree(
        # ewdml: allow[prng] -- payload-schema template; bytes discarded,
        # only shapes/dtypes register (and must match on both endpoints)
        grads0, prng.key(0))
    if compress_tree is None and cfg.precision.bf16_wire:
        template = wire_cast(template, cfg.precision.wire_dtype)
    return EndpointSetup(model, comp, params, specs, grad_fn, compress_tree,
                         template, grads_scale, device)


def _expect(header: dict, op: str) -> dict:
    """``header`` if the server answered ``op``; else raise (a reply is
    input from outside the process)."""
    if header.get("op") != op:
        raise RuntimeError(f"expected a {op!r} reply, got {header!r}")
    return header


def _bn_buffers(model: torch.nn.Module) -> list:
    """``(Flax path, buffer)`` of every BatchNorm statistic, in the JAX
    tree's leaf order (paths sorted level by level): the ``bn_stats``
    upload's layout."""
    from ewdml_tpu_torch.train.state import _stat_buffers

    return sorted(_stat_buffers(model), key=lambda kv: tuple(kv[0].split("/")))


# -- server ------------------------------------------------------------------

class _Endpoint:
    """What every served endpoint (the apply server, a pull replica, an
    aggregator) shares with the event-loop plane: its registry, socket byte
    counts, occupancy gauges and stop event, the per-request envelope
    (:meth:`_dispatch` around the subclass's ``_dispatch_inner``) and the
    reply frames the plane sends for pushes."""

    #: The trace role of the plane's thread.
    role = "ps-server"
    _tcp = None
    _evloop = None
    #: The federated coordinator (the apply server under --federated).
    fed = None
    #: The live metrics endpoint of ``--metrics-port`` (``obs/serve``).
    live = oserve.Live(None, None, "")

    def _arm_metrics(self) -> None:
        """Serve this endpoint's registry under ``--metrics-port``; the
        last step of a constructor, so a constructor that raises leaves no
        thread behind."""
        self.live = oserve.Live(self.cfg.metrics_port, self.registry,
                                self.role)

    def __init__(self, registry: Optional[MetricsRegistry]) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.bytes = ByteCounter(self.registry)
        self._shutdown = threading.Event()
        self._occ_lock = threading.Lock()
        self._connections = 0   # ewdml: guarded-by[_occ_lock]
        self._inflight = 0      # ewdml: guarded-by[_occ_lock]
        self._g_conns = self.registry.gauge("ps_net.connections")
        self._g_inflight = self.registry.gauge("ps_net.inflight")

    def _kill_frame(self, exc: StragglerKilled) -> bytes:
        """The tag-77 verdict as a reply frame."""
        logger.warning("ps_net: sending kill to worker %d (%s)",
                       exc.worker, exc.reason)
        return make_request({"op": "kill", "worker": exc.worker,
                             "reason": exc.reason})

    def _push_ok_frame(self, accepted) -> bytes:
        return make_request({"op": "push_ok", "accepted": bool(accepted)})

    def _request_stop(self) -> None:
        """Ask the serving plane to exit (idempotent, any thread)."""
        self._shutdown.set()
        if self._tcp is not None:
            threading.Thread(target=self._tcp.shutdown, daemon=True).start()

    def _dispatch(self, header: dict, sections: list, recv_ns: int = 0,
                  parse_ns: int = 0,
                  buffered_since_ns: Optional[int] = None,
                  inner=None) -> bytes | None:
        """One request, segmented: queue (timed-lock waits; under the
        evloop also the tick-buffer wait since ``buffered_since_ns``),
        serialize (the reply's encode), and handler (the rest). ``inner``
        replaces ``_dispatch_inner`` (a parked ``fed_end``'s answer)."""
        op = header.get("op")
        if self._evloop is None:
            with self._occ_lock:
                self._inflight += 1
                self._g_inflight.set(self._inflight)
        seg = reqctx.RequestSegments()
        reqctx.activate(seg)
        t0_ns = clock.monotonic_ns()
        if buffered_since_ns is not None:
            seg.add_queue(buffered_since_ns, max(0, t0_ns - buffered_since_ns))
            t0_ns = buffered_since_ns
        try:
            return (inner or self._dispatch_inner)(op, header, sections)
        finally:
            reqctx.deactivate()
            dur_ns = clock.monotonic_ns() - t0_ns
            self._emit_dispatch_obs(op, header, t0_ns, dur_ns, seg,
                                    recv_ns, parse_ns)
            if self._evloop is None:
                with self._occ_lock:
                    self._inflight -= 1
                    self._g_inflight.set(self._inflight)

    def _emit_dispatch_obs(self, op, header: dict, t0_ns: int, dur_ns: int,
                           seg: reqctx.RequestSegments, recv_ns: int = 0,
                           parse_ns: int = 0) -> None:
        """The request's histograms and spans; handler = the dispatch wall
        less queue and serialize, never negative."""
        handler_ns = max(0, dur_ns - seg.queue_ns - seg.serialize_ns)
        reg = self.registry
        _op_hist(reg, op, "latency_s").observe(dur_ns / 1e9)
        _op_hist(reg, op, "queue_s").observe(seg.queue_ns / 1e9)
        _op_hist(reg, op, "handler_s").observe(handler_ns / 1e9)
        if otrace.enabled():
            label = op if op in _OPS else "other"
            # ewdml: allow[trace-name] -- bounded: `label` is clamped
            # to the closed _OPS vocabulary, so the span-name set is
            # finite (the rule stops UNbounded f-string names).
            otrace.complete(f"ps_net/{label}", t0_ns, dur_ns,
                            worker=header.get("worker"),
                            req=header.get("req"),
                            version=header.get("version"),
                            retry=header.get("retry"),
                            queue_ns=seg.queue_ns, handler_ns=handler_ns,
                            serialize_ns=seg.serialize_ns)
            if recv_ns:
                otrace.complete("ps_net/recv", t0_ns - parse_ns - recv_ns,
                                recv_ns, op=op, req=header.get("req"))
            if parse_ns:
                otrace.complete("ps_net/parse", t0_ns - parse_ns, parse_ns,
                                op=op, req=header.get("req"))
            if seg.queue_max_ns:
                otrace.complete("ps_net/queue", seg.queue_max_start_ns,
                                seg.queue_max_ns, op=op,
                                req=header.get("req"), total_ns=seg.queue_ns)
            if seg.serialize_ns:
                otrace.complete("ps_net/serialize", seg.serialize_start_ns,
                                seg.serialize_ns, op=op,
                                req=header.get("req"))

    def _push_record(self, header: dict, sections: list, **extra):
        """The fields every push frame carries, as a
        :class:`~ewdml_tpu_torch.parallel.ps.PushRecord`; ``extra`` holds
        what only its op reads (a leaf push's ``round_id``, an
        ``agg_push``'s ``weight`` and ``members``), as in the JAX
        package's branches."""
        from ewdml_tpu_torch.parallel.ps import PushRecord

        return PushRecord(worker=int(header["worker"]),
                          version=int(header["version"]),
                          message=bytes(sections[0]),
                          loss=float(header["loss"]),
                          push_id=str(header.get("push_id", "")),
                          plan_version=int(header.get("plan_version", 0)),
                          **extra)


class PSNetServer(_Endpoint):
    """The TCP front of :class:`~ewdml_tpu_torch.parallel.ps.
    ParameterServer`: builds the model, optimizer and compressor from a
    config, fixes the push schema, recovers from ``--server-state-dir``
    when it holds state, and serves until ``shutdown``."""

    def __init__(self, cfg, host: str = "127.0.0.1", port: int = 0,
                 registry: Optional[MetricsRegistry] = None):
        from ewdml_tpu_torch.optim import make_optimizer
        from ewdml_tpu_torch.parallel import ps
        from ewdml_tpu_torch.utils import transfer

        check_supported(cfg, "server")
        self.cfg = cfg
        super().__init__(registry)
        otrace.configure(cfg.trace_dir, role="ps-server")
        otrace.maybe_configure_from_env(role="ps-server")
        # The abort verdict stops the accept loop (serve_forever returns,
        # main exits 76) rather than unwinding a handler mid-reply.
        self.health = ohealth.make_watchdog(cfg, role="ps-server",
                                            registry=self.registry,
                                            on_abort=self._health_abort)
        self._host = socket.gethostname()
        setup = build_endpoint_setup(cfg)
        self.model = setup.model
        self.device = setup.device
        optimizer = make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum,
                                   cfg.weight_decay, cfg.nesterov,
                                   state_dtype=cfg.precision.state_dtype)
        # The workers upload their BatchNorm statistics for checkpoints
        # (the reference's worker saved them); the server holds none.
        bn = _bn_buffers(self.model)
        self._bn_paths = [p for p, _ in bn]
        self._bn0 = [b.detach().clone() for _, b in bn]
        self._latest_bn = None  # ewdml: guarded-by[_lock_bn]
        self._bn_unpack = (transfer.make_device_unpacker(self._bn0)
                           if self._bn0 else None)
        self._lock_bn = threading.Lock()
        self.state_store = None
        self._had_state = False
        self._recoveries = 0
        if cfg.server_state_dir:
            from ewdml_tpu_torch.parallel.server_state import ServerStateStore

            self.state_store = ServerStateStore(cfg.server_state_dir)
            # Prior state decides the coordinator's resume: a restart
            # reopens the round ledger to append and replays it; a cold
            # start truncates it.
            self._had_state = (self.state_store.load_snapshot() is not None
                               or bool(self.state_store.read_wal()))
        if cfg.federated:
            # The coordinator owns the rounds (sampler, ledger, barrier)
            # and supplies the cohort policy of the mode.
            from ewdml_tpu_torch.federated.coordinator import \
                FederatedCoordinator
            from ewdml_tpu_torch.federated.loop import ledger_path_for

            self.fed = FederatedCoordinator(cfg, ledger_path_for(cfg),
                                            resume=self._had_state,
                                            registry=self.registry)
            policy = self.fed.policy
        else:
            # One policy for the deployment; K is clamped to >= 1 (an
            # async server has no world size to read 0 as "all").
            policy = StragglerPolicy(
                kill_threshold=cfg.kill_threshold,
                max_staleness=(cfg.max_staleness if cfg.max_staleness > 0
                               else None),
                num_aggregate=cfg.num_aggregate)
        comp = setup.comp
        spec = FaultSpec.parse(cfg.fault_spec)
        # Adaptive compression: the server owns the controller; every
        # plan's scale contract derives from the template the workers hold.
        adapt = None
        if cfg.adapt != "off":
            from ewdml_tpu_torch.adapt import AdaptRuntime
            from ewdml_tpu_torch.adapt.plan import unit_names_and_sizes

            names, sizes = unit_names_and_sizes(setup.specs)
            adapt = AdaptRuntime(cfg, names, sizes, surface="ps",
                                 registry=self.registry)
            if cfg.server_agg == "homomorphic":
                adapt.set_scale_base(setup.grads_scale)
        self.server = ps.ParameterServer(
            setup.params, optimizer, comp, policy=policy,
            # The weights-down relay, the paper's negative result, only
            # behind the explicit --lossy-weights-down (ps_net.py:683).
            relay_compress=(cfg.lossy_weights_down and cfg.relay_compress
                            and cfg.ps_mode == "weights"
                            and comp is not None),
            seed=cfg.seed,
            down_mode=cfg.ps_down if comp is not None else "weights",
            bootstrap=cfg.ps_bootstrap, precision=cfg.precision_policy,
            server_agg=cfg.server_agg, health=self.health, adapt=adapt,
            device=self.device, leaf_names=[s.name for s in setup.specs],
            # Elastic K: with --num-aggregate 0 a join makes K the live
            # count; a tree pins the schema to its aggregators instead,
            # and a federated server's K is the cohort's accept.
            elastic_k=(cfg.num_aggregate == 0 and not cfg.agg_tree
                       and not cfg.federated),
            kill_at_apply=spec.server_kill_at,
            # The publication stream's knobs, inert until a subscriber.
            pull_delta=cfg.pull_delta, keyframe_every=cfg.keyframe_every)
        if cfg.agg_tree:
            # The root of an aggregation tree takes int16 pseudo-pushes: the
            # widened schema, a slot per aggregator, and the round's leaf
            # weight (the K-of-N quota) as the divisor.
            from ewdml_tpu_torch.core.config import parse_agg_tree
            from ewdml_tpu_torch.ops.homomorphic import widen_payload_tree

            self.server.register_payload_schema(
                widen_payload_tree(setup.template),
                schema_k=len(parse_agg_tree(cfg.agg_tree)),
                agg_weight=self.server.num_aggregate)
        elif cfg.federated and cfg.round_pipeline == "async":
            # Async commits on a tick quota (accept x WEIGHT_SCALE unit
            # copies); the weighted apply divides by the realized ticks.
            quota_ticks = policy.num_aggregate
            self.server.register_payload_schema(
                setup.template, schema_k=quota_ticks, agg_weight=quota_ticks)
        else:
            self.server.register_payload_schema(setup.template)
        if cfg.federated and cfg.round_pipeline != "off":
            self.server.arm_round_pipeline(cfg.round_pipeline)
        if self.state_store is not None:
            if self.fed is not None:
                # The round ledger is the federated recovery's authority;
                # the snapshot carries the coordinator's state to read.
                self.server._snapshot_extra = \
                    lambda: {"federated": self.fed.state()}
            if self.server.recover(self.state_store) is not None:
                self._recoveries = 1
            # After recover: replay must not journal, and the snapshot
            # written now bounds a later restart's replay.
            self.server.arm_durability(self.state_store, cfg.snapshot_every)

        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                otrace.set_role("ps-server")
                with outer._occ_lock:
                    outer._connections += 1
                    outer._g_conns.set(outer._connections)
                try:
                    while True:
                        msg, recv_ns = recv_frame_timed(self.request,
                                                        outer.bytes)
                        t0 = clock.monotonic_ns()
                        header, sections = parse_request(msg)
                        parse_ns = clock.monotonic_ns() - t0
                        reply = outer._dispatch(header, sections,
                                                recv_ns=recv_ns,
                                                parse_ns=parse_ns)
                        if reply is not None:
                            t0 = clock.monotonic_ns()
                            send_frame(self.request, reply, outer.bytes)
                            if otrace.enabled():
                                otrace.complete(
                                    "ps_net/send", t0,
                                    clock.monotonic_ns() - t0,
                                    op=header.get("op"),
                                    req=header.get("req"))
                        if header.get("op") == "shutdown":
                            return
                except (ConnectionError, OSError, ValueError):
                    return  # the worker is done or gone, or sent garbage
                finally:
                    with outer._occ_lock:
                        outer._connections -= 1
                        outer._g_conns.set(outer._connections)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            request_queue_size = 128  # the evloop listener's backlog

        self.wire_plane = cfg.wire_plane
        self._evloop = None
        self._tcp = None
        if self.wire_plane == "threads":
            self._tcp = Server((host, port), Handler)
            self.address = self._tcp.server_address
        else:
            lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lsock.bind((host, port))
            lsock.listen(128)
            lsock.setblocking(False)
            self.address = lsock.getsockname()
            self._evloop = _EvLoopPlane(self, lsock)
        self._arm_metrics()

    @property
    def policy(self) -> StragglerPolicy:
        return self.server.policy

    def close(self) -> None:
        """Release the listening socket, any sessions and the metrics
        endpoint (idempotent)."""
        self.live.close()
        if self._tcp is not None:
            self._tcp.server_close()
        if self._evloop is not None:
            self._evloop.close()
        if self.state_store is not None:
            self.state_store.close()
        if self.fed is not None:
            self.fed.close()
        if self.server.adapt is not None:
            self.server.adapt.close()

    def _health_abort(self, event: dict) -> None:
        """The watchdog's abort verdict: stop accepting (``main`` exits
        :data:`~ewdml_tpu_torch.obs.health.HEALTH_EXIT_CODE`)."""
        logger.error("ps_net: health abort (%s) — shutting down",
                     event.get("kind"))
        self._request_stop()

    def _agg_push_ok_frame(self, accepted, dup_members) -> bytes:
        """The verdict on a pseudo-push; ``dup_members`` names the leaves
        the round already counted."""
        return make_request({"op": "agg_push_ok",
                             "accepted": bool(accepted),
                             "dup_members": [int(m) for m in dup_members]})

    def _fed_end_ok_frame(self, round_idx: int, rec: dict) -> bytes:
        return make_request({"op": "fed_end_ok", "round": round_idx,
                             "accepted": rec["accepted"],
                             "version": rec["version"]})

    def _barrier_timeout_frame(self, round_idx) -> bytes:
        return make_request({
            "op": "error",
            "detail": f"round {round_idx} barrier timed out (accept quota "
                      f"unreachable?)"})

    def _barrier_wait_s(self) -> float:
        """The server's ``fed_end`` wait: shorter than the client's socket
        timeout, so the error reply arrives before the client gives up."""
        return max(0.5, self.cfg.net_timeout_s * 0.5)

    def _plan_reply(self, header: dict, reply: dict) -> None:
        """Plan negotiation on a ``pull`` or ``resync`` reply: always the
        plan version in force, the plan's JSON only when the worker's
        stated version is stale. The version comes from the plan object
        itself, so a concurrent switch never pairs one plan's body with
        another's version."""
        if self.server.adapt is None:
            return
        plan = self.server.adapt.plan
        reply["plan_version"] = plan.version
        if int(header.get("plan_version", -1)) != plan.version:
            reply["plan"] = plan.to_json()

    def _dispatch_inner(self, op, header: dict, sections: list) -> bytes:
        retried = bool(header.get("retry"))
        if op == "pull":
            try:
                mode, payload, version, nbytes = self.server.pull(
                    int(header.get("worker_version", -1)),
                    worker=header.get("worker"), retried=retried)
            except StragglerKilled as e:
                return self._kill_frame(e)
            bufs = ([np.asarray(payload).tobytes()]
                    if mode.startswith("weights")
                    else [np.asarray(b).tobytes() for b in payload])
            reply = {"op": "pull_ok", "mode": mode, "version": int(version),
                     # ewdml: allow[wire-protocol] -- accounting echo: the
                     # byte-oracle tests compare this app-level count
                     # against the socket counters; the worker itself
                     # deliberately ignores it (its oracle is the socket).
                     "nbytes": int(nbytes)}
            if self.server.server_agg == "homomorphic":
                # The scale contract's CRC, paired with the plan version it
                # belongs to: the worker compares its own and fails loud on
                # a desync.
                pv, comp = self.server.current_plan()
                reply["scale_crc"] = comp.contract_checksum()
                reply["scale_crc_pv"] = pv
            self._plan_reply(header, reply)
            if "mono_ns" in header:
                # Clock handshake: our monotonic stamp and host.
                reply["server_mono_ns"] = clock.monotonic_ns()
                reply["host"] = self._host
            return make_request(reply, bufs)
        if op == "push":
            try:
                accepted = self.server.push(
                    self._push_record(
                        header, sections,
                        round_id=int(header.get("round", -1))),
                    retried=retried)
            except StragglerKilled as e:
                return self._kill_frame(e)
            return self._push_ok_frame(accepted)
        if op == "agg_push":
            # An aggregator's int16 sum standing in for ``weight`` leaf
            # pushes, judged at member granularity.
            try:
                accepted, dups = self.server.push_subtree(
                    self._push_record(
                        header, sections, weight=int(header.get("weight", 1)),
                        members=tuple(int(m) for m in
                                      header.get("members", ()))),
                    retried=retried)
            except StragglerKilled as e:
                return self._kill_frame(e)
            return self._agg_push_ok_frame(accepted, dups)
        if op == "subscribe":
            # A pull replica's poll of the publication stream: everything
            # published after ``since``, with the stream's contract.
            mode, version, kf_version, bufs = self.server.subscribe_stream(
                int(header.get("since", -1)))
            return make_request(
                {"op": "subscribe_ok", "mode": mode,
                 "version": int(version), "keyframe": int(kf_version),
                 **self.server.pd_contract()},
                [np.asarray(b).tobytes() for b in bufs])
        if op == "resync":
            # After a reconnect: where the server is (a restarted server's
            # recovered version), so the worker keeps its params or pulls
            # afresh.
            try:
                if header.get("worker") is not None:
                    self.server._check_worker(header["worker"],
                                              retried=retried)
            except StragglerKilled as e:
                return self._kill_frame(e)
            reply = {"op": "resync_ok", "version": int(self.server.version)}
            self._plan_reply(header, reply)
            return make_request(reply)
        if op == "join":
            worker = int(header["worker"])
            if self.fed is not None:
                # Federated membership is the pool registration, open
                # mid-run: the joiner is eligible from the next draw.
                try:
                    info = self.fed.register(worker)
                except ValueError as e:
                    return make_request({"op": "error", "detail": str(e)})
                joined = {"version": int(self.server.version),
                          "live": int(info["pool"]),
                          "num_aggregate": int(self.server.num_aggregate)}
            else:
                joined = self.server.join_worker(worker)
            logger.info("ps_net: worker %d joined mid-run at version %d "
                        "(%d live, K=%d)", worker, joined["version"],
                        joined["live"], joined["num_aggregate"])
            return make_request({"op": "join_ok", **joined})
        if op == "stats":
            return self._stats_frame()
        if op == "bn_stats":
            try:
                if header.get("worker") is not None:
                    self.server._check_worker(header["worker"],
                                              retried=retried)
            except StragglerKilled as e:
                return self._kill_frame(e)
            if self._bn_unpack is not None and sections:
                buf = torch.from_numpy(
                    np.frombuffer(bytes(sections[0]), np.uint8).copy())
                with self._lock_bn:
                    self._latest_bn = [t.clone() for t in
                                       self._bn_unpack(buf)]
            return make_request({"op": "bn_stats_ok"})
        if op == "save":
            return self._save(header)
        if op in _FED_OPS:
            # A coordinator's refusal (a round out of order, a client
            # outside the pool) is an error frame, never an escaped raise:
            # that would cost the connection and send the driver into a
            # reconnect-and-retry loop.
            if self.fed is None:
                return make_request({"op": "error",
                                     "detail": "server not federated"})
            try:
                return self._dispatch_fed(op, header)
            except (ValueError, RuntimeError) as e:
                return make_request({"op": "error", "detail": str(e)})
        if op == "shutdown":
            self._request_stop()
            return make_request({"op": "shutdown_ok"})
        return make_request({"op": "error", "detail": f"unknown op {op!r}"})

    def _dispatch_fed(self, op, header: dict) -> bytes:
        """The federated ops. Each is safe to re-send: a retried begin or
        drop replays its recorded outcome, and register and end are
        idempotent."""
        if op == "fed_register":
            info = self.fed.register(int(header["client"]))
            return make_request({
                "op": "fed_register_ok", "pool": info["pool"],
                "round": info["round"], "cohort": self.fed.cohort_size,
                "accept": self.fed.accept,
                "max_cohort": self.fed.max_cohort})
        if op == "fed_begin":
            # The server samples and journals the cohort; the driver only
            # learns whom to run.
            r = int(header["round"])
            cohort = self.fed.begin_round(r, version=self.server.version)
            return make_request({"op": "fed_begin_ok", "round": r,
                                 "cohort": cohort,
                                 "version": self.server.version})
        if op == "fed_end":
            # The round barrier (threads plane; the event loop parks it).
            r = int(header["round"])
            rec = self.fed.wait_round(r, timeout=self._barrier_wait_s())
            if rec is None:
                return self._barrier_timeout_frame(r)
            return self._fed_end_ok_frame(r, rec)
        if op == "fed_drop":
            replacement = self.fed.report_drop(int(header["client"]),
                                               int(header["round"]))
            return make_request({"op": "fed_drop_ok",
                                 "replacement": replacement,
                                 "dropped": self.fed.dropouts})
        if op == "fed_flush":
            # The async drain: commit the ticks pending below the quota
            # (a retried flush of an empty batch answers False).
            return make_request({"op": "fed_flush_ok",
                                 "flushed": bool(self.server.flush_pending())})
        raise ValueError(f"unknown federated op {op!r}")

    def _stats_frame(self) -> bytes:
        s = self.server.stats
        pol = self.policy.snapshot()
        reg = self.registry
        reg.absorb_ps_stats(s)
        reg.absorb_policy(pol)
        fed_snap = None
        if self.fed is not None:
            fed_snap = self.fed.snapshot()
            reg.absorb_federated(fed_snap)
        obs_snapshot = reg.snapshot()
        hists = obs_snapshot["histograms"]
        segments = {}
        for seg_op in sorted(_OPS):
            entry = {}
            for field in _SEGMENT_FIELDS:
                h = hists.get(f"ps_net.{seg_op}.{field}")
                if h and h.get("count"):
                    entry[field] = {
                        "p50_ms": round((h["p50"] or 0) * 1e3, 3),
                        "p99_ms": round((h["p99"] or 0) * 1e3, 3),
                        "count": h["count"]}
            if entry:
                segments[seg_op] = entry
        # Every key of the JAX server's reply (ps_net.py:1204-1252).
        return make_request({
            "op": "stats_ok", "version": self.server.version,
            "pushes": s.pushes, "updates": s.updates,
            "dropped_stale": s.dropped_stale,
            "dropped_plan_stale": s.dropped_plan_stale,
            "plan_version": self.server.plan_version,
            "server_agg": self.server.server_agg,
            "decode_count": s.decode_count,
            "apply_rounds": s.apply_rounds,
            "apply_ms_mean": round(s.apply_ms_mean, 3),
            "dropped_straggler": len(pol.excluded),
            "excluded": pol.excluded,
            "kills_sent": pol.kills_sent,
            "live_workers": self.policy.live_workers(),
            "joins": s.joins,
            "dup_pushes": s.dup_pushes,
            "wal_records": s.wal_records,
            "snapshots": s.snapshots,
            "recoveries": self._recoveries,
            "federated": fed_snap,
            "fed_rejected": s.fed_rejected,
            "dropped_round_stale": s.dropped_round_stale,
            "async_downweighted": s.async_downweighted,
            "async_ticks": s.async_ticks,
            "agg_pushes": s.agg_pushes,
            "agg_weight": s.agg_weight,
            "agg_dup_members": s.agg_dup_members,
            "bytes_up": s.bytes_up, "bytes_down": s.bytes_down,
            "socket_sent": self.bytes.sent,
            "socket_received": self.bytes.received,
            "segments": segments,
            "obs": obs_snapshot,
            # The port's own: this process's kernel launches per wrapper,
            # and the leaves it decoded on the card with the plain version.
            "kernel_launches": dict(kernels.LAUNCHES),
            "plain_decodes_on_card": kernels.PLAIN_DECODES_ON_CARD[
                "acc_decode"],
        })

    def _save(self, header: dict) -> bytes:
        """A checkpoint of (params, opt_state, version), read together, with
        the latest uploaded BatchNorm statistics (``train/checkpoint``)."""
        from ewdml_tpu_torch.train import checkpoint
        from ewdml_tpu_torch.train.state import _nested

        with self._lock_bn:
            bn = self._latest_bn if self._latest_bn is not None else self._bn0
        srv = self.server
        with srv._lock:
            params, opt_state, version = srv.params, srv.opt_state, srv.version
        tree = {"params": srv._tree(params),
                "opt_state": srv._opt_tree(opt_state),
                "batch_stats": _nested(zip(self._bn_paths, bn)),
                "residual": {}}
        path = checkpoint.save(self.cfg.train_dir, tree,
                               int(header.get("step", version)))
        return make_request({"op": "save_ok", "path": path})

    def serve_forever(self):
        from ewdml_tpu_torch.train.metrics import log_robustness

        logger.info("ps_net server on %s:%d (%s plane)",
                    self.address[0], self.address[1], self.wire_plane)
        if self._evloop is not None:
            self._evloop.run()
        else:
            self._tcp.serve_forever()
            self._tcp.server_close()
        snap = self.policy.snapshot()
        log_robustness(-1, excluded=snap.excluded,
                       kills_sent=snap.kills_sent, registry=self.registry)
        self.registry.absorb_ps_stats(self.server.stats)
        self.registry.absorb_policy(snap)
        if self.health is not None:
            self.health.close()
        if self.state_store is not None:
            self.state_store.close()
        otrace.flush()


# -- event-loop wire plane ---------------------------------------------------

class _EvFrame:
    """One complete, parsed request frame in the tick buffer."""

    __slots__ = ("conn", "header", "sections", "recv_ns", "parse_ns",
                 "ready_ns")


class _EvConn:
    """Per-connection frame state machine of the event loop: ``head``
    collects the 8-byte length, ``body`` is sized from it once and filled in
    place; ``out`` queues reply ``sendmsg`` batches. Loop-thread only."""

    __slots__ = ("sock", "head", "head_view", "head_got", "body",
                 "body_view", "body_got", "body_t0_ns", "out", "want_write")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.head = bytearray(_LEN.size)
        self.head_view = memoryview(self.head)
        self.head_got = 0
        self.body: Optional[bytearray] = None
        self.body_view: Optional[memoryview] = None
        self.body_got = 0
        self.body_t0_ns = 0
        self.out: list = []  # [[views...], owns_scratch]
        self.want_write = False


class _EvLoopPlane:
    """The single-threaded ``selectors`` wire plane of
    :class:`PSNetServer` (``ps_net.py:1442-1889``): a tick is ``select()``,
    then every readable socket drained into complete frames, then the
    tick's frames dispatched, the pushes as one
    :meth:`ParameterServer.push_batch` (bit-identical to sequential
    pushes). Replies are encoded into the loop's scratch and sent as
    ``[prefix, body]`` scatter/gather batches under ``EVENT_WRITE``."""

    #: Tick timeout (s): the most a shutdown poll waits.
    TICK_S = 0.05
    #: A read pass stops pulling bytes after this long (ns) and dispatches
    #: what it has, so a frame parsed early does not wait out the fleet.
    DRAIN_BUDGET_NS = 20_000_000
    #: Bound on an announced length: a corrupt prefix is no allocation.
    MAX_FRAME = 1 << 31

    def __init__(self, server: _Endpoint, lsock: socket.socket):
        self.server = server
        self.lsock = lsock
        self.sel = selectors.DefaultSelector()
        self.sel.register(lsock, selectors.EVENT_READ, data=None)
        self._rr = 0
        self._closed = False
        # fed_end frames waiting on their round's commit: (frame,
        # deadline), probed every tick.
        self._parked: list = []

    def run(self) -> None:
        """Serve until the server's ``_shutdown``; then flush queued replies
        (``shutdown_ok`` among them) and close."""
        otrace.set_role(self.server.role)
        _reply_scratch.cur = _ReplyScratch()
        try:
            while not self.server._shutdown.is_set():
                frames = self._poll_once(self.TICK_S)
                if frames:
                    self._dispatch_tick(frames)
                self._service_parked()
            self._drain_for_close()
        finally:
            _reply_scratch.cur = None
            self.close()

    def _service_parked(self) -> None:
        """Per tick: answer each parked ``fed_end`` whose round committed,
        or its barrier-timeout error once its deadline passed. A subclass
        that parks frames of its own (the aggregator's pushes) extends
        this and calls it."""
        if not self._parked:
            return
        still: list = []
        for f, deadline in self._parked:
            if f.conn.sock.fileno() < 0:
                continue  # the connection died while parked
            try:
                if self._try_finish_fed_end(f):
                    continue
            except Exception:
                logger.exception("ps_net[evloop]: parked fed_end failed; "
                                 "dropping connection")
                self._close_conn(f.conn)
                continue
            if clock.monotonic() >= deadline:
                self._send_reply(f.conn, self.server._barrier_timeout_frame(
                    f.header.get("round")))
                continue
            still.append((f, deadline))
        self._parked = still

    def _try_finish_fed_end(self, f: _EvFrame) -> bool:
        """A barrier probe that never blocks; once the round committed,
        the reply goes out through the request envelope (the parked wait
        counts as the frame's queue time)."""
        server = self.server
        r = int(f.header["round"])
        rec = server.fed.wait_round(r, timeout=0)
        if rec is None:
            return False

        def inner(_op, _header, _sections):
            return server._fed_end_ok_frame(r, rec)

        reply = server._dispatch(f.header, f.sections, recv_ns=f.recv_ns,
                                 parse_ns=f.parse_ns,
                                 buffered_since_ns=f.ready_ns, inner=inner)
        self._send_reply(f.conn, reply)
        return True

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for key in list(self.sel.get_map().values()):
            try:
                key.fileobj.close()
            except OSError:
                pass
        self.sel.close()

    def _poll_once(self, timeout: float) -> list:
        frames: list = []
        deadline_ns = clock.monotonic_ns() + self.DRAIN_BUDGET_NS
        ready = self.sel.select(timeout=timeout)
        if len(ready) > 1:
            # Rotate the start so that no connection starves at the tail
            # of a pass whose budget runs out.
            self._rr = (self._rr + 1) % len(ready)
            ready = ready[self._rr:] + ready[:self._rr]
        for key, mask in ready:
            if key.data is None:
                self._accept()
                continue
            conn = key.data
            if conn.sock.fileno() < 0:
                continue  # closed earlier this tick
            if mask & selectors.EVENT_WRITE:
                self._flush_out(conn)
            if mask & selectors.EVENT_READ and conn.sock.fileno() >= 0 \
                    and clock.monotonic_ns() < deadline_ns:
                self._drain_readable(conn, frames, deadline_ns)
        return frames

    def _accept(self) -> None:
        while True:
            try:
                sock, _addr = self.lsock.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            self.sel.register(sock, selectors.EVENT_READ, data=_EvConn(sock))
            self._set_conn_gauge()

    def _drain_readable(self, conn: _EvConn, frames: list,
                        deadline_ns: int) -> None:
        """Read until EAGAIN or the pass deadline, appending each complete
        frame. A disconnect mid-frame or a corrupt frame closes this
        session only, as a threads-plane handler dies on it."""
        try:
            while True:
                if clock.monotonic_ns() >= deadline_ns:
                    return  # the rest stays in the kernel's buffer
                if conn.body is None:
                    r = conn.sock.recv_into(conn.head_view[conn.head_got:],
                                            _LEN.size - conn.head_got)
                    if not r:
                        raise ConnectionError("peer closed")
                    conn.head_got += r
                    if conn.head_got < _LEN.size:
                        continue
                    (n,) = _LEN.unpack(conn.head)
                    if not 0 < n <= self.MAX_FRAME:
                        raise ConnectionError(f"bad frame length {n}")
                    conn.body = bytearray(n)
                    conn.body_view = memoryview(conn.body)
                    conn.body_got = 0
                    conn.body_t0_ns = clock.monotonic_ns()
                    conn.head_got = 0
                else:
                    r = conn.sock.recv_into(conn.body_view[conn.body_got:],
                                            len(conn.body) - conn.body_got)
                    if not r:
                        raise ConnectionError("peer closed")
                    conn.body_got += r
                    if conn.body_got == len(conn.body):
                        self._complete_frame(conn, frames)
        except BlockingIOError:
            return
        except (ConnectionError, OSError, ValueError):
            self._close_conn(conn)

    def _complete_frame(self, conn: _EvConn, frames: list) -> None:
        recv_ns = clock.monotonic_ns() - conn.body_t0_ns
        self.server.bytes.add(received=_LEN.size + len(conn.body))
        t0 = clock.monotonic_ns()
        # A corrupt frame's ValueError closes the session (the caller).
        header, sections = parse_request(bytes(conn.body))
        f = _EvFrame()
        f.conn, f.header, f.sections = conn, header, sections
        f.recv_ns = recv_ns
        f.parse_ns = clock.monotonic_ns() - t0
        f.ready_ns = clock.monotonic_ns()
        frames.append(f)
        conn.body = conn.body_view = None
        conn.body_got = 0

    def _close_conn(self, conn: _EvConn) -> None:
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        # A queued reply may own the scratch: release it with the session.
        for _views, owns in conn.out:
            if owns:
                scratch = getattr(_reply_scratch, "cur", None)
                if scratch is not None:
                    scratch.busy = False
        conn.out.clear()
        self._set_conn_gauge()

    def _set_conn_gauge(self) -> None:
        n = max(0, len(self.sel.get_map()) - 1)  # less the listener
        server = self.server
        with server._occ_lock:
            server._connections = n
            server._g_conns.set(n)

    def _dispatch_tick(self, frames: list) -> None:
        """The tick's frames: the pushes as one batch admission, the rest
        one by one. ``ps_net.inflight`` is the tick's frame count here."""
        server = self.server
        with server._occ_lock:
            server._inflight = len(frames)
            server._g_inflight.set(len(frames))
        try:
            pushes = [f for f in frames if f.header.get("op") == "push"]
            if pushes:
                self._dispatch_push_batch(pushes)
            for f in frames:
                if f.header.get("op") != "push":
                    self._dispatch_one(f)
        finally:
            with server._occ_lock:
                server._inflight = 0
                server._g_inflight.set(0)

    def _dispatch_one(self, f: _EvFrame) -> None:
        if (f.header.get("op") == "fed_end" and self.server.fed is not None
                and f.header.get("round") is not None):
            # The round barrier must not block the loop (the pushes that
            # commit the round arrive on it): probe now, else park and
            # probe every tick until the commit or the deadline.
            if not self._try_finish_fed_end(f):
                self._parked.append(
                    (f, clock.monotonic() + self.server._barrier_wait_s()))
            return
        try:
            reply = self.server._dispatch(f.header, f.sections,
                                          recv_ns=f.recv_ns,
                                          parse_ns=f.parse_ns,
                                          buffered_since_ns=f.ready_ns)
        except Exception:
            # A handler fault costs one session, never the loop.
            logger.exception("ps_net[evloop]: %r dispatch failed; dropping "
                             "connection", f.header.get("op"))
            self._close_conn(f.conn)
            return
        if reply is not None:
            self._send_reply(f.conn, reply)

    def _dispatch_push_batch(self, frames: list) -> None:
        """One tick's pushes: one ``push_batch`` in arrival order, then a
        reply and a request envelope per frame. A frame's tick-buffer wait
        is its queue time; the batch's lock waits go to the last frame,
        whose push ran the apply."""
        server = self.server
        records, retried, admitted = [], [], []
        for f in frames:
            try:
                records.append(server._push_record(
                    f.header, f.sections,
                    round_id=int(f.header.get("round", -1))))
            except (KeyError, ValueError, TypeError, IndexError):
                self._close_conn(f.conn)  # a malformed push: one session
                continue
            retried.append(bool(f.header.get("retry")))
            admitted.append(f)
        if not records:
            return
        seg = reqctx.RequestSegments()
        reqctx.activate(seg)
        t_admit0 = clock.monotonic_ns()
        try:
            outcomes = server.server.push_batch(records, retried=retried)
        finally:
            reqctx.deactivate()
        for i, (f, out) in enumerate(zip(admitted, outcomes)):
            if isinstance(out, Exception) and \
                    not isinstance(out, StragglerKilled):
                # A corrupt payload: no reply, the session dies, as a
                # threads-plane handler's raise does.
                logger.warning("ps_net[evloop]: push from worker %s failed "
                               "(%s); dropping connection",
                               f.header.get("worker"), out)
                self._close_conn(f.conn)
                continue
            fseg = reqctx.RequestSegments()
            fseg.add_queue(f.ready_ns, max(0, t_admit0 - f.ready_ns))
            if i == len(admitted) - 1 and seg.queue_ns:
                fseg.add_queue(seg.queue_max_start_ns or t_admit0,
                               seg.queue_ns)
            reqctx.activate(fseg)
            try:
                reply = (server._kill_frame(out)
                         if isinstance(out, StragglerKilled)
                         else server._push_ok_frame(out))
            finally:
                reqctx.deactivate()
            server._emit_dispatch_obs("push", f.header, f.ready_ns,
                                      clock.monotonic_ns() - f.ready_ns,
                                      fseg, f.recv_ns, f.parse_ns)
            self._send_reply(f.conn, reply)

    def _send_reply(self, conn: _EvConn, msg) -> None:
        """Queue ``[length prefix, body]`` and try to flush it now. ``msg``
        is the scratch's memoryview (owned until sent) or bytes."""
        if conn.sock.fileno() < 0:
            return
        owns = isinstance(msg, memoryview)
        body = msg if owns else memoryview(msg)
        conn.out.append([[memoryview(_LEN.pack(len(body))), body], owns])
        self._flush_out(conn)

    def _flush_out(self, conn: _EvConn) -> None:
        server = self.server
        try:
            while conn.out:
                views, owns = conn.out[0]
                try:
                    sent = conn.sock.sendmsg(views)
                except BlockingIOError:
                    self._want_write(conn, True)
                    return
                server.bytes.add(sent=sent)
                while views and sent >= len(views[0]):
                    sent -= len(views[0])
                    del views[0]
                if views and sent:
                    views[0] = views[0][sent:]
                if not views:
                    conn.out.pop(0)
                    if owns:
                        scratch = getattr(_reply_scratch, "cur", None)
                        if scratch is not None:
                            scratch.busy = False
            self._want_write(conn, False)
        except OSError:
            self._close_conn(conn)

    def _want_write(self, conn: _EvConn, on: bool) -> None:
        if on == conn.want_write:
            return
        conn.want_write = on
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if on else 0)
        try:
            self.sel.modify(conn.sock, events, data=conn)
        except (KeyError, ValueError):
            pass

    def _drain_for_close(self) -> None:
        """Give queued replies a few seconds to reach their peers."""
        deadline = clock.monotonic() + 5.0
        while clock.monotonic() < deadline:
            pending = [key.data for key in list(self.sel.get_map().values())
                       if key.data is not None and key.data.out]
            if not pending:
                return
            for key, _mask in self.sel.select(timeout=0.05):
                if key.data is not None and key.data.out:
                    self._flush_out(key.data)


# -- worker ------------------------------------------------------------------

class PSNetWorker:
    """One worker process: connect, then pull -> compute -> compress ->
    push, as :class:`~ewdml_tpu_torch.parallel.ps.AsyncWorker` does, over a
    real socket. Its model copy keeps its own BatchNorm statistics, which it
    uploads at the end; its key chain is ``fold_in(key(seed), index)``,
    then ``step_key`` per step; its data is the whole dataset under its own
    shuffle (``seed + index``), as in the reference."""

    def __init__(self, cfg, index: int, addr: tuple,
                 registry: Optional[MetricsRegistry] = None):
        from ewdml_tpu_torch.data import datasets, loader
        from ewdml_tpu_torch.parallel import ps
        from ewdml_tpu_torch.utils import prng, transfer

        check_supported(cfg, "worker")
        self.cfg = cfg
        self.index = index
        self.addr = addr
        self.registry = registry if registry is not None else MetricsRegistry()
        otrace.configure(cfg.trace_dir, role=f"worker-{index}")
        otrace.maybe_configure_from_env(role=f"worker-{index}")
        self.health = ohealth.make_watchdog(cfg, role=f"worker-{index}",
                                            registry=self.registry)
        self.bytes = ByteCounter(self.registry)
        self.faults = FaultSpec.parse(cfg.fault_spec).for_worker(index)
        setup = build_endpoint_setup(cfg)
        self.device = setup.device
        self.module = setup.model
        self.specs = setup.specs
        # The homomorphic contract this worker encodes under: its CRC is
        # compared with the server's on every pull.
        self._hom_comp = setup.comp if setup.grads_scale is not None else None
        # A plan switch renegotiates the scales from this template, as the
        # server's AdaptRuntime.set_scale_base does from its own copy.
        self._grads_scale = setup.grads_scale
        self.grad_fn = setup.grad_fn
        self._compress_tree = setup.compress_tree
        self._pack = transfer.make_device_packer()
        self._unpack_params = transfer.make_device_unpacker(setup.params)
        self._unpack_params_bf16 = (ps.make_bf16_unpacker(setup.params)
                                    if cfg.ps_bootstrap == "bf16" else None)
        self._wire_dtype = (cfg.precision.wire_dtype
                            if setup.compress_tree is None
                            and cfg.precision.bf16_wire else None)
        self._apply_delta = None
        if setup.comp is not None and cfg.ps_down == "delta":
            self._apply_delta = ps.make_apply_delta(
                setup.comp, transfer.make_device_unpacker(setup.template))
        ds = datasets.load(cfg.dataset, cfg.data_dir, train=True,
                           synthetic=cfg.synthetic_data, seed=cfg.seed,
                           synthetic_size=cfg.synthetic_size)
        self.data = loader.global_batches(ds, cfg.batch_size, 1,
                                          seed=cfg.seed + index, feed="f32")
        self.key = prng.fold_in(prng.key(cfg.seed), index)
        self._params = None
        self._version = -1
        # The adaptive plan this worker encodes under, and per plan key its
        # (compressor, compress tree).
        self._plan_version = 0
        self._ctree_cache: dict = {}
        # The RetryingConnections, set by run(): to the apply server, and
        # the pull and push routes (the server's unless --replicas or
        # --agg-tree name other endpoints).
        self.conn = self.pull_conn = self.push_conn = None
        # The live metrics endpoint (obs/serve) of --metrics-port.
        self.live = oserve.Live(cfg.metrics_port, self.registry,
                                f"worker-{index}")

    def _to_device(self, raw) -> torch.Tensor:
        return torch.from_numpy(
            np.frombuffer(bytes(raw), np.uint8).copy()).to(self.device)

    def _follow_plan(self, header: dict) -> None:
        """Adopt the server's adaptive plan when the reply says ours is
        stale: the compress tree is rebuilt from the shipped plan JSON with
        the server's constructor (``build_planned_compressor``), wrapped
        with the scale contract renegotiated from this worker's template
        under ``--server-agg homomorphic``; one per plan key."""
        if "plan" not in header:
            if "plan_version" in header:
                self._plan_version = int(header["plan_version"])
            return
        from ewdml_tpu_torch.adapt.plan import Plan, build_planned_compressor
        from ewdml_tpu_torch.parallel import ps

        plan = Plan.from_json(header["plan"])
        ckey = plan.key()
        cached = self._ctree_cache.get(ckey)
        if cached is None:
            comp = build_planned_compressor(plan, exact=self.cfg.topk_exact,
                                            block=self.cfg.qsgd_block)
            if self.cfg.server_agg == "homomorphic":
                from ewdml_tpu_torch.ops.homomorphic import make_homomorphic

                comp = make_homomorphic(comp, self._grads_scale)
            cached = self._ctree_cache[ckey] = (comp,
                                                ps.make_compress_tree(comp))
        comp, self._compress_tree = cached
        if self.cfg.server_agg == "homomorphic":
            self._hom_comp = comp
        self._plan_version = int(header["plan_version"])
        logger.info("worker %d: adopted adaptive plan v%d (%s)",
                    self.index, self._plan_version, plan.method_counts())

    def _check_scale(self, header: dict) -> None:
        """The contract-desync guard: the pull reply's scale CRC must be
        this worker's own, compared only when it belongs to the plan
        version this worker encodes under (a racing switch re-checks at
        the next pull)."""
        if (self._hom_comp is None or "scale_crc" not in header
                or int(header.get("scale_crc_pv", -1)) != self._plan_version):
            return
        mine = self._hom_comp.contract_checksum()
        theirs = int(header["scale_crc"])
        if mine != theirs:
            raise RuntimeError(
                f"worker {self.index}: shared-scale contract desync at plan "
                f"v{self._plan_version} (ours crc {mine:#010x}, server "
                f"{theirs:#010x}) — the endpoints derived different scale "
                "grids; pushes would be decoded on scales they were not "
                "encoded with")

    def _load_pull(self, header: dict, sections: list) -> None:
        mode = header["mode"]
        if mode == "weights":
            self._params = self._unpack_params(self._to_device(sections[0]))
        elif mode == "weights_bf16":
            self._params = self._unpack_params_bf16(
                self._to_device(sections[0]))
        else:
            for raw in sections:
                self._params = self._apply_delta(self._params,
                                                 self._to_device(raw))
        self._version = int(header["version"])

    def run(self, steps: int) -> dict:
        from ewdml_tpu_torch import native
        from ewdml_tpu_torch.core.precision import wire_cast
        from ewdml_tpu_torch.train.metrics import log_robustness
        from ewdml_tpu_torch.utils import prng

        cfg = self.cfg
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        conn = self.conn = RetryingConnection(
            self.addr, timeout_s=cfg.net_timeout_s, retries=cfg.net_retries,
            backoff_s=cfg.net_backoff_s, byte_counter=self.bytes,
            # Seeded full jitter, distinct per worker: a fleet reconnecting
            # to a restarted server decorrelates, and a run replays.
            jitter_seed=(cfg.seed << 16) ^ self.index,
            registry=self.registry)
        # Reads and writes split (ps_net.py:2045-2078): every step's pull
        # goes to the replica list, its push to this worker's home
        # aggregator (index % A, the others as failover); resync, join and
        # bn_stats stay on the apply server. Each route has its own jitter.
        pull_conn = push_conn = conn
        if cfg.replicas:
            pull_conn = self.pull_conn = RetryingConnection(
                parse_replicas(cfg.replicas), timeout_s=cfg.net_timeout_s,
                retries=cfg.net_retries, backoff_s=cfg.net_backoff_s,
                byte_counter=self.bytes,
                jitter_seed=(cfg.seed << 16) ^ self.index ^ 0x5A5A,
                registry=self.registry)
        if cfg.agg_tree:
            from ewdml_tpu_torch.core.config import parse_agg_tree

            aggs = parse_agg_tree(cfg.agg_tree)
            home = self.index % len(aggs)
            push_conn = self.push_conn = RetryingConnection(
                aggs[home:] + aggs[:home], timeout_s=cfg.net_timeout_s,
                retries=cfg.net_retries, backoff_s=cfg.net_backoff_s,
                byte_counter=self.bytes,
                jitter_seed=(cfg.seed << 16) ^ self.index ^ 0xA660,
                registry=self.registry)
            header = _expect(push_conn.call({"op": "agg_register",
                                             "worker": self.index})[0],
                             "agg_register_ok")
            if int(header["children"]) < 1:
                raise RuntimeError(f"agg_register answered {header!r}")
        otrace.set_role(f"worker-{self.index}")
        try:
            last_loss = float("nan")
            rejected = 0
            resyncs = 0
            if self.faults.join_after is not None:
                # ``join@W=N``: a late joiner waits N seconds, then asks to
                # be admitted; its first pull is a full one.
                time.sleep(self.faults.join_after)
                header = _expect(conn.call({"op": "join",
                                            "worker": self.index})[0],
                                 "join_ok")
                logger.info("worker %d: joined mid-run at version %d "
                            "(live=%d, num_aggregate=%d)", self.index,
                            int(header["version"]), int(header["live"]),
                            int(header["num_aggregate"]))
                self._version = -1
            last_reconnects = conn.counters.reconnects
            for step in range(steps):
                self.faults.crash_due(step)
                if self.faults.reset_due(step):
                    conn.inject_reset()
                if self.faults.drop_due(step):
                    conn.inject_truncated(make_request(
                        {"op": "pull", "worker": self.index,
                         "worker_version": self._version}))
                bh = self.faults.partition_due(step)
                if bh:
                    conn.inject_blackhole(bh)
                if conn.counters.reconnects != last_reconnects:
                    # The connection died since the last round trip: the
                    # server may be a restarted process. A version skew
                    # forces a full pull (old delta chains are gone).
                    header = _expect(conn.call(
                        {"op": "resync", "worker": self.index,
                         "plan_version": self._plan_version})[0],
                        "resync_ok")
                    self._follow_plan(header)
                    if int(header["version"]) != self._version:
                        self._version = -1
                    resyncs += 1
                    last_reconnects = conn.counters.reconnects
                # plan_version rides every pull and push: against an
                # adaptive server an untagged push would read as plan 0.
                req = {"op": "pull", "worker": self.index,
                       "worker_version": self._version,
                       "plan_version": self._plan_version}
                retries_before = conn.counters.retries
                t_send = clock.monotonic_ns()
                rid = otrace.next_request_id()
                if otrace.enabled():
                    req["mono_ns"] = t_send
                with otrace.span("worker/pull", step=step, req=rid):
                    header, sections = pull_conn.call(req, req_id=rid)
                t_recv = clock.monotonic_ns()
                _expect(header, "pull_ok")
                self._follow_plan(header)
                self._check_scale(header)
                if step == 0 and otrace.enabled() \
                        and "server_mono_ns" in header:
                    # Clock handshake: 0 on one host (CLOCK_MONOTONIC is
                    # machine-wide); across hosts the RTT midpoint, only
                    # for a round trip that was not retried.
                    if header.get("host") == socket.gethostname():
                        otrace.set_clock_offset(0)
                    elif conn.counters.retries == retries_before:
                        otrace.set_clock_offset(
                            int(header["server_mono_ns"])
                            - (t_send + t_recv) // 2)
                self._load_pull(header, sections)
                images, labels = next(self.data)
                k = prng.step_key(self.key, step)
                with otrace.span("worker/grad", step=step,
                                 version=self._version):
                    loss, grads = self.grad_fn(
                        self.module, self._params,
                        torch.from_numpy(np.ascontiguousarray(images)).to(
                            self.device),
                        torch.from_numpy(np.ascontiguousarray(labels)).to(
                            self.device), k)
                if self.health is not None:
                    gn = float(torch.sqrt(sum(
                        (g.float() * g.float()).sum() for g in grads)))
                    self.health.observe_grad_norm(step, gn)
                self.faults.sleep_if_due()
                with otrace.span("worker/compress", step=step,
                                 version=self._version), torch.no_grad():
                    if self._compress_tree is not None:
                        payloads = self._compress_tree(grads, k)
                    elif self._wire_dtype is not None:
                        payloads = wire_cast(grads, self._wire_dtype)
                    else:
                        payloads = grads
                    buf = self._pack(payloads).cpu().numpy()
                last_loss = float(loss)
                if self.faults.nan_due(step):
                    last_loss = float("nan")
                rid = otrace.next_request_id()
                with otrace.span("worker/push", step=step,
                                 version=self._version, req=rid):
                    # push_id is the idempotency key: a re-sent push whose
                    # first copy landed is acknowledged, not applied twice.
                    header, _ = push_conn.call(
                        {"op": "push", "worker": self.index,
                         "version": self._version, "loss": last_loss,
                         "plan_version": self._plan_version,
                         "push_id": f"{self.index}:{step}"},
                        [native.encode_arrays([buf])], req_id=rid)
                if not _expect(header, "push_ok").get("accepted", True):
                    rejected += 1
                if self.health is not None:
                    # After the push: the server's watchdog owns the
                    # deployment's verdict and sees the NaN first.
                    self.health.observe_loss(step, last_loss)
            bn = [b for _, b in _bn_buffers(self.module)]
            if bn:
                buf = self._pack(bn).cpu().numpy()
                _expect(conn.call({"op": "bn_stats", "worker": self.index},
                                  [buf.tobytes()])[0], "bn_stats_ok")
            return {"worker": self.index, "steps": steps, "loss": last_loss,
                    "rejected": rejected, "resyncs": resyncs,
                    "retries": conn.counters.retries,
                    "reconnects": conn.counters.reconnects,
                    "socket_sent": self.bytes.sent,
                    "socket_received": self.bytes.received}
        finally:
            # On every exit path: a killed or crashed worker's counters
            # matter most.
            log_robustness(self.index, retries=conn.counters.retries,
                           reconnects=conn.counters.reconnects)
            otrace.flush()
            for c in {id(c): c for c in (conn, pull_conn, push_conn)}.values():
                c.close()


def parse_replicas(spec: str) -> list:
    """``"host:port,host:port"`` -> the address list a
    :class:`RetryingConnection` fails over across."""
    addrs = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, port = part.rsplit(":", 1)
        addrs.append((host, int(port)))
    if not addrs:
        raise ValueError(f"--replicas parsed to no addresses: {spec!r}")
    return addrs


def client_call(addr: tuple, header: dict, sections=(), *,
                timeout_s: float = 30.0, retries: int = 3,
                backoff_s: float = 0.5) -> tuple[dict, list]:
    """One control request (stats, save, shutdown) with the worker wire's
    retry and backoff."""
    conn = RetryingConnection(addr, timeout_s=timeout_s, retries=retries,
                              backoff_s=backoff_s)
    try:
        return conn.call(header, sections)
    finally:
        conn.close()


def _serve(endpoint: _Endpoint) -> None:
    """Serve until ``shutdown``: first the ``PS_NET_METRICS <role> <port>``
    line under ``--metrics-port`` (an ephemeral port is known only here),
    and the metrics endpoint closed at the end."""
    if endpoint.live.port:
        print(f"PS_NET_METRICS {endpoint.role} {endpoint.live.port}",
              flush=True)
    try:
        endpoint.serve_forever()
    finally:
        endpoint.live.close()


def main(argv=None) -> int:
    """``python -m ewdml_tpu_torch.parallel.ps_net --role
    server|worker|fed_driver|replica|aggregator`` with the JAX entry point's
    flags (``ps_net.py:2317-2455``). A replica and an aggregator listen on
    ``--replica-host/--replica-port`` and ``--agg-host/--agg-port``, with
    ``--host/--port`` naming the apply server upstream; a ``fed_driver``
    drives the rounds of the ``--federated`` server at ``--host/--port``
    and prints ``PS_NET_FED_DONE {json}``."""
    import argparse
    import os

    from ewdml_tpu_torch.core.config import TrainConfig, add_fit_args

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="cross-process PS over TCP")
    add_fit_args(parser)
    parser.add_argument("--role",
                        choices=["server", "worker", "fed_driver",
                                 "replica", "aggregator"],
                        required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=29500)
    parser.add_argument("--worker-index", type=int, default=0)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--replica-host", default="127.0.0.1")
    parser.add_argument("--replica-port", type=int, default=0)
    parser.add_argument("--agg-host", default="127.0.0.1")
    parser.add_argument("--agg-port", type=int, default=0)
    parser.add_argument("--agg-index", type=int, default=0)
    ns = parser.parse_args(argv)
    fields = {f.name: getattr(ns, f.name)
              for f in dataclasses.fields(TrainConfig) if hasattr(ns, f.name)}
    cfg = TrainConfig(**fields)
    check_supported(cfg, ns.role)
    if ns.role != "fed_driver":  # which arms no exporter
        cfg.metrics_port = oserve.env_port(cfg.metrics_port)
    if ns.role == "server":
        server = PSNetServer(cfg, ns.host, ns.port)
        print(f"PS_NET_READY {server.address[0]}:{server.address[1]}",
              flush=True)
        _serve(server)
        if server.health is not None and server.health.aborted:
            print("PS_NET_HEALTH_ABORT " + json.dumps(server.health.aborted),
                  flush=True)
            # Exit hard: a handler thread may be mid-apply.
            os._exit(ohealth.HEALTH_EXIT_CODE)
        return 0
    if ns.role == "replica":
        # Ready once the bootstrap keyframe has landed: the address serves
        # a real version when a supervisor reads it.
        from ewdml_tpu_torch.parallel.replica import PullReplicaServer

        replica = PullReplicaServer(cfg, (ns.host, ns.port),
                                    host=ns.replica_host,
                                    port=ns.replica_port)
        print(f"PS_REPLICA_READY {replica.address[0]}:{replica.address[1]}",
              flush=True)
        _serve(replica)
        return 0
    if ns.role == "aggregator":
        from ewdml_tpu_torch.parallel.aggtree import AggregatorServer

        agg = AggregatorServer(cfg, (ns.host, ns.port), host=ns.agg_host,
                               port=ns.agg_port, index=ns.agg_index)
        print(f"PS_AGG_READY {agg.address[0]}:{agg.address[1]}", flush=True)
        _serve(agg)
        return 0
    if ns.role == "fed_driver":
        # The client pool on this side; the server (--role server with the
        # same --federated config) samples, journals and commits.
        from ewdml_tpu_torch.federated import run_federated

        result = run_federated(cfg, addr=(ns.host, ns.port))
        print("PS_NET_FED_DONE " + json.dumps({
            "rounds": result.rounds, "final_loss": result.final_loss,
            "dropouts": result.dropouts, "rejected": result.rejected,
            "skew": round(result.skew, 4)}), flush=True)
        return 0
    worker = PSNetWorker(cfg, ns.worker_index, (ns.host, ns.port))
    if worker.live.port:
        print(f"PS_NET_METRICS worker-{ns.worker_index} "
              f"{worker.live.port}", flush=True)

    def wire_counters():
        conn = worker.conn
        return {} if conn is None else {"retries": conn.counters.retries,
                                        "reconnects": conn.counters.reconnects}

    try:
        result = worker.run(ns.steps)
    except ohealth.HealthAbort as e:
        print("PS_NET_HEALTH_ABORT " + json.dumps(
            {"worker": ns.worker_index, "kind": e.kind, "step": e.step,
             **wire_counters()}), flush=True)
        return ohealth.HEALTH_EXIT_CODE
    except StragglerKilled as e:
        print("PS_NET_WORKER_KILLED " + json.dumps(
            {"worker": ns.worker_index, "reason": e.reason,
             **wire_counters()}), flush=True)
        return KILL_EXIT_CODE
    except FaultCrash as e:
        print("PS_NET_WORKER_CRASHED " + json.dumps(
            {"worker": ns.worker_index, "step": e.step,
             **wire_counters()}), flush=True)
        return CRASH_EXIT_CODE
    finally:
        worker.live.close()
    print("PS_NET_WORKER_DONE " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
