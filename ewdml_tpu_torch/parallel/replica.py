"""Pull replicas: the read path of the TCP tier, scaled out
(``ewdml_tpu/parallel/replica.py``).

The apply server is the one process that applies updates; every pull it
serves waits behind them. A :class:`PullReplicaServer` subscribes to the
apply server's publication stream (the ``subscribe`` op), keeps a versioned
copy of the packed f32 parameters, and serves ``pull``, ``resync``,
``stats`` and ``shutdown`` from it on its own event-loop plane
(:class:`~ewdml_tpu_torch.parallel.ps_net._EvLoopPlane`), never touching
the apply server's locks. Workers given ``--replicas`` pull from the
address list and fail over between replicas
(:class:`~ewdml_tpu_torch.parallel.ps_net.RetryingConnection`).

Every reply is version-stamped; the staleness bound stays where it was: a
push computed on a replica-served version is judged by the apply server's
``--max-staleness``. The replica reports how far behind the stream its last
poll found it (``replica.staleness``).

Under ``--pull-delta`` the stream carries int8 per-version deltas on the
shared scale grid and a full f32 keyframe every ``--keyframe-every``
versions; the replica replays them with the server's own numpy expression
(:func:`~ewdml_tpu_torch.parallel.ps.pd_apply_delta`), so its copy equals
the server's publication shadow at every version and the parameters
exactly at a keyframe. The stream's geometry is pinned by a CRC on every
reply, and a replica refuses a stream whose contract changed under it.

A replica is a host process: numpy only, it never initialises CUDA. Its
counters and gauges (``replica.*``) live in its own ``MetricsRegistry``,
served under ``--metrics-port`` (``PS_NET_METRICS ps-replica <port>``).

    python -m ewdml_tpu_torch.parallel.ps_net --role replica \\
        --host 127.0.0.1 --port 29500 --replica-port 29600 ...
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np

from ewdml_tpu_torch.obs import trace as otrace
from ewdml_tpu_torch.obs.registry import MetricsRegistry
from ewdml_tpu_torch.parallel import ps_net
from ewdml_tpu_torch.parallel.ps import pd_apply_delta, pd_contract_crc
from ewdml_tpu_torch.parallel.ps_net import make_request

logger = logging.getLogger("ewdml_tpu_torch.replica")


def subscribe_call(conn, since: int) -> tuple:
    """One ``subscribe`` poll of the apply server: ``(mode, version,
    kf_version, contract, sections)``, where ``contract`` is the stream
    geometry of the reply header and ``sections`` the buffers to replay
    (``[keyframe][, levels, scales]*``)."""
    header, sections = conn.call({"op": "subscribe", "since": int(since)})
    if header.get("op") != "subscribe_ok":
        raise ConnectionError(f"subscribe refused: {header}")
    contract = {"flat": int(header["flat"]), "block": int(header["block"]),
                "s": int(header["s"]),
                "keyframe_every": int(header["keyframe_every"]),
                "crc": int(header["crc"])}
    return (header["mode"], int(header["version"]),
            int(header["keyframe"]), contract, sections)


class _ReadOnlyPS:
    """The plane's ``push_batch`` on a replica: every push fails on its own
    (its connection is dropped), and the loop goes on."""

    def push_batch(self, records, retried=()):
        return [RuntimeError("replica is read-only; push to the apply "
                             "server") for _ in records]


class PullReplicaServer(ps_net._Endpoint):
    """A versioned read replica on the event-loop plane.

    Construction blocks until the first subscribe has landed (within the
    connection's retry budget), so an address it prints already serves a
    real version. A poll thread then subscribes every
    ``cfg.subscribe_every_s`` and swaps the served buffer under ``_lock``;
    the loop thread reads it under the same lock."""

    role = "ps-replica"

    def __init__(self, cfg, upstream: tuple, host: str = "127.0.0.1",
                 port: int = 0, registry: Optional[MetricsRegistry] = None):
        import socket

        from ewdml_tpu_torch.core.config import validate_replicas

        validate_replicas(cfg)
        self.cfg = cfg
        self.server = _ReadOnlyPS()
        super().__init__(registry)
        otrace.configure(cfg.trace_dir, role=self.role)
        otrace.maybe_configure_from_env(role=self.role)
        # The served copy: the poll thread builds (flat, wire, version) off
        # the lock and swaps the references under it. _flat and _contract
        # belong to the poll thread (the bootstrap writes them first).
        self._lock = threading.Lock()
        # _flat/_contract: rebound by whole-reference stores, never
        # mutated in place.
        self._flat: Optional[np.ndarray] = None  # ewdml: atomic
        self._contract = None                    # ewdml: atomic
        self._wire = b""         # ewdml: guarded-by[_lock]
        self._version = -1       # ewdml: guarded-by[_lock]
        self._kf_version = -1    # ewdml: guarded-by[_lock]
        # One writer each: pulls the loop thread, the rest the poll thread
        # (read racily, as advisory counts, by the stats op).
        self._pulls = 0
        self._keyframes = 0      # ewdml: atomic
        self._deltas = 0         # ewdml: atomic
        self._polls = 0          # ewdml: atomic
        reg = self.registry
        self._g_version = reg.gauge("replica.version")
        self._g_upstream = reg.gauge("replica.upstream_version")
        self._g_staleness = reg.gauge("replica.staleness")
        self._c_keyframes = reg.counter("replica.keyframes")
        self._c_deltas = reg.counter("replica.deltas")
        self._c_pulls = reg.counter("replica.pulls")
        self._up = ps_net.RetryingConnection(
            upstream, timeout_s=cfg.net_timeout_s, retries=cfg.net_retries,
            backoff_s=cfg.net_backoff_s, byte_counter=self.bytes)
        # The bootstrap keyframe, before the listener binds.
        self._sync_once()
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((host, port))
        lsock.listen(128)
        lsock.setblocking(False)
        self.address = lsock.getsockname()
        self._evloop = ps_net._EvLoopPlane(self, lsock)
        self._poller = threading.Thread(target=self._poll_loop, daemon=True)
        self._arm_metrics()

    # -- the stream (poll thread) ----------------------------------------------

    def _sync_once(self) -> None:
        """One subscribe round trip and its replay. A changed contract
        raises RuntimeError (fatal); a ConnectionError goes to the poll
        loop, which keeps trying (the upstream may be restarting)."""
        with self._lock:
            since = self._version
        mode, version, kf_version, contract, sections = subscribe_call(
            self._up, since)
        crc = pd_contract_crc(contract["flat"], contract["block"],
                              contract["s"], contract["keyframe_every"])
        if crc != contract["crc"]:
            raise RuntimeError(
                f"subscribe contract CRC mismatch (ours {crc:#010x}, "
                f"server {contract['crc']:#010x}): endpoints derived "
                "different stream geometry")
        if self._contract is None:
            self._contract = contract
        elif contract != self._contract:
            raise RuntimeError(
                f"subscribe stream contract changed under us "
                f"(pinned {self._contract}, got {contract}): the apply "
                "server restarted with different wire-semantics knobs — "
                "restart this replica to renegotiate")
        i = 0
        if mode == "keyframe":
            flat = np.frombuffer(sections[0], np.float32).copy()
            if flat.nbytes != contract["flat"]:
                raise RuntimeError(
                    f"keyframe size {flat.nbytes} != contract "
                    f"{contract['flat']}")
            i = 1
            self._keyframes += 1
            self._c_keyframes.inc()
        else:
            flat = self._flat
        nd = 0
        while i < len(sections):
            flat = pd_apply_delta(flat, np.frombuffer(sections[i], np.int8),
                                  np.frombuffer(sections[i + 1], np.float32))
            i += 2
            nd += 1
        if nd:
            self._deltas += nd
            self._c_deltas.inc(nd)
        self._polls += 1
        with self._lock:
            have_wire = bool(self._wire)
        if version != since or not have_wire:
            self._flat = flat
            wire = flat.tobytes()
            with self._lock:
                self._wire = wire
                self._version = version
                self._kf_version = kf_version
        self._g_version.set(version)
        self._g_upstream.set(version)
        # How far behind the stream this poll found the served copy.
        self._g_staleness.set(max(0, version - since))

    def _poll_loop(self) -> None:
        otrace.set_role(self.role)
        while not self._shutdown.is_set():
            try:
                self._sync_once()
            except ConnectionError as e:
                # The next successful subscribe resynchronises by one
                # keyframe.
                logger.warning("replica: subscribe failed (%s); retrying", e)
            except RuntimeError:
                logger.exception("replica: fatal stream error; stopping")
                self._request_stop()
                return
            self._shutdown.wait(self.cfg.subscribe_every_s)

    # -- serving (loop thread) -------------------------------------------------

    def _dispatch_inner(self, op, header: dict, sections: list):
        if op == "pull":
            # The dense weights of a direct weights-mode pull, from the
            # local copy.
            with self._lock:
                wire, version = self._wire, self._version
            self._pulls += 1
            self._c_pulls.inc()
            return make_request({"op": "pull_ok", "mode": "weights",
                                 "version": int(version)}, [wire])
        if op == "resync":
            with self._lock:
                version = self._version
            return make_request({"op": "resync_ok", "version": int(version)})
        if op == "stats":
            with self._lock:
                version, kf_version = self._version, self._kf_version
            return make_request({
                "op": "stats_ok", "version": int(version),
                "replica_keyframe": int(kf_version),
                "replica_pulls": self._pulls,
                "replica_keyframes": self._keyframes,
                "replica_deltas": self._deltas,
                "replica_polls": self._polls,
                "bytes_sent": self.bytes.sent,
                "bytes_received": self.bytes.received})
        if op == "shutdown":
            self._request_stop()
            return make_request({"op": "shutdown_ok"})
        return make_request(
            {"op": "error", "detail": f"unsupported op {op!r} on a pull "
                                      "replica (writes go to the apply "
                                      "server)"})

    def serve_forever(self) -> None:
        with self._lock:
            boot_version = self._version
        logger.info("pull replica on %s:%d (upstream %s:%d, version %d)",
                    self.address[0], self.address[1], self._up.addr[0],
                    self._up.addr[1], boot_version)
        self._poller.start()
        try:
            self._evloop.run()
        finally:
            self._up.close()
            otrace.flush()

    def close(self) -> None:
        """Release the listener and the metrics endpoint (idempotent)."""
        self.live.close()
        self._request_stop()
        self._evloop.close()
        self._up.close()
