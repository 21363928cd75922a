"""The aggregation tier: mid-tier sums in the compressed domain
(``ewdml_tpu/parallel/aggtree.py``).

A homomorphic root decodes once a round, but every leaf's int8 push still
crosses its wire and its admission. On the shared scale grid a subtree's
sum of int8 levels is exact, only wider, so an aggregator never decodes:

- leaves push their ordinary int8 frames (the ``push`` op, the same bytes)
  to their aggregator instead of the root;
- the aggregator sums the level buffers in an int32 host accumulator
  (numpy) and forwards one int16 pseudo-push (``agg_push {weight,
  members}``) once its group is complete: every registered child present,
  or the ``subtree_expect`` count the pushes stamp. A group idle past the
  flush window (no new member), or one a newer version has superseded,
  forwards what it has;
- the root registers the widened schema and divides by the total leaf
  weight, so its parameters equal a flat root's bit for bit: integer
  addition is associative.

The hop's budget is ``weight x s <= INT16_WIRE_MAX``: a wider group
forwards in chunks of ``max_subtree_weight`` members
(``ops/homomorphic.py``).

``aggkill@A=N``: aggregator A SIGKILLs itself right after its Nth forward
returns, after the root applied it and before any leaf is acknowledged.
The orphaned leaves' retries fail over to a sibling, whose forward carries
members the root already counted; a policy that reports them
(``dup_members``) lets the sibling acknowledge those leaves, subtract their
payloads and forward the rest. The base policy reports none.

An aggregator is a host process (numpy sums, no CUDA); its counters and
gauges (``agg.*``) live in its own ``MetricsRegistry``, served under
``--metrics-port`` (``PS_NET_METRICS ps-agg-<index> <port>``).

    python -m ewdml_tpu_torch.parallel.ps_net --role aggregator \\
        --host 127.0.0.1 --port 29500 --agg-port 29700 --agg-index 0 \\
        --agg-tree 127.0.0.1:29700,127.0.0.1:29701 ...
"""

from __future__ import annotations

import logging
import os
import signal
from typing import Optional

import numpy as np

from ewdml_tpu_torch import native
from ewdml_tpu_torch.obs import clock
from ewdml_tpu_torch.obs import trace as otrace
from ewdml_tpu_torch.obs.registry import MetricsRegistry
from ewdml_tpu_torch.parallel import ps_net
from ewdml_tpu_torch.parallel.faults import FaultSpec
from ewdml_tpu_torch.parallel.ps_net import make_request

logger = logging.getLogger("ewdml_tpu_torch.aggtree")


class _PushSink:
    """The plane's ``push_batch`` on an aggregator, reached only if the
    parking override were bypassed: every push fails on its own."""

    def push_batch(self, records, retried=()):
        return [RuntimeError("aggregator plane must park pushes; "
                             "_dispatch_push_batch override missing")
                for _ in records]


class _Member:
    """One leaf's retained contribution to an open group."""

    __slots__ = ("worker", "push_id", "levels", "loss", "frames")

    def __init__(self, worker: int, push_id: str, levels: np.ndarray,
                 loss: float):
        self.worker = worker
        self.push_id = push_id
        self.levels = levels      # int8, the leaf's packed level buffer
        self.loss = loss
        self.frames: list = []    # parked frames awaiting the ack


class _Group:
    """One (version, plan_version) accumulation window."""

    __slots__ = ("version", "plan_version", "members", "t_last", "expect")

    def __init__(self, version: int, plan_version: int):
        self.version = version
        self.plan_version = plan_version
        self.members: dict = {}
        self.t_last = clock.monotonic()   # the last arrival (idle clock)
        self.expect = 0   # the largest subtree_expect stamped (0: none)


class _AggEvPlane(ps_net._EvLoopPlane):
    """The event-loop plane with parked pushes: a leaf's push joins its
    group and is answered when the group's forward resolves."""

    def _dispatch_push_batch(self, frames) -> None:
        server = self.server
        for f in frames:
            try:
                server._admit_push(f, f.header)
            except Exception:
                # A malformed push costs its connection, never the loop.
                logger.exception("aggtree: bad push frame; dropping "
                                 "connection")
                self._close_conn(f.conn)
        server._flush_ready(self)

    def _service_parked(self) -> None:
        super()._service_parked()
        self.server._flush_aged(self)


class AggregatorServer(ps_net._Endpoint):
    """One ``--role aggregator`` node on the event-loop plane.

    Takes its subtree's leaf ``push`` frames, sums their int8 levels in an
    int32 accumulator without decoding, and forwards one int16 ``agg_push``
    a complete group. One loop thread owns the groups, the upstream
    connection and every socket."""

    def __init__(self, cfg, upstream: tuple, host: str = "127.0.0.1",
                 port: int = 0, index: int = 0,
                 registry: Optional[MetricsRegistry] = None):
        import socket

        from ewdml_tpu_torch.core.config import (parse_agg_tree,
                                                 validate_agg_tree)
        from ewdml_tpu_torch.ops.homomorphic import max_subtree_weight

        validate_agg_tree(cfg)
        addrs = parse_agg_tree(cfg.agg_tree)
        if not addrs:
            raise ValueError("--role aggregator needs --agg-tree")
        if not 0 <= int(index) < len(addrs):
            raise ValueError(
                f"--agg-index {index} out of range for --agg-tree with "
                f"{len(addrs)} aggregator(s)")
        self.cfg = cfg
        self.index = int(index)
        self.role = f"ps-agg-{self.index}"
        self.server = _PushSink()
        super().__init__(registry)
        otrace.configure(cfg.trace_dir, role=self.role)
        otrace.maybe_configure_from_env(role=self.role)
        # The subtree's state, all on the loop thread.
        self._children: set = set()
        self._groups: dict = {}
        self._seq = 0            # the upstream push id sequence
        self._forwards = 0       # upstream round trips completed
        self._pushes_in = 0
        self._dup_members = 0
        self._fwd_weight = 0     # leaf weight forwarded
        self._aged_flushes = 0
        self._bytes_up = 0
        #: Members a forward carries at most: the int16 hop's budget.
        self._max_weight = max_subtree_weight(cfg.quantum_num)
        #: Idle window (s) after which a partial group forwards: keeps a
        #: caller that pushes one leaf at a time live; each arrival
        #: re-arms it.
        self._flush_age_s = max(0.05, min(0.5, cfg.net_timeout_s / 4.0))
        #: Patience for a group short of its stamped ``subtree_expect``,
        #: within the leaves' ack deadline.
        self._expect_patience_s = max(self._flush_age_s,
                                      cfg.net_timeout_s / 4.0)
        #: ``aggkill@A=N`` for this index (None: no clause).
        self._kill_after = FaultSpec.parse(cfg.fault_spec).agg_kill_after(
            self.index)
        reg = self.registry
        self._c_pushes = reg.counter("agg.pushes_in")
        self._c_forwards = reg.counter("agg.forwards")
        self._c_dups = reg.counter("agg.dup_members")
        self._c_bytes_up = reg.counter("agg.bytes_up")
        self._c_aged = reg.counter("agg.aged_flushes")
        self._g_children = reg.gauge("agg.children")
        self._g_parked = reg.gauge("agg.parked")
        self._up = ps_net.RetryingConnection(
            upstream, timeout_s=cfg.net_timeout_s, retries=cfg.net_retries,
            backoff_s=cfg.net_backoff_s, byte_counter=self.bytes,
            jitter_seed=(cfg.seed << 16) ^ 0xA660 ^ self.index)
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((host, port))
        lsock.listen(128)
        lsock.setblocking(False)
        self.address = lsock.getsockname()
        self._evloop = _AggEvPlane(self, lsock)
        self._arm_metrics()

    # -- admission (loop thread) -----------------------------------------------

    def _set_parked(self) -> None:
        self._g_parked.set(sum(len(g.members) for g in self._groups.values()))

    def _admit_push(self, f, header: dict) -> None:
        """Park one leaf push frame (``header`` is its request header) in
        its (version, plan) group; a malformed frame raises (the plane
        closes its connection)."""
        worker = int(header["worker"])
        version = int(header["version"])
        pv = int(header.get("plan_version", 0))
        push_id = str(header.get("push_id", ""))
        loss = float(header["loss"])
        # The leaf's packed payload is the flat int8 level vector of the
        # validated config (decode_arrays checks the frame's CRC).
        levels = native.decode_arrays(bytes(f.sections[0]))[0].view(np.int8)
        self._pushes_in += 1
        self._c_pushes.inc()
        # A pushing leaf is a child: a leaf rehomed from a killed sibling
        # registered with the dead process.
        self._children.add(worker)
        self._g_children.set(len(self._children))
        key = (version, pv)
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _Group(version, pv)
        member = group.members.get(worker)
        if member is not None and member.push_id != push_id:
            # The same worker's next step at the same version: forward the
            # open group first rather than overwrite its payload.
            self._flush_group(self._evloop, key, group)
            group = self._groups[key] = _Group(version, pv)
            member = None
        if member is None:
            member = group.members[worker] = _Member(worker, push_id, levels,
                                                     loss)
        else:
            # A retried frame: one retained payload (the same bytes), and
            # every parked copy acknowledged when the group resolves.
            member.levels, member.loss = levels, loss
        member.frames.append(f)
        group.expect = max(group.expect,
                           int(header.get("subtree_expect", 0)))
        group.t_last = clock.monotonic()
        self._set_parked()

    # -- flushes (loop thread) -------------------------------------------------

    def _flush_ready(self, plane) -> None:
        """Forward every group that is complete (every registered child, or
        the stamped ``subtree_expect``) or superseded by a newer version."""
        if not self._groups:
            return
        newest = max(v for v, _pv in self._groups)
        for key in sorted(self._groups):
            group = self._groups.get(key)
            if group is None:
                continue
            complete = (self._children and
                        set(group.members) >= self._children) or \
                (group.expect > 0 and len(group.members) >= group.expect)
            if complete or group.version < newest:
                self._flush_group(plane, key, group)

    def _flush_aged(self, plane) -> None:
        """The tick's idle flush: a group no member has joined for the
        flush window forwards what it has, the exact sum of fewer
        members."""
        if not self._groups:
            return
        now = clock.monotonic()
        for key in sorted(self._groups):
            group = self._groups.get(key)
            if group is None:
                continue
            window = (self._expect_patience_s
                      if 0 < len(group.members) < group.expect
                      else self._flush_age_s)
            if now - group.t_last >= window:
                self._aged_flushes += 1
                self._c_aged.inc()
                self._flush_group(plane, key, group)

    # -- the forward (loop thread) ---------------------------------------------

    def _flush_group(self, plane, key, group: _Group) -> None:
        self._groups.pop(key, None)
        members = [group.members[w] for w in sorted(group.members)]
        while members:
            chunk, members = (members[:self._max_weight],
                              members[self._max_weight:])
            self._forward_chunk(plane, group, chunk)
        self._set_parked()

    def _forward_chunk(self, plane, group: _Group, chunk: list) -> None:
        """One pseudo-push of at most ``max_subtree_weight`` members. A
        ``dup_members`` verdict removes those members (acknowledged: the
        root holds them) and re-forwards the rest under a fresh push id,
        until the root accepts or nothing is left. Every parked leaf frame
        gets its member's verdict."""
        verdicts: dict = {}
        pending = {m.worker: m for m in chunk}
        while pending:
            live = [pending[w] for w in sorted(pending)]
            acc = np.zeros(live[0].levels.shape, np.int32)
            for m in live:
                acc += m.levels
            # Exact by the budget: weight x s <= INT16_WIRE_MAX.
            wire = native.encode_arrays([acc.astype(np.int16)
                                         .view(np.uint8)])
            push_id = f"agg{self.index}:{group.version}:{self._seq}"
            self._seq += 1
            try:
                header, _ = self._up.call(
                    {"op": "agg_push", "worker": -(1 + self.index),
                     "version": group.version,
                     "loss": float(np.mean([m.loss for m in live])),
                     "plan_version": group.plan_version,
                     "push_id": push_id, "weight": len(live),
                     "members": [m.worker for m in live]}, [wire])
            except (ps_net.StragglerKilled, OSError) as e:
                # The root is unreachable past the retry budget: the leaves
                # get a rejected ack, and the aggregator lives on.
                logger.warning("aggtree[%d]: upstream forward failed (%s)",
                               self.index, e)
                for m in live:
                    verdicts[m.worker] = False
                break
            self._forwards += 1
            self._fwd_weight += len(live)
            self._bytes_up += len(wire)
            self._c_forwards.inc()
            self._c_bytes_up.inc(len(wire))
            if self._kill_after is not None \
                    and self._forwards >= self._kill_after:
                # After the root applied, before any leaf is acknowledged.
                logger.warning("aggtree[%d]: aggkill clause firing after "
                               "forward %d", self.index, self._forwards)
                otrace.flush()
                os.kill(os.getpid(), signal.SIGKILL)
            if header.get("op") != "agg_push_ok":
                logger.warning("aggtree[%d]: upstream refused agg_push (%s)",
                               self.index, header)
                for m in live:
                    verdicts[m.worker] = False
                break
            if bool(header.get("accepted", True)):
                for m in live:
                    verdicts[m.worker] = True
                break
            dups = [int(w) for w in header.get("dup_members", ())]
            if dups:
                self._dup_members += len(dups)
                self._c_dups.inc(len(dups))
                for w in dups:
                    if w in pending:
                        verdicts[w] = True
                        del pending[w]
                continue
            # Rejected outright (quota, staleness): the round went on.
            for m in live:
                verdicts[m.worker] = False
            break
        for m in chunk:
            # Bytes, not the loop's reply scratch: one frame, many sends.
            reply = bytes(self._leaf_push_ok_frame(
                verdicts.get(m.worker, False)))
            for f in m.frames:
                plane._send_reply(f.conn, reply)

    def _leaf_push_ok_frame(self, accepted) -> bytes:
        """The root's own ``push_ok`` frame: a leaf cannot tell the tiers
        apart."""
        return make_request({"op": "push_ok", "accepted": bool(accepted)})

    # -- control ops (loop thread) ---------------------------------------------

    def _dispatch_inner(self, op, header: dict, sections: list):
        if op == "agg_register":
            # Registered children gate the all-present flush; pushes
            # register their leaf too.
            self._children.add(int(header["worker"]))
            self._g_children.set(len(self._children))
            return make_request({"op": "agg_register_ok",
                                 "children": len(self._children)})
        if op == "agg_stats":
            return make_request({
                "op": "agg_stats_ok", "index": self.index,
                "children": len(self._children),
                "pushes_in": self._pushes_in,
                "forwards": self._forwards,
                "forwarded_weight": self._fwd_weight,
                "dup_members": self._dup_members,
                "aged_flushes": self._aged_flushes,
                "parked": sum(len(g.members)
                              for g in self._groups.values()),
                "bytes_up": self._bytes_up,
                "bytes_sent": self.bytes.sent,
                "bytes_received": self.bytes.received})
        if op == "shutdown":
            self._request_stop()
            return make_request({"op": "shutdown_ok"})
        return make_request(
            {"op": "error", "detail": f"unsupported op {op!r} on an "
                                      "aggregator (pulls/control go to "
                                      "the apply server)"})

    def serve_forever(self) -> None:
        logger.info("aggregator %d on %s:%d (upstream %s:%d, flush age "
                    "%.2fs, max weight %d)", self.index, self.address[0],
                    self.address[1], self._up.addr[0], self._up.addr[1],
                    self._flush_age_s, self._max_weight)
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
