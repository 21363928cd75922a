"""Analytic bytes-on-wire plan and the per-step log schema
(``ewdml_tpu/train/metrics.py:26-304``: the single-slice sync trainer and
the async parameter server's rows).

The plan prices the payloads the exchange ships: per transport unit (a
leaf, or a fused bucket under the resolved fusion), the up-link payload
and the down-link (dense weights for M1, dense averaged gradients for
M2/M3, the compressed relay for M4/M5, one compressed payload for a
``ring_rs`` phase 2), amortized over Method 6's sync period; under
``--collective fused_q`` the one ``<fused-q-ring>`` unit holds the exact
ring hop bytes of each phase. Under ``--mode async --server-agg
homomorphic`` the up-link is the shared-scale wire. Under
``--precision-policy bf16_wire*`` the dense gradient bytes are priced at
two bytes an element (the weight down-link and Method 6's adoption stay
f32); under ``--overlap bucket`` the units are the overlap buckets
(``<obucket-b>``), and ``per_bucket_*`` hold each bucket's bytes in
production order. As in the JAX plan,
an async run is priced on the units of the resolved fusion, though the
parameter server ships one payload per leaf: the two agree under
``--fusion none``. Unit names are the JAX package's
(``conv1/kernel``, ``<bucket-3>``), so the two plans compare row by row.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

from ewdml_tpu_torch.core.config import (TrainConfig, resolve_fusion,
                                         resolved_unit_sizes)
from ewdml_tpu_torch.ops import make_compressor
from ewdml_tpu_torch.ops.bytes import numel

logger = logging.getLogger("ewdml_tpu_torch")


@dataclass
class WirePlan:
    """Analytic bytes on the wire per worker per sync step, per direction."""

    per_layer_up: dict
    per_layer_down: dict
    sync_every: int = 1
    adopt_bytes: int = 0   # Method 6 best-worker weight adoption per sync
    dense_bytes: int = 0   # an uncompressed f32 exchange, up + down
    wire_dtype: str = "float32"  # the dense gradient wire's dtype
    transport: str = "gather"  # 'gather' | 'ring_rs' | 'fused_q'
    world: int = 1         # workers on the exchange
    overlap: str = "off"   # the resolved --overlap
    # Per overlap bucket (production order; the whole tree is the one
    # '<monolithic>' bucket with overlap off): up, down and f32 gradient
    # bytes.
    per_bucket_up: dict = field(default_factory=dict)
    per_bucket_down: dict = field(default_factory=dict)
    per_bucket_grad_bytes: dict = field(default_factory=dict)

    @property
    def up_bytes(self) -> int:
        return sum(self.per_layer_up.values())

    @property
    def down_bytes(self) -> int:
        return sum(self.per_layer_down.values())

    @property
    def total_bytes(self) -> int:
        return self.up_bytes + self.down_bytes

    @property
    def per_step_bytes(self) -> float:
        """Average per-iteration gradient cost (Method 6 divides by the
        sync period; adoption excluded, as in the paper's tables)."""
        return self.total_bytes / self.sync_every

    @property
    def per_step_bytes_total(self) -> float:
        """Everything on the wire, Method 6's weight adoption included."""
        return (self.total_bytes + self.adopt_bytes) / self.sync_every

    @property
    def per_rank_exchange_bytes(self) -> float:
        """Bytes that cross the interconnect per rank per step under the
        resolved transport: the rows themselves for a ring (``ring_rs``,
        ``fused_q``: phase 1 up, phase 2 down), W up payloads for the
        gather (each rank gathers all W; the relay is local)."""
        if self.transport in ("ring_rs", "fused_q"):
            return (self.up_bytes + self.down_bytes) / self.sync_every
        return self.world * self.up_bytes / self.sync_every

    @property
    def per_layer_bytes(self) -> dict:
        """Per-unit bytes a step (both directions over the sync period),
        summing to :attr:`per_step_bytes`."""
        names = set(self.per_layer_up) | set(self.per_layer_down)
        return {name: (self.per_layer_up.get(name, 0)
                       + self.per_layer_down.get(name, 0)) / self.sync_every
                for name in sorted(names)}

    @property
    def per_bucket_bytes(self) -> dict:
        """Per-overlap-bucket bytes a step in production order, summing to
        :attr:`per_step_bytes`."""
        return {name: (self.per_bucket_up.get(name, 0)
                       + self.per_bucket_down.get(name, 0)) / self.sync_every
                for name in self.per_bucket_up}

    def predicted_overlap_frac(self, comm_frac):
        """The share of exchange time the bucketed schedule is predicted to
        hide behind the backward (``parallel/overlap.predict_overlap_frac``
        over the per-bucket bytes), for the comm/compute split
        ``comm_frac`` the caller passes (None gives None: no split, no
        prediction). 0.0 for a monolithic exchange."""
        if self.overlap != "bucket" or len(self.per_bucket_up) <= 1:
            return 0.0
        from ewdml_tpu_torch.parallel.overlap import predict_overlap_frac

        names = list(self.per_bucket_up)
        return predict_overlap_frac(
            [self.per_bucket_up[n] + self.per_bucket_down.get(n, 0)
             for n in names],
            [self.per_bucket_grad_bytes.get(n, 0) for n in names],
            comm_frac)


def ring_hop_bytes(n: int, world: int) -> int:
    """Bytes one rank ships in one phase of the fused int8 ring over ``n``
    elements: W - 1 chunk payloads of int8 levels plus one f32 norm per
    4096-element block, padding included."""
    from ewdml_tpu_torch.ops.kernels import BLOCK_ELEMS
    from ewdml_tpu_torch.parallel.collectives import fused_chunk_elems

    m = fused_chunk_elems(n, world, BLOCK_ELEMS)
    return (world - 1) * (m + (m // BLOCK_ELEMS) * 4)


def wire_plan(cfg: TrainConfig, leaves, world: int | None = None) -> WirePlan:
    """Per-unit byte plan for a config. ``leaves`` is a list of
    ``(name, jax_shape)`` in the JAX tree's leaf order
    (``models/convert.leaf_specs``); ``world`` is the number of workers."""
    if cfg.num_slices > 1:
        raise NotImplementedError("wire_plan covers the single-slice "
                                  "exchange")
    comp = make_compressor(cfg.compress_grad, cfg.quantum_num, cfg.topk_ratio,
                           cfg.topk_exact, cfg.qsgd_block)
    leaves = [(name, tuple(shape)) for name, shape in leaves]
    sizes = [numel(shape) for _, shape in leaves]
    overlap_on = cfg.overlap == "bucket" and cfg.mode != "async"
    oplan = None
    if overlap_on:
        from ewdml_tpu_torch.parallel.overlap import plan_buckets
        oplan = plan_buckets([n * 4 for n in sizes], cfg.overlap_buckets)
    fusion = (resolve_fusion(cfg, len(leaves)) if cfg.compression_enabled
              else "none")
    if fusion == "none":
        units = [(name, numel(shape)) for name, shape in leaves]
    else:
        label = ("<obucket-{}>" if overlap_on
                 else "<fused-bucket>" if fusion == "all" else "<bucket-{}>")
        units = [(label.format(j), n)
                 for j, n in enumerate(resolved_unit_sizes(cfg, sizes))]
    policy = cfg.precision
    wire_dtype = "bfloat16" if policy.bf16_wire else "float32"
    transport = "gather"
    if cfg.compression_enabled:
        if cfg.gather_type == "ring_rs":
            transport = "ring_rs"
    elif cfg.collective == "fused_q" and cfg.mode != "async":
        transport = "fused_q"
    w = max(1, int(world) if world else 1)
    up, down = {}, {}
    if transport == "fused_q":
        # One flat ring over the whole tree (one ring per bucket under
        # --overlap bucket): exact hop bytes per phase.
        if overlap_on:
            for b, idxs in enumerate(oplan.buckets):
                hop = ring_hop_bytes(sum(sizes[i] for i in idxs), w)
                up[f"<obucket-{b}>"] = down[f"<obucket-{b}>"] = hop
        else:
            hop = ring_hop_bytes(sum(elems for _, elems in units), w)
            up["<fused-q-ring>"] = down["<fused-q-ring>"] = hop
        units = []
        wire_dtype = "int8"
    # Compressed-domain PS aggregation (--server-agg homomorphic on the
    # async path): the up-link ships the shared-scale wire (unpacked int8
    # levels, no per-push norms), priced by ops/homomorphic.
    hom_up = (cfg.compression_enabled and cfg.mode == "async"
              and cfg.server_agg == "homomorphic")
    for name, elems in units:
        dense_wire = elems * policy.wire_itemsize
        if hom_up:
            from ewdml_tpu_torch.ops.homomorphic import priced_wire_bytes

            up[name] = priced_wire_bytes(comp, elems)
        else:
            up[name] = (comp.wire_bytes((elems,)) if cfg.compression_enabled
                        else dense_wire)
        if cfg.ps_mode == "weights":
            down[name] = elems * 4          # weights broadcast (M1), f32
        elif transport == "ring_rs":
            # Ring phase 2 circulates one compressed payload per unit,
            # relay or not (priced as one full-unit payload, as the JAX
            # plan does).
            down[name] = comp.wire_bytes((elems,))
        elif cfg.relay_compress and cfg.compression_enabled:
            down[name] = comp.wire_bytes((elems,))  # compressed relay (M4/M5)
        elif cfg.compression_enabled:
            down[name] = elems * 4          # dense relay of M2, f32
        else:
            down[name] = dense_wire         # dense down leg (M3)
    n_params = sum(sizes)
    adopt = n_params * 4 + 4 if cfg.sync_every > 1 else 0
    if overlap_on:
        bnames = [f"<obucket-{b}>" for b in range(oplan.n_buckets)]
        pb_grad = dict(zip(bnames, oplan.bucket_bytes))
        if next(iter(up), "").startswith("<obucket-"):
            pb_up, pb_down = dict(up), dict(down)
        else:
            l2b = oplan.leaf_to_bucket()
            pb_up = {n: 0 for n in bnames}
            pb_down = {n: 0 for n in bnames}
            for j, (uname, _) in enumerate(units):
                pb_up[bnames[l2b[j]]] += up.get(uname, 0)
                pb_down[bnames[l2b[j]]] += down.get(uname, 0)
    else:
        pb_up = {"<monolithic>": sum(up.values())}
        pb_down = {"<monolithic>": sum(down.values())}
        pb_grad = {"<monolithic>": n_params * 4}
    return WirePlan(up, down, sync_every=cfg.sync_every, adopt_bytes=adopt,
                    dense_bytes=2 * n_params * 4, wire_dtype=wire_dtype,
                    transport=transport, world=w,
                    overlap="bucket" if overlap_on else "off",
                    per_bucket_up=pb_up, per_bucket_down=pb_down,
                    per_bucket_grad_bytes=pb_grad)


@dataclass
class StepTimer:
    """Wall-clock accounting: compile (here: the first, warm-up window),
    host data time, and step time."""

    compile_s: float = 0.0
    data_s: float = 0.0
    step_s: float = 0.0
    steps: int = 0
    _t0: float = field(default=0.0, repr=False)

    def tic(self):
        self._t0 = time.perf_counter()

    def toc_data(self):
        self.data_s += time.perf_counter() - self._t0

    def add_window(self, elapsed_s: float, n_steps: int):
        self.step_s += max(0.0, elapsed_s)
        self.steps += n_steps

    @property
    def mean_step_s(self) -> float:
        return self.step_s / max(1, self.steps)

    def as_dict(self) -> dict:
        return {
            "compile_s": round(self.compile_s, 4),
            "data_s": round(self.data_s, 4),
            "step_s": round(self.step_s, 4),
            "steps": self.steps,
            "mean_step_ms": round(self.mean_step_s * 1e3, 4),
        }


def log_step(rank: int, step: int, loss: float, step_time: float,
             cum_mb_sent: float, cum_mb_recv: float, top1: float):
    """Reference log schema (``distributed_worker.py:146-155,230-231``)."""
    logger.info(
        "Worker: %d, Step: %d, Loss: %.4f, Time Cost: %.4f, "
        "Bytes sent: %.3f MB, Bytes received: %.3f MB, Prec@1: %.4f",
        rank, step, loss, step_time, cum_mb_sent, cum_mb_recv, top1,
    )


@dataclass
class RetryCounters:
    """A TCP worker's wire robustness counters (``metrics.py:614-634``):
    operations re-sent after a fault and sockets re-established, carried
    per ``parallel/ps_net.RetryingConnection``. Each increment also lands in
    ``registry`` (``net.retries``, ``net.reconnects``) when one is given:
    the endpoint's own, never a process-global one."""

    retries: int = 0
    reconnects: int = 0
    registry: object = None

    def inc_retries(self) -> None:
        self.retries += 1
        if self.registry is not None:
            self.registry.counter("net.retries").inc()

    def inc_reconnects(self) -> None:
        self.reconnects += 1
        if self.registry is not None:
            self.registry.counter("net.reconnects").inc()


def log_robustness(rank: int, retries: int = 0, reconnects: int = 0,
                   excluded=(), kills_sent: int = 0, registry=None):
    """The fault-tolerance log line (``metrics.py:637-650``): a worker
    reports its wire recovery counters, the server (rank -1) its
    exclusions and kill signals, which also set ``registry``'s
    ``ps.kills_sent`` and ``ps.excluded`` gauges when one is given."""
    if registry is not None:
        registry.gauge("ps.kills_sent").set(kills_sent)
        registry.gauge("ps.excluded").set(len(excluded))
    logger.info(
        "Worker: %d, Retries: %d, Reconnects: %d, Excluded: %s, "
        "Kills sent: %d",
        rank, retries, reconnects, sorted(excluded), kills_sent,
    )
