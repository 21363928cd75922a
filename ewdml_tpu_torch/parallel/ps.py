"""Asynchronous parameter server, in process (``ewdml_tpu/parallel/ps.py``).

A server owns the canonical parameters and applies updates with an
explicit-gradient optimizer; W worker threads each pull the parameters,
compute gradients on their device, compress them and push the compact
payload. The decisions of the reference's section 5.3 live in the shared
:class:`~ewdml_tpu_torch.parallel.policy.StragglerPolicy`: K-of-N acceptance
(``num_aggregate``), the staleness drop (``max_staleness``) and the
straggler kill (``kill_threshold``).

Every message crosses the host boundary as ONE contiguous buffer in the JAX
package's byte layout (``utils/transfer.py``): a pull is the packed
parameters, a push is the packed payloads inside the native checksummed
frame (``native.encode_arrays``), so byte accounting is the real bytes.

``server_agg='homomorphic'`` negotiates a shared scale contract against the
warm gradient (``ops/homomorphic.py``); the server then sums the K pushes'
int8 levels in an int32 accumulator and dequantizes once per round
(``ops/kernels.int_accumulate`` per leaf, then one ``acc_decode_set``
launch for every leaf, on the card), where
``'decode'`` decodes every payload to f32 first.

Parameters and gradients are lists in the JAX tree's leaf order and Flax
layout (``models/convert.leaf_specs``); each worker keeps its own copy of
the model, whose BatchNorm statistics are its own, as in the JAX package.
The server applies on its own CUDA stream and synchronizes it before it
reads the clock, so ``apply_s_sum`` is the apply's device time plus its
host dispatch, not the work the workers queue on the default stream.

The precision policy (``core/precision.py``): under ``bf16_wire*`` the
dense push frames carry bf16 (``wire_cast``) and the server's mean stays
f32; the server's optimizer state is stored at the policy's state dtype,
its bf16 stores rounding under ``fold_in(key(seed ^ 0x0917), version)``.

The down-link (``ewdml_tpu/parallel/ps.py:405-446``): ``down_mode='weights'``
ships the packed parameters on every pull; ``'delta'`` publishes, per
update, the compressed difference between the new parameters and a
server-side shadow, ``d_k = compress(params_k - shadow_{k-1})`` keyed
``fold_in(key(seed ^ 0x5EED), k)``, and advances the shadow by
``decompress(d_k)`` (error feedback on the server), so a worker that
replays ``d_{v+1}..d_k`` on its copy lands on ``shadow_k``. A worker more
than ``down_window`` versions behind gets the shadow dense. Under
``bootstrap='bf16'`` a worker's first pull (version -1) ships the shadow
in bf16, half the bytes. ``relay_compress`` is the paper's negative
result on this path: every pulled version goes through compress then
decompress on the server, and the bytes counted are the compressor's.

``health`` (``obs/health.py``) observes the loss of every push the server
keeps; after an abort verdict the workers stop.

What the TCP tier (``parallel/ps_net.py``) adds to the server
(``ewdml_tpu/parallel/ps.py:713-833,1305-1593,1696-1757``): a retried
contact is not judged by the policy; a push carries an idempotency id
(``push_id``), and a push whose id was applied or is pending is
acknowledged and not applied again; :meth:`ParameterServer.push_batch`
admits an event-loop tick's pushes, bit-identical to sequential pushes;
the durable state plane (``arm_durability``: a WAL record per apply and a
snapshot every ``snapshot_every`` versions, ``parallel/server_state.py``)
and :meth:`~ParameterServer.recover`, which replays the WAL through the
same apply, so the recovered state is bit-equal; ``serverkill@N``; and the
elastic ``join`` (``--num-aggregate 0`` recomputes K from the live
workers). The snapshot blob is the JAX package's flax ``to_bytes`` of
``{"params", "opt_state", "shadow"}`` in Flax paths (``utils/msgpack.py``),
so a directory written by either package recovers in the other.

The read replicas' publication stream (``ewdml_tpu/parallel/ps.py:64-90,
1594-1694``; the ``subscribe`` op, ``parallel/replica.py``): armed by the
first subscriber, each committed apply then publishes its packed f32
parameters as a keyframe, or under ``pull_delta`` as int8 levels on
blockwise shared scales (:data:`PD_BLOCK`, :data:`PD_S`) of the difference
to a publication shadow, keyed ``fold_in(key(seed ^ 0x9D17), version)``,
with a keyframe every ``keyframe_every`` versions. Server and replica
replay a delta through the same numpy expression (:func:`pd_apply_delta`).

The aggregation tree's root (``ps.py:537-700,835-900``): an aggregator's
pseudo-push (:meth:`ParameterServer.push_subtree`) carries the int16 sum
of ``weight`` leaves' levels and their ``members``; readiness counts
weight, not records, and the apply divides by the batch's total weight
(one apply per distinct weight and stack height, cached). A short batch is
padded with zero levels, a fragmented round stacks higher.

The federated rounds (``federated/``) drive this server through a
``parallel/policy.CohortPolicy``: its ``admit_push`` refusals count in
``PSStats.fed_rejected`` and its ``note_applied`` closes a round.

Adaptive compression (``ps.py:287-310,1149-1297,1892-1946,2035-2058``):
with ``adapt`` (an ``adapt.AdaptRuntime``) the server owns the controller.
The apply also returns the per-leaf moments of the applied mean gradient;
at every decision boundary of the version counter a switched plan
re-registers the push schema (:meth:`ParameterServer._apply_adapt_plan`)
and bumps ``plan_version``. A push encoded under an older plan is dropped
(``dropped_plan_stale``), as is a batch released just before a switch; a
worker follows the plan version of the server (:class:`AsyncWorker`).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import logging
import os
import signal
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch

from ewdml_tpu_torch import native
from ewdml_tpu_torch.core.precision import resolve_policy, wire_cast
from ewdml_tpu_torch.models.convert import from_jax, leaf_specs, to_jax
from ewdml_tpu_torch.obs import clock, reqctx
from ewdml_tpu_torch.obs import trace as otrace
from ewdml_tpu_torch.obs.health import HealthAbort
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.optim import AdamState, update_accepts_key
from ewdml_tpu_torch.parallel.faults import FaultCrash, FaultSpec
from ewdml_tpu_torch.parallel.policy import StragglerKilled, StragglerPolicy
from ewdml_tpu_torch.train.state import _flat, _nested, leaf_params
from ewdml_tpu_torch.utils import msgpack, prng, transfer

logger = logging.getLogger("ewdml_tpu_torch.ps")

def _indexed(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


#: The publication stream's quantizer grid: int8 levels on per-block shared
#: scales of the packed parameter difference. Fixed, and pinned by
#: :func:`pd_contract_crc` on both endpoints.
PD_BLOCK = 4096
PD_S = 127


def pd_apply_delta(flat: np.ndarray, levels: np.ndarray,
                   scales: np.ndarray) -> np.ndarray:
    """Replay one published delta onto the f32 publication state: the one
    numpy expression the server's shadow and every replica's copy advance
    through, so the two cannot drift. ``levels`` int8 [n], ``scales`` f32
    [ceil(n / PD_BLOCK)]."""
    step = np.repeat(scales, PD_BLOCK)[: flat.shape[0]]
    return flat + step * levels.astype(np.float32)


def pd_contract_crc(flat_bytes: int, block: int, s: int, every: int) -> int:
    """The stream's structural pin (packed f32 bytes, quantizer grid,
    keyframe cadence), which both endpoints derive from the ``subscribe_ok``
    header."""
    return zlib.crc32(
        np.asarray([flat_bytes, block, s, every], np.int64).tobytes())


def pd_quantize(diff: torch.Tensor, key) -> tuple:
    """``(levels int8 [n], scales f32 [nb])`` of a packed parameter
    difference on the :data:`PD_BLOCK` grid (``ps.py:1614-1619``): the
    shared-scale encode, its draw ``jax.random.uniform``'s threefry stream
    for ``key``."""
    from ewdml_tpu_torch.ops import qsgd

    scales = qsgd.shared_scales(diff, PD_S, block=PD_BLOCK)
    levels = qsgd.shared_levels(
        key, diff, qsgd.expand_scales(scales, PD_BLOCK, diff.numel()), PD_S)
    return levels, scales


@dataclasses.dataclass
class PushRecord:
    """One gradient push. ``message`` is the wire frame holding the packed
    payload buffer."""

    worker: int
    version: int          # server version the worker pulled before computing
    message: bytes
    loss: float
    # The idempotency key ("worker:step" from the TCP worker), stable
    # across wire retries and server restarts; "" = no dedupe.
    push_id: str = ""
    # The adaptive plan the payload was encoded under; one superseded by a
    # switch is dropped (``dropped_plan_stale``).
    plan_version: int = 0
    # The federated round a push was computed for (-1: unstamped; the
    # round pipeline routes by it).
    round_id: int = -1
    # The leaf contributions this payload sums (1: an ordinary push; an
    # aggregator's pseudo-push carries its subtree's), and their leaf ids.
    weight: int = 1
    members: tuple = ()

    @property
    def wire_bytes(self) -> int:
        return len(self.message)


class SubtreeRejected(RuntimeError):
    """A pseudo-push refused at member granularity: ``dup_members`` names
    the members the round already holds, which the aggregator acknowledges,
    subtracts and re-forwards without."""

    def __init__(self, reason: str, dup_members: tuple = ()):
        super().__init__(reason)
        self.reason = reason
        self.dup_members = tuple(int(m) for m in dup_members)


@dataclasses.dataclass
class PSStats:
    pushes: int = 0
    updates: int = 0
    dropped_stale: int = 0
    dropped_plan_stale: int = 0
    dropped_straggler: int = 0
    worker_crashes: int = 0
    kills_sent: int = 0
    bytes_up: int = 0
    bytes_down: int = 0
    staleness_sum: int = 0
    # Compressed-domain aggregation: payload decode passes (decode mode pays
    # K per round, homomorphic exactly 1), apply rounds, and the summed
    # device-synced wall of the apply.
    decode_count: int = 0
    apply_rounds: int = 0
    apply_s_sum: float = 0.0
    # Of the port only: the delta down-link's step per update (encode,
    # shadow update and the packed D2H), outside apply_s_sum as in JAX;
    # the pulls answered per mode, and the deltas they shipped.
    delta_s_sum: float = 0.0
    deltas_down: int = 0
    fed_rejected: int = 0
    agg_pushes: int = 0
    agg_weight: int = 0
    agg_dup_members: int = 0
    dropped_round_stale: int = 0
    async_downweighted: int = 0
    async_ticks: int = 0
    dup_pushes: int = 0
    wal_records: int = 0
    snapshots: int = 0
    joins: int = 0
    excluded_workers: dict = dataclasses.field(default_factory=dict)
    pulls_by_mode: dict = dataclasses.field(default_factory=dict)
    staleness_hist: dict = dataclasses.field(default_factory=dict)
    loss_history: list = dataclasses.field(default_factory=list)

    LOSS_HISTORY_MAX = 4096

    def record_loss(self, version: int, loss: float) -> None:
        self.loss_history.append((version, loss))
        if len(self.loss_history) > self.LOSS_HISTORY_MAX:
            del self.loss_history[:-self.LOSS_HISTORY_MAX]

    @property
    def mean_staleness(self) -> float:
        return self.staleness_sum / max(1, self.pushes)

    def loss_tail_mean(self, k: int = 10) -> float:
        tail = [l for _, l in self.loss_history[-k:]]
        return float(np.mean(tail)) if tail else float("nan")

    @property
    def apply_ms_mean(self) -> float:
        """Mean per-round apply wall (ms)."""
        return (self.apply_s_sum / self.apply_rounds * 1e3
                if self.apply_rounds else 0.0)

    @property
    def delta_ms_mean(self) -> float:
        """Mean delta step per update (ms; 0 in weights mode)."""
        return (self.delta_s_sum / self.updates * 1e3
                if self.updates else 0.0)


def _clone_state(state):
    """A copy of an optimizer state dataclass whose tensors (and lists of
    tensors) are cloned, so an apply never writes the state it read."""
    kw = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            v = v.clone()
        elif isinstance(v, list):
            v = [x.clone() if isinstance(x, torch.Tensor) else x for x in v]
        kw[f.name] = v
    return type(state)(**kw)


class ParameterServer:
    """Host-side server: device-resident state + update policies."""

    def __init__(self, params, optimizer, compressor=None,
                 num_aggregate: int = 1, max_staleness: Optional[int] = None,
                 relay_compress: bool = False, device=None,
                 down_mode: str = "weights", down_window: int = 16,
                 bootstrap: str = "f32",
                 kill_threshold: Optional[float] = None,
                 precision: str = "f32", adapt=None,
                 server_agg: str = "decode", health=None, seed: int = 0,
                 policy: Optional[StragglerPolicy] = None,
                 leaf_names: Optional[list] = None,
                 elastic_k: bool = False,
                 kill_at_apply: Optional[int] = None,
                 pull_delta: bool = False, keyframe_every: int = 64):
        # The run-health watchdog (None: --health off).
        self.health = health
        if server_agg not in ("decode", "homomorphic"):
            raise ValueError(f"server_agg must be 'decode' or 'homomorphic',"
                             f" got {server_agg!r}")
        self.server_agg = server_agg
        if server_agg == "homomorphic":
            from ewdml_tpu_torch.ops.homomorphic import HomomorphicCompressor

            if down_mode == "delta":
                raise ValueError(
                    "--server-agg homomorphic requires --ps-down weights "
                    "(the delta stream's per-push norms are a different "
                    "scale domain than the negotiated contract)")
            if relay_compress:
                raise ValueError("--server-agg homomorphic is incompatible "
                                 "with the lossy weights-down relay")
            if adapt is None and not isinstance(compressor,
                                               HomomorphicCompressor):
                raise ValueError(
                    "--server-agg homomorphic needs the shared-scale "
                    "contract: wrap the compressor with "
                    "ops.homomorphic.make_homomorphic(comp, grads_template)"
                    " (run_async_ps does)")
        # Adaptive compression: the server owns the controller and the
        # plan; workers follow plan_version.
        self.adapt = adapt
        self.plan_version = 0
        if adapt is not None:
            if down_mode == "delta":
                raise ValueError("--adapt requires --ps-down weights "
                                 "(a plan switch would desynchronize the "
                                 "compressed delta stream)")
            if relay_compress:
                raise ValueError("--adapt is incompatible with the lossy "
                                 "weights-down relay")
            compressor = adapt.compressor()
            if server_agg == "homomorphic":
                from ewdml_tpu_torch.ops.homomorphic import \
                    HomomorphicCompressor

                if not isinstance(compressor, HomomorphicCompressor):
                    raise ValueError(
                        "--server-agg homomorphic with --adapt needs the "
                        "scale contract armed: call "
                        "AdaptRuntime.set_scale_base(grads_template) "
                        "before constructing the server")
        self.device = _indexed(device if device is not None
                               else params[0].device)
        self.params = [p.detach().to(self.device, torch.float32, copy=True)
                       for p in params]
        self.optimizer = optimizer
        self.opt_state = optimizer.init(self.params)
        # The dense push wire's dtype (the registered template must match:
        # run_async_ps casts it as the workers cast their frames) and the
        # seed of the bf16 optimizer-state stores
        # (``ewdml_tpu/parallel/ps.py:337-343``).
        self.precision = resolve_policy(precision)
        self._opt_key = prng.key(seed ^ 0x0917)
        self.compressor = compressor
        # A caller's policy wins: the TCP server shares its one instance.
        self.policy = policy if policy is not None else StragglerPolicy(
            kill_threshold=kill_threshold, max_staleness=max_staleness,
            num_aggregate=num_aggregate)
        # The parameters' Flax paths (``LeafSpec.name``): the snapshot
        # blob's keys. Needed only by the durable state plane.
        self.leaf_names = list(leaf_names) if leaf_names is not None else None
        # The lossy weights-down relay (the paper's negative result,
        # Final Report p.5) and the wire of a first pull ("f32" | "bf16").
        self.relay_compress = relay_compress and compressor is not None
        self.bootstrap = bootstrap if bootstrap in ("f32", "bf16") else "f32"
        self._relay_key = prng.key(seed ^ 0x5EED)
        self.version = 0
        self.stats = PSStats()
        # Canonical order: _update_lock before _lock, never the reverse.
        # TimedLocks: a blocked acquire inside a ps_net request counts as
        # that request's queue segment (obs/reqctx.py).
        self._lock = reqctx.TimedLock()         # params/version/stats
        self._update_lock = reqctx.TimedLock()  # serializes applies
        self._pending: list = []  # ewdml: guarded-by[_lock]
        # Per pending buffer: its pusher, its push id, its leaf weight and
        # its members (an ordinary push: 1 and ()).
        self._pending_workers: list = []  # ewdml: guarded-by[_lock]
        self._pending_ids: list = []  # ewdml: guarded-by[_lock]
        self._pending_weights: list = []  # ewdml: guarded-by[_lock]
        self._pending_members: list = []  # ewdml: guarded-by[_lock]
        # The round pipeline (arm_round_pipeline): "off", "overlap" (one
        # pending grid per open round: round -> (bufs, workers, ids,
        # weights)) or "async" (tick copies in the shared batch).
        self._rp_mode = "off"
        self._rp_pending: dict = {}  # ewdml: guarded-by[_lock]
        # Push ids applied (id -> version, insertion-ordered, bounded):
        # with the pending ids they make a re-sent push an ack, not a
        # second apply. Rebuilt from the snapshot and the WAL on recovery.
        self._applied_ids: dict = {}  # ewdml: guarded-by[_lock]
        # The durable state plane (arm_durability; None: no journal I/O),
        # the serverkill@N fault, and elastic K (--num-aggregate 0 on the
        # TCP server; the payload template is kept for its rebuild).
        self._state_store = None
        self._snapshot_every = 0
        # More snapshot metadata (the TCP server hangs the federated
        # coordinator's state here), called on the apply path.
        self._snapshot_extra = None
        self._kill_at_apply = kill_at_apply
        self._elastic_k = elastic_k
        self._payload_template = None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._pack = transfer.make_device_packer()
        # One packed pull per wire and version (one D2H each).
        self._packed_cache = {"f32": (None, -1), "bf16": (None, -1)}  # ewdml: guarded-by[_lock]
        if self.relay_compress:
            self._down_bytes = sum(compressor.wire_bytes(tuple(p.shape))
                                   for p in self.params)
            self._down_bytes_boot = self._down_bytes
        else:
            self._down_bytes = sum(p.numel() * p.element_size()
                                   for p in self.params)
            self._down_bytes_boot = sum(
                p.numel() * (2 if self.bootstrap == "bf16"
                             and p.dtype == torch.float32
                             else p.element_size())
                for p in self.params)
        self._apply_fn = None
        self._schema_k = None
        self._agg_mode = False
        self.down_mode = down_mode if compressor is not None else "weights"
        if self.bootstrap == "bf16" and self.down_mode != "delta":
            # In weights mode every pull is a first pull's wire, so the
            # cast would re-round every version: the negative result.
            raise ValueError(
                "--ps-bootstrap bf16 requires the delta down-link "
                "(--ps-down delta with a compressor): in weights mode the "
                "cast would re-round every pull, reproducing the lossy-"
                "weights negative result instead of a one-time bootstrap "
                "rounding")
        if (self.down_mode == "delta"
                and getattr(compressor, "block", None) is None):
            logger.warning(
                "--ps-down delta with a per-tensor-norm compressor is "
                "unstable on tensors larger than ~4s^2 elements; pass "
                "--qsgd-block 4096 (blockwise norms) for a bounded-error "
                "delta stream")
        self.down_window = down_window
        self._deltas: dict = {}   # version -> packed d_k (numpy uint8)
        self._shadow = self.params
        self._delta_fn = None
        self.payload_unpack = None
        # The publication stream, armed by the first subscriber (zero cost
        # before). Without pull_delta every version is a keyframe. The
        # shadow (numpy f32) moves only under _update_lock.
        self._pd_every = max(1, int(keyframe_every)) if pull_delta else 1
        self._pd_on = False
        self._pd_key = prng.key(seed ^ 0x9D17)
        self._pd_shadow = None
        self._pd_nbytes = 0
        self._pd_crc = 0
        self._pd_head = -1                      # ewdml: guarded-by[_lock]
        self._pd_keyframe: tuple = (-1, None)   # ewdml: guarded-by[_lock]
        self._pd_deltas: dict = {}              # ewdml: guarded-by[_lock]

    @property
    def num_aggregate(self) -> int:
        return self.policy.num_aggregate

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    def register_payload_schema(self, payload_template, *,
                                schema_k: Optional[int] = None,
                                agg_weight: Optional[int] = None) -> None:
        """Fix the push schema (payload structure and leaf specs) and build
        the apply over K stacked buffers: unpack, then the homomorphic mean
        or decode-then-mean, then the optimizer update. The apply is run
        once on zeroed buffers (its result discarded) before any worker is
        timed, as the JAX server warms its compiled apply. Re-entrant: an
        elastic K rebuilds the apply for the new K.

        An aggregation tree's root registers the widened int16 template
        with ``schema_k`` = the aggregators (its stacked slots) and
        ``agg_weight`` = the leaf weight a round expects, which arms the
        weighted mode: the divisor is the batch's total weight
        (:meth:`_apply_for`)."""
        self._payload_template = payload_template
        unpack = self.payload_unpack = transfer.make_device_unpacker(
            payload_template)
        comp = self.compressor
        k = self._schema_k = (self.policy.num_aggregate if schema_k is None
                              else max(1, int(schema_k)))
        self._agg_mode = agg_weight is not None
        optimizer = self.optimizer
        homomorphic = self.server_agg == "homomorphic"
        takes_key = update_accepts_key(optimizer)
        want_moments = self.adapt is not None

        def make_apply(divisor: Optional[int], height: int):
            # divisor None: the flat mean over the K stacked payloads; an
            # int: the weighted divisor of a tree's batch of ``height``.
            def apply_bufs(params, opt_state, bufs, okey):  # uint8 [K, n]
                trees = [unpack(bufs[i]) for i in range(height)]
                if homomorphic:
                    from ewdml_tpu_torch.ops.homomorphic import \
                        homomorphic_mean

                    grads = homomorphic_mean(comp, trees, k=divisor)
                else:
                    if comp is not None:
                        trees = [decompress_tree(comp, t) for t in trees]
                    # f32 accumulation whatever the wire dtype: bf16 push
                    # frames upcast before the mean.
                    kk = kernels.f32_scalar(float(height))
                    grads = [torch.stack(xs).to(torch.float32).sum(dim=0)
                             / kk for xs in zip(*trees)]
                new_params = [p.clone() for p in params]
                new_opt = _clone_state(opt_state)
                if takes_key:
                    optimizer.update(grads, new_opt, new_params, key=okey)
                else:
                    optimizer.update(grads, new_opt, new_params)
                if not want_moments:
                    return new_params, new_opt, None
                # The controller's sample: per leaf (mean, mean of squares)
                # of the applied mean gradient.
                mom = torch.stack([torch.stack([g.mean(), g.square().mean()])
                                   for g in grads])
                return new_params, new_opt, mom

            return apply_bufs

        self._make_apply = make_apply
        self._agg_apply_cache: dict = {}
        self._apply_fn = (self._apply_for(int(agg_weight)) if self._agg_mode
                          else make_apply(None, k))
        if self.down_mode == "delta":
            self._delta_fn = functools.partial(delta_step, comp,
                                               transfer.make_device_packer())
        nbytes = sum(s.nbytes for s in transfer.specs_of(payload_template))
        with self._on_stream(), torch.no_grad():
            bufs0 = torch.zeros((k, nbytes), dtype=torch.uint8,
                                device=self.device)
            self._apply_fn(self.params, self.opt_state, bufs0,
                           prng.fold_in(self._opt_key, 0))
            if self._delta_fn is not None:  # warmed too, result discarded
                self._delta_fn(self.params, self._shadow,
                               prng.fold_in(self._relay_key, 0))
        self._sync()

    def _apply_for(self, wsum: int, height: Optional[int] = None):
        """The apply whose divisor is ``wsum`` leaves over a stack of
        ``height`` (default: the registered K). Flat mode has one apply;
        the weighted mode keeps one per distinct (weight, height), as the
        JAX server keeps a trace per pair."""
        if not self._agg_mode:
            return self._apply_fn
        wsum = max(1, int(wsum))
        kk = self._schema_k if height is None else max(1, int(height))
        fn = self._agg_apply_cache.get((wsum, kk))
        if fn is None:
            fn = self._agg_apply_cache[(wsum, kk)] = self._make_apply(wsum,
                                                                      kk)
        return fn

    def _check_worker(self, worker, retried: bool = False) -> None:
        """Shared-policy liveness check on a worker contact; raises
        :class:`StragglerKilled` for an excluded worker. ``retried`` marks
        a wire re-send, whose gap is not judged."""
        reason = self.policy.observe(worker, retried=retried)
        if reason is not None:
            with self._lock:
                self.stats.kills_sent = self.policy.kills_sent
                self.stats.excluded_workers = self.policy.excluded()
                self.stats.dropped_straggler = len(
                    self.stats.excluded_workers)
            raise StragglerKilled(worker, reason)

    # -- worker-facing API (the wire) ------------------------------------
    def pull(self, worker_version: int = -1, worker: Optional[int] = None,
             retried: bool = False):
        """Down link: ``(mode, payload, version, nbytes)``. ``mode`` is
        ``"weights"`` (the packed parameters, a uint8 numpy buffer),
        ``"weights_bf16"`` (the same in bf16: only a delta-mode first pull,
        ``worker_version`` -1, under ``bootstrap='bf16'``; a worker that
        fell behind the window gets f32) or ``"delta"`` (the list of packed
        deltas after ``worker_version``). An excluded worker's pull raises
        :class:`StragglerKilled`; ``retried`` flags a wire re-send. Traced
        as ``ps/pull``."""
        with otrace.span("ps/pull", worker=worker):
            return self._pull(worker_version, worker, retried)

    def _pull(self, worker_version: int = -1, worker: Optional[int] = None,
              retried: bool = False):
        if worker is not None:
            self._check_worker(worker, retried=retried)
        with self._lock:
            # The shadow advances with the version, under this lock.
            params, shadow, version = self.params, self._shadow, self.version
        delta = self.down_mode == "delta"
        if delta and 0 <= worker_version <= version:
            with self._lock:
                bufs = [self._deltas.get(v)
                        for v in range(worker_version + 1, version + 1)]
            if all(b is not None for b in bufs):
                nbytes = sum(b.nbytes for b in bufs)
                self._count_pull("delta", nbytes, len(bufs))
                return "delta", bufs, version, nbytes
            # The gap exceeds the window: a dense pull of the shadow, which
            # later deltas move (the parameters would leave the residual).
        src = shadow if delta else params
        boot = self.bootstrap == "bf16" and worker_version < 0
        wire = "bf16" if boot else "f32"
        nbytes = self._down_bytes_boot if boot else self._down_bytes
        with self._lock:
            cached, cached_version = self._packed_cache[wire]
        if cached_version != version:
            with self._on_stream(), torch.no_grad():
                cached = self._pull_pack(src, version, boot).cpu().numpy()
            with self._lock:
                # A racing pull may have cached a newer version; keep it.
                if version > self._packed_cache[wire][1]:
                    self._packed_cache[wire] = (cached, version)
        mode = "weights_bf16" if boot else "weights"
        self._count_pull(mode, nbytes)
        return mode, cached, version, nbytes

    def _count_pull(self, mode: str, nbytes: int, deltas: int = 0) -> None:
        with self._lock:
            self.stats.bytes_down += nbytes
            self.stats.deltas_down += deltas
            self.stats.pulls_by_mode[mode] = (
                self.stats.pulls_by_mode.get(mode, 0) + 1)

    def _pull_pack(self, src: list, version: int, bf16: bool):
        """The packed pull of ``src``: through compress then decompress
        under the relay (keyed ``layer_key(fold_in(relay key, version),
        i)``), in bf16 for a bootstrap."""
        if self.relay_compress:
            comp = self.compressor
            key = prng.fold_in(self._relay_key, version)
            src = [comp.decompress(comp.compress(prng.layer_key(key, i), p))
                   for i, p in enumerate(src)]
        return self._pack(_bf16_wire(src) if bf16 else src)

    def push(self, record: PushRecord, retried: bool = False) -> bool:
        """Gradients-up link. Returns False if the push was dropped as
        stale; raises :class:`StragglerKilled` for an excluded pusher.
        ``retried`` flags a wire re-send (its gap is not judged). A push
        whose ``push_id`` was applied or is pending is acknowledged (True)
        and not applied again. The push that completes a K-of-N batch runs
        the apply in its thread. Traced as ``ps/push``, the apply within it
        as ``ps/apply``."""
        with otrace.span("ps/push", worker=record.worker):
            return self._push(record, retried)

    def push_batch(self, records: list, retried: Optional[list] = None
                   ) -> list:
        """Admit one event-loop tick's pushes: the exact sequence of
        :meth:`push` calls in arrival order, so the state, the versions and
        the per-push verdicts equal sequential pushes bit for bit. One
        outcome per record: True/False, or the exception the record raised
        (a :class:`StragglerKilled`, a corrupt payload's ``ValueError``),
        which never stops the rest of the tick."""
        outcomes: list = []
        for i, record in enumerate(records):
            re = bool(retried[i]) if retried is not None else False
            try:
                outcomes.append(self.push(record, retried=re))
            except Exception as err:  # noqa: BLE001 -- per-record isolation
                outcomes.append(err)
        return outcomes

    def push_subtree(self, record: PushRecord,
                     retried: bool = False) -> tuple:
        """An aggregator's pseudo-push (``ps.py:835-856``): the :meth:`push`
        sequence with member-granularity verdicts, ``(accepted,
        dup_members)``; ``(False, dups)`` names the members the round
        already holds. :class:`StragglerKilled` propagates."""
        with otrace.span("ps/agg_push", worker=record.worker,
                         weight=record.weight):
            try:
                ok = self._push(record, retried=retried)
            except SubtreeRejected as rej:
                with self._lock:
                    self.stats.agg_dup_members += len(rej.dup_members)
                return False, rej.dup_members
            return ok, ()

    def _retract(self, record: PushRecord) -> None:
        """Release a dropped record's policy slot (its members' for a
        pseudo-push)."""
        if record.members:
            self.policy.retract_subtree(record.members)
        else:
            self.policy.retract_push(record.worker, record.round_id)

    def arm_round_pipeline(self, mode: str) -> None:
        """Arm round routing (``ps.py:865-878``): ``overlap`` keeps one
        pending grid per open round, each paying one decode on its own
        commit; ``async`` pends a staleness-weighted delta as tick copies
        in the shared batch. Call before any stamped push; the caller
        installs the matching policy."""
        if mode not in ("off", "overlap", "async"):
            raise ValueError(f"round pipeline mode must be "
                             f"off|overlap|async, got {mode!r}")
        with self._lock:
            self._rp_mode = mode
            self._rp_pending = {}

    # ewdml: requires[_lock] -- the batch is taken and cleared in the
    # same critical section that released it; guarded-by-flow verifies it.
    def _take_pending(self) -> tuple:
        """The pending batch, cleared (under ``_lock``, held by the
        caller): ``(bufs, workers, ids, weights, members, plan_version)``."""
        taken = (self._pending, self._pending_workers, self._pending_ids,
                 self._pending_weights, self._pending_members,
                 self.plan_version)
        self._pending, self._pending_workers, self._pending_ids = [], [], []
        self._pending_weights, self._pending_members = [], []
        return taken

    def flush_pending(self) -> bool:
        """Apply the pending batch short of its quota (a final drain;
        ``ps.py:880-900``). Needs the weighted mode: the flat apply takes
        exactly K stacked payloads. False when nothing pends."""
        with self._lock:
            if not self._pending:
                return False
            if not self._agg_mode and len(self._pending) != self._schema_k:
                raise RuntimeError(
                    "flush_pending needs the weighted (agg-mode) apply "
                    "for a partial batch; the flat apply is compiled for "
                    f"K={self._schema_k} slots")
            taken = self._take_pending()
        return self._apply_batch(*taken)

    def _push(self, record: PushRecord, retried: bool = False) -> bool:
        if self._apply_fn is None:
            raise RuntimeError("register_payload_schema first")
        self._check_worker(record.worker, retried=retried)
        # Idempotent replay: checked before the decode (no CRC work for an
        # ack) and before admission.
        if record.push_id:
            with self._lock:
                if (record.push_id in self._applied_ids
                        or record.push_id in self._pending_ids):
                    self.stats.dup_pushes += 1
                    return True
        # The round-stale precheck: a push for a round that committed
        # (overlap) or left the window (async) never applies. After the
        # dedupe (a retried push whose first copy applied is an ack),
        # before the decode and before admission (no cohort slot).
        rid = int(record.round_id)
        if (self._rp_mode != "off" and rid >= 0
                and self.policy.round_stale(rid)):
            with self._lock:
                self.stats.dropped_round_stale += 1
            logger.debug("push from worker %d rejected: round %d stale",
                         record.worker, rid)
            return False
        # The async tick weight, read outside the server lock (the policy
        # has its own).
        ticks = (self.policy.push_weight(rid)
                 if self._rp_mode == "async" and rid >= 0 else 1)
        wscale = getattr(self.policy, "weight_scale", 1)
        # Decode (CRC verify + copy) outside the lock.
        buf = native.decode_arrays(record.message)[0]
        if record.members:
            # A pseudo-push is admitted or refused whole: its levels are
            # one pre-summed buffer.
            reason, dups = self.policy.admit_subtree(record.members)
            if reason is not None:
                with self._lock:
                    self.stats.fed_rejected += 1
                raise SubtreeRejected(reason, dups)
        elif self.policy.admit_push(record.worker,
                                    round_id=rid) is not None:
            # The cohort policy's refusal (not a cohort member, a duplicate,
            # past the accept quota); never under the base policy.
            with self._lock:
                self.stats.fed_rejected += 1
            return False
        health = self.health
        if health is not None:
            if health.aborted is not None:
                self._retract(record)
                return False  # unobserved: the run's verdict is the first
            if not (self.policy.stale(self.version - record.version)
                    or (self.adapt is not None
                        and record.plan_version != self.plan_version)):
                # Outside the lock (an event is an fsync'd write), and not
                # for a push about to be dropped as stale: its loss was
                # computed on long-gone weights. An abort raises here,
                # before any state changes, or (the TCP server's
                # on_abort) sets the verdict checked just after.
                health.observe_loss(self.version, record.loss)
                if health.aborted is not None:
                    self._retract(record)
                    return False
        with self._lock:
            if health is not None and health.aborted is not None:
                # The verdict came from another thread after the checks
                # above: checked again under the lock that counts, so no
                # push is counted once the verdict is set.
                self._retract(record)
                return False
            self.stats.pushes += 1
            self.stats.bytes_up += record.wire_bytes
            if (self.adapt is not None
                    and record.plan_version != self.plan_version):
                # Encoded under a superseded plan: its layout is not the
                # registered schema's. The worker learns the plan on its
                # next pull.
                self.stats.dropped_plan_stale += 1
                self._retract(record)
                return False
            staleness = self.version - record.version
            self.stats.staleness_sum += staleness
            if self.policy.stale(staleness):
                self.stats.dropped_stale += 1
                self._retract(record)
                return False
            self.stats.staleness_hist[staleness] = (
                self.stats.staleness_hist.get(staleness, 0) + 1)
            self.stats.record_loss(self.version, record.loss)
            weight = max(1, int(record.weight))
            if self._rp_mode == "overlap" and rid >= 0:
                # Each open round pends into its own grid and fires on its
                # own quota: two rounds never mix in one batch.
                pend = self._rp_pending.setdefault(rid, ([], [], [], []))
                pend[0].append(buf)
                pend[1].append(record.worker)
                pend[2].append(record.push_id)
                pend[3].append(weight)
                if not self.policy.ready_to_apply(sum(pend[3])):
                    return True
                del self._rp_pending[rid]
                taken = (*pend, [() for _ in pend[0]], self.plan_version)
                round_id = rid
            elif self._rp_mode == "async":
                # A delta of tick weight w pends w copies of its buffer,
                # one tick each: the weighted apply's divisor is the tick
                # total, the FedBuff mean sum(w_i g_i) / sum(w_i). Only
                # the first copy carries the push id.
                for i in range(ticks):
                    self._pending.append(buf)
                    self._pending_workers.append(record.worker)
                    self._pending_ids.append(record.push_id if i == 0
                                             else "")
                    self._pending_weights.append(1)
                    self._pending_members.append(())
                self.stats.async_ticks += ticks
                if ticks < wscale:
                    self.stats.async_downweighted += 1
                if not self.policy.ready_to_apply(
                        sum(self._pending_weights)):
                    return True
                taken = self._take_pending()
                round_id = -1
            else:
                taken = self._pend_flat(record, buf, weight)
                if taken is None:
                    return True
                round_id = -1
        return self._apply_batch(*taken, round_id=round_id)

    # ewdml: requires[_lock] -- pending and the quota check that releases
    # the batch commit together; guarded-by-flow verifies every caller.
    def _pend_flat(self, record: PushRecord, buf, weight: int):
        """Pend one push in the shared batch (under ``_lock``, held by the
        caller); the batch to apply once the quota fills, else None."""
        self._pending.append(buf)
        self._pending_workers.append(record.worker)
        self._pending_ids.append(record.push_id)
        self._pending_weights.append(weight)
        self._pending_members.append(tuple(record.members))
        if record.members:
            self.stats.agg_pushes += 1
            self.stats.agg_weight += weight
        # Readiness counts leaf weight, not records: a tree's round
        # fragmented by partial flushes pends past its K slots and
        # applies at its height, never early on a partial weight.
        if not self.policy.ready_to_apply(sum(self._pending_weights)):
            return None
        return self._take_pending()

    # ewdml: requires[_update_lock] -- applies are serial: the version the
    # keys fold in moves only under this lock (the live path and replay).
    def _run_apply(self, batch, wsum: Optional[int] = None):
        """The apply of one released batch on the server's stream, under
        ``_update_lock`` (held by the caller): ``(new_params, new_opt,
        delta_buf, new_shadow, apply_s, delta_s, moments)``, the moments
        None unless adaptive. The live path and the
        WAL replay both run it, so a replayed version is bit-equal.
        ``wsum`` is the weighted mode's divisor (the batch's leaf
        weight)."""
        if not self._agg_mode and len(batch) != self._schema_k:
            raise RuntimeError(
                f"a batch of {len(batch)} payloads; the registered apply "
                f"takes K={self._schema_k}")
        apply_fn = self._apply_for(wsum if wsum else len(batch), len(batch))
        bufs = torch.from_numpy(np.stack(batch)).to(self.device)
        # The bf16 state stores' key, one per applied update (the
        # version advances only under _update_lock).
        okey = prng.fold_in(self._opt_key, self.version)
        self._sync()
        t_apply = clock.monotonic()
        new_params, new_opt, moments = apply_fn(self.params, self.opt_state,
                                                bufs, okey)
        self._sync()
        apply_s = clock.monotonic() - t_apply
        delta_buf, new_shadow, delta_s = None, self._shadow, 0.0
        if self._delta_fn is not None:
            # The new version's delta on this stream, one D2H.
            t_delta = clock.monotonic()
            packed, new_shadow = self._delta_fn(
                new_params, self._shadow,
                prng.fold_in(self._relay_key, self.version + 1))
            delta_buf = packed.cpu().numpy()
            delta_s = clock.monotonic() - t_delta
        return (new_params, new_opt, delta_buf, new_shadow, apply_s, delta_s,
                moments)

    # ewdml: requires[_lock] -- params, version and the applied ids swap
    # together for every reader; guarded-by-flow verifies every caller.
    def _commit(self, new_params, new_opt, delta_buf, new_shadow,
                push_ids) -> int:
        """Swap in an applied version (under ``_lock``, held by the
        caller); returns it."""
        self.params, self.opt_state = new_params, new_opt
        self._shadow = new_shadow
        self.version += 1
        self.stats.updates += 1
        self._note_applied_ids(push_ids, self.version)
        if delta_buf is not None:
            self._deltas[self.version] = delta_buf
            for old in [v for v in self._deltas
                        if v <= self.version - self.down_window]:
                del self._deltas[old]
        return self.version

    def _apply_batch(self, batch, workers=(), push_ids=(), weights=(),
                     members=(), batch_pv: int = 0,
                     round_id: int = -1) -> bool:
        """The released batch's apply and commit, outside the state lock
        (``_update_lock`` keeps applies ordered); then its publication, its
        WAL record, the policy's commit hook, an adaptive decision and the
        serverkill fault, in that order. ``batch_pv`` is the plan version
        the batch was released under. The weighted mode pads a short batch
        with zero levels (an exact no-op of the integer sum) up to the K
        slots."""
        n_bufs = len(batch)
        if self._agg_mode and len(batch) < self._schema_k:
            batch = batch + [np.zeros_like(batch[0])
                             for _ in range(self._schema_k - len(batch))]
        wsum = sum(weights) if weights else len(batch)
        with self._update_lock, self._on_stream(), torch.no_grad(), \
                otrace.span("ps/apply", k=len(batch), version=self.version,
                            **({"round": round_id} if round_id >= 0
                               else {})):
            if self.adapt is not None:
                # Plan switches happen only under _update_lock: a batch
                # released just before one would ride its old layout
                # through the new unpack, so it is dropped.
                with self._lock:
                    if self.plan_version != batch_pv:
                        self.stats.dropped_plan_stale += n_bufs
                        return False
            (new_params, new_opt, delta_buf, new_shadow, apply_s,
             delta_s, moments) = self._run_apply(batch, wsum)
            decodes = (0 if self.compressor is None
                       else 1 if self.server_agg == "homomorphic"
                       else len(batch))
            with self._lock:
                self.stats.apply_rounds += 1
                self.stats.apply_s_sum += apply_s
                self.stats.decode_count += decodes
                if delta_buf is not None:
                    self.stats.delta_s_sum += delta_s
                version_now = self._commit(new_params, new_opt, delta_buf,
                                           new_shadow, push_ids)
            if self._pd_on:
                # Published under _update_lock: a subscriber is handed a
                # version only once it is committed.
                self._pd_publish(new_params, version_now)
            self._journal_applied(version_now, batch, workers, push_ids,
                                  weights, batch_pv)
            # A pseudo-push's contributors are its leaf members.
            applied = []
            for w, ms in zip(workers, members or [()] * len(workers)):
                applied.extend(ms if ms else (w,))
            self.policy.note_applied(
                version_now, applied,
                round_id=(round_id if round_id >= 0 else None))
            if self.adapt is not None and self.adapt.due(version_now):
                # A decision boundary: the version counter is the step
                # clock here. Under _update_lock, so the re-registration
                # never races another apply.
                new_plan = self.adapt.on_window(version_now,
                                                moments.cpu().numpy())
                if new_plan is not None:
                    self._apply_adapt_plan(new_plan)
            # Last: every journal this apply owes (the WAL, the round
            # ledger, the decision ledger) is durable.
            self._maybe_trip_server_kill(version_now)
        return True

    # ewdml: requires[_update_lock] -- schema re-registration must never
    # race another apply; guarded-by-flow verifies every caller holds it.
    def _apply_adapt_plan(self, plan) -> None:
        """Switch the push schema to ``plan`` (``ps.py:1259-1297``; under
        ``_update_lock``): the planned compressor, the payload template (a
        zero gradient list compressed: its shapes and dtypes are the
        schema), the re-registered and warmed apply. The version, the
        compressor and the pending clear commit in one ``_lock`` section
        before the rebuild: from there an old-plan push is rejected, and a
        pull's :meth:`current_plan` pairs the new version with the new
        compressor."""
        comp = self.adapt.compressor(plan)
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in self.params]
        template = compress_tree_fn(
            # ewdml: allow[prng] -- payload-schema template over a zero
            # tree; bytes discarded, only shapes/dtypes register
            comp, zeros, prng.key(0))
        with self._lock:
            self.plan_version = plan.version
            self.compressor = comp
            # Accepted but unapplied old-plan buffers go, counted as the
            # batch recheck counts them.
            self.stats.dropped_plan_stale += len(self._pending)
            self._take_pending()
        self.register_payload_schema(template)
        logger.info("ps adapt: switched to plan v%d at version %d (%s)",
                    plan.version, plan.step, plan.method_counts())

    def current_plan(self) -> tuple:
        """``(plan_version, compressor)``, read together under the lock,
        for plan-following workers."""
        with self._lock:
            return self.plan_version, self.compressor

    # -- the durable state plane and elastic membership --------------------

    #: Applied push ids kept for dedupe, oldest evicted first: far beyond
    #: any wire retry's horizon.
    APPLIED_IDS_MAX = 8192

    # ewdml: requires[_lock] -- id bookkeeping must commit atomically with
    # the version bump it tags; guarded-by-flow verifies callers hold it.
    def _note_applied_ids(self, push_ids, version_now: int) -> None:
        for pid in push_ids:
            if pid:
                self._applied_ids[pid] = version_now
        while len(self._applied_ids) > self.APPLIED_IDS_MAX:
            self._applied_ids.pop(next(iter(self._applied_ids)))

    # ewdml: requires[_update_lock] -- journal/snapshot ordering must stay
    # serial with applies; guarded-by-flow verifies every caller holds it.
    def _journal_applied(self, version_now: int, batch, workers,
                         push_ids, weights=(), batch_pv: int = 0) -> None:
        """The apply's WAL record, durable on return, and a snapshot at
        every ``snapshot_every``-th version (under ``_update_lock``). A
        weighted batch's record carries its weights, so its divisor
        replays."""
        if self._state_store is None:
            return
        from ewdml_tpu_torch.parallel.server_state import encode_bufs

        rec = {
            "version": int(version_now),
            "workers": [int(w) for w in workers],
            "push_ids": [str(i) for i in push_ids],
            "plan_version": int(batch_pv),
            "bufs": encode_bufs(batch),
        }
        if any(w != 1 for w in weights):
            rec["weights"] = [int(w) for w in weights]
        self._state_store.append_wal(rec)
        with self._lock:
            self.stats.wal_records += 1
        if self._snapshot_every and version_now % self._snapshot_every == 0:
            self._write_snapshot()

    def _tree(self, leaves: list) -> dict:
        if self.leaf_names is None:
            raise ValueError("the durable state plane needs the server's "
                             "leaf_names (the parameters' Flax paths)")
        return _nested(zip(self.leaf_names, leaves))

    def _opt_tree(self, opt_state) -> dict:
        """The JAX optimizer state's Flax state dict: ``AdamState``'s
        ``count``, ``mu``, ``nu``; ``SGDState``'s ``momentum_buf`` and
        ``initialized``."""
        if isinstance(opt_state, AdamState):
            return {"count": opt_state.count,
                    "mu": self._tree(opt_state.mu),
                    "nu": self._tree(opt_state.nu)}
        return {"momentum_buf": self._tree(opt_state.momentum_buf),
                "initialized": torch.tensor(bool(opt_state.initialized))}

    def _from_blob(self, blob: bytes) -> tuple:
        """``(params, opt_state, shadow)`` of a snapshot blob, on the
        server's device."""
        tree = msgpack.unpackb(blob)

        def leaves(t: dict) -> list:
            flat = _flat(t)
            return [flat[n].to(self.device) for n in self.leaf_names]

        opt = tree["opt_state"]
        if isinstance(self.opt_state, AdamState):
            opt_state = AdamState(opt["count"].to(self.device),
                                  leaves(opt["mu"]), leaves(opt["nu"]))
        else:
            opt_state = type(self.opt_state)(leaves(opt["momentum_buf"]),
                                             bool(opt["initialized"]))
        return leaves(tree["params"]), opt_state, leaves(tree["shadow"])

    # ewdml: requires[_update_lock] -- the snapshot must be a point-in-time
    # cut between applies (params/version/ids only move under this lock).
    def _write_snapshot(self) -> None:
        """A point-in-time snapshot between applies (under
        ``_update_lock``)."""
        with self._lock:
            version = self.version
            plan_version = self.plan_version
            applied_ids = dict(self._applied_ids)
            joins = int(self.stats.joins)
            params, opt_state = self.params, self.opt_state
        # flax to_bytes({"params", "opt_state", "shadow"}), as the JAX
        # server writes it.
        blob = msgpack.packb({"params": self._tree(params),
                              "opt_state": self._opt_tree(opt_state),
                              "shadow": self._tree(self._shadow)})
        pol = self.policy.snapshot()
        meta = {
            "version": int(version),
            "plan_version": int(plan_version),
            "applied_ids": applied_ids,
            "policy": {"excluded": pol.excluded,
                       "kills_sent": pol.kills_sent,
                       "contacts": pol.contacts,
                       "members": pol.members},
            "joins": joins,
            "num_aggregate": int(self.num_aggregate),
            "scale_crc": (self.compressor.contract_checksum()
                          if self.server_agg == "homomorphic" else None),
        }
        if self._snapshot_extra is not None:
            meta.update(self._snapshot_extra())
        self._state_store.write_snapshot(meta, blob)
        with self._lock:
            self.stats.snapshots += 1

    def arm_durability(self, store, snapshot_every: int = 20) -> None:
        """Arm the durable state plane: a WAL record per apply, a snapshot
        every ``snapshot_every``-th version, and one now (it bounds a later
        replay and rotates a replayed WAL). Call after :meth:`recover`."""
        with self._update_lock:
            self._state_store = store
            self._snapshot_every = max(0, int(snapshot_every))
            self._write_snapshot()

    # ewdml: requires[_update_lock] -- trips only at the apply boundary,
    # after every journal this apply owes is durable.
    def _maybe_trip_server_kill(self, version_now: int) -> None:
        """``serverkill@N``: SIGKILL this process after apply N commits and
        journals (under ``_update_lock``)."""
        if (self._kill_at_apply is not None
                and version_now == self._kill_at_apply):
            logger.warning(
                "ps: serverkill@%d fault tripped at version %d -- SIGKILL "
                "(durable state plane %s)", self._kill_at_apply, version_now,
                "armed" if self._state_store is not None else "NOT armed")
            os.kill(os.getpid(), signal.SIGKILL)

    def recover(self, store) -> Optional[dict]:
        """Rebuild the server from ``store``: the snapshot's state, ids,
        policy and K, then every later WAL record replayed through the same
        apply as a live push (the keys fold per version), so the recovered
        parameters, optimizer state and shadow are bit-equal. Refuses a
        snapshot whose homomorphic scale CRC differs from this server's.
        Call after ``register_payload_schema`` and before
        :meth:`arm_durability`. Returns a summary, or None on a cold
        start."""
        snap = store.load_snapshot()
        wal = store.read_wal()
        if snap is None and not wal:
            return None
        meta = None
        if snap is not None:
            meta, blob = snap
            if self.adapt is None:
                self._check_scale_crc(meta)
            params, opt_state, shadow = self._from_blob(blob)
            with self._lock:
                self.params, self.opt_state = params, opt_state
                self._shadow = shadow
                self.version = int(meta["version"])
                self._packed_cache = {"f32": (None, -1), "bf16": (None, -1)}
                self._applied_ids = {
                    str(k): int(v)
                    for k, v in (meta.get("applied_ids") or {}).items()}
                self.stats.joins = int(meta.get("joins", 0))
            pol = meta.get("policy") or {}
            self.policy.restore(excluded=pol.get("excluded") or {},
                                kills_sent=int(pol.get("kills_sent", 0)),
                                contacts=int(pol.get("contacts", 0)),
                                members=pol.get("members") or ())
        if self.adapt is not None:
            # Adopt the plan in force at the snapshot's version (the
            # decision ledger says which), then check it against the one
            # the snapshot recorded, and its scale contract.
            with self._update_lock, self._on_stream(), torch.no_grad():
                plan = self.adapt.fast_forward(self.version)
                if plan is not None:
                    self._apply_adapt_plan(plan)
                else:
                    with self._lock:
                        self.plan_version = self.adapt.plan.version
            if (meta is not None and self.plan_version
                    != int(meta.get("plan_version", 0))):
                raise RuntimeError(
                    f"recovered plan desync: decision ledger replays to "
                    f"plan v{self.plan_version} at version {self.version}, "
                    f"snapshot recorded v{meta.get('plan_version')}")
            if meta is not None:
                self._check_scale_crc(meta)
        replayed = 0
        with self._update_lock, self._on_stream(), torch.no_grad():
            if (self._elastic_k and meta is not None
                    and self._payload_template is not None):
                k = max(1, int(meta.get("num_aggregate",
                                        self.num_aggregate)))
                if k != self._schema_k:
                    self.policy.num_aggregate = k
                    self.register_payload_schema(self._payload_template)
            for rec in wal:
                if rec.get("kind") == "join":
                    self._join_locked(int(rec["worker"]), replay=True)
                    continue
                v = int(rec["version"])
                if v <= self.version:
                    continue  # subsumed by the snapshot (un-rotated tail)
                if v != self.version + 1:
                    raise RuntimeError(
                        f"WAL gap: at version {self.version}, next journaled "
                        f"record is {v} — corrupt beyond the torn tail; "
                        f"refusing to skip applies")
                rpv = int(rec.get("plan_version", 0))
                if self.adapt is not None and rpv != self.plan_version:
                    # The plan switched mid-WAL: adopt the plan this batch
                    # was encoded under before replaying its bytes.
                    plan = self.adapt.fast_forward(v - 1)
                    if plan is not None:
                        self._apply_adapt_plan(plan)
                    if rpv != self.plan_version:
                        raise RuntimeError(
                            f"WAL record at version {v} encoded under plan "
                            f"v{rpv}, but the decision ledger replays to "
                            f"v{self.plan_version} there")
                self._replay_record(rec)
                replayed += 1
        with self._lock:
            version = int(self.version)
        summary = {"version": version,
                   "snapshot_version": int(meta["version"]) if meta else -1,
                   "replayed": replayed}
        logger.info("ps: recovered at version %d (snapshot %d + %d WAL "
                    "records replayed)", version,
                    summary["snapshot_version"], replayed)
        return summary

    def _check_scale_crc(self, meta: dict) -> None:
        """Refuse a snapshot whose homomorphic scale CRC is not the live
        contract's."""
        if (self.server_agg != "homomorphic"
                or meta.get("scale_crc") is None):
            return
        crc = self.compressor.contract_checksum()
        if int(meta["scale_crc"]) != crc:
            raise RuntimeError(
                f"recovered scale-contract desync: snapshot CRC "
                f"{meta['scale_crc']} != live contract {crc} — the "
                f"homomorphic sum would be garbage; refusing to serve")

    # ewdml: requires[_update_lock] -- replay IS the apply path: the exact
    # commit sequence of _push, minus journaling and policy hooks (the
    # round completion this apply funded was journaled before the kill).
    def _replay_record(self, rec) -> None:
        """One WAL record through the live apply and commit, without the
        journal and the hooks (under ``_update_lock``)."""
        from ewdml_tpu_torch.parallel.server_state import decode_bufs

        batch = decode_bufs(rec["bufs"])
        weights = rec.get("weights")
        (new_params, new_opt, delta_buf, new_shadow, _, _,
         _) = self._run_apply(batch, sum(int(w) for w in weights)
                              if weights else len(batch))
        with self._lock:
            version_now = self._commit(new_params, new_opt, delta_buf,
                                       new_shadow, rec.get("push_ids", []))
            self._packed_cache = {"f32": (None, -1), "bf16": (None, -1)}
        if self._pd_on:
            self._pd_publish(new_params, version_now)

    # -- the publication stream (the ``subscribe`` op) ----------------------

    def _pd_arm(self) -> None:
        """Arm the stream on the first subscriber: publish a keyframe of the
        current version. Under ``_update_lock``, so the stream starts at a
        committed version and misses none after it."""
        with self._update_lock, self._on_stream(), torch.no_grad():
            if self._pd_on:
                return
            bad = [str(p.dtype) for p in self.params
                   if p.dtype != torch.float32]
            if bad:
                raise ValueError(
                    "the subscribe stream replays the packed buffer as "
                    f"f32[n] and requires an all-f32 parameter tree; found "
                    f"a {bad[0]} leaf")
            with self._lock:
                params, version = self.params, self.version
            packed = self._pack(params).cpu().numpy()
            self._pd_nbytes = packed.nbytes
            self._pd_crc = pd_contract_crc(packed.nbytes, PD_BLOCK, PD_S,
                                           self._pd_every)
            self._pd_shadow = packed.view(np.float32).copy()
            with self._lock:
                self._pd_head = version
                self._pd_keyframe = (version, packed)
                self._pd_deltas = {}
            self._pd_on = True

    # ewdml: requires[_update_lock] -- publication rides the apply commit:
    # the shadow replay and the version it claims must be serialized with
    # the params bump (guarded-by-flow verifies every caller holds it).
    def _pd_publish(self, new_params, version_now: int) -> None:
        """Publish ``version_now`` (under ``_update_lock``, on the server's
        stream): a keyframe once ``keyframe_every`` versions have passed
        since the last, else the quantized difference to the shadow, which
        then advances by :func:`pd_apply_delta`. One packed D2H an apply,
        and the delta's levels and scales."""
        packed = self._pack(new_params).cpu().numpy()
        flat = packed.view(np.float32)
        with self._lock:
            kf_version = self._pd_keyframe[0]
        if version_now - kf_version >= self._pd_every:
            self._pd_shadow = flat.copy()
            with self._lock:
                self._pd_head = version_now
                self._pd_keyframe = (version_now, packed)
                self._pd_deltas = {}
            return
        diff = torch.from_numpy(flat - self._pd_shadow).to(self.device)
        levels, scales = pd_quantize(diff,
                                     prng.fold_in(self._pd_key, version_now))
        levels, scales = levels.cpu().numpy(), scales.cpu().numpy()
        self._pd_shadow = pd_apply_delta(self._pd_shadow, levels, scales)
        with self._lock:
            self._pd_head = version_now
            self._pd_deltas[version_now] = (levels, scales)

    def pd_contract(self) -> dict:
        """The stream geometry every ``subscribe_ok`` header carries."""
        return {"flat": self._pd_nbytes, "block": PD_BLOCK, "s": PD_S,
                "keyframe_every": self._pd_every, "crc": self._pd_crc}

    def subscribe_stream(self, since: int = -1) -> tuple:
        """One ``subscribe`` poll: ``(mode, version, kf_version, bufs)``.
        Mode "delta" when ``since`` lies in the keyframe's window: the
        [levels, scales] pairs of since+1..version (none when caught up);
        "keyframe" otherwise: the keyframe, then the pairs after it. Serves
        up to the published head; the first call arms the stream."""
        if not self._pd_on:
            self._pd_arm()
        with self._lock:
            version = self._pd_head
            kf_version, kf_buf = self._pd_keyframe
            if kf_version <= since <= version:
                mode, start, bufs = "delta", since, []
            else:
                mode, start, bufs = "keyframe", kf_version, [kf_buf]
            for v in range(start + 1, version + 1):
                bufs.extend(self._pd_deltas[v])
            self.stats.bytes_down += sum(b.nbytes for b in bufs)
        return mode, version, kf_version, bufs

    def join_worker(self, worker: int) -> dict:
        """Admit ``worker`` mid-run (the ``join`` op): the policy seeds its
        liveness and, under elastic K, K becomes the live count (pending
        old-K buffers are dropped and the apply is rebuilt before the
        reply). Journals a ``join`` WAL record when durability is armed.
        Returns the ``join_ok`` payload."""
        with self._update_lock:
            return self._join_locked(int(worker))

    # ewdml: requires[_update_lock] -- membership, K, and the journal must
    # move atomically with respect to applies (the WAL's join records sit
    # between the batch records they re-order K for).
    def _join_locked(self, worker: int, replay: bool = False) -> dict:
        already = self.policy.is_member(worker)
        self.policy.note_join(worker)
        live = self.policy.live_workers()
        if (self._elastic_k and self._payload_template is not None
                and max(1, live) != self._schema_k):
            with self._lock:
                dropped = len(self._pending)
                self.stats.dropped_stale += dropped
                self._take_pending()
            self.policy.num_aggregate = max(1, live)
            self.register_payload_schema(self._payload_template)
            logger.info("ps: elastic K-of-N recomputed to K=%d (%d live) on "
                        "join of worker %d; %d pending old-K buffers "
                        "dropped", self.num_aggregate, live, worker, dropped)
        with self._lock:
            # A replayed join of a restored member is a WAL tail the
            # snapshot subsumed: the counter must not double.
            if not (replay and already):
                self.stats.joins += 1
            version = self.version
        if not replay and self._state_store is not None:
            self._state_store.append_wal({"kind": "join",
                                          "worker": int(worker),
                                          "version": int(version)})
            with self._lock:
                self.stats.wal_records += 1
        return {"version": int(version), "live": int(live),
                "num_aggregate": int(self.num_aggregate)}


def make_grad_fn(specs):
    """``(module, params, images, labels, key) -> (loss, grads)``: load the
    parameters (JAX leaf order and layout) into the worker's module, run
    forward and backward in train mode (its BatchNorm statistics update in
    place), and return the gradients in the same order and layout. The
    dropout stream is seeded from ``key``, as the sync step seeds it."""
    from ewdml_tpu_torch.train.trainer import cross_entropy

    def loss_and_grad(module, params, images, labels, key):
        mparams = leaf_params(module, specs)
        with torch.no_grad():
            for p, leaf, spec in zip(mparams, params, specs):
                p.copy_(from_jax(leaf, spec.kind))
        module.zero_grad(set_to_none=True)
        logits = module(images, train=True,
                        generator=prng.generator(key, images.device))
        loss = cross_entropy(logits.float(), labels.long())
        loss.backward()
        grads = [to_jax(p.grad, s.kind).contiguous()
                 for p, s in zip(mparams, specs)]
        return loss.detach(), grads

    return loss_and_grad


def compress_tree_fn(compressor, tree, key) -> list:
    """Per-leaf compress with the canonical (key, layer) derivation; a
    per-unit compressor dispatches through ``for_leaf(i)``."""
    per_unit = hasattr(compressor, "for_leaf")
    with torch.no_grad():
        return [(compressor.for_leaf(i) if per_unit else compressor)
                .compress(prng.layer_key(key, i), g)
                for i, g in enumerate(tree)]


def decompress_tree(compressor, payload_tree) -> list:
    """Per-leaf decompress, the inverse of :func:`compress_tree_fn`."""
    per_unit = hasattr(compressor, "for_leaf")
    return [(compressor.for_leaf(i) if per_unit else compressor).decompress(p)
            for i, p in enumerate(payload_tree)]


def delta_step(compressor, pack, params, shadow, key):
    """The delta down-link's step (``ewdml_tpu/parallel/ps.py:643-657``):
    ``(packed compress(params - shadow), shadow + decompress(...))``, each
    leaf keyed ``layer_key(key, i)``."""
    diff = [a - b for a, b in zip(params, shadow)]
    payloads = compress_tree_fn(compressor, diff, key)
    dec = decompress_tree(compressor, payloads)
    return pack(payloads), [sh + d for sh, d in zip(shadow, dec)]


def make_apply_delta(compressor, unpack_payload):
    """A worker's replay of one packed delta: ``params + decompress``, the
    server's shadow update on the same values."""

    def apply_delta(params, buf):
        dec = decompress_tree(compressor, unpack_payload(buf))
        return [p + d for p, d in zip(params, dec)]

    return apply_delta


def _bf16_wire(leaves: list) -> list:
    """The bf16 bootstrap's wire view of a parameter list: f32 leaves
    halve (round to nearest even), the others pass through."""
    return wire_cast(leaves, torch.bfloat16)


def make_bf16_unpacker(params_template):
    """Unpack a ``weights_bf16`` pull back to the parameters' dtypes."""
    unpack_wire = transfer.make_device_unpacker(_bf16_wire(params_template))
    dtypes = [p.dtype for p in params_template]
    return lambda buf: [x.to(d) for x, d in zip(unpack_wire(buf), dtypes)]


def make_compress_tree(compressor):
    """Whole-tree compress (or None for the dense path)."""
    if compressor is None:
        return None
    return lambda grads, key: compress_tree_fn(compressor, grads, key)


class AsyncWorker(threading.Thread):
    """One worker: pull -> compute -> compress -> push, ``steps`` times.

    ``module`` is this worker's own copy of the model (its BatchNorm
    statistics are worker-local); its key chain is
    ``fold_in(key(seed), index)`` then ``step_key`` per step, as in the JAX
    package. ``params`` and ``version`` are the parameters it last pulled
    (or replayed) and their server version (-1 before its first pull),
    ``base_version`` the version of its last dense pull, on which it
    replays deltas. It stops at a step's start once the server's watchdog
    has aborted."""

    def __init__(self, index: int, device, server: ParameterServer,
                 grad_fn, data_iter, module,
                 steps: int = 10, seed: int = 0, delay_s: float = 0.0,
                 compress_tree=None, pack_payloads=None, unpack_params=None,
                 apply_delta=None, unpack_params_bf16=None,
                 crash_at: Optional[int] = None,
                 nan_at: frozenset = frozenset(), specs=None,
                 debug_nans: bool = False, wire_dtype=None):
        super().__init__(daemon=True, name=f"ps-worker-{index}")
        self.index = index
        self.device = _indexed(device)
        self.server = server
        self.grad_fn = grad_fn
        self.data_iter = data_iter
        self.module = module
        self.steps = steps
        self.key = prng.fold_in(prng.key(seed), index)
        self.delay_s = delay_s
        self.crash_at = crash_at
        self.nan_at = nan_at
        self.killed: Optional[str] = None
        self.exc: Optional[BaseException] = None
        self._compress_tree = compress_tree
        self._pack_payloads = pack_payloads
        self._unpack_params = unpack_params
        self._unpack_params_bf16 = unpack_params_bf16
        self._apply_delta = apply_delta
        self.specs = specs
        self.debug_nans = debug_nans
        self.wire_dtype = wire_dtype
        # ewdml: allow[guarded-by-flow] -- thread-owned: written on this
        # worker's thread (run -> pull_params); callers read it, or call
        # pull_params, only after join()
        self.params: Optional[list] = None
        # ewdml: allow[guarded-by-flow] -- thread-owned, as params
        self.version = -1
        # ewdml: allow[guarded-by-flow] -- thread-owned, as params
        self.base_version = -1
        # The adaptive plan this worker encodes under, and its compress
        # per plan key (a controller returning to a plan reuses it).
        self.plan_version = 0
        self._ctree_cache: dict = {}

    def _follow_plan(self) -> None:
        """Adopt the server's plan when it switched: version and
        compressor read together under the server's lock."""
        server = self.server
        if server.adapt is None or self.plan_version == server.plan_version:
            return
        pv, comp = server.current_plan()
        ckey = comp.plan.key()
        ctree = self._ctree_cache.get(ckey)
        if ctree is None:
            ctree = self._ctree_cache[ckey] = make_compress_tree(comp)
        self._compress_tree = ctree
        self.plan_version = pv

    def pull_params(self) -> None:
        """Pull, and update ``params`` and ``version`` by the mode the
        server answers with."""
        mode, payload, version, _ = self.server.pull(self.version,
                                                     worker=self.index)
        if mode == "delta":
            for b in payload:
                self.params = self._apply_delta(self.params,
                                                self._to_device(b))
        else:
            unpack = (self._unpack_params_bf16 if mode == "weights_bf16"
                      else self._unpack_params)
            self.params = unpack(self._to_device(payload))
            self.base_version = version
        self.version = version

    def _check_finite(self, step: int, loss, grads) -> None:
        """``--debug-nans``: raise ``FloatingPointError`` naming the step
        and the leaf where this worker's loss or a gradient is not
        finite."""
        flags = torch.stack([torch.isfinite(loss).all()]
                            + [torch.isfinite(g).all() for g in grads]).cpu()
        if bool(flags.all()):
            return
        bad = int((~flags).nonzero()[0, 0])
        what = ("loss" if bad == 0 else
                f"gradient {self.specs[bad - 1].name}")
        raise FloatingPointError(f"--debug-nans: non-finite {what} at "
                                 f"step {step} (async worker {self.index})")

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def run(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            # One role per thread: the in-process server and its workers
            # share one process and one trace shard.
            otrace.set_role(f"worker-{self.index}")
            for step in range(self.steps):
                if self.crash_at is not None and step == self.crash_at:
                    raise FaultCrash(self.index, step)
                health = self.server.health
                if health is not None and health.aborted is not None:
                    break  # every later push would be dropped
                self.pull_params()
                self._follow_plan()
                version = self.version
                images, labels = next(self.data_iter)
                k = prng.step_key(self.key, step)
                with otrace.span("worker/grad", step=step):
                    loss, grads = self.grad_fn(self.module, self.params,
                                               self._to_device(images),
                                               self._to_device(labels), k)
                if self.debug_nans:
                    self._check_finite(step, loss, grads)
                if self.delay_s:
                    time.sleep(self.delay_s)
                with torch.no_grad():
                    if self._compress_tree is not None:
                        payloads = self._compress_tree(grads, k)
                    elif self.wire_dtype is not None:
                        payloads = wire_cast(grads, self.wire_dtype)
                    else:
                        payloads = grads
                    buf = self._pack_payloads(payloads).cpu().numpy()
                message = native.encode_arrays([buf])
                self.server.push(PushRecord(
                    worker=self.index, version=version, message=message,
                    loss=(float("nan") if step in self.nan_at
                          else float(loss)),
                    plan_version=self.plan_version))
        except StragglerKilled as e:
            self.killed = e.reason
        except BaseException as e:  # noqa: BLE001 -- surfaced by AsyncRun.run
            self.exc = e


def run_async_ps(*args, **kwargs):
    """Drive an async PS run: :func:`build_async_ps`'s arguments, then
    :meth:`AsyncRun.run`. Returns ``(final_params, PSStats)``, the
    parameters as a list in the JAX tree's leaf order and layout."""
    return build_async_ps(*args, **kwargs).run()


class AsyncRun:
    """An async PS run, built and not started: its ``server`` and its
    ``workers`` (one thread each), open to inspection after :meth:`run`."""

    def __init__(self, server, workers, *, steps_per_worker: int,
                 kill_threshold: Optional[float], health, registry,
                 adapt=None):
        self.server = server
        self.workers = workers
        #: The adaptive runtime (None unless ``adapt_cfg``); its ledger is
        #: closed at the end of :meth:`run`.
        self.adapt = adapt
        self._budget = (kill_threshold * steps_per_worker
                        if kill_threshold is not None else None)
        self._health = health
        self._registry = registry

    def run(self):
        """Start the workers and wait for them: ``(final_params,
        PSStats)``. The watchdog's abort verdict raises ``HealthAbort``."""
        server, workers = self.server, self.workers
        health, registry, budget = self._health, self._registry, self._budget
        t0 = clock.monotonic()
        for w in workers:
            w.start()
        for w in workers:
            if budget is None:
                w.join()
            else:
                w.join(timeout=max(0.0, budget - (clock.monotonic() - t0)))
                if w.is_alive():
                    logger.warning("worker %d exceeded kill threshold; "
                                   "abandoned", w.index)
        if health is not None and health.aborted is not None:
            # Workers racing the verdict may each have raised: surface the
            # first, which stopped the run.
            a = health.aborted
            raise HealthAbort(a["kind"], a["step"], a["detail"])
        for w in workers:
            if w.killed is not None:
                logger.warning("worker %d killed by policy: %s", w.index,
                               w.killed)
            if isinstance(w.exc, FaultCrash):
                server.stats.worker_crashes += 1
                logger.warning("worker %d crashed (injected): %s", w.index,
                               w.exc)
            elif w.exc is not None and not w.is_alive():
                raise w.exc
        server.stats.excluded_workers = server.policy.excluded()
        server.stats.kills_sent = server.policy.kills_sent
        abandoned = [w.index for w in workers
                     if w.is_alive()
                     and w.index not in server.stats.excluded_workers]
        server.stats.dropped_straggler = (
            len(server.stats.excluded_workers) + len(abandoned))
        if registry is not None:
            registry.absorb_ps_stats(server.stats)
            registry.absorb_policy(server.policy.snapshot())
        if self.adapt is not None:
            self.adapt.close()  # appends are fsync'd; this frees the file
        otrace.flush()
        return server.params, server.stats


def build_async_ps(model, optimizer, data_iter_factory, *,
                   num_workers: int, steps_per_worker: int, compressor=None,
                   num_aggregate: int = 1,
                   max_staleness: Optional[int] = None, seed: int = 0,
                   kill_threshold: Optional[float] = None,
                   relay_compress: bool = False, down_mode: str = "weights",
                   straggler_delays: Optional[dict] = None,
                   bootstrap: str = "f32", fault_spec=None,
                   precision: str = "f32", adapt_cfg=None,
                   server_agg: str = "decode", health=None, device=None,
                   devices=None, debug_nans: bool = False,
                   registry=None) -> AsyncRun:
    """Build an async PS run: the server and one worker thread each.

    The initial parameters and BatchNorm statistics are ``model``'s own.
    ``device`` is where the server lives (CUDA unless the caller asks for
    the CPU; a CUDA run without a GPU raises); the workers run on
    ``devices[i % len(devices)]`` (default: the server's device). The warm
    gradient (the first batch of ``data_iter_factory(0)`` at the initial
    parameters, dropout key ``key(0)``) fixes the push schema and, under
    ``server_agg='homomorphic'``, the scale contract. ``fault_spec``'s
    ``delay`` clauses merge into ``straggler_delays``, ``crash`` clauses kill
    a worker thread at a step. ``debug_nans`` makes a worker raise
    ``FloatingPointError`` at a non-finite loss or gradient (re-raised
    here). ``registry`` absorbs the run's ``PSStats`` and the policy's
    snapshot at the end. ``down_mode``, ``bootstrap`` and
    ``relay_compress`` choose the down-link (see :class:`ParameterServer`);
    ``health`` (``obs/health.HealthWatchdog``) observes the pushes' losses,
    and its abort verdict raises ``HealthAbort`` from :meth:`AsyncRun.run`.
    ``adapt_cfg`` (a config with ``--adapt`` on) arms the server's adaptive
    controller: decisions at version boundaries, its ledger and
    instruments into ``registry``, every plan's scale contract under
    ``server_agg='homomorphic'`` negotiated against the warm gradient.
    """
    from ewdml_tpu_torch.core.world import resolve_device

    device = _indexed(resolve_device(None, device))
    devices = [_indexed(d) for d in (devices or [device])]
    if not isinstance(fault_spec, FaultSpec):
        fault_spec = FaultSpec.parse(fault_spec)
    straggler_delays = {**fault_spec.delays(), **(straggler_delays or {})}
    crashes = fault_spec.crashes()
    model = model.to(device)
    specs = leaf_specs(model)
    params = [to_jax(p.detach(), s.kind).contiguous().clone()
              for p, s in zip(leaf_params(model, specs), specs)]
    grad_fn = make_grad_fn(specs)
    wi, wl = next(data_iter_factory(0))
    _, grads0 = grad_fn(copy.deepcopy(model), params,
                        torch.from_numpy(np.ascontiguousarray(wi)).to(device),
                        torch.from_numpy(np.ascontiguousarray(wl)).to(device),
                        # ewdml: allow[prng] -- one-shot warm/template
                        # gradient (wire schema + scale contract)
                        prng.key(0))
    adapt = None
    if adapt_cfg is not None and adapt_cfg.adapt != "off":
        from ewdml_tpu_torch.adapt import AdaptRuntime
        from ewdml_tpu_torch.adapt.plan import unit_names_and_sizes

        if adapt_cfg.server_agg != server_agg:
            # The controller prices its budget from the config's wire.
            raise ValueError(
                f"run_async_ps(server_agg={server_agg!r}) disagrees with "
                f"adapt_cfg.server_agg={adapt_cfg.server_agg!r}; pass one "
                "value on both (the controller's wire pricing keys off the "
                "config)")
        names, sizes = unit_names_and_sizes(specs)
        adapt = AdaptRuntime(adapt_cfg, names, sizes, surface="ps",
                             registry=registry)
        if server_agg == "homomorphic":
            adapt.set_scale_base(grads0)
        compressor = adapt.compressor()
    elif server_agg == "homomorphic":
        from ewdml_tpu_torch.ops.homomorphic import make_homomorphic

        compressor = make_homomorphic(compressor, grads0)
    server = ParameterServer(params, optimizer, compressor,
                             num_aggregate=num_aggregate,
                             max_staleness=max_staleness,
                             relay_compress=relay_compress,
                             device=device, down_mode=down_mode,
                             bootstrap=bootstrap,
                             kill_threshold=kill_threshold,
                             precision=precision, server_agg=server_agg,
                             health=health, seed=seed, adapt=adapt)
    shared_compress = make_compress_tree(compressor)
    payload_template = grads0 if shared_compress is None \
        else shared_compress(grads0, prng.key(0))  # ewdml: allow[prng] -- payload-schema template; bytes discarded, only shapes/dtypes register
    # Dense push frames honour the policy: the template and the workers'
    # per-step cast share one definition (core/precision.wire_cast).
    wire_dtype = (server.precision.wire_dtype
                  if shared_compress is None and server.precision.bf16_wire
                  else None)
    if wire_dtype is not None:
        payload_template = wire_cast(payload_template, wire_dtype)
    server.register_payload_schema(payload_template)
    pack_payloads = transfer.make_device_packer()
    # f32 for every "weights" pull; bf16 only for a first pull's bootstrap.
    unpack_params = transfer.make_device_unpacker(params)
    unpack_params_bf16 = (make_bf16_unpacker(params)
                          if server.bootstrap == "bf16" else None)
    apply_delta = (make_apply_delta(compressor, server.payload_unpack)
                   if server.down_mode == "delta" else None)
    workers = [
        AsyncWorker(
            i, devices[i % len(devices)], server, grad_fn,
            data_iter_factory(i),
            copy.deepcopy(model).to(devices[i % len(devices)]),
            steps=steps_per_worker, seed=seed,
            delay_s=straggler_delays.get(i, 0.0), crash_at=crashes.get(i),
            nan_at=fault_spec.for_worker(i).nan_at,
            compress_tree=shared_compress, pack_payloads=pack_payloads,
            unpack_params=unpack_params, apply_delta=apply_delta,
            unpack_params_bf16=unpack_params_bf16, specs=specs,
            debug_nans=debug_nans, wire_dtype=wire_dtype)
        for i in range(num_workers)
    ]
    return AsyncRun(server, workers, steps_per_worker=steps_per_worker,
                    kill_threshold=kill_threshold, health=health,
                    registry=registry, adapt=adapt)
