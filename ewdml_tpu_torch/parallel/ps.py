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
(``ops/kernels.int_accumulate`` / ``acc_decode`` on the card), where
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

Options of later slices raise ``NotImplementedError`` by name here or in
``train/trainer.check_supported(async_path=True)``: durability and
recovery, the publication stream, aggregation-tree pseudo-pushes, round
pipelines and cohort policies, and ``--adapt``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from ewdml_tpu_torch import native
from ewdml_tpu_torch.core.precision import resolve_policy, wire_cast
from ewdml_tpu_torch.models.convert import from_jax, leaf_specs, to_jax
from ewdml_tpu_torch.obs import clock
from ewdml_tpu_torch.obs import trace as otrace
from ewdml_tpu_torch.obs.health import HealthAbort
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.optim import update_accepts_key
from ewdml_tpu_torch.parallel.faults import FaultCrash, FaultSpec
from ewdml_tpu_torch.parallel.policy import StragglerKilled, StragglerPolicy
from ewdml_tpu_torch.train.state import leaf_params
from ewdml_tpu_torch.utils import prng, transfer

logger = logging.getLogger("ewdml_tpu_torch.ps")

def _indexed(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _unsupported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to ewdml_tpu_torch yet (ROADMAP.md)")


@dataclasses.dataclass
class PushRecord:
    """One gradient push. ``message`` is the wire frame holding the packed
    payload buffer."""

    worker: int
    version: int          # server version the worker pulled before computing
    message: bytes
    loss: float

    @property
    def wire_bytes(self) -> int:
        return len(self.message)


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
                 server_agg: str = "decode", health=None, seed: int = 0):
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
        if adapt is not None:
            _unsupported("--adapt")
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
        self.policy = StragglerPolicy(
            kill_threshold=kill_threshold, max_staleness=max_staleness,
            num_aggregate=num_aggregate)
        # The lossy weights-down relay (the paper's negative result,
        # Final Report p.5) and the wire of a first pull ("f32" | "bf16").
        self.relay_compress = relay_compress and compressor is not None
        self.bootstrap = bootstrap if bootstrap in ("f32", "bf16") else "f32"
        self._relay_key = prng.key(seed ^ 0x5EED)
        self.version = 0
        self.stats = PSStats()
        # Canonical order: _update_lock before _lock, never the reverse.
        self._lock = threading.Lock()           # params/version/stats
        self._update_lock = threading.Lock()    # serializes applies
        self._pending: list = []
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._pack = transfer.make_device_packer()
        # One packed pull per wire and version (one D2H each).
        self._packed_cache = {"f32": (None, -1), "bf16": (None, -1)}
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

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    def register_payload_schema(self, payload_template) -> None:
        """Fix the push schema (payload structure and leaf specs) and build
        the apply over K stacked buffers: unpack, then the homomorphic mean
        or decode-then-mean, then the optimizer update. The apply is run
        once on zeroed buffers (its result discarded) before any worker is
        timed, as the JAX server warms its compiled apply."""
        unpack = self.payload_unpack = transfer.make_device_unpacker(
            payload_template)
        comp = self.compressor
        k = self._schema_k = self.policy.num_aggregate
        optimizer = self.optimizer
        homomorphic = self.server_agg == "homomorphic"
        takes_key = update_accepts_key(optimizer)

        def apply_bufs(params, opt_state, bufs, okey):  # uint8 [K, n]
            trees = [unpack(bufs[i]) for i in range(k)]
            if homomorphic:
                from ewdml_tpu_torch.ops.homomorphic import homomorphic_mean

                grads = homomorphic_mean(comp, trees)
            else:
                if comp is not None:
                    trees = [decompress_tree(comp, t) for t in trees]
                # f32 accumulation whatever the wire dtype: bf16 push
                # frames upcast before the mean.
                kk = kernels.f32_scalar(float(k))
                grads = [torch.stack(xs).to(torch.float32).sum(dim=0) / kk
                         for xs in zip(*trees)]
            new_params = [p.clone() for p in params]
            new_opt = _clone_state(opt_state)
            if takes_key:
                optimizer.update(grads, new_opt, new_params, key=okey)
            else:
                optimizer.update(grads, new_opt, new_params)
            return new_params, new_opt

        self._apply_fn = apply_bufs
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

    def _check_worker(self, worker) -> None:
        """Shared-policy liveness check on a worker contact; raises
        :class:`StragglerKilled` for an excluded worker."""
        reason = self.policy.observe(worker)
        if reason is not None:
            with self._lock:
                self.stats.kills_sent = self.policy.kills_sent
                self.stats.excluded_workers = self.policy.excluded()
                self.stats.dropped_straggler = len(
                    self.stats.excluded_workers)
            raise StragglerKilled(worker, reason)

    # -- worker-facing API (the wire) ------------------------------------
    def pull(self, worker_version: int = -1, worker: Optional[int] = None):
        """Down link: ``(mode, payload, version, nbytes)``. ``mode`` is
        ``"weights"`` (the packed parameters, a uint8 numpy buffer),
        ``"weights_bf16"`` (the same in bf16: only a delta-mode first pull,
        ``worker_version`` -1, under ``bootstrap='bf16'``; a worker that
        fell behind the window gets f32) or ``"delta"`` (the list of packed
        deltas after ``worker_version``). An excluded worker's pull raises
        :class:`StragglerKilled`. Traced as ``ps/pull``."""
        with otrace.span("ps/pull", worker=worker):
            return self._pull(worker_version, worker)

    def _pull(self, worker_version: int = -1, worker: Optional[int] = None):
        if worker is not None:
            self._check_worker(worker)
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

    def push(self, record: PushRecord) -> bool:
        """Gradients-up link. Returns False if the push was dropped as
        stale; raises :class:`StragglerKilled` for an excluded pusher. The
        push that completes a K-of-N batch runs the apply in its thread.
        Traced as ``ps/push``, the apply within it as ``ps/apply``."""
        with otrace.span("ps/push", worker=record.worker):
            return self._push(record)

    def _push(self, record: PushRecord) -> bool:
        if self._apply_fn is None:
            raise RuntimeError("register_payload_schema first")
        self._check_worker(record.worker)
        # Decode (CRC verify + copy) outside the lock.
        buf = native.decode_arrays(record.message)[0]
        health = self.health
        if health is not None:
            if health.aborted is not None:
                return False  # unobserved: the run's verdict is the first
            if not self.policy.stale(self.version - record.version):
                # Outside the lock (an event is an fsync'd write), and not
                # for a push about to be dropped as stale: its loss was
                # computed on long-gone weights. An abort raises here,
                # before any state changes.
                health.observe_loss(self.version, record.loss)
        with self._lock:
            self.stats.pushes += 1
            self.stats.bytes_up += record.wire_bytes
            staleness = self.version - record.version
            self.stats.staleness_sum += staleness
            if self.policy.stale(staleness):
                self.stats.dropped_stale += 1
                return False
            self.stats.staleness_hist[staleness] = (
                self.stats.staleness_hist.get(staleness, 0) + 1)
            self.stats.record_loss(self.version, record.loss)
            self._pending.append(buf)
            if not self.policy.ready_to_apply(len(self._pending)):
                return True
            batch, self._pending = self._pending, []
        return self._apply_batch(batch)

    def _apply_batch(self, batch) -> bool:
        """The released batch's apply and commit, outside the state lock
        (``_update_lock`` keeps applies ordered)."""
        with self._update_lock, self._on_stream(), torch.no_grad(), \
                otrace.span("ps/apply", k=len(batch), version=self.version):
            bufs = torch.from_numpy(np.stack(batch)).to(self.device)
            # The bf16 state stores' key, one per applied update (the
            # version advances only under _update_lock, held here).
            okey = prng.fold_in(self._opt_key, self.version)
            self._sync()
            t_apply = clock.monotonic()
            new_params, new_opt = self._apply_fn(self.params, self.opt_state,
                                                 bufs, okey)
            self._sync()
            apply_s = clock.monotonic() - t_apply
            decodes = (0 if self.compressor is None
                       else 1 if self.server_agg == "homomorphic"
                       else len(batch))
            delta_buf, new_shadow = None, self._shadow
            if self._delta_fn is not None:
                # The new version's delta on this stream, one D2H; the
                # version advances only under _update_lock, held here.
                t_delta = clock.monotonic()
                packed, new_shadow = self._delta_fn(
                    new_params, self._shadow,
                    prng.fold_in(self._relay_key, self.version + 1))
                delta_buf = packed.cpu().numpy()
                delta_s = clock.monotonic() - t_delta
            with self._lock:
                self.stats.apply_rounds += 1
                self.stats.apply_s_sum += apply_s
                self.stats.decode_count += decodes
                self.params, self.opt_state = new_params, new_opt
                self._shadow = new_shadow
                self.version += 1
                self.stats.updates += 1
                if delta_buf is not None:
                    self.stats.delta_s_sum += delta_s
                    self._deltas[self.version] = delta_buf
                    for old in [v for v in self._deltas
                                if v <= self.version - self.down_window]:
                        del self._deltas[old]
        return True


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
        self.params: Optional[list] = None
        self.version = -1
        self.base_version = -1

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
                          else float(loss))))
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
                 kill_threshold: Optional[float], health, registry):
        self.server = server
        self.workers = workers
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
    """
    from ewdml_tpu_torch.core.world import resolve_device

    if adapt_cfg is not None:
        _unsupported("--adapt")
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
                        prng.key(0))
    if server_agg == "homomorphic":
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
                             health=health, seed=seed)
    shared_compress = make_compress_tree(compressor)
    payload_template = (grads0 if shared_compress is None
                        else shared_compress(grads0, prng.key(0)))
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
                    registry=registry)
