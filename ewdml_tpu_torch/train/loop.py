"""The training loop (``ewdml_tpu/train/loop.py``, the sync path).

Builds the world, model, optimizer and state from a config, streams the
global batches (or, under ``--feed device``, uploads the split once), runs
steps one host dispatch at a time or K per launch (``--scan-window``), and
logs per-worker loss / top-1 with the analytic wire bytes.

- Checkpoints: every ``--eval-freq`` steps into ``--train-dir`` (under a
  scan window, at the end of the window holding the due step) and once at
  the end (``train/checkpoint.py``); :meth:`Trainer.maybe_restore` resumes
  from the latest one, in place, so a CUDA graph captured before replays
  on the restored state. After a resume the streaming feed is re-seeded
  with ``seed + start step``; the device feed derives its batches from the
  step.
- Observability: ``--trace-dir`` records the JAX package's spans
  (``train/dispatch``, ``train/compile``, ``train/window``,
  ``train/checkpoint``, ``eval/full_test``; ``obs/trace.py``),
  ``--metrics-port`` serves the trainer's registry live (``obs/serve.py``;
  :meth:`Trainer.close` stops it),
  ``--profile-dir`` runs ``torch.profiler`` around the steps and writes a
  Chrome trace, and ``--debug-nans`` raises ``FloatingPointError`` at the
  first step (or window) whose loss, gradients or parameters are not
  finite.
- Adaptive compression: under ``--adapt variance|replay`` the step returns
  its per-leaf moments, every ``--adapt-every`` steps (replay: at the
  journaled steps) the loop fences and ``adapt/`` decides, and a switched
  plan takes the step of its key (built once per plan) from step + 1 on
  (``loop.py:147-204,310-358,623-717``).
- Run health: ``--health warn|abort`` observes the mean loss at every read
  point (a window fence) with the watchdog of ``obs/health.py``; under
  ``abort`` a non-finite or spiking loss raises ``HealthAbort`` there. A
  ``nan@0=N`` fault clause poisons the loss observed at the fence covering
  step N, never the training state.
- :func:`run_eval` is the full-test evaluation of one model, shared with
  the polling evaluator (``train/evaluator.py``).
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import logging
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ewdml_tpu_torch.core.config import TrainConfig, resolve_scan_window
from ewdml_tpu_torch.core.world import (build_world, place_global,
                                        resolve_device)
from ewdml_tpu_torch.data import datasets, loader
from ewdml_tpu_torch.models import build_model, convert, num_classes_for
from ewdml_tpu_torch.obs import clock
from ewdml_tpu_torch.obs import health as ohealth
from ewdml_tpu_torch.obs import serve as oserve
from ewdml_tpu_torch.obs import trace as otrace
from ewdml_tpu_torch.obs.registry import MetricsRegistry
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.optim import make_optimizer
from ewdml_tpu_torch.parallel import launcher
from ewdml_tpu_torch.parallel.faults import FaultSpec
from ewdml_tpu_torch.train import checkpoint, flops
from ewdml_tpu_torch.train import metrics as M
from ewdml_tpu_torch.train.state import (leaf_params, load_state_tree,
                                         make_train_state, state_template,
                                         state_tree)
from ewdml_tpu_torch.train.trainer import (check_supported, make_train_step,
                                           make_window_step)
from ewdml_tpu_torch.utils import prng

logger = logging.getLogger("ewdml_tpu_torch")

#: The trainer's stall deadline (s), as in the JAX package: a kernel build
#: at first use (~30 s on the card) or a window's graph capture (~6 s on
#: ResNet50) falls well inside it. Fences heartbeat.
HEALTH_STALL_DEADLINE_S = 600.0


@dataclass
class TrainResult:
    steps: int
    final_loss: float
    final_top1: float
    mean_step_s: float
    compile_s: float
    wire: M.WirePlan
    history: list = field(default_factory=list)
    timing: dict = field(default_factory=dict)
    #: Every step's per-worker metrics, ``[steps, W, 3]`` (loss, top-1,
    #: top-5), read back at the loop's read points.
    rows: Optional[np.ndarray] = None


class Trainer:
    """Build everything from a config and run the loop.

    ``device`` overrides ``cfg.platform``; a run runs on CUDA unless the
    caller asks for the CPU, and a CUDA run without a GPU raises."""

    def __init__(self, cfg: TrainConfig, device=None):
        check_supported(cfg)
        self.cfg = cfg
        # A sweep parent's EWDML_TRACE_ROLE wins over the plain "trainer".
        role = os.environ.get("EWDML_TRACE_ROLE") or "trainer"
        if cfg.trace_dir:
            otrace.configure(cfg.trace_dir, role=role)
        else:
            otrace.maybe_configure_from_env(role=role)
        self._tracing = otrace.enabled()
        #: This trainer's counters and histograms (``obs/registry.py``).
        self.metrics = MetricsRegistry()
        # The run-health watchdog (None under --health off). Its stall
        # deadline runs only inside train(): between runs no progress is
        # expected. A nan@0=N clause poisons the observed fence loss.
        self._health = ohealth.make_watchdog(
            cfg, role=role, stall_deadline_s=HEALTH_STALL_DEADLINE_S,
            registry=self.metrics)
        self._health_faults = None
        self._health_mark = -1
        if self._health is not None:
            self._health.set_idle(True)
            self._health_faults = FaultSpec.parse(cfg.fault_spec) \
                .for_worker(0)
        self.device = resolve_device(cfg.platform, device)
        if cfg.pallas != "auto":
            kernels.configure(cfg.pallas)
        # --num-slices S: the two-level (dcn, data) world (loop.py:114-116);
        # in a torch.distributed cluster this process's part of it.
        self.world = build_world(cfg.num_workers, cfg.num_slices, self.device)
        self.model = build_model(cfg.network, num_classes_for(cfg.dataset),
                                 dataset=cfg.dataset, seed=cfg.seed)
        self.specs = convert.leaf_specs(self.model)
        # The precision policy (core/precision.py): the optimizer state's
        # storage here, the dense wire and the EF residuals' dtype below.
        # Weights stay f32 under every policy.
        policy = cfg.precision
        self.optimizer = make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum,
                                        cfg.weight_decay, cfg.nesterov,
                                        state_dtype=policy.state_dtype)
        # Adaptive compression (adapt/): per-layer transport units only (a
        # fused bucket cannot carry per-unit decisions), so 'auto' fusion
        # resolves to 'none' before the unit sizes are derived.
        self._adapt = None
        self._step_compressor = None   # the PlannedCompressor when adaptive
        self._comm_frac = None
        self._comm_frac_source = None
        self._comm_frac_stale = True
        if cfg.adapt != "off":
            self._init_adapt()
        self._stabilize_ef_quantizer()
        self.state = make_train_state(
            self.model, self.optimizer, len(self.world.ranks), self.device,
            error_feedback=cfg.error_feedback and cfg.compression_enabled,
            residual_dtype=policy.wire_dtype)
        if policy.name != "f32":
            logger.info(
                "precision policy %s: dense wire + EF residual %s, "
                "optimizer state %s, weights f32 (Method-2 invariant)",
                policy.name, str(policy.wire_dtype).replace("torch.", ""),
                str(policy.state_dtype).replace("torch.", ""))
        self._train_ds = None
        # The device feed augments as the loaded split says (a synthetic
        # split never does), as the streaming feeds do.
        device_augment = (self._train_split().augment
                          if cfg.feed == "device" else None)
        self._device_augment = device_augment
        self.train_step = make_train_step(self.model, self.optimizer, cfg,
                                          self.world,
                                          device_augment=device_augment,
                                          compressor=self._step_compressor,
                                          with_moments=self._adapt
                                          is not None)
        # The plan-keyed step cache: a controller revisiting an earlier
        # decision set reuses its step.
        self._adapt_steps = ({self._adapt.plan.key(): self.train_step}
                             if self._adapt is not None else {})
        # K steps per host launch (--scan-window; 1 for the streaming feeds).
        self.scan_window = resolve_scan_window(cfg)
        self.window_step = None
        if self.scan_window > 1:
            self.window_step = make_window_step(
                self.model, self.optimizer, cfg, self.world, self.scan_window,
                device_augment=device_augment)
            logger.info("scan window: %d steps per host launch (%s)",
                        self.scan_window, self.window_step.mode)
        self._device_arrays = None
        self.wire = M.wire_plan(cfg, [(s.name, s.jax_shape) for s in self.specs],
                                world=self.world.size,
                                compressor=self._step_compressor)
        self.base_key = prng.key(cfg.seed)
        if cfg.compression_enabled:
            logger.info("compressor=%s s=%d block=%s topk_ratio=%s "
                        "wire=%.4f MB/step/worker", cfg.compress_grad,
                        cfg.quantum_num, cfg.qsgd_block, cfg.topk_ratio,
                        self.wire.per_step_bytes / 1e6)
        # The live metrics endpoint of --metrics-port (obs/serve; unset:
        # no thread, no socket), on this trainer's registry. Armed last,
        # so a constructor that raises leaves no thread behind.
        self.live = oserve.Live(cfg.metrics_port, self.metrics, role)
        if self.live.port:
            logger.info("live metrics on http://127.0.0.1:%d/metrics "
                        "(role %s)", self.live.port, role)

    def close(self) -> None:
        """Stop the live metrics endpoint (idempotent)."""
        self.live.close()

    def _init_adapt(self) -> None:
        """The adaptive runtime (``loop.py:147-178``): per-layer units, the
        ledger beside the checkpoints, the initial plan's compressor."""
        from ewdml_tpu_torch.adapt import AdaptRuntime, validate_config
        from ewdml_tpu_torch.adapt.plan import unit_names_and_sizes
        from ewdml_tpu_torch.core.config import resolve_fusion

        cfg = self.cfg
        validate_config(cfg, surface="trainer")
        if resolve_fusion(cfg, len(self.specs)) != "none":
            if cfg.fusion not in ("auto", "none"):
                raise ValueError("--adapt needs per-layer transport units; "
                                 f"drop --fusion {cfg.fusion}")
            logger.info("adapt: forcing --fusion none (per-layer transport "
                        "units carry the per-unit decisions)")
            cfg.fusion = "none"
        names, sizes = unit_names_and_sizes(self.specs)
        self._adapt = AdaptRuntime(cfg, names, sizes, surface="trainer",
                                   registry=self.metrics)
        self._step_compressor = self._adapt.compressor()
        logger.info("adapt mode=%s: %d units, budget %.4f MB/sync, ledger %s",
                    cfg.adapt, len(sizes), self._adapt.budget_bytes / 1e6,
                    self._adapt.ledger_path)

    def _apply_plan(self, plan) -> None:
        """Switch the step to ``plan`` (``loop.py:310-331``): the planned
        compressor changes, the step is built (or taken from the plan-keyed
        cache), and the wire plan is derived again, so the bytes always
        describe the transport in use."""
        cfg = self.cfg
        self._step_compressor = self._adapt.compressor(plan)
        fn = self._adapt_steps.get(plan.key())
        if fn is None:
            fn = make_train_step(self.model, self.optimizer, cfg, self.world,
                                 device_augment=self._device_augment,
                                 compressor=self._step_compressor,
                                 with_moments=True)
            self._adapt_steps[plan.key()] = fn
        self.train_step = fn
        self.wire = M.wire_plan(cfg, [(s.name, s.jax_shape)
                                      for s in self.specs],
                                world=self.world.size,
                                compressor=self._step_compressor)
        self._comm_frac_stale = True  # a new step, a new bytes split
        logger.info("adapt: switched to plan v%d at step %d (%s; wire %.4f "
                    "MB/step/worker)", plan.version, plan.step,
                    plan.method_counts(), self.wire.per_step_bytes / 1e6)

    def note_comm_frac(self, frac: Optional[float],
                       source: str = "measured") -> None:
        """Hand the trainer a comm/comp ratio (a measured probe's,
        ``experiments/collect``): later decisions read it instead of the
        bytes-proportional estimate."""
        self._comm_frac = None if frac is None else round(float(frac), 6)
        self._comm_frac_source = source

    def _adapt_comm_frac(self, images, labels) -> Optional[float]:
        """The comm/comp ratio a decision reads (``loop.py:333-358``): a
        measured one handed in by :meth:`note_comm_frac`, else the
        bytes-proportional estimate (wire bytes of all workers over the
        bytes one step moves, ``flops.count_bytes``), counted once per
        plan on a copy of the state, so training is untouched (the copy's
        kernel launches count like any other)."""
        if self._comm_frac_source == "measured" or not self._comm_frac_stale:
            return self._comm_frac
        self._comm_frac_stale = False
        cost = flops.count_bytes(self.train_step, copy.deepcopy(self.state),
                                 images, labels, self.base_key)
        if cost > 0:
            self.note_comm_frac(min(1.0, self.wire.per_step_bytes
                                    * self.world.size / cost),
                                source="bytes_est")
        return self._comm_frac

    def _stabilize_ef_quantizer(self) -> None:
        """Blockwise QSGD norms when error feedback would otherwise diverge
        (per-tensor norms are expansive for n > s^2; ``loop.py:277``)."""
        from ewdml_tpu_torch.core.config import resolved_unit_sizes
        from ewdml_tpu_torch.ops.topk import static_k

        cfg = self.cfg
        name = (cfg.compress_grad or "").lower()
        if (not cfg.error_feedback or cfg.qsgd_block is not None
                or name not in
                ("compress", "qsgd", "topk_qsgd", "topk-qsgd", "method5")):
            return
        ns = resolved_unit_sizes(cfg, [int(np.prod(s.jax_shape))
                                       for s in self.specs])
        if "topk" in name or name == "method5":
            ns = [static_k(n, cfg.topk_ratio) for n in ns]
        if max(ns) > cfg.quantum_num ** 2:
            cfg.qsgd_block = 4096
            logger.warning(
                "error feedback with a per-tensor QSGD norm is unstable at "
                "this scale (largest quantized vector %d > s^2 = %d); "
                "enabling blockwise norms (--qsgd-block 4096)",
                max(ns), cfg.quantum_num ** 2)

    def load_flax_state(self, params: dict, batch_stats: dict | None = None):
        """Start every worker from Flax ``params``/``batch_stats`` (numpy
        nested dicts), e.g. the JAX trainer's initial state."""
        sd = convert.flax_to_torch(self.model, params, batch_stats)
        for ws in self.state.workers:
            ws.model.load_state_dict(sd)

    def _train_split(self):
        if self._train_ds is None:
            cfg = self.cfg
            self._train_ds = datasets.load(
                cfg.dataset, cfg.data_dir, train=True,
                synthetic=cfg.synthetic_data, seed=cfg.seed,
                synthetic_size=cfg.synthetic_size)
        return self._train_ds

    def _device_split(self, ds):
        """The whole split on the device for ``--feed device`` (uint8 where
        the dataset has raw pixels, else f32; int32 labels), uploaded once
        per Trainer."""
        if self._device_arrays is None:
            x_all = ds.raw if ds.raw is not None else ds.images
            self._device_arrays = self._to_device(x_all,
                                                  ds.labels.astype(np.int32))
            logger.info("device-resident feed: %d examples uploaded once "
                        "(%.1f MB %s + labels)", len(ds), x_all.nbytes / 1e6,
                        x_all.dtype)
        return self._device_arrays

    def _to_device(self, images: np.ndarray, labels: np.ndarray):
        return to_device(images, labels, self.device)

    # -- checkpoints -------------------------------------------------------
    @property
    def _divergent_state(self) -> bool:
        """Whether the workers' states can differ: Method 6's local phases,
        error-feedback residuals, or per-replica BatchNorm statistics. Only
        then is a checkpoint written full (``[W, ...]``); otherwise worker 0's
        collapsed view loses nothing."""
        cfg = self.cfg
        return (cfg.sync_every > 1
                or (cfg.error_feedback and cfg.compression_enabled)
                or any(True for _ in self.model.buffers()))

    def _save_ckpt(self, step: int) -> None:
        """Write the checkpoint of ``step``. In a multi-process world a full
        one gathers every process's workers first (a collective: every
        process reaches this line, the step budget and ``--eval-freq``
        being the same on all), and only the coordinator writes, the bytes
        of the emulated run's (``loop.py:443-466``)."""
        with otrace.span("train/checkpoint", step=step), \
                self._ranged("train/checkpoint"):
            full = self._divergent_state
            coordinator = launcher.is_coordinator()
            if full:
                gather = self.world.gather_rows
                tree = state_tree(self.state.workers, self.specs,
                                  leaf=lambda ts: gather(torch.stack(ts)))
            elif coordinator:
                # Worker 0's view, which the coordinator holds.
                tree = state_tree(self.state.workers, self.specs)
            if coordinator:
                checkpoint.save(self.cfg.train_dir, tree, step,
                                world=self.world.size if full else 0)

    def maybe_restore(self) -> bool:
        """Resume from the latest checkpoint in ``--train-dir`` if there is
        one (``ewdml_tpu/train/loop.py:378``).

        The template is the full ``[W, ...]`` tree, so a full checkpoint
        restores every worker's own state and a collapsed one is broadcast
        to all. The values are copied into the state's existing tensors.
        A blob of at most one worker's view restored onto W > 1 workers
        with error feedback restarts the residuals at zero: the blob held
        at most worker 0's, and broadcasting it would apply rank 0's
        untransmitted mass W times."""
        path = checkpoint.latest_path(self.cfg.train_dir)
        if path is None:
            return False
        workers = self.state.workers
        # Every process reads the blob and takes its own workers' rows.
        tree, step, blob_world = checkpoint.restore(
            path, state_template(workers, self.specs, stacked=True,
                                 size=self.world.size))
        load_state_tree(workers, tree, self.specs, stacked=True,
                        rows=self.world.ranks)
        if blob_world <= 1 < self.world.size:
            with torch.no_grad():
                for ws in workers:
                    for res in ws.residual:
                        res.zero_()
        self.state.step = step
        logger.info("restored checkpoint %s at step %d (world=%d)", path,
                    step, blob_world)
        return True

    # -- profiling and --debug-nans ---------------------------------------
    def _ranged(self, name: str):
        """A ``torch.profiler`` range named as the trace span, while
        ``--profile-dir`` profiles this run."""
        if self.cfg.profile_dir:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _check_finite(self, first: int, last: int, metrics) -> None:
        """``--debug-nans``: raise ``FloatingPointError`` if a loss of steps
        ``first``..``last`` (``metrics`` ``[.., W, 3]``), or a gradient or
        parameter after step ``last``, is not finite; the message names
        the step, the worker and the leaf (its Flax path)."""
        w_n = self.world.size
        losses = metrics.reshape(-1, w_n, 3)[..., 0]
        named, flags = [], [torch.isfinite(losses).reshape(-1)]
        params = [leaf_params(ws.model, self.specs)
                  for ws in self.state.workers]
        for kind in ("gradient", "parameter"):
            for r, ps in zip(self.world.ranks, params):
                for p, s in zip(ps, self.specs):
                    t = p.grad if kind == "gradient" else p
                    if t is not None:
                        named.append((kind, s.name, r))
                        flags.append(torch.isfinite(t).all().reshape(1))
        ok = torch.cat(flags).cpu()
        if bool(ok.all()):
            return
        bad = int((~ok).nonzero()[0, 0])
        if bad < losses.numel():
            j, r = divmod(bad, w_n)
            raise FloatingPointError(
                f"--debug-nans: non-finite loss at step {first + j} "
                f"(worker {r})")
        kind, name, r = named[bad - losses.numel()]
        where = (f"step {last}" if first == last else
                 f"step {last}, the end of the window of steps "
                 f"{first}-{last}")
        raise FloatingPointError(f"--debug-nans: non-finite {kind} {name} "
                                 f"after {where} (worker {r})")

    # -- the loop ----------------------------------------------------------
    def train(self, max_steps: Optional[int] = None) -> TrainResult:
        cfg = self.cfg
        steps_target = max_steps or cfg.max_steps
        start_step = self.state.step
        ds = self._train_split()
        steps_per_epoch = max(1, len(ds) // (cfg.batch_size * self.world.size))
        steps_target = min(steps_target, cfg.epochs * steps_per_epoch)
        timer = M.StepTimer()
        history, rows = [], []
        nan = float("nan")
        if start_step >= steps_target:
            # A restored checkpoint covers the whole budget: nothing to
            # train, and the checkpoint is not overwritten.
            logger.info("restored step %d >= target %d; nothing to do",
                        start_step, steps_target)
            return TrainResult(steps=start_step, final_loss=nan,
                               final_top1=nan, mean_step_s=0.0, compile_s=0.0,
                               wire=self.wire, history=history,
                               timing=timer.as_dict())
        ws = self.window_step
        if self._health is not None:
            # Arm the stall deadline. The fence mark starts at the resume
            # step: a restored run does not re-poison steps it trained past.
            self._health_mark = start_step - 1
            self._health.set_idle(False)
        with profiled(cfg.profile_dir, self.device), self._health_armed():
            if ws is not None:  # --feed device, K > 1
                if ws.stream is not None:
                    ws.stream.wait_stream(
                        torch.cuda.current_stream(self.device))
                try:
                    with ws.stream_context():
                        last = self._run_windows(start_step, steps_target,
                                                 self._device_split(ds),
                                                 timer, history, rows)
                finally:  # also when a health abort ends the run
                    if ws.stream is not None:
                        torch.cuda.current_stream(self.device).wait_stream(
                            ws.stream)
            else:
                if cfg.feed == "device":
                    batches = itertools.repeat(self._device_split(ds))
                else:
                    # Re-seeded by the start step on a resume: a fresh
                    # shuffle, not a replay of the interrupted epoch.
                    # Each process takes its rows of the global batch.
                    batches = ((place_global(self.world, x),
                                place_global(self.world, y))
                               for x, y in loader.global_batches(
                                   ds, cfg.batch_size, self.world.size,
                                   seed=cfg.seed + start_step, feed=cfg.feed))
                last = self._run_steps(start_step, steps_target, batches,
                                       timer, history, rows)
        if cfg.eval_freq:
            self._save_ckpt(steps_target)
        timing = timer.as_dict()
        self.metrics.absorb_step_timer(timing)
        if self._tracing:
            otrace.flush()
        return TrainResult(steps=steps_target, final_loss=last[0],
                           final_top1=last[1], mean_step_s=timer.mean_step_s,
                           compile_s=timer.compile_s, wire=self.wire,
                           history=history, timing=timing,
                           rows=np.concatenate(rows) if rows else None)

    @contextlib.contextmanager
    def _health_armed(self):
        """Suspends the stall deadline again when the steps end."""
        try:
            yield
        finally:
            if self._health is not None:
                self._health.set_idle(True)

    def _observe_health(self, fence_step: int, mean_loss: float) -> None:
        """One watchdog observation per read point: the fence's mean loss,
        NaN when a ``nan@0=N`` clause covers a step since the last fence."""
        if self._health is None:
            return
        mark, self._health_mark = self._health_mark, fence_step
        loss = mean_loss
        if self._health_faults is not None and any(
                self._health_faults.nan_due(s)
                for s in range(mark + 1, fence_step + 1)):
            loss = float("nan")
        self._health.observe_loss(fence_step, loss)

    def _log_row(self, step: int, m: np.ndarray, timer) -> None:
        """The per-worker log lines of one due step (``m`` is ``[W, 3]``),
        from the coordinator of a multi-process world."""
        if not launcher.is_coordinator():
            return
        cum_mb = self.wire.per_step_bytes * (step + 1) / 1e6
        total = max(1, self.wire.total_bytes)
        for rank in range(m.shape[0]):
            M.log_step(rank + 1, step, float(m[rank, 0]), timer.mean_step_s,
                       cum_mb * self.wire.up_bytes / total,
                       cum_mb * self.wire.down_bytes / total,
                       float(m[rank, 1]))

    def _run_steps(self, start_step, steps_target, batches, timer, history,
                   rows):
        """One host dispatch per step; metrics are read back (which waits
        for the device) only at the first, due-log, due-checkpoint and last
        steps, the steps between with them."""
        cfg = self.cfg
        tracing = self._tracing
        adapt = self._adapt
        if adapt is not None and start_step > 0:
            # A resumed run adopts the plan in force at the restored step
            # before anything is dispatched.
            plan = adapt.fast_forward(start_step)
            if plan is not None:
                self._apply_plan(plan)
        last = (float("nan"), float("nan"))
        window_t0, window_n, pending = None, 0, []
        moments = None
        for step in range(start_step, steps_target):
            timer.tic()
            x, y = next(batches)
            timer.toc_data()
            if window_t0 is None:
                window_t0 = clock.monotonic()
                data_mark = timer.data_s
            if tracing:
                otrace.instant("train/dispatch", step=step)
            with self._ranged("train/dispatch"):
                metrics = self.train_step(self.state, x, y, self.base_key)
            if adapt is not None:
                metrics, moments = metrics
            if cfg.debug_nans:
                self._check_finite(step, step, metrics)
            pending.append(metrics)
            window_n += 1
            first = step == start_step
            due_log = step % cfg.log_every == 0
            due_ckpt = cfg.eval_freq and (step + 1) % cfg.eval_freq == 0
            # A decision boundary fences the loop: the controller sees the
            # boundary step's moments before the next step is dispatched,
            # and a switched plan takes effect exactly at step + 1.
            due_adapt = adapt is not None and adapt.due(step + 1)
            if not (first or due_log or due_ckpt or due_adapt
                    or step == steps_target - 1):
                continue
            rows.append(torch.stack(pending).cpu().numpy())  # waits
            pending = []
            m = rows[-1][-1]  # [W, 3]
            raw = clock.monotonic() - window_t0
            elapsed = raw - (timer.data_s - data_mark)
            if tracing:
                # Recorded after the fence, outside the timed region.
                otrace.complete("train/compile" if first else "train/window",
                                int(window_t0 * 1e9), int(raw * 1e9),
                                steps=window_n, step_s=round(elapsed, 6))
            if first:
                timer.compile_s += elapsed
            else:
                timer.add_window(elapsed, window_n)
            window_t0, window_n = None, 0
            last = (float(m[:, 0].mean()), float(m[:, 1].mean()))
            self._observe_health(step, last[0])
            if due_log:
                self._log_row(step, m, timer)
                history.append((step, last[0], last[1]))
            if due_ckpt:
                self._save_ckpt(step + 1)
            if due_adapt:
                # Replay reads no ratio: its decisions are the ledger's.
                new_plan = adapt.on_window(
                    step + 1, moments.cpu().numpy(),
                    comm_frac=(self._adapt_comm_frac(x, y)
                               if adapt.mode == "variance" else None))
                if new_plan is not None:
                    self._apply_plan(new_plan)
        return last

    def _run_windows(self, start_step, steps_target, split, timer, history,
                     rows):
        """One host launch per K steps (``--scan-window``; the reference's
        ``_run_windows``, ``loop.py:731``). Windows are launched without
        waiting, and the metrics (``[K, W, 3]`` per window) are read back
        only at log and checkpoint points, after at most ``read_period``
        steps, and at the end; every due step's row is logged, and a
        checkpoint snaps to the end of the window holding its due step. A
        tail shorter than K runs as per-step dispatches. The first group is
        the warm-up window and counts as compile time, as do the graph
        captures."""
        cfg = self.cfg
        tracing = self._tracing
        k_win = self.scan_window
        data, labels = split
        last = (float("nan"), float("nan"))
        read_period = max(k_win, min(cfg.log_every, 32))
        pending, group_t0, first = [], None, True
        step = start_step
        while step < steps_target:
            k = min(k_win, steps_target - step)
            if group_t0 is None:
                group_t0 = clock.monotonic()
                capture_mark = self.window_step.capture_s
            if k == k_win:
                if tracing:
                    otrace.instant("train/dispatch", step=step, steps=k)
                with self._ranged("train/dispatch"):
                    stacked = self.window_step(self.state, data, labels,
                                               self.base_key)
            else:
                tail = []
                for j in range(k):
                    if tracing:
                        otrace.instant("train/dispatch", step=step + j)
                    with self._ranged("train/dispatch"):
                        tail.append(self.train_step(self.state, data, labels,
                                                    self.base_key))
                stacked = torch.stack(tail)
            if cfg.debug_nans:
                self._check_finite(step, step + k - 1, stacked)
            pending.append((step, k, stacked))
            step += k
            due_log = any(s % cfg.log_every == 0 for s in range(step - k, step))
            due_ckpt = cfg.eval_freq and any(
                (s + 1) % cfg.eval_freq == 0 for s in range(step - k, step))
            n_pending = sum(p[1] for p in pending)
            if not (first or due_log or due_ckpt or n_pending >= read_period
                    or step >= steps_target):
                continue
            mats = [(s0, st.cpu().numpy()) for s0, _, st in pending]
            elapsed = clock.monotonic() - group_t0
            captured = self.window_step.capture_s - capture_mark
            if tracing:
                otrace.complete("train/compile" if first else "train/window",
                                int(group_t0 * 1e9), int(elapsed * 1e9),
                                steps=n_pending, dispatches=len(pending),
                                step_s=round(elapsed - captured, 6))
            if first:
                timer.compile_s += elapsed
                first = False
            else:
                timer.compile_s += captured
                timer.add_window(elapsed - captured, n_pending)
            group_t0, pending = None, []
            rows += [m_all for _, m_all in mats]
            for s0, m_all in mats:
                for j in range(m_all.shape[0]):
                    if (s0 + j) % cfg.log_every:
                        continue
                    self._log_row(s0 + j, m_all[j], timer)
                    history.append((s0 + j, float(m_all[j, :, 0].mean()),
                                    float(m_all[j, :, 1].mean())))
            m_last = mats[-1][1][-1]
            last = (float(m_last[:, 0].mean()), float(m_last[:, 1].mean()))
            self._observe_health(step - 1, last[0])
            if due_ckpt:
                self._save_ckpt(step)  # snapped to the window's end
        return last

    def evaluate(self, synthetic: Optional[bool] = None) -> dict:
        """Full-test-set metrics of worker 0's model (the checkpointed
        view)."""
        return run_eval(self.state.workers[0].model, self.cfg, self.device,
                        synthetic=synthetic, registry=self.metrics)


@contextlib.contextmanager
def profiled(profile_dir: Optional[str], device):
    """``--profile-dir``: ``torch.profiler`` (CPU, and CUDA on the card)
    around the body, its Chrome trace written into ``profile_dir`` (the
    counterpart of ``jax.profiler.start_trace``); nothing without a
    directory."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir,
                        f"torch_trace_{os.getpid()}_{clock.wall_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("profile: %s", path)


def to_device(images: np.ndarray, labels: np.ndarray, device):
    """A host batch on ``device`` (through pinned memory on the card)."""
    x = torch.from_numpy(np.ascontiguousarray(images))
    y = torch.from_numpy(np.ascontiguousarray(labels))
    if device.type == "cuda":
        x, y = x.pin_memory(), y.pin_memory()
    return x.to(device, non_blocking=True), y.to(device, non_blocking=True)


@torch.no_grad()
def run_eval(model: torch.nn.Module, cfg: TrainConfig, device,
             synthetic: Optional[bool] = None,
             registry: Optional[MetricsRegistry] = None) -> dict:
    """Full-test-set loss, top-1 and top-5 of one model (reference
    ``_evaluate_model``, ``distributed_worker.py:365-390``), shared by
    :meth:`Trainer.evaluate` and the polling evaluator; traced as
    ``eval/full_test``, its wall observed as ``eval.full_test_s`` in
    ``registry``."""
    t_eval = clock.monotonic()
    with otrace.span("eval/full_test", dataset=cfg.dataset):
        ds = datasets.load(cfg.dataset, cfg.data_dir, train=False,
                           synthetic=cfg.synthetic_data if synthetic is None
                           else synthetic, seed=cfg.seed)
        total, loss_sum, top1_sum, top5_sum = 0, 0.0, 0.0, 0.0
        for images, labels, mask in loader.eval_batches(ds,
                                                        cfg.test_batch_size):
            x, y = to_device(images, labels, device)
            logits = model(x, train=False).float()
            logp = torch.log_softmax(logits, dim=-1)
            y = y.long()
            loss = -logp.gather(1, y[:, None])[:, 0]
            order = torch.argsort(-logits, dim=1, stable=True)
            top1 = (order[:, 0] == y).float()
            top5 = (order[:, :5] == y[:, None]).any(dim=1).float()
            m = torch.from_numpy(mask.astype(np.float32)).to(device)
            loss_sum += float((loss * m).sum())
            top1_sum += float((top1 * m).sum())
            top5_sum += float((top5 * m).sum())
            total += int(mask.sum())
    if registry is not None:
        registry.histogram("eval.full_test_s").observe(
            clock.monotonic() - t_eval)
    return {"loss": loss_sum / total, "top1": top1_sum / total,
            "top5": top5_sum / total, "examples": total}
