"""The training loop (``ewdml_tpu/train/loop.py``, the sync path).

Builds the world, model, optimizer and state from a config, streams the
global batches, runs steps, and logs per-worker loss / top-1 with the
analytic wire bytes. Checkpointing, the polling evaluator, adaptive
compression and observability are later slices.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.core.world import (LocalWorld, default_num_workers,
                                        resolve_device)
from ewdml_tpu_torch.data import datasets, loader
from ewdml_tpu_torch.models import build_model, num_classes_for
from ewdml_tpu_torch.models.convert import flax_to_torch, leaf_specs
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.optim import make_optimizer
from ewdml_tpu_torch.train import metrics as M
from ewdml_tpu_torch.train.state import make_train_state
from ewdml_tpu_torch.train.trainer import check_supported, make_train_step
from ewdml_tpu_torch.utils import prng

logger = logging.getLogger("ewdml_tpu_torch")


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


class Trainer:
    """Build everything from a config and run the loop.

    ``device`` overrides ``cfg.platform``; a run runs on CUDA unless the
    caller asks for the CPU, and a CUDA run without a GPU raises."""

    def __init__(self, cfg: TrainConfig, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.platform, device)
        if cfg.pallas != "auto":
            kernels.configure(cfg.pallas)
        self.world = LocalWorld(cfg.num_workers or default_num_workers(self.device),
                                self.device)
        self.model = build_model(cfg.network, num_classes_for(cfg.dataset),
                                 dataset=cfg.dataset, seed=cfg.seed)
        self.specs = leaf_specs(self.model)
        self.optimizer = make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum,
                                        cfg.weight_decay, cfg.nesterov)
        self._stabilize_ef_quantizer()
        self.state = make_train_state(
            self.model, self.optimizer, self.world.size, self.device,
            error_feedback=cfg.error_feedback and cfg.compression_enabled)
        self.train_step = make_train_step(self.model, self.optimizer, cfg,
                                          self.world)
        self.wire = M.wire_plan(cfg, [(s.name, s.jax_shape) for s in self.specs],
                                world=self.world.size)
        self.base_key = prng.key(cfg.seed)
        self._train_ds = None
        if cfg.compression_enabled:
            logger.info("compressor=%s s=%d block=%s topk_ratio=%s "
                        "wire=%.4f MB/step/worker", cfg.compress_grad,
                        cfg.quantum_num, cfg.qsgd_block, cfg.topk_ratio,
                        self.wire.per_step_bytes / 1e6)

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
        sd = flax_to_torch(self.model, params, batch_stats)
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

    def _to_device(self, images: np.ndarray, labels: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(images))
        y = torch.from_numpy(np.ascontiguousarray(labels))
        if self.device.type == "cuda":
            x, y = x.pin_memory(), y.pin_memory()
        return (x.to(self.device, non_blocking=True),
                y.to(self.device, non_blocking=True))

    def train(self, max_steps: Optional[int] = None) -> TrainResult:
        cfg = self.cfg
        steps_target = max_steps or cfg.max_steps
        start_step = self.state.step
        ds = self._train_split()
        steps_per_epoch = max(1, len(ds) // (cfg.batch_size * self.world.size))
        steps_target = min(steps_target, cfg.epochs * steps_per_epoch)
        timer = M.StepTimer()
        history = []
        last = (float("nan"), float("nan"))
        batches = loader.global_batches(ds, cfg.batch_size, self.world.size,
                                        seed=cfg.seed + start_step,
                                        feed=cfg.feed)
        window_t0, window_n = None, 0
        for step in range(start_step, steps_target):
            timer.tic()
            x, y = self._to_device(*next(batches))
            timer.toc_data()
            if window_t0 is None:
                window_t0 = time.perf_counter()
                data_mark = timer.data_s
            step_metrics = self.train_step(self.state, x, y, self.base_key)
            window_n += 1
            first = step == start_step
            due_log = step % cfg.log_every == 0
            if not (first or due_log or step == steps_target - 1):
                continue
            m = step_metrics.cpu().numpy()  # [W, 3]; waits for the device
            elapsed = time.perf_counter() - window_t0 - (timer.data_s - data_mark)
            if first:
                timer.compile_s += elapsed
            else:
                timer.add_window(elapsed, window_n)
            window_t0, window_n = None, 0
            last = (float(m[:, 0].mean()), float(m[:, 1].mean()))
            if due_log:
                cum_mb = self.wire.per_step_bytes * (step + 1) / 1e6
                total = max(1, self.wire.total_bytes)
                for rank in range(m.shape[0]):
                    M.log_step(rank + 1, step, float(m[rank, 0]),
                               timer.mean_step_s,
                               cum_mb * self.wire.up_bytes / total,
                               cum_mb * self.wire.down_bytes / total,
                               float(m[rank, 1]))
                history.append((step, last[0], last[1]))
        return TrainResult(steps=steps_target, final_loss=last[0],
                           final_top1=last[1], mean_step_s=timer.mean_step_s,
                           compile_s=timer.compile_s, wire=self.wire,
                           history=history, timing=timer.as_dict())

    @torch.no_grad()
    def evaluate(self, synthetic: Optional[bool] = None) -> dict:
        """Full-test-set metrics of worker 0's model (the checkpointed view)."""
        cfg = self.cfg
        model = self.state.workers[0].model
        ds = datasets.load(cfg.dataset, cfg.data_dir, train=False,
                           synthetic=cfg.synthetic_data if synthetic is None
                           else synthetic, seed=cfg.seed)
        total, loss_sum, top1_sum, top5_sum = 0, 0.0, 0.0, 0.0
        for images, labels, mask in loader.eval_batches(ds, cfg.test_batch_size):
            x, y = self._to_device(images, labels)
            logits = model(x, train=False).float()
            logp = torch.log_softmax(logits, dim=-1)
            y = y.long()
            loss = -logp.gather(1, y[:, None])[:, 0]
            order = torch.argsort(-logits, dim=1, stable=True)
            top1 = (order[:, 0] == y).float()
            top5 = (order[:, :5] == y[:, None]).any(dim=1).float()
            m = torch.from_numpy(mask.astype(np.float32)).to(self.device)
            loss_sum += float((loss * m).sum())
            top1_sum += float((top1 * m).sum())
            top5_sum += float((top5 * m).sum())
            total += int(mask.sum())
        return {"loss": loss_sum / total, "top1": top1_sum / total,
                "top5": top5_sum / total, "examples": total}
