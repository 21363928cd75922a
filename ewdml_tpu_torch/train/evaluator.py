"""The polling evaluator (``ewdml_tpu/train/evaluator.py``; reference
``src/distributed_evaluator.py``).

A process of its own that watches ``--train-dir`` for the checkpoint,
evaluates it on the test set and logs it. It re-evaluates only when the
file changes (its mtime), and, as the reference built only the model, it
builds the model and the optimizer's initial state for the restore
template and no trainer.

    python -m ewdml_tpu_torch.train.evaluator --network LeNet \\
        --dataset mnist10k --train-dir output/models/ --max-polls 1

runs on the GPU unless ``--platform cpu`` is given; every evaluation prints
one ``validation {json}`` line. Under ``--metrics-port`` (0 = ephemeral) it
serves its registry (``obs/serve.py``) and prints
``EVALUATOR_METRICS <port>`` first.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

import torch

from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.core.world import resolve_device
from ewdml_tpu_torch.models import build_model, num_classes_for
from ewdml_tpu_torch.models.convert import leaf_specs
from ewdml_tpu_torch.obs import serve as oserve
from ewdml_tpu_torch.obs import trace as otrace
from ewdml_tpu_torch.obs.registry import MetricsRegistry
from ewdml_tpu_torch.optim import make_optimizer
from ewdml_tpu_torch.train import checkpoint
from ewdml_tpu_torch.train.loop import run_eval
from ewdml_tpu_torch.train.state import (WorkerState, leaf_params,
                                         load_state_tree, state_tree)

logger = logging.getLogger("ewdml_tpu_torch.evaluator")


class DistributedEvaluator:
    """Evaluate the checkpoints of ``cfg.train_dir`` on ``device`` (CUDA
    unless ``cfg.platform`` or ``device`` asks for the CPU; a CUDA
    evaluator without a GPU raises)."""

    def __init__(self, cfg: TrainConfig, device=None):
        self.cfg = cfg
        otrace.configure(cfg.trace_dir, role="evaluator")
        otrace.maybe_configure_from_env(role="evaluator")
        self.metrics = MetricsRegistry()
        self.device = resolve_device(cfg.platform, device)
        self.model = build_model(cfg.network, num_classes_for(cfg.dataset),
                                 dataset=cfg.dataset,
                                 seed=cfg.seed).to(self.device)
        self.specs = leaf_specs(self.model)
        # The restore template: one worker's state as the model and the
        # optimizer's init give it (no train step is built).
        policy = cfg.precision
        optimizer = make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum,
                                   cfg.weight_decay, cfg.nesterov,
                                   state_dtype=policy.state_dtype)
        ef = cfg.error_feedback and cfg.compression_enabled
        residual = ([torch.zeros(s.jax_shape, dtype=policy.wire_dtype,
                                 device=self.device)
                     for s in self.specs] if ef else [])
        self._worker = WorkerState(
            self.model, optimizer.init(leaf_params(self.model, self.specs)),
            residual)
        self._template = state_tree([self._worker], self.specs)
        # The live metrics endpoint of --metrics-port; armed last, so a
        # constructor that raises leaves no thread behind.
        self.live = oserve.Live(cfg.metrics_port, self.metrics, "evaluator")

    def close(self) -> None:
        """Stop the live metrics endpoint (idempotent)."""
        self.live.close()

    def evaluate_once(self, path: str) -> dict:
        """Restore the checkpoint at ``path`` into the model and evaluate
        it (traced as ``evaluator/evaluate``)."""
        with otrace.span("evaluator/evaluate", path=path):
            tree, step, _ = checkpoint.restore(path, self._template)
            load_state_tree([self._worker], tree, self.specs)
            result = run_eval(self.model, self.cfg, self.device,
                              registry=self.metrics)
        return dict(result, step=step)

    def evaluate(self, interval_s: float = 10.0, max_polls: int | None = None):
        """The poll loop (reference ``:72-87``): yields one result per
        changed checkpoint, sleeping ``interval_s`` between polls that
        found nothing new; ``max_polls`` bounds the polls."""
        last_mtime = None
        polls = 0
        while max_polls is None or polls < max_polls:
            polls += 1
            otrace.instant("evaluator/poll", poll=polls)
            self.metrics.counter("eval.polls").inc()
            path = checkpoint.latest_path(self.cfg.train_dir)
            if path is not None:
                mtime = os.path.getmtime(path)
                if mtime != last_mtime:
                    last_mtime = mtime
                    result = self.evaluate_once(path)
                    logger.info("validation at %s (step %d): loss %.4f, "
                                "top1 %.4f, top5 %.4f", path, result["step"],
                                result["loss"], result["top1"],
                                result["top5"])
                    # Flushed per evaluation: a killed poller still leaves
                    # its finished spans in the shard.
                    otrace.flush()
                    yield result
                    continue
            time.sleep(interval_s)


def main(argv=None) -> int:
    """``evaluate_pytorch.sh``'s counterpart (reference
    ``distributed_evaluator.py:112-141``): the trainer's flags, plus
    ``--eval-interval`` and ``--max-polls``."""
    import argparse
    import dataclasses

    from ewdml_tpu_torch.core.config import add_fit_args

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="polling evaluator")
    add_fit_args(parser)
    parser.add_argument("--eval-interval", type=float, default=10.0)
    parser.add_argument("--max-polls", type=int, default=None)
    ns = parser.parse_args(argv)
    fields = {f.name: getattr(ns, f.name)
              for f in dataclasses.fields(TrainConfig) if hasattr(ns, f.name)}
    fields["metrics_port"] = oserve.env_port(fields.get("metrics_port"))
    ev = DistributedEvaluator(TrainConfig(**fields))
    if ev.live.port:
        # Scrape-port discovery: an ephemeral port is known only here.
        print(f"EVALUATOR_METRICS {ev.live.port}", flush=True)
    try:
        for result in ev.evaluate(interval_s=ns.eval_interval,
                                  max_polls=ns.max_polls):
            print("validation " + json.dumps(result), flush=True)
    finally:
        ev.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
