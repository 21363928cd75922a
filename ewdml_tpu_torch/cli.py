"""CLI entry (``ewdml_tpu/cli.py``): the sync trainer, the async
parameter server and the federated rounds.

    python -m ewdml_tpu_torch.cli --network VGG11 --dataset Cifar10 \\
        --synthetic-data --num-workers 4 --method 5 --topk-ratio 0.01 \\
        --max-steps 5
    python -m ewdml_tpu_torch.cli --mode async --compress-grad qsgd \\
        --server-agg homomorphic --network LeNet --dataset mnist10k \\
        --num-workers 4 --num-aggregate 2 --max-steps 16

run on the GPU (``--platform cpu`` runs on the CPU). The flags are the JAX
package's. ``--federated`` runs sampled-cohort rounds of local SGD against
the in-process parameter server (``federated/``):

    python -m ewdml_tpu_torch.cli --federated --network LeNet \\
        --dataset mnist10k --server-agg homomorphic --compress-grad qsgd \\
        --pool-size 64 --cohort 8 --local-steps 5 --fed-rounds 20 \\
        --partition dirichlet --partition-alpha 0.1

and prints a ``federated done: ...`` line and an ``eval: ...`` line (on a
model with BatchNorm the eval raises, as in the JAX package: ROADMAP Queue
3 item 21). ``--round-pipeline overlap`` keeps two rounds open,
``--round-pipeline async`` admits stale deltas down-weighted (both with
``--server-agg homomorphic``). ``--feed device`` keeps the
training split on the device, and ``--scan-window K`` (auto under
``--feed device``) then runs K steps per host launch, one CUDA graph a
window on the GPU:

    python -m ewdml_tpu_torch.cli --network VGG11 --dataset Cifar10 \\
        --synthetic-data --num-workers 4 --method 4 --feed device \\
        --scan-window 8 --max-steps 24

A sync run saves a checkpoint every ``--eval-freq`` steps and at the end
into ``--train-dir``, and resumes from the one it finds there; the polling
evaluator (``python -m ewdml_tpu_torch.train.evaluator``, same flags)
evaluates it from a second process. ``--trace-dir`` writes a trace shard,
``--profile-dir`` a ``torch.profiler`` Chrome trace.

``--health warn|abort`` watches the run's loss (``obs/health.py``): an
aborted run prints ``HEALTH_ABORT kind=... step=...`` and exits 76 on both
paths.

``python -m ewdml_tpu_torch.cli repro --table baseline`` runs the paper's
published table (``experiments/``), as ``python -m
ewdml_tpu_torch.experiments`` does. ``python -m ewdml_tpu_torch.cli obs
{report,export,rounds} <trace-dir>`` reads a trace directory back: the
merged report, the Perfetto JSON, the rounds' critical paths
(``obs/report.py``). ``python -m ewdml_tpu_torch.cli lint`` runs the
static analysis pass over the package (``analysis/``; exit 0 clean, 1
findings). ``--metrics-port`` (0 = ephemeral) serves a sync run's
registry live and prints ``TRAINER_METRICS <port>``; the async and
federated paths refuse it (the JAX CLI accepts it there and serves
nothing).

The sync trainer runs across OS processes (``parallel/launcher.py``),
``--num-workers`` being the global count; the coordinator prints the
summary and evaluates:

    torchrun --nproc-per-node 2 -m ewdml_tpu_torch.cli --platform cpu \\
        --network LeNet --dataset mnist10k --num-workers 4 --method 4
"""

from __future__ import annotations

import logging
import os
import sys

from ewdml_tpu_torch.core.config import from_args
from ewdml_tpu_torch.obs import serve as oserve
from ewdml_tpu_torch.obs.health import (HEALTH_EXIT_CODE, HealthAbort,
                                        make_watchdog)
from ewdml_tpu_torch.parallel import launcher
from ewdml_tpu_torch.train.loop import Trainer


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["repro"]:
        # The resumable published-table sweep, one subcommand off the
        # trainer's entry point (as in the JAX package's cli.py).
        from ewdml_tpu_torch.experiments.__main__ import main as repro_main

        return repro_main(argv[1:])
    if argv[:1] == ["lint"]:
        # The repo-invariant static analysis pass (analysis/): the ten
        # rules against the committed shrink-only baseline; exit 0 clean,
        # 1 findings, 2 usage error.
        from ewdml_tpu_torch.analysis.cli import main as lint_main

        return lint_main(argv[1:])
    if argv[:1] == ["obs"]:
        # The trace tools over a --trace-dir (obs/report.py): the merged
        # report, the Perfetto export and the round critical paths.
        from ewdml_tpu_torch.obs.report import main as obs_main

        return obs_main(argv[1:])
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    cfg = from_args(argv)
    if cfg.federated:
        return _main_federated(cfg)
    if cfg.mode == "async":
        return _main_async(cfg)
    cfg.metrics_port = oserve.env_port(cfg.metrics_port)
    # A process of a torchrun (or RANK/WORLD_SIZE) cluster joins it here;
    # with no such environment this is a no-op.
    launcher.initialize(platform=cfg.platform)
    try:
        return _main_sync(cfg)
    finally:
        launcher.shutdown()


def _main_sync(cfg) -> int:
    """The sync trainer: train, then print the summary and evaluate worker
    0's model (on the coordinator of a multi-process world)."""
    trainer = Trainer(cfg)
    if trainer.live.port:
        # Scrape-port discovery: an ephemeral port is known only here.
        print(f"TRAINER_METRICS {trainer.live.port}", flush=True)
    try:
        trainer.maybe_restore()
        try:
            result = trainer.train()
        except HealthAbort as e:
            return _health_abort(e)
        if not launcher.is_coordinator():
            return 0
        print(
            f"done: steps={result.steps} loss={result.final_loss:.4f} "
            f"top1={result.final_top1:.4f} "
            f"step_time={result.mean_step_s * 1e3:.2f}ms "
            f"wire_per_step={result.wire.per_step_bytes / 1e6:.4f}MB"
        )
        ev = trainer.evaluate()
        print(f"eval: loss={ev['loss']:.4f} top1={ev['top1']:.4f} "
              f"top5={ev['top5']:.4f}")
    finally:
        trainer.close()
    return 0


def _health_abort(e: HealthAbort) -> int:
    """The watchdog's abort verdict as the exit status a supervisor
    journals as a retryable event."""
    print(f"HEALTH_ABORT kind={e.kind} step={e.step}", flush=True)
    return HEALTH_EXIT_CODE


def run_async(cfg, registry=None):
    """The ``--mode async`` run of a config: ``(params, PSStats)``, the
    parameters in the JAX tree's leaf order and layout, profiled under
    ``--profile-dir``. ``registry`` (an ``obs.registry.MetricsRegistry``)
    absorbs the server's run totals and its straggler policy's snapshot at
    the end, and holds the watchdog's counters under ``--health``. A
    ``--health abort`` verdict raises ``HealthAbort``."""
    from ewdml_tpu_torch.core.world import resolve_device
    from ewdml_tpu_torch.train.loop import profiled

    # build_async checks the flags before it resolves the device.
    device = resolve_device(cfg.platform) if cfg.profile_dir else None
    with profiled(cfg.profile_dir, device):
        return build_async(cfg, registry).run()


def build_async(cfg, registry=None):
    """The ``--mode async`` run of a config, built and not started: a
    ``parallel.ps.AsyncRun`` whose ``run()`` is :func:`run_async`'s result
    and whose ``server`` and ``workers`` stay open after it."""
    from ewdml_tpu_torch.core.world import default_num_workers, resolve_device
    from ewdml_tpu_torch.data import datasets, loader
    from ewdml_tpu_torch.models import build_model, num_classes_for
    from ewdml_tpu_torch.obs import trace as otrace
    from ewdml_tpu_torch.ops import kernels, make_compressor
    from ewdml_tpu_torch.optim import make_optimizer
    from ewdml_tpu_torch.parallel.ps import build_async_ps
    from ewdml_tpu_torch.train.trainer import check_supported

    check_supported(cfg, async_path=True)
    device = resolve_device(cfg.platform)
    # The server and its worker threads share this process's shard; each
    # worker thread records under its own role.
    role = os.environ.get("EWDML_TRACE_ROLE") or "ps-server"
    if cfg.trace_dir:
        otrace.configure(cfg.trace_dir, role=role)
    else:
        otrace.maybe_configure_from_env(role=role)
    if cfg.pallas != "auto":
        kernels.configure(cfg.pallas)
    model = build_model(cfg.network, num_classes_for(cfg.dataset),
                        dataset=cfg.dataset, seed=cfg.seed)
    comp = (make_compressor(cfg.compress_grad, cfg.quantum_num,
                            cfg.topk_ratio, cfg.topk_exact, cfg.qsgd_block)
            if cfg.compression_enabled else None)
    ds = datasets.load(cfg.dataset, cfg.data_dir, train=True,
                       synthetic=cfg.synthetic_data, seed=cfg.seed,
                       synthetic_size=cfg.synthetic_size)

    def factory(worker_index):
        # Async workers consume host-normalized f32, as in the JAX package.
        return loader.global_batches(ds, cfg.batch_size, 1,
                                     seed=cfg.seed + worker_index,
                                     feed="f32")

    num_workers = cfg.num_workers or default_num_workers(device)
    return build_async_ps(
        model, make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum,
                              cfg.weight_decay, cfg.nesterov,
                              state_dtype=cfg.precision.state_dtype),
        factory, num_workers=num_workers,
        steps_per_worker=max(1, cfg.max_steps // num_workers),
        # --num-aggregate 0 means "all workers" (distributed_nn.py:58).
        compressor=comp, num_aggregate=cfg.num_aggregate or num_workers,
        kill_threshold=(cfg.kill_threshold if cfg.kill_threshold > 0
                        else None),
        max_staleness=(cfg.max_staleness if cfg.max_staleness > 0
                       else None),
        fault_spec=cfg.fault_spec,
        # The weights-down relay reproduces the reference's negative
        # result and is not the M4/M5 presets' gradient relay.
        relay_compress=False, down_mode=cfg.ps_down,
        bootstrap=cfg.ps_bootstrap, precision=cfg.precision_policy,
        server_agg=cfg.server_agg, seed=cfg.seed, device=device,
        # The server-side controller (adapt/) decides at version
        # boundaries and re-registers the push schema.
        adapt_cfg=cfg if cfg.adapt != "off" else None,
        # Every push's loss the server keeps is observed.
        health=make_watchdog(cfg, role="ps-server", registry=registry),
        debug_nans=cfg.debug_nans, registry=registry)


def _main_federated(cfg) -> int:
    """``--federated``: the sampled-cohort round loop in process
    (``ewdml_tpu/cli.py:84-113``)."""
    from ewdml_tpu_torch.federated import run_federated
    from ewdml_tpu_torch.federated.loop import evaluate_params
    from ewdml_tpu_torch.train.metrics import federated_wire_plan
    from ewdml_tpu_torch.train.trainer import _reject, unserved_metrics_row

    _reject([unserved_metrics_row(cfg, "the federated CLI")])
    res = run_federated(cfg)
    stats = res.stats
    plan = federated_wire_plan(cfg, res.params)
    print(
        f"federated done: rounds={res.rounds} pool={cfg.pool_size} "
        f"cohort={cfg.cohort} partition={cfg.partition} "
        f"skew={res.skew:.3f} final_loss={res.final_loss:.4f} "
        f"decodes={stats.decode_count}/{stats.apply_rounds} rounds "
        f"(flat server cost) dropouts={res.dropouts} "
        f"resampled={res.resampled} rejected={res.rejected} "
        f"up={stats.bytes_up / 1e6:.2f}MB down={stats.bytes_down / 1e6:.2f}MB "
        f"planned_up/round={plan.up_bytes_round / 1e6:.2f}MB", flush=True
    )
    ev = evaluate_params(cfg, res.params)
    print(f"eval: loss={ev['loss']:.4f} top1={ev['top1']:.4f}")
    return 0


def _main_async(cfg) -> int:
    """``--mode async``: the in-process asynchronous parameter server."""
    try:
        _, stats = run_async(cfg)
    except HealthAbort as e:
        return _health_abort(e)
    print(
        f"async done: pushes={stats.pushes} updates={stats.updates} "
        f"stale_dropped={stats.dropped_stale} stragglers={stats.dropped_straggler} "
        f"crashes={stats.worker_crashes} kills={stats.kills_sent} "
        f"excluded={sorted(stats.excluded_workers)} "
        f"mean_staleness={stats.mean_staleness:.2f} "
        f"loss_tail10={stats.loss_tail_mean(10):.4f} "
        f"up={stats.bytes_up / 1e6:.2f}MB down={stats.bytes_down / 1e6:.2f}MB"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
