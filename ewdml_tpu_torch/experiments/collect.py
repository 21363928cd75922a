"""Run one cell and derive the table's metrics
(``ewdml_tpu/experiments/collect.py``).

The five metric families of the published table, each from an existing
instrument:

- **comm MB/iter**: the analytic wire plan (``train/metrics.wire_plan``)
  times the workers (the reference counted both workers' both
  directions).
- **top-1**: the full-test-set evaluator (``train/loop.run_eval``).
- **comm/comp split** of the step time (``StepTimer`` totals). Compute and
  exchange run in one step body, so there is no exchange call to time
  alone. Two attributions, and the row says which it got
  (``comm_split_source``):

  * ``measured`` (``comm_min``/``comp_min``), under ``--trace-dir``:
    interleaved timed windows of the real step and of a clone of the same
    step body whose exchange never runs (``sync_every`` pushed to 10^9:
    the same compute, optimizer and feed); the per-step difference is the
    exchange's share (:func:`_comm_split_measured`).
  * ``bytes_est`` (``comm_min_est``/``comp_min_est``) otherwise: wire bytes
    over the bytes one step moves (``train/flops.count_bytes``: every aten
    op's operands and results, plus what each hand-written kernel reads and
    writes). Not comparable with the JAX package's estimate, which XLA
    counts after fusion.
- **end-to-end time**: the cell's wall clock.
- **epochs to converge**: the accuracy-target oracle (train epoch by
  epoch, evaluate, record the first epoch at the published target).

Runs in the cell's child process, or in process for a caller that drives
cells itself (``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os

import numpy as np

from ewdml_tpu_torch.obs import clock

logger = logging.getLogger("ewdml_tpu_torch.experiments")


def _load_epoch_evals(path: str | None, start_epoch: int) -> list:
    """A resumed cell's persisted per-epoch evals, keeping only the epochs
    the restored checkpoint covers (a later entry describes training the
    crash threw away)."""
    if not path or not os.path.isfile(path):
        return []
    try:
        with open(path) as f:
            evals = json.load(f)
    except (OSError, json.JSONDecodeError):
        return []
    return [e for e in evals if e.get("epoch", 10**9) <= start_epoch]


def _save_epoch_evals(path: str | None, evals: list) -> None:
    if not path:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(evals, f)
    os.replace(tmp, path)  # atomic, like the checkpoints


def _probe_args(trainer, cfg) -> tuple:
    """``(images, labels)`` on the trainer's device for a step probe: the
    device-resident split under ``--feed device``, else one global batch
    (the probe times shapes, not data)."""
    from ewdml_tpu_torch.data import loader

    ds = trainer._train_split()
    if cfg.feed == "device":
        return trainer._device_split(ds)
    images, labels = next(loader.global_batches(
        ds, cfg.batch_size, trainer.world.size, seed=cfg.seed, feed=cfg.feed))
    return trainer._to_device(images, labels)


def _comm_split_measured(trainer, cfg, step_total_s: float, windows: int = 3):
    """The measured comm/comp attribution of the step.

    A second step is built from the same step body on a clone config with
    ``sync_every=10**9``: compute, optimizer and feed are the same, only
    the exchange never runs. Full and exchange-free windows alternate
    (``utils/timing.timed_window``, each ending in a read of the metrics,
    which waits for the device), so drift hits both; the gap of the
    medians is the exchange's share of a step, which scales the run's
    ``step_s`` total. Under Method 6 a window is one sync period, so each
    full window holds one exchange and adoption, as training did.

    The probe trains on in place (the step updates the state); the caller
    takes the final eval before it. It runs per step on the current
    stream, never on a window's capture stream. Returns ``(comm_s, comp_s,
    frac, detail)``, or None when the probe cannot run (an instrument,
    never fatal)."""
    from ewdml_tpu_torch.obs import trace as otrace
    from ewdml_tpu_torch.train.trainer import make_train_step
    from ewdml_tpu_torch.utils import timing

    try:
        with otrace.span("collect/comm_probe", cell=cfg.network):
            # method=None: replace() re-runs __post_init__, and a method
            # would re-apply its preset over the clone's sync_every.
            cfg2 = dataclasses.replace(cfg, sync_every=10**9, method=None)
            augment = (trainer._train_split().augment
                       if cfg.feed == "device" else None)
            # An adaptive run's probe mirrors the live step: the current
            # planned compressor and the moments output, so only the
            # exchange differs between the two arms.
            noexc_step = make_train_step(
                trainer.model, trainer.optimizer, cfg2, trainer.world,
                device_augment=augment,
                compressor=trainer._step_compressor,
                with_moments=trainer._adapt is not None)
            images, labels = _probe_args(trainer, cfg)
            key = trainer.base_key
            iters = cfg.sync_every if cfg.sync_every > 1 else 4
            last = {}

            def stepper(fn):
                def step():
                    last["m"] = fn(trainer.state, images, labels, key)
                return step

            def block():
                m = last["m"]  # (metrics, moments) when adaptive
                (m[0] if isinstance(m, tuple) else m).cpu()  # waits

            full, noexc = stepper(trainer.train_step), stepper(noexc_step)
            full()
            block()
            noexc()   # warm both steps outside the windows
            block()
            full_samples, noexc_samples = [], []
            for _ in range(windows):  # interleaved: drift hits both arms
                full_samples.append(timing.timed_window(full, block, iters))
                noexc_samples.append(timing.timed_window(noexc, block, iters))
            full_ms = float(np.median(full_samples))
            noexc_ms = float(np.median(noexc_samples))
            if full_ms <= 0:
                return None
            frac = min(1.0, max(0.0, 1.0 - noexc_ms / full_ms))
            comm_s = step_total_s * frac
            detail = {
                "full_step_ms": round(full_ms, 4),
                "noexchange_step_ms": round(noexc_ms, 4),
                "windows": windows, "iters": iters,
                "full_samples_ms": [round(s, 4) for s in full_samples],
                "noexchange_samples_ms": [round(s, 4)
                                          for s in noexc_samples],
            }
            return comm_s, step_total_s - comm_s, frac, detail
    except Exception as e:  # the measured split is best-effort
        logger.warning("measured comm/comp split unavailable (%s); falling "
                       "back to the bytes-proportional estimate", e,
                       exc_info=True)
        return None


def _comm_split_est(trainer, cfg, step_total_s: float):
    """Bytes-proportional comm/comp attribution of the step.

    ``frac = wire bytes (all workers) / bytes one step moves``
    (``flops.count_bytes`` over one per-step dispatch, windowed cells
    included: the share is per step either way). The counted step trains
    on in place, after the final eval. Returns ``(comm_s, comp_s, frac)``,
    all None when nothing was counted."""
    from ewdml_tpu_torch.train import flops as F

    try:
        images, labels = _probe_args(trainer, cfg)
        cost_bytes = F.count_bytes(trainer.train_step, trainer.state, images,
                                   labels, trainer.base_key)
    except Exception as e:  # the estimate is best-effort
        logger.warning("comm/comp attribution unavailable (%s)", e,
                       exc_info=True)
        return None, None, None
    if cost_bytes <= 0:
        return None, None, None
    wire_all_workers = trainer.wire.per_step_bytes * trainer.world.size
    frac = min(1.0, wire_all_workers / cost_bytes)
    comm = step_total_s * frac
    return comm, step_total_s - comm, frac


def _run_federated_cell(cfg, device=None, evaluate: bool = True) -> dict:
    """One ``federated`` table cell (``collect.py:211-267``):
    ``cfg.fed_rounds`` sampled-cohort rounds in process on ``device``, and
    the row: convergence (the last pushed loss, held-out top-1), the flat
    server cost (``decode_count`` against ``apply_rounds``), the analytic
    round pricing (``train.metrics.federated_wire_plan``) beside the
    measured bytes, and the churn (dropouts, resamples, quota drops). The
    run's registry is the row's ``obs_metrics``."""
    from ewdml_tpu_torch.federated import run_federated
    from ewdml_tpu_torch.federated.loop import evaluate_params
    from ewdml_tpu_torch.obs.registry import MetricsRegistry
    from ewdml_tpu_torch.train.metrics import federated_wire_plan
    from ewdml_tpu_torch.utils.provenance import hardware_provenance

    t_wall = clock.monotonic()
    registry = MetricsRegistry()
    res = run_federated(cfg, device=device, registry=registry)
    stats = res.stats
    plan = federated_wire_plan(cfg, res.params)
    row = {
        "mode": "federated",
        "rounds": res.rounds,
        "pool_size": cfg.pool_size,
        "cohort": cfg.cohort,
        "accept": cfg.num_aggregate or cfg.cohort,
        "local_steps": cfg.local_steps,
        "partition": cfg.partition,
        "partition_alpha": cfg.partition_alpha,
        "skew": round(res.skew, 4),
        "final_loss": round(res.final_loss, 4),
        "round_losses": [round(l, 4) for l in res.round_losses],
        "decode_count": stats.decode_count,
        "apply_rounds": stats.apply_rounds,
        "apply_ms_mean": round(stats.apply_ms_mean, 3),
        "dropouts": res.dropouts,
        "resampled": res.resampled,
        "quota_dropped": res.coordinator["quota_dropped"],
        "fed_rejected": stats.fed_rejected,
        "bytes_up_mb": round(stats.bytes_up / 1e6, 4),
        "bytes_down_mb": round(stats.bytes_down / 1e6, 4),
        "planned_up_mb_round": round(plan.up_bytes_round / 1e6, 4),
        "planned_down_mb_round": round(plan.down_bytes_round / 1e6, 4),
        "planned_delta_down_mb_round": round(
            plan.pull_delta_down_bytes_round / 1e6, 4),
        "planned_down_compression": round(plan.down_compression, 3),
        "planned_server_decodes": plan.server_decodes,
        "round_wall_ms_mean": round(
            1e3 * sum(res.round_walls_s) / max(1, len(res.round_walls_s)),
            2),
        "wall_s": round(clock.monotonic() - t_wall, 3),
        "data_source": res.data_source,
        "obs_metrics": registry.snapshot(),
        # "hardware", as the port's other rows (the JAX row says
        # "provenance"): the report's provenance block reads it.
        "hardware": hardware_provenance(mesh_devices=1),
    }
    if evaluate:
        ev = evaluate_params(cfg, res.params, device=device)
        row["top1"] = round(ev["top1"], 4)
        row["eval_loss"] = round(ev["loss"], 4)
    return row


def run_cell(cfg, *, device=None, evaluate: bool = True,
             target_top1: float | None = None,
             max_epochs: int | None = None, per_epoch_eval: bool = False,
             budget_epochs: int | None = None,
             crash_at: int | None = None, resume: bool = True) -> dict:
    """Train one cell config (resuming from its checkpoint if there is one)
    on ``device`` (``Trainer(cfg, device=...)``: CUDA unless the caller
    asks for the CPU) and return the derived metrics as one JSON-able
    dict.

    ``target_top1`` arms the epochs-to-target oracle: train one epoch at a
    time, evaluate, record the first epoch at the target (capped at
    ``max_epochs``, default the config's epochs). With ``per_epoch_eval``
    training stops at ``budget_epochs`` (the published budget) once the
    target is met and goes on up to ``max_epochs`` while it is not.
    ``crash_at`` is the fault harness's hook (``crash@CELL=N``): train to
    step N, leaving only what the checkpoint cadence wrote, then raise
    :class:`~ewdml_tpu_torch.parallel.faults.FaultCrash`."""
    from ewdml_tpu_torch.obs import trace as otrace
    from ewdml_tpu_torch.train.loop import Trainer
    from ewdml_tpu_torch.utils.provenance import hardware_provenance

    if cfg.federated:
        # The sampled-cohort round loop, not the sync trainer: its budget
        # is rounds, and none of the epoch or target machinery applies.
        return _run_federated_cell(cfg, device=device, evaluate=evaluate)
    t_wall = clock.monotonic()
    trainer = Trainer(cfg, device=device)
    if resume:
        trainer.maybe_restore()
    start_step = trainer.state.step
    ds = trainer._train_split()
    spe = max(1, len(ds) // (cfg.batch_size * trainer.world.size))

    if crash_at is not None:
        from ewdml_tpu_torch.parallel.faults import FaultCrash

        # An abrupt death leaves no checkpoint at the crash step, only what
        # the cadence wrote: train to the last cadence point (which
        # saves), run the tail with checkpoints off (no end-of-train
        # save), and die. The retry resumes from the cadence point and
        # trains the lost tail again.
        ef = cfg.eval_freq
        last_cadence = (crash_at // ef) * ef if ef else 0
        if ef and last_cadence > start_step:
            trainer.train(max_steps=last_cadence)
        cfg.eval_freq = 0
        try:
            trainer.train(max_steps=crash_at)
        finally:
            cfg.eval_freq = ef
        raise FaultCrash(worker=0, step=crash_at)

    epochs_to_target = None
    epoch_evals = []
    last_ev = None
    timing = {}
    if target_top1 is not None or per_epoch_eval:
        cap = max_epochs or cfg.epochs
        budget = min(budget_epochs or cap, cap)
        start_epoch = start_step // spe
        # The per-epoch evals persist beside the cell's checkpoints, so the
        # oracle survives a retry: without them a resumed attempt would
        # report the first epoch after the resume that met the target.
        evals_path = (os.path.join(cfg.train_dir, "epoch_evals.json")
                      if resume and cfg.train_dir else None)
        epoch_evals = _load_epoch_evals(evals_path, start_epoch)
        if (evals_path and start_epoch > 0 and start_step % spe == 0
                and not any(e["epoch"] == start_epoch
                            for e in epoch_evals)):
            # A kill between an epoch's checkpoint and its eval: the
            # restored state is that epoch's end state, so evaluate it now
            # (only at an exact epoch boundary).
            ev = trainer.evaluate()
            last_ev = ev
            epoch_evals.append(
                {"epoch": start_epoch, "top1": round(ev["top1"], 4)})
            _save_epoch_evals(evals_path, epoch_evals)
            logger.info("resume: filled missing epoch-%d eval "
                        "(top1=%.4f)", start_epoch, ev["top1"])
        result = None
        # Each train() call has its own StepTimer: the totals are summed
        # over the epoch loop.
        totals = {"compile_s": 0.0, "data_s": 0.0, "step_s": 0.0,
                  "steps": 0}
        for epoch in range(start_epoch + 1, cap + 1):
            result = trainer.train(max_steps=epoch * spe)
            for k in totals:
                totals[k] += (result.timing or {}).get(k, 0)
            ev = trainer.evaluate()
            last_ev = ev
            epoch_evals.append(
                {"epoch": epoch, "top1": round(ev["top1"], 4)})
            _save_epoch_evals(evals_path, epoch_evals)
            logger.info("cell epoch %d/%d: test top1=%.4f",
                        epoch, cap, ev["top1"])
            target_met = (target_top1 is None
                          or any(e["top1"] >= target_top1
                                 for e in epoch_evals))
            if target_top1 is not None and not per_epoch_eval and target_met:
                break   # oracle-only callers stop at the target
            if per_epoch_eval and epoch >= budget and target_met:
                # The budget is covered and the oracle has its number; the
                # headroom is only for targets the budget did not reach.
                break
        if target_top1 is not None:
            epochs_to_target = next(
                (e["epoch"] for e in
                 sorted(epoch_evals, key=lambda d: d["epoch"])
                 if e["top1"] >= target_top1), None)
        if result is None:  # the restored checkpoint covered the budget
            result = trainer.train()
            totals = dict(result.timing or {})
            totals.setdefault("steps", 0)
        timing = {k: round(v, 4) if isinstance(v, float) else v
                  for k, v in totals.items()}
        timing["mean_step_ms"] = round(
            totals.get("step_s", 0.0) / max(1, totals.get("steps", 0))
            * 1e3, 4)
        # Nothing trained since the loop's last eval: reuse it.
        final_eval = (last_ev if last_ev is not None
                      else trainer.evaluate()) if evaluate else None
        epochs_trained = max(start_epoch,
                             max((e["epoch"] for e in epoch_evals),
                                 default=start_epoch))
    else:
        result = trainer.train()
        timing = result.timing or {}
        final_eval = trainer.evaluate() if evaluate else None
        epochs_trained = result.steps // spe

    wall_s = clock.monotonic() - t_wall
    wire = trainer.wire
    world = trainer.world.size
    step_total_s = timing.get("step_s", result.mean_step_s * result.steps)
    # Measured under a trace, the bytes estimate otherwise; both after the
    # final eval, since the probes train on.
    comm_s = comp_s = comm_frac = probe_detail = None
    split_source = None
    if cfg.trace_dir or otrace.enabled():
        measured = _comm_split_measured(trainer, cfg, step_total_s)
        if measured is not None:
            comm_s, comp_s, comm_frac, probe_detail = measured
            split_source = "measured"
            # Handed to the trainer: a later decision of this trainer
            # (a continued epoch) reads the measured share instead of the
            # bytes estimate (``collect.py:435-444`` sets a global gauge).
            trainer.note_comm_frac(comm_frac, source="measured")
    if comm_s is None:
        comm_s, comp_s, comm_frac = _comm_split_est(trainer, cfg,
                                                    step_total_s)
        if comm_s is not None:
            split_source = "bytes_est"

    metrics = {
        # The reference's accounting: every worker's both directions per
        # iteration (M6 averaged over its sync period; adoption excluded).
        "comm_mb_per_iter": round(wire.per_step_bytes * world / 1e6, 4),
        # Per-rank interconnect bytes under the resolved transport.
        "exchange_mb_per_rank_iter": round(
            wire.per_rank_exchange_bytes / 1e6, 4),
        "transport": wire.transport,
        "end_to_end_min": round(wall_s / 60.0, 4),
    }
    if final_eval is not None:
        metrics["top1_pct"] = round(final_eval["top1"] * 100.0, 2)
    if comm_s is not None:
        if split_source == "measured":
            metrics["comm_min"] = round(comm_s / 60.0, 4)
            metrics["comp_min"] = round(comp_s / 60.0, 4)
        else:
            metrics["comm_min_est"] = round(comm_s / 60.0, 4)
            metrics["comp_min_est"] = round(comp_s / 60.0, 4)
    if target_top1 is not None:
        metrics["epochs_to_converge"] = epochs_to_target

    adapt_block = None
    if cfg.adapt != "off":
        # The decision provenance for the report: the journaled ledger is
        # the source of truth, summarized (``collect.py:479-512``).
        from ewdml_tpu_torch.adapt.ledger import read_decisions
        from ewdml_tpu_torch.adapt.runtime import resolve_ledger_path

        path = resolve_ledger_path(cfg)
        decs = read_decisions(path)
        adapt_block = {
            "mode": cfg.adapt,
            "ledger": path,
            "decisions": len(decs),
            "switches": sum(1 for d in decs if d.get("switched")),
            "windows": [{
                "step": d.get("step"),
                "plan_version": d.get("plan_version"),
                "switched": d.get("switched"),
                "trigger": d.get("trigger"),
                "bytes_per_sync": d.get("bytes_per_sync"),
                "comm_frac": (d.get("signals") or {}).get("comm_frac"),
                "methods": {m: sum(1 for u in (d.get("plan") or {})
                                   .get("decisions", [])
                                   if u.get("method") == m)
                            for m in ("dense", "qsgd", "topk_qsgd")},
            } for d in decs],
        }

    ws = trainer.window_step
    row = {
        "steps": result.steps,
        "resumed_from_step": start_step,
        "steps_per_epoch": spe,
        "epochs_trained": epochs_trained,
        "world": world,
        "final_loss": None if np.isnan(result.final_loss)
        else round(result.final_loss, 4),
        "train_top1": None if np.isnan(result.final_top1)
        else round(result.final_top1, 4),
        "mean_step_ms": timing.get("mean_step_ms",
                                   round(result.mean_step_s * 1e3, 3)),
        "timing": timing,
        "wall_s": round(wall_s, 3),
        "wire_mb_per_step_worker": round(wire.per_step_bytes / 1e6, 4),
        "wire_dtype": wire.wire_dtype,
        "bytes_reduction_vs_dense": round(
            wire.dense_bytes / max(1.0, wire.per_step_bytes), 1),
        "dataset": cfg.dataset,
        "data_source": ds.source,
        "eval": ({k: round(v, 4) if isinstance(v, float) else v
                  for k, v in final_eval.items()}
                 if final_eval is not None else None),
        "epoch_evals": epoch_evals,
        "epochs_to_target": epochs_to_target,
        "target_top1": target_top1,
        "comm_split_source": split_source,
        "overlap": cfg.overlap,
        "overlap_buckets": len(wire.per_bucket_bytes),
        "predicted_overlap_frac": (
            None if (pof := wire.predicted_overlap_frac(comm_frac)) is None
            else round(pof, 4)),
        "comm_frac": None if comm_frac is None else round(comm_frac, 4),
        "comm_frac_est": (round(comm_frac, 4)
                          if split_source == "bytes_est" else None),
        "comm_split_probe": probe_detail,
        "adapt": adapt_block,
        # The scan window's graphs (--feed device): one capture per window
        # phase a cell, however many epochs call train().
        "window": None if ws is None else {
            "k": ws.window, "captures": ws.captures, "replays": ws.replays,
            "eager_windows": ws.eager_windows,
            "capture_s": round(ws.capture_s, 4)},
        "metrics": metrics,
        # This trainer's registry: this cell's counters and histograms.
        "obs_metrics": trainer.metrics.snapshot(),
        "hardware": hardware_provenance(mesh_devices=world),
    }
    return row
