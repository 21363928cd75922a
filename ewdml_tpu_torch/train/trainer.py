"""The synchronous training step, Methods 1-6 (``ewdml_tpu/train/trainer.py:45-396``).

One step: every worker runs forward/backward on its shard of the global
batch; the gradients go through the exchange (dense pmean or the int8-wire
``fused_q`` ring; or the compressed collective over the gather, ``ring`` or
``ring_rs`` transport, with optional error feedback and K-of-N
acceptance); every worker applies SGD; under Method 6 the exchange runs only
at sync steps, which also adopt the lowest-loss worker's weights. On a
multi-slice world (``--num-slices > 1``) the compressed exchange is the
two-level ICI+DCN one, error feedback included; the dense mean and Method
6's adoption stay flat over all W workers.

The precision policy (``core/precision.py``) narrows the dense wire and the
error-feedback residuals to bf16 under ``bf16_wire`` and the optimizer
state too under ``bf16_wire_state``; every bf16 store is seeded stochastic
rounding (the residuals under a rank-folded key, the optimizer state under
a rank-shared one, so the synchronous replicas stay bit-identical).
``--overlap bucket`` exchanges size-balanced buckets, each issued on a side
CUDA stream while the last worker's backward still runs
(``parallel/overlap.py``). ``--lossy-weights-down`` reproduces the paper's
negative result: after every update each worker adopts the compressed and
decompressed weights.

Method dispatch (Final Report pp.4-6):
- M1 'weights' PS: dense grads up, weights down (dense data parallel).
- M2: compressed up, dense down (``relay=False``).
- M3: dense both ways.
- M4/M5: compressed both ways (the relay requantizes the average with a
  key shared by all ranks).
- M6: local SGD between syncs, compressed exchange + adoption at syncs.

The JAX package compiles this as one ``shard_map``-ed program; here it is
a plain Python step over the W workers of a :class:`LocalWorld` (or this
process's L of them in a ``core/world.ProcessWorld``, the metrics rows
gathered to all W), and it updates the state in place. Keys and the
per-rank dropout stream derive from the same chain as in the JAX package
(``utils/prng.py``). Under ``--feed device`` the step gathers its batches
from the device-resident split (``data/device_feed.py``), and
``make_window_step`` runs K steps per host launch (``train/window.py``;
one CUDA graph on the GPU). Under ``--adapt`` (``adapt/``) the step takes
the plan's per-unit compressor and also returns the per-leaf gradient
moments the controller folds.
"""

from __future__ import annotations

import contextlib
import logging

import torch
import torch.nn.functional as F

from ewdml_tpu_torch.core.config import (TrainConfig, resolve_fusion,
                                         validate_collective,
                                         validate_lossy_weights,
                                         validate_overlap,
                                         validate_server_agg)
from ewdml_tpu_torch.core.precision import resolve_policy, tree_store_round
from ewdml_tpu_torch.core.world import LocalWorld
from ewdml_tpu_torch.data import device_feed
from ewdml_tpu_torch.data.datasets import _SPECS
from ewdml_tpu_torch.models.convert import from_jax, leaf_specs, to_jax
from ewdml_tpu_torch.models.layers import Dropout
from ewdml_tpu_torch.ops import make_compressor
from ewdml_tpu_torch.ops.bytes import numel
from ewdml_tpu_torch.ops.none import NoneCompressor
from ewdml_tpu_torch.optim import update_accepts_key
from ewdml_tpu_torch.parallel import collectives
from ewdml_tpu_torch.parallel import overlap as ovl
from ewdml_tpu_torch.train.state import TrainState, leaf_params
from ewdml_tpu_torch.train.window import WindowStep
from ewdml_tpu_torch.utils import prng
from ewdml_tpu_torch.utils.keytable import HostKeys

#: Key tags of the JAX step (``trainer.py``): the relay (``:236``), the
#: optimizer's rank-shared bf16 stores (``:342``), the residuals'
#: rank-folded bf16 stores (``:305``) and the lossy weight broadcast
#: (``:378``).
RELAY_TAG = 0x5EED
OPT_TAG = 0x0917
RESIDUAL_TAG = 0x0E5F
LOSSY_TAG = 0xBAD

logger = logging.getLogger("ewdml_tpu_torch")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, ks=(1, 5)):
    """Top-1/top-5 accuracy (reference ``distributed_worker.py:27-39``)."""
    order = torch.argsort(-logits, dim=1, stable=True)
    return [(order[:, :k] == labels[:, None]).any(dim=1).float().mean()
            for k in ks]


def has_dropout(model: torch.nn.Module) -> bool:
    return any(isinstance(m, Dropout) for m in model.modules())


def check_supported(cfg: TrainConfig, async_path: bool = False) -> None:
    """Refuse, by name, every option the port does not implement yet, and
    those the JAX package accepts and ignores on this path.

    ``async_path`` checks a run of the in-process parameter server
    (``--mode async``, ``parallel/ps.py``) instead of the sync trainer."""
    if async_path:
        _check_async_supported(cfg)
        return
    validate_collective(cfg)
    validate_overlap(cfg)
    validate_lossy_weights(cfg)
    resolve_policy(cfg.precision_policy)
    unsupported = [
        (cfg.mode != "normal", f"--mode {cfg.mode} (the sync trainer; "
                               "--mode async runs the parameter server)"),
        (cfg.federated, "--federated"),
    ]
    _reject(unsupported)
    _check_process_world(cfg)


def _check_process_world(cfg: TrainConfig) -> None:
    """The options a ``torch.distributed`` world refuses. ``--adapt`` on
    more than one process, as the JAX package (``loop.py:158-161``); the
    ring transports, bucketed overlap and scan windows in any cluster:
    their ring shift across processes (and the collectives a CUDA graph
    would capture) are ROADMAP Queue 1 item 3b."""
    from ewdml_tpu_torch.parallel import launcher

    if not launcher.is_initialized():
        return
    if cfg.adapt != "off" and launcher.process_count() > 1:
        raise ValueError("--adapt supports single-process meshes "
                         "(the decision loop reads rank-shared "
                         "moments on the coordinator)")
    compressed = cfg.compression_enabled
    _reject([
        (compressed and cfg.gather_type in ("ring", "ring_rs"),
         f"--gather-type {cfg.gather_type} in a multi-process world (a "
         "ring shift across processes, ROADMAP Queue 1 item 3b)"),
        (cfg.collective == "fused_q",
         "--collective fused_q in a multi-process world (a ring shift "
         "across processes, ROADMAP Queue 1 item 3b)"),
        (cfg.overlap == "bucket",
         "--overlap bucket in a multi-process world (ROADMAP Queue 1 item "
         "3b)"),
        (cfg.feed == "device" and cfg.scan_window > 1,
         f"--scan-window {cfg.scan_window} in a multi-process world "
         "(collectives inside a captured window, ROADMAP Queue 1 item 3b)"),
    ])


def _check_async_supported(cfg: TrainConfig) -> None:
    validate_server_agg(cfg)
    validate_overlap(cfg)
    unsupported = [
        (cfg.mode != "async", f"--mode {cfg.mode} (not the parameter "
                              "server)"),
        (cfg.federated, "--federated"),
        (cfg.pull_delta, "--pull-delta (the publication stream)"),
        (bool(cfg.replicas), "--replicas"),
        (bool(cfg.agg_tree), "--agg-tree (aggregation-tree pseudo-pushes)"),
        # The in-process server has no process to restart; the TCP server
        # (parallel/ps_net.py) takes the flag.
        (bool(cfg.server_state_dir),
         "--server-state-dir on the in-process async path (the TCP "
         "server, python -m ewdml_tpu_torch.parallel.ps_net, takes it)"),
        # A federated flag: --federated runs the pipelined rounds.
        (cfg.round_pipeline != "off",
         f"--round-pipeline {cfg.round_pipeline} on the async path (a "
         "federated flag; --federated runs it)"),
        # The TCP server arms it from the flag, and
        # run_async_ps(relay_compress=True) is the in-process relay
        # (ROADMAP Queue 3 item 16).
        ignored_row(cfg.lossy_weights_down,
                    "--lossy-weights-down on the async path",
                    "it never arms the relay"),
        unserved_metrics_row(cfg, "the in-process async path"),
    ]
    _reject(unsupported)


def unserved_metrics_row(cfg: TrainConfig, path: str) -> tuple:
    """``--metrics-port`` on a path where the JAX package accepts the flag
    and arms no exporter (the in-process async CLI, the federated CLI and
    ``--role fed_driver``; ROADMAP Queue 3 item 28): refused for good, by
    name. The sync trainer, the evaluator and the ``ps_net`` server,
    worker, replica and aggregator serve it."""
    return ignored_row(cfg.metrics_port is not None,
                       f"--metrics-port on {path}", "it arms no exporter")


def ignored_row(bad: bool, what: str, effect: str) -> tuple:
    """A refusal row for good: the JAX package accepts ``what`` on this
    path and ignores it (``effect`` says how), so no later slice ports
    it. A plain ``(bad, what)`` row waits on a later slice."""
    return (bad, what, effect)


def _reject(unsupported) -> None:
    """Raise ``NotImplementedError`` for the first row that applies."""
    for bad, what, *ignored in unsupported:
        if not bad:
            continue
        if ignored:
            raise NotImplementedError(
                f"{what} is refused: the JAX package accepts it here and "
                f"ignores it ({ignored[0]})")
        raise NotImplementedError(
            f"{what} is not ported to ewdml_tpu_torch yet (ROADMAP.md)")


def _make_step_body(model: torch.nn.Module, optimizer, cfg: TrainConfig,
                    world: LocalWorld, compressor=None, device_augment=None,
                    with_moments: bool = False):
    """Build ``body(state, images, labels, keys) -> metrics [W, 3]``, the
    one step that the per-step dispatch and the window both run.

    ``compressor`` overrides the config's (the adaptive controller passes
    its per-unit ``PlannedCompressor``); ``with_moments`` makes the body
    return ``(metrics, moments [U, 2])``: per leaf the mean and the mean of
    squares of the raw f32 gradient, before the exchange and the error
    feedback touch it, averaged over the workers, so every replica sees
    the same sample (``trainer.py:269-279``).

    ``keys`` is the step's key source (``utils/keytable``): host values, or
    a window's key table. Under ``--feed device`` ``images``/``labels`` are
    the whole device-resident split and each worker gathers its own batch
    (``data/device_feed``); otherwise they are the global batch on the
    world's device, worker w's shard at rows ``[w * B, (w + 1) * B)``. The
    state is updated in place (residuals and statistics included, so a CUDA
    graph of the step finds its state where it left it) and its step
    advanced."""
    check_supported(cfg)
    if cfg.overlap == "bucket" and hasattr(compressor, "for_leaf"):
        # Behind validate_overlap's refusal: a per-unit plan is indexed on
        # the whole tree, which a bucket's leaf order would scramble.
        raise ValueError("--overlap bucket does not support per-unit "
                         "compression plans (ewdml_tpu/adapt)")
    if compressor is None:
        compressor = make_compressor(cfg.compress_grad, cfg.quantum_num,
                                     cfg.topk_ratio, cfg.topk_exact,
                                     cfg.qsgd_block)
    dense = isinstance(compressor, NoneCompressor)
    if cfg.lossy_weights_down:
        logger.warning(
            "--lossy-weights-down: the weight broadcast is QSGD-compressed; "
            "this reproduces the reference's NEGATIVE result (Final Report "
            "p.5) and training is expected to stall or diverge")
    fused_q = cfg.collective == "fused_q" and dense
    if fused_q and 0 < cfg.num_aggregate < world.size:
        raise ValueError(
            "--collective fused_q does not support K-of-N "
            "--num-aggregate (partial sums ride the ring; no per-rank "
            "payload exists to drop); use the gather collective")
    if cfg.gather_type == "ring_rs" and not dense and (
            cfg.error_feedback or 0 < cfg.num_aggregate < world.size):
        raise ValueError(
            "--gather-type ring_rs is incompatible with --error-feedback "
            "and with K-of-N --num-aggregate (per-hop requantization has "
            "no per-rank own-payload); use the default gather transport")
    multislice = world.num_slices > 1
    if multislice and not dense and (
            cfg.num_aggregate or cfg.gather_type in ("ring", "ring_rs")):
        raise ValueError(
            "--num-slices > 1 uses the hierarchical ICI+DCN exchange, which "
            "does not support --num-aggregate or ring transports; drop "
            "those flags or train single-slice")
    ef = cfg.error_feedback and not dense
    specs = leaf_specs(model)
    kinds = [s.kind for s in specs]
    fusion = resolve_fusion(cfg, len(specs))
    fuse = fusion == "all"
    bucket_bytes = (int(cfg.fusion_threshold_mb * (1 << 20))
                    if fusion == "bucket" else None)
    relay = cfg.relay_compress and cfg.ps_mode == "grads"
    policy = cfg.precision
    wire_dtype = policy.wire_dtype if dense and policy.bf16_wire else None
    device = world.device
    # --overlap bucket: the planner's buckets over the JAX tree, and (on
    # the card) the side stream each bucket's exchange is issued on.
    plan = (ovl.plan_buckets([4 * numel(s.jax_shape) for s in specs],
                             cfg.overlap_buckets)
            if cfg.overlap == "bucket" else None)
    side_stream = (torch.cuda.Stream(device)
                   if plan is not None and device.type == "cuda" else None)
    spec = _SPECS.get((cfg.dataset or "").lower())
    norm_consts = None
    if spec is not None:
        norm_consts = (torch.tensor(spec["mean"], dtype=torch.float32, device=device),
                       torch.tensor(spec["std"], dtype=torch.float32, device=device))
    if device_augment is None:
        device_augment = bool(spec and spec["augment"] and not cfg.synthetic_data)
    feeds = {}  # base key -> DeviceFeed
    dropout = has_dropout(model)

    def normalize(images: torch.Tensor) -> torch.Tensor:
        # The u8 feed ships raw pixels and normalizes here: (x/255 - m)/s.
        if images.dtype != torch.uint8:
            return images
        x = images.to(torch.float32) / 255.0
        if norm_consts is None:
            return x
        return (x - norm_consts[0]) / norm_consts[1]

    def compute_ctx():
        if cfg.bf16_compute:
            # No cast cache: a captured window re-casts every step, as the
            # per-step path does.
            return torch.autocast(device_type=device.type, dtype=torch.bfloat16,
                                  cache_enabled=False)
        return contextlib.nullcontext()

    def exchange(grads, step, skey, return_own=False):
        if dense:
            if fused_q:
                # The int8-wire ring; its hops draw from the step key,
                # folded per rank inside the collective.
                return collectives.fused_q_allreduce_mean(world, grads, skey)
            # Multi-slice too: one mean over all W workers in linear
            # order (the pmean over the (dcn, data) axes).
            return collectives.dense_allreduce_mean(world, grads,
                                                    wire_dtype=wire_dtype)
        if multislice:
            return collectives.hierarchical_compressed_allreduce(
                world, grads, compressor, skey, relay=relay,
                relay_key=prng.fold_in(skey, RELAY_TAG), fuse=fuse,
                bucket_bytes=bucket_bytes, return_own_decompressed=return_own)
        return collectives.compressed_allreduce(
            world, grads, compressor, skey, num_aggregate=cfg.num_aggregate,
            relay=relay, relay_key=prng.fold_in(skey, RELAY_TAG),
            transport={"ring": "ppermute", "ring_rs": "ring_rs"}.get(
                cfg.gather_type, "all_gather"),
            return_own_decompressed=return_own, step=step, fuse=fuse,
            bucket_bytes=bucket_bytes)

    def store_residuals(state, step, skey, g_eff, own, idxs):
        """The residuals of leaves ``idxs``: what the wire dropped, all of
        ``g_eff`` for a rank whose payload K-of-N did not accept; stored at
        the wire dtype, bf16 through the seeded rounding, every local
        rank's as one set, leaf i of global rank r under the path
        (RESIDUAL_TAG, r, i) from the step key."""
        w_n = world.size
        k = cfg.num_aggregate if 0 < cfg.num_aggregate < w_n else w_n
        with torch.no_grad():
            xs, stored, paths = [], [], []
            for lj, (r, ws) in enumerate(zip(world.ranks, state.workers)):
                accepted = ((r - step) % w_n) < k
                for j, i in enumerate(idxs):
                    ge = g_eff[lj][j]
                    xs.append(ge - own[lj][j] if accepted else ge)
                    stored.append(ws.residual[i])
                    paths.append((RESIDUAL_TAG, r, i))
            tree_store_round(skey if policy.bf16_wire else None, xs, stored,
                             outs=stored, paths=paths)

    def run_bucket(state, grads, avg, step, skey, b):
        """``--overlap bucket``: bucket b's exchange (with its residuals
        under error feedback), its averages written into ``avg``."""
        idxs = plan.buckets[b]
        sub = [[g[i] for i in idxs] for g in grads]
        if ef:
            sub = [[g + ws.residual[i] for g, i in zip(sub[r], idxs)]
                   for r, ws in enumerate(state.workers)]
        res = ovl.exchange_bucket(
            world, sub, ovl.bucket_key(skey, b),
            compressor=None if dense else compressor, wire_dtype=wire_dtype,
            fused_q=fused_q, num_aggregate=cfg.num_aggregate, relay=relay,
            fuse=fusion != "none", step=step, return_own=ef)
        if ef:
            res, own = res
            store_residuals(state, step, skey, sub, own, idxs)
        for i, g in zip(idxs, res):
            avg[i] = g

    def worker_batches(images, labels, step, keys):
        """The local workers' batches: from the device-resident split, or
        their rows of the (process's part of the) global batch."""
        if cfg.feed == "device":
            feed = feeds.get(keys.base)
            if feed is None:
                feed = feeds[keys.base] = device_feed.DeviceFeed(
                    keys.base, images.shape[0], cfg.batch_size, world.size,
                    device_augment, ranks=world.ranks)
            return feed.batches(images, labels, step, keys)
        n_local = len(world.ranks)
        per = images.shape[0] // n_local
        return [(images[j * per:(j + 1) * per], labels[j * per:(j + 1) * per])
                for j in range(n_local)]

    def body(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
             keys) -> torch.Tensor:
        step = state.step
        w_n = world.size
        skey = keys.step_key(step)
        is_sync = (cfg.sync_every <= 1
                   or step % cfg.sync_every == cfg.sync_every - 1)
        grads, rows = [], []
        avg = [None] * len(specs)
        sched, hooks = None, []
        batches = worker_batches(images, labels, step, keys)
        for j, (r, ws) in enumerate(zip(world.ranks, state.workers)):
            x = normalize(batches[j][0])
            y = batches[j][1].long()
            # The per-rank dropout stream (a model without dropout takes none).
            gen = (prng.generator(prng.fold_in(skey, r), device)
                   if dropout else None)
            ws.model.zero_grad(set_to_none=True)
            params = leaf_params(ws.model, specs)
            if (plan is not None and is_sync and r == w_n - 1
                    and ovl.use_stream(device)):
                # Each bucket is issued once the last worker's backward
                # has produced all of its leaves.
                last = [None] * len(specs)
                grads.append(last)
                sched = ovl.StreamSchedule(
                    plan, lambda b: run_bucket(state, grads, avg, step, skey,
                                               b), side_stream)
                hooks = [p.register_post_accumulate_grad_hook(
                    _leaf_hook(sched, last, i, s.kind))
                    for i, (p, s) in enumerate(zip(params, specs))]
            with compute_ctx():
                logits = ws.model(x, train=True, generator=gen)
            loss = cross_entropy(logits.float(), y)
            loss.backward()
            for h in hooks:
                h.remove()
            if sched is None or r < w_n - 1:
                grads.append([to_jax(p.grad, s.kind)
                              for p, s in zip(params, specs)])
            top1, top5 = topk_accuracy(logits.detach().float(), y)
            rows.append(torch.stack([loss.detach(), top1, top5]))

        # [W, 3]: loss, top-1, top-5 of every worker, this process's rows
        # gathered with the others'.
        metrics = world.gather_rows(torch.stack(rows))
        n_local = len(state.workers)
        mom = None
        if with_moments:
            with torch.no_grad():
                mom = world.gather_rows(torch.stack([
                    torch.stack([torch.stack([g.float().mean(),
                                              g.float().square().mean()])
                                 for g in gw])
                    for gw in grads])).mean(dim=0)
        if not is_sync:
            grads_used = grads  # Method 6 local step; residuals kept
        elif plan is not None:
            if sched is not None:
                sched.join()
            else:
                for b in range(plan.n_buckets):
                    run_bucket(state, grads, avg, step, skey, b)
            grads_used = [avg] * n_local
        elif ef:
            g_eff = [[g + res for g, res in zip(grads[j], ws.residual)]
                     for j, ws in enumerate(state.workers)]
            avg, own = exchange(g_eff, step, skey, return_own=True)
            store_residuals(state, step, skey, g_eff, own, range(len(specs)))
            grads_used = [avg] * n_local
        else:
            grads_used = [exchange(grads, step, skey)] * n_local

        # The optimizer's bf16 stores round under a rank-shared key, so the
        # synchronous replicas stay bit-identical.
        okey = prng.fold_in(skey, OPT_TAG)
        for j, ws in enumerate(state.workers):
            params = leaf_params(ws.model, specs)
            g_torch = [from_jax(g, s.kind)
                       for g, s in zip(grads_used[j], specs)]
            # Resolved each step: a caller may swap the optimizer's update
            # for one of the plain protocol after the step is built.
            if update_accepts_key(optimizer):
                optimizer.update(g_torch, ws.opt_state, params, key=okey,
                                 kinds=kinds)
            else:
                optimizer.update(g_torch, ws.opt_state, params)

        if cfg.sync_every > 1 and is_sync:
            with torch.no_grad():
                best = collectives.adopt_best_worker(
                    [leaf_params(ws.model, specs) for ws in state.workers],
                    metrics[:, 0], world)
                for ws in state.workers:
                    for p, b in zip(leaf_params(ws.model, specs), best):
                        p.copy_(b)
        if cfg.lossy_weights_down:
            # Every worker adopts dec(compress(W)) under the step's shared
            # key, leaf i under layer_key(fold_in(step_key, 0xBAD), i), in
            # the JAX layout (trainer.py:369-385).
            wkey = prng.fold_in(skey, LOSSY_TAG)
            with torch.no_grad():
                for ws in state.workers:
                    for i, (p, s) in enumerate(zip(leaf_params(ws.model, specs),
                                                   specs)):
                        pj = to_jax(p, s.kind).contiguous()
                        dec = compressor.decompress(
                            compressor.compress(prng.layer_key(wkey, i), pj))
                        p.copy_(from_jax(dec.reshape(s.jax_shape), s.kind))
        state.step = step + 1
        return metrics if mom is None else (metrics, mom)

    return body


def _leaf_hook(sched, grads: list, i: int, kind: str):
    """The post-accumulate-grad hook of leaf ``i``: record its gradient (in
    the JAX layout) and count its bucket down."""
    def hook(p):
        grads[i] = to_jax(p.grad, kind)
        sched.leaf_ready(i)
    return hook


def make_train_step(model: torch.nn.Module, optimizer, cfg: TrainConfig,
                    world: LocalWorld, compressor=None, device_augment=None,
                    with_moments: bool = False):
    """Build ``step(state, images, labels, key) -> metrics [W, 3]``: one
    step dispatched from the host, its keys host values derived from the
    base ``key``. ``images``/``labels`` as for the step body (under
    ``--feed device`` the whole split). The state is updated in place and
    its step advanced. With ``with_moments`` (the adaptive trainer) the
    step returns ``(metrics, moments [U, 2])``."""
    body = _make_step_body(model, optimizer, cfg, world, compressor,
                           device_augment, with_moments)

    def step_fn(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                key) -> torch.Tensor:
        return body(state, images, labels, HostKeys(key))

    return step_fn


def make_window_step(model: torch.nn.Module, optimizer, cfg: TrainConfig,
                     world: LocalWorld, window: int, device_augment=None):
    """The multi-step window (``trainer.py:500``): one host launch runs
    ``window`` training steps. Returns a :class:`~ewdml_tpu_torch.train.
    window.WindowStep`, ``(state, data, labels_all, key) -> metrics
    [K, W, 3]``, row k what the per-step dispatch at ``state.step + k``
    returns, bit for bit. Requires ``--feed device``: a streaming feed ships
    a host batch per step."""
    window = int(window)
    if window < 1:
        raise ValueError(f"scan window must be >= 1, got {window}")
    if cfg.feed != "device":
        raise ValueError(
            "make_window_step requires --feed device: the streaming feeds "
            "(u8/f32) receive one host-fed batch per step, so K steps "
            "cannot fold into one launch (resolve_scan_window forces K=1 "
            "there)")
    if cfg.adapt != "off":
        raise ValueError(
            "make_window_step is incompatible with --adapt: decision "
            "boundaries are host work between launches "
            "(resolve_scan_window forces K=1 for adaptive runs)")
    body = _make_step_body(model, optimizer, cfg, world,
                           device_augment=device_augment)
    return WindowStep(body, cfg, world, window, dropout=has_dropout(model))
