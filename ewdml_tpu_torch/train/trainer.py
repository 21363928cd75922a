"""The synchronous training step, Methods 1-6 (``ewdml_tpu/train/trainer.py:45-396``).

One step: every worker runs forward/backward on its shard of the global
batch; the gradients go through the exchange (dense pmean or the int8-wire
``fused_q`` ring; or the compressed collective over the gather, ``ring`` or
``ring_rs`` transport, with optional error feedback and K-of-N
acceptance); every worker applies SGD; under Method 6 the exchange runs only
at sync steps, which also adopt the lowest-loss worker's weights.

Method dispatch (Final Report pp.4-6):
- M1 'weights' PS: dense grads up, weights down (dense data parallel).
- M2: compressed up, dense down (``relay=False``).
- M3: dense both ways.
- M4/M5: compressed both ways (the relay requantizes the average with a
  key shared by all ranks).
- M6: local SGD between syncs, compressed exchange + adoption at syncs.

The JAX package compiles this as one ``shard_map``-ed program; here it is
a plain Python step over the W workers of a :class:`LocalWorld`, and it
updates the state in place. Keys and the per-rank dropout stream derive
from the same chain as in the JAX package (``utils/prng.py``). Under
``--feed device`` the step gathers its batches from the device-resident
split (``data/device_feed.py``), and ``make_window_step`` runs K steps per
host launch (``train/window.py``; one CUDA graph on the GPU).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ewdml_tpu_torch.core.config import (TrainConfig, resolve_fusion,
                                         validate_collective, validate_overlap,
                                         validate_server_agg)
from ewdml_tpu_torch.core.world import LocalWorld
from ewdml_tpu_torch.data import device_feed
from ewdml_tpu_torch.data.datasets import _SPECS
from ewdml_tpu_torch.models.convert import from_jax, leaf_specs, to_jax
from ewdml_tpu_torch.models.layers import Dropout
from ewdml_tpu_torch.ops import make_compressor
from ewdml_tpu_torch.ops.none import NoneCompressor
from ewdml_tpu_torch.parallel import collectives
from ewdml_tpu_torch.train.state import TrainState, leaf_params
from ewdml_tpu_torch.train.window import WindowStep
from ewdml_tpu_torch.utils import prng
from ewdml_tpu_torch.utils.keytable import HostKeys

#: Key tags of the JAX step (``trainer.py:236``).
RELAY_TAG = 0x5EED


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
    """Reject every option the port does not implement yet, by name.

    ``async_path`` checks a run of the in-process parameter server
    (``--mode async``, ``parallel/ps.py``) instead of the sync trainer."""
    if async_path:
        _check_async_supported(cfg)
        return
    validate_collective(cfg)
    validate_overlap(cfg)
    unsupported = [
        (cfg.mode != "normal", f"--mode {cfg.mode} (the sync trainer; "
                               "--mode async runs the parameter server)"),
        (cfg.federated, "--federated"),
        (cfg.overlap != "off", "--overlap bucket"),
        (cfg.num_slices > 1, "--num-slices > 1 (multislice)"),
        (cfg.lossy_weights_down, "--lossy-weights-down"),
        (cfg.precision_policy != "f32",
         f"--precision-policy {cfg.precision_policy}"),
        (cfg.adapt != "off", f"--adapt {cfg.adapt}"),
        *_serving_rows(cfg),
    ]
    _reject(unsupported)


def _check_async_supported(cfg: TrainConfig) -> None:
    validate_server_agg(cfg)
    validate_overlap(cfg)
    unsupported = [
        (cfg.mode != "async", f"--mode {cfg.mode} (not the parameter "
                              "server)"),
        (cfg.federated, "--federated"),
        (cfg.adapt != "off", f"--adapt {cfg.adapt}"),
        (cfg.ps_down != "weights", f"--ps-down {cfg.ps_down}"),
        (cfg.ps_bootstrap != "f32", f"--ps-bootstrap {cfg.ps_bootstrap}"),
        (cfg.pull_delta, "--pull-delta (the publication stream)"),
        (bool(cfg.replicas), "--replicas"),
        (bool(cfg.agg_tree), "--agg-tree (aggregation-tree pseudo-pushes)"),
        (bool(cfg.server_state_dir),
         "--server-state-dir (durability and recovery)"),
        (cfg.round_pipeline != "off", f"--round-pipeline {cfg.round_pipeline}"),
        (cfg.precision_policy != "f32",
         f"--precision-policy {cfg.precision_policy}"),
        *_serving_rows(cfg),
    ]
    _reject(unsupported)


def check_evaluator_supported(cfg: TrainConfig) -> None:
    """Reject, by name, the evaluator's flags the port does not implement:
    it takes every trainer flag and honours only what it reads."""
    _reject(_serving_rows(cfg))


def _serving_rows(cfg: TrainConfig) -> list:
    return [
        (cfg.metrics_port is not None, "--metrics-port (the live metrics "
                                       "endpoint, obs/serve)"),
        (cfg.health != "off", f"--health {cfg.health}"),
    ]


def _reject(unsupported) -> None:
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to ewdml_tpu_torch yet (ROADMAP.md)")


def _make_step_body(model: torch.nn.Module, optimizer, cfg: TrainConfig,
                    world: LocalWorld, compressor=None, device_augment=None):
    """Build ``body(state, images, labels, keys) -> metrics [W, 3]``, the
    one step that the per-step dispatch and the window both run.

    ``keys`` is the step's key source (``utils/keytable``): host values, or
    a window's key table. Under ``--feed device`` ``images``/``labels`` are
    the whole device-resident split and each worker gathers its own batch
    (``data/device_feed``); otherwise they are the global batch on the
    world's device, worker w's shard at rows ``[w * B, (w + 1) * B)``. The
    state is updated in place (residuals and statistics included, so a CUDA
    graph of the step finds its state where it left it) and its step
    advanced."""
    check_supported(cfg)
    if compressor is None:
        compressor = make_compressor(cfg.compress_grad, cfg.quantum_num,
                                     cfg.topk_ratio, cfg.topk_exact,
                                     cfg.qsgd_block)
    dense = isinstance(compressor, NoneCompressor)
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
    ef = cfg.error_feedback and not dense
    specs = leaf_specs(model)
    fusion = resolve_fusion(cfg, len(specs))
    fuse = fusion == "all"
    bucket_bytes = (int(cfg.fusion_threshold_mb * (1 << 20))
                    if fusion == "bucket" else None)
    relay = cfg.relay_compress and cfg.ps_mode == "grads"
    device = world.device
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
            return collectives.dense_allreduce_mean(world, grads)
        return collectives.compressed_allreduce(
            world, grads, compressor, skey, num_aggregate=cfg.num_aggregate,
            relay=relay, relay_key=prng.fold_in(skey, RELAY_TAG),
            transport={"ring": "ppermute", "ring_rs": "ring_rs"}.get(
                cfg.gather_type, "all_gather"),
            return_own_decompressed=return_own, step=step, fuse=fuse,
            bucket_bytes=bucket_bytes)

    def worker_batches(images, labels, step, keys):
        w_n = world.size
        if cfg.feed == "device":
            feed = feeds.get(keys.base)
            if feed is None:
                feed = feeds[keys.base] = device_feed.DeviceFeed(
                    keys.base, images.shape[0], cfg.batch_size, w_n,
                    device_augment)
            return feed.batches(images, labels, step, keys)
        per = images.shape[0] // w_n
        return [(images[r * per:(r + 1) * per], labels[r * per:(r + 1) * per])
                for r in range(w_n)]

    def body(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
             keys) -> torch.Tensor:
        step = state.step
        w_n = world.size
        skey = keys.step_key(step)
        grads, rows = [], []
        batches = worker_batches(images, labels, step, keys)
        for r, ws in enumerate(state.workers):
            x = normalize(batches[r][0])
            y = batches[r][1].long()
            # The per-rank dropout stream (a model without dropout takes none).
            gen = (prng.generator(prng.fold_in(skey, r), device)
                   if dropout else None)
            ws.model.zero_grad(set_to_none=True)
            with compute_ctx():
                logits = ws.model(x, train=True, generator=gen)
            loss = cross_entropy(logits.float(), y)
            loss.backward()
            params = leaf_params(ws.model, specs)
            grads.append([to_jax(p.grad, s.kind) for p, s in zip(params, specs)])
            top1, top5 = topk_accuracy(logits.detach().float(), y)
            rows.append(torch.stack([loss.detach(), top1, top5]))

        metrics = torch.stack(rows)  # [W, 3]: loss, top-1, top-5
        is_sync = (cfg.sync_every <= 1
                   or step % cfg.sync_every == cfg.sync_every - 1)
        if not is_sync:
            grads_used = grads  # Method 6 local step; residuals kept
        elif ef:
            g_eff = [[g + res for g, res in zip(grads[r], ws.residual)]
                     for r, ws in enumerate(state.workers)]
            avg, own = exchange(g_eff, step, skey, return_own=True)
            # K-of-N: a rank whose payload was not accepted this step keeps
            # its whole g_eff as the residual.
            k = cfg.num_aggregate if 0 < cfg.num_aggregate < w_n else w_n
            with torch.no_grad():
                for r, ws in enumerate(state.workers):
                    accepted = ((r - step) % w_n) < k
                    for res, ge, o in zip(ws.residual, g_eff[r], own[r]):
                        res.copy_(ge - o if accepted else ge)
            grads_used = [avg] * w_n
        else:
            grads_used = [exchange(grads, step, skey)] * w_n

        for r, ws in enumerate(state.workers):
            params = leaf_params(ws.model, specs)
            g_torch = [from_jax(g, s.kind) for g, s in zip(grads_used[r], specs)]
            optimizer.update(g_torch, ws.opt_state, params)

        if cfg.sync_every > 1 and is_sync:
            with torch.no_grad():
                best = collectives.adopt_best_worker(
                    [leaf_params(ws.model, specs) for ws in state.workers],
                    metrics[:, 0])
                for ws in state.workers:
                    for p, b in zip(leaf_params(ws.model, specs), best):
                        p.copy_(b)
        state.step = step + 1
        return metrics

    return body


def make_train_step(model: torch.nn.Module, optimizer, cfg: TrainConfig,
                    world: LocalWorld, compressor=None, device_augment=None):
    """Build ``step(state, images, labels, key) -> metrics [W, 3]``: one
    step dispatched from the host, its keys host values derived from the
    base ``key``. ``images``/``labels`` as for the step body (under
    ``--feed device`` the whole split). The state is updated in place and
    its step advanced."""
    body = _make_step_body(model, optimizer, cfg, world, compressor,
                           device_augment)

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
