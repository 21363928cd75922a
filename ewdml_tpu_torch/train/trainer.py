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
from the same chain as in the JAX package (``utils/prng.py``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ewdml_tpu_torch.core.config import (TrainConfig, resolve_fusion,
                                         validate_collective, validate_overlap,
                                         validate_server_agg)
from ewdml_tpu_torch.core.world import LocalWorld
from ewdml_tpu_torch.data.datasets import _SPECS
from ewdml_tpu_torch.models.convert import from_jax, leaf_specs, to_jax
from ewdml_tpu_torch.ops import make_compressor
from ewdml_tpu_torch.ops.none import NoneCompressor
from ewdml_tpu_torch.parallel import collectives
from ewdml_tpu_torch.train.state import TrainState, leaf_params
from ewdml_tpu_torch.utils import prng

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
        (cfg.feed == "device", "--feed device (and make_window_step)"),
        (cfg.scan_window > 1, "--scan-window (make_window_step)"),
        (cfg.precision_policy != "f32",
         f"--precision-policy {cfg.precision_policy}"),
        (cfg.adapt != "off", f"--adapt {cfg.adapt}"),
        (cfg.profile_dir is not None, "--profile-dir"),
        (cfg.trace_dir is not None, "--trace-dir"),
        (cfg.metrics_port is not None, "--metrics-port"),
        (cfg.health != "off", f"--health {cfg.health}"),
        (cfg.debug_nans, "--debug-nans"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to ewdml_tpu_torch yet (ROADMAP.md)")


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
        (cfg.health != "off", f"--health {cfg.health}"),
        (cfg.profile_dir is not None, "--profile-dir"),
        (cfg.trace_dir is not None, "--trace-dir"),
        (cfg.metrics_port is not None, "--metrics-port"),
        (cfg.debug_nans, "--debug-nans"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to ewdml_tpu_torch yet (ROADMAP.md)")


def make_train_step(model: torch.nn.Module, optimizer, cfg: TrainConfig,
                    world: LocalWorld, compressor=None):
    """Build ``step(state, images, labels, key) -> metrics [W, 3]``.

    ``images``/``labels`` are the global batch on the world's device,
    worker w's shard at rows ``[w * B, (w + 1) * B)``. The state is updated
    in place and its step advanced."""
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
            return torch.autocast(device_type=device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def exchange(grads, step, key, return_own=False):
        skey = prng.step_key(key, step)
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

    def step_fn(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                key) -> torch.Tensor:
        step = state.step
        w_n = world.size
        per = images.shape[0] // w_n
        skey = prng.step_key(key, step)
        grads, rows = [], []
        for r, ws in enumerate(state.workers):
            x = normalize(images[r * per:(r + 1) * per])
            y = labels[r * per:(r + 1) * per].long()
            dkey = prng.fold_in(skey, r)  # the per-rank dropout stream
            gen = torch.Generator(device=device)
            gen.manual_seed((dkey[0] << 32) | dkey[1])
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
            avg, own = exchange(g_eff, step, key, return_own=True)
            # K-of-N: a rank whose payload was not accepted this step keeps
            # its whole g_eff as the residual.
            k = cfg.num_aggregate if 0 < cfg.num_aggregate < w_n else w_n
            for r, ws in enumerate(state.workers):
                accepted = ((r - step) % w_n) < k
                ws.residual = [ge - o if accepted else ge
                               for ge, o in zip(g_eff[r], own[r])]
            grads_used = [avg] * w_n
        else:
            grads_used = [exchange(grads, step, key)] * w_n

        for r, ws in enumerate(state.workers):
            params = leaf_params(ws.model, specs)
            g_torch = [from_jax(g, s.kind) for g, s in zip(grads_used[r], specs)]
            optimizer.update(g_torch, ws.opt_state, params)

        if cfg.sync_every > 1 and is_sync:
            best = collectives.adopt_best_worker(
                [leaf_params(ws.model, specs) for ws in state.workers],
                metrics[:, 0])
            with torch.no_grad():
                for ws in state.workers:
                    for p, b in zip(leaf_params(ws.model, specs), best):
                        if p is not b:
                            p.copy_(b)
        state.step = step + 1
        return metrics

    return step_fn
