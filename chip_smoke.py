#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ewdml_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. Build the CUDA kernels from ``ewdml_tpu_torch/kernels/compress.cu``.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the training paths give it (VGG11-BN's largest 8 MB gradient
   bucket, 2 359 296 elements): quantize per tensor and blockwise (bit),
   dequant_mean at W = 4 (within W * 2^-23 * sum|norm * level| / (s * W);
   the kernel keeps the plain version's order, so 0 is expected),
   block_top1 on that bucket's (104, 23 680) block view (bit); the ring
   kernels chunk_encode and dequant_acc_requant (scale 1 and 1/4) on the
   ``--collective fused_q`` chunk of VGG11-BN at W = 4 (2 441 216
   elements) and on a chunk with a tail block (levels and norms bit).
   Each is timed with CUDA events (median of repeats, L2 flushed before
   each launch) beside its bound, its plain version, and one PyTorch call
   for the same function where there is one.
3. Train VGG11-BN at full width (CIFAR-10 shapes, synthetic data, batch
   128 per worker, W = 4 workers emulated on the card, f32 with TF32 off)
   through the CLI's config and the Trainer: M1, M2, M4, M5 (1% top-k)
   for 5 steps each, M6 for 20 steps so that it reaches a sync; then the
   ring transports for 5 steps each: M3 with ``--collective fused_q``, M2
   and M4 with ``--gather-type ring_rs --qsgd-block 4096``, M5 with
   ``--gather-type ring``. The loss must be finite; the wire bytes of the
   payloads the step ships must equal the analytic wire plan (under
   ``fused_q``: the ring bytes the transport moved must equal the plan's
   exact hop bytes; under ``ring_rs`` the moved bytes are printed beside
   the plan's); the ring kernels must launch as often as the rings hop;
   and every kernel's launch count over these runs must be above 0 (the
   counts are zeroed just before each run and read just after it, so the
   checks around a run do not count).

Then it prints the kernels' JSON line, the card's name and power limit
(nvidia-smi), and last ``{"ok": true, "device": {...}}``. Without a GPU, or
without the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BUCKET = 2_359_296          # VGG11-BN's largest 8 MB bucket (fusion 'bucket')
VGG11_PARAMS = 9_756_426    # trainable parameters of build_model('VGG11')
WORLD = 4
TAIL_CHUNK = 530_442        # 129 whole 4096-blocks and a tail of 2058
SOURCE = "ewdml_tpu_torch/kernels/compress.cu"
REPLACES = {
    "qsgd_quantize": "ewdml_tpu/ops/pallas_kernels.py:169",
    "dequant_mean": "ewdml_tpu/ops/pallas_kernels.py:232",
    "block_top1": "ewdml_tpu/ops/pallas_kernels.py:290",
    "chunk_encode": "ewdml_tpu/ops/pallas_kernels.py:431",
    "dequant_acc_requant": "ewdml_tpu/ops/pallas_kernels.py:479",
}
# Operations per element, for the compute side of each bound (all of them
# scalar int32/f32 work, counted against the f32 rate): the murmur hash
# (11) plus the quantize arithmetic and cast (~14); W multiply-adds plus
# one scale; one abs and one compare; the ring kernels' square-and-add of
# the block norm (2) plus the quantize (25), and a hop's decode-accumulate
# (4) before them.
OPS_PER_ELEM = {"qsgd_quantize": 25, "dequant_mean": 2 * WORLD + 1,
                "block_top1": 2, "chunk_encode": 2 + 25,
                "dequant_acc_requant": 4 + 2 + 25}


def bound_ms(nbytes: int, ops: int) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """CUDA-event timing of single launches, L2 flushed before each."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 25, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def check_kernels(torch, kernels, timer) -> dict:
    """Phase 2: each kernel against its plain version at the path's shapes."""
    g = torch.Generator(device="cuda").manual_seed(20)
    out = {}

    # -- quantize: per tensor (the default wire) and blockwise 4096 --
    x = torch.randn(BUCKET, device="cuda", generator=g) * 1e-2
    norm = torch.linalg.vector_norm(x)
    nb = BUCKET // 4096
    bnorms = torch.linalg.vector_norm(x.reshape(nb, 4096), dim=1)
    seed = -123456789
    for block, norms in ((None, norm), (4096, bnorms)):
        a = kernels.qsgd_quantize(x, norms, seed, 127, block=block)
        b = kernels.qsgd_quantize_ref(x, norms, seed, 127, block=block)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"qsgd_quantize block={block}: {bad} levels "
                                 "differ from the plain version")
        if int(a.abs().max()) == 0:
            raise AssertionError("qsgd_quantize produced only zero levels")
    ms = timer(lambda: kernels.qsgd_quantize(x, norm, seed, 127))
    plain = timer(lambda: kernels.qsgd_quantize_ref(x, norm, seed, 127), reps=10)
    bnd, by = bound_ms(5 * BUCKET + 4, OPS_PER_ELEM["qsgd_quantize"] * BUCKET)
    out["qsgd_quantize"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                bound_ms=bnd, bound_by=by, library_ms=None,
                                shape=[BUCKET])

    # -- dequant_mean: W gathered int8 payloads, per-tensor norms --
    lv = torch.randint(-127, 128, (WORLD, BUCKET), device="cuda",
                       generator=g).to(torch.int8)
    nm = torch.rand(WORLD, device="cuda", generator=g) * 3
    a = kernels.dequant_mean(lv, nm, 127)
    b = kernels.dequant_mean_ref(lv, nm, 127)
    torch.cuda.synchronize()
    err = (a.double() - b.double()).abs()
    mag = (nm[:, None].double() * lv.double()).abs().sum(0) / (127 * WORLD)
    if bool((err > WORLD * 2.0 ** -23 * mag + 1e-45).any()):
        raise AssertionError("dequant_mean is outside its stated bound")
    ms = timer(lambda: kernels.dequant_mean(lv, nm, 127))
    plain = timer(lambda: kernels.dequant_mean_ref(lv, nm, 127), reps=10)
    bnd, by = bound_ms((WORLD + 4) * BUCKET + 4 * WORLD,
                       OPS_PER_ELEM["dequant_mean"] * BUCKET)
    out["dequant_mean"] = dict(max_abs_err=float(err.max()), ms=ms,
                               plain_ms=plain, bound_ms=bnd, bound_by=by,
                               library_ms=None, shape=[WORLD, BUCKET])

    # -- block_top1: the bucket's (blk_pad, nb) view at the 1% ratio --
    from ewdml_tpu_torch.ops.blocktopk import geometry
    nbc, _, blk_pad = geometry(BUCKET, 0.01)
    x2 = torch.zeros(blk_pad * nbc, device="cuda")
    x2[:BUCKET] = torch.randn(BUCKET, device="cuda", generator=g)
    x2 = x2.reshape(blk_pad, nbc)
    va, la = kernels.block_top1(x2)
    vb, lb = kernels.block_top1_ref(x2)
    torch.cuda.synchronize()
    if not (torch.equal(la, lb) and torch.equal(va.view(torch.int32),
                                                vb.view(torch.int32))):
        raise AssertionError("block_top1 differs from the plain version")
    ms = timer(lambda: kernels.block_top1(x2))
    plain = timer(lambda: kernels.block_top1_ref(x2), reps=10)
    # One PyTorch call for the winners' magnitudes: max |x| per column.
    lib = timer(lambda: torch.linalg.vector_norm(x2, float("inf"), dim=0))
    bnd, by = bound_ms(4 * blk_pad * nbc + 8 * nbc,
                       OPS_PER_ELEM["block_top1"] * blk_pad * nbc)
    out["block_top1"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                             bound_ms=bnd, bound_by=by, library_ms=lib,
                             shape=[blk_pad, nbc])
    out.update(check_ring_kernels(torch, kernels, timer, g))
    return out


def check_ring_kernels(torch, kernels, timer, g) -> dict:
    """The ring kernels on fused_q's VGG11-BN chunk and on a tail chunk:
    levels and norms bit-equal to the plain versions; timed on the chunk."""
    from ewdml_tpu_torch.parallel.collectives import fused_chunk_elems

    m = fused_chunk_elems(VGG11_PARAMS, WORLD, kernels.BLOCK_ELEMS)
    out = {}

    def same(a, b, what):
        (la, na), (lb, nb_) = a, b
        torch.cuda.synchronize()
        if not torch.equal(na.view(torch.int32), nb_.view(torch.int32)):
            raise AssertionError(f"{what}: {int((na != nb_).sum())} norms "
                                 "differ from the plain version")
        if not torch.equal(la, lb):
            raise AssertionError(f"{what}: {int((la != lb).sum())} levels "
                                 "differ from the plain version")
        if int(la.abs().max()) == 0:
            raise AssertionError(f"{what} produced only zero levels")

    chunks = {n: torch.randn(n, device="cuda", generator=g) * 1e-2
              for n in (m, TAIL_CHUNK)}
    for n, x in chunks.items():
        for seed in (0, -77, 2**31 - 1):
            same(kernels.chunk_encode(x, seed, 127),
                 kernels.chunk_encode_ref(x, seed, 127), f"chunk_encode n={n}")
            lv, nm = kernels.chunk_encode_ref(x, seed + 1, 127)
            local = torch.randn(n, device="cuda", generator=g) * 1e-2
            for scale in (1.0, 1.0 / WORLD):
                same(kernels.dequant_acc_requant(lv, nm, local, seed, 127,
                                                 scale=scale),
                     kernels.dequant_acc_requant_ref(lv, nm, local, seed, 127,
                                                     scale=scale),
                     f"dequant_acc_requant n={n} scale={scale}")
    nb = m // kernels.BLOCK_ELEMS
    x = chunks[m]
    ms = timer(lambda: kernels.chunk_encode(x, 5, 127))
    plain = timer(lambda: kernels.chunk_encode_ref(x, 5, 127), reps=10)
    bnd, by = bound_ms(4 * m + m + 4 * nb, OPS_PER_ELEM["chunk_encode"] * m)
    out["chunk_encode"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                               bound_ms=bnd, bound_by=by, library_ms=None,
                               shape=[m])
    lv, nm = kernels.chunk_encode(x, 6, 127)
    local = torch.randn(m, device="cuda", generator=g) * 1e-2
    ms = timer(lambda: kernels.dequant_acc_requant(lv, nm, local, 7, 127,
                                                   scale=1.0 / WORLD))
    plain = timer(lambda: kernels.dequant_acc_requant_ref(
        lv, nm, local, 7, 127, scale=1.0 / WORLD), reps=10)
    bnd, by = bound_ms(m + 4 * m + m + 8 * nb,
                       OPS_PER_ELEM["dequant_acc_requant"] * m)
    out["dequant_acc_requant"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                      bound_ms=bnd, bound_by=by,
                                      library_ms=None, shape=[m])
    return out


def shipped_up_bytes(trainer) -> int:
    """The up-link bytes of the payloads one worker's last gradients make,
    compressed through the trainer's own transport units (an independent
    count against the analytic wire plan)."""
    import torch

    from ewdml_tpu_torch.core.config import resolve_fusion
    from ewdml_tpu_torch.models.convert import to_jax
    from ewdml_tpu_torch.ops import make_compressor
    from ewdml_tpu_torch.parallel.collectives import bucket_tree
    from ewdml_tpu_torch.train.state import leaf_params
    from ewdml_tpu_torch.utils import prng

    cfg = trainer.cfg
    if not cfg.compression_enabled:
        return sum(4 * p.numel() for p in trainer.state.workers[0].model.parameters())
    comp = make_compressor(cfg.compress_grad, cfg.quantum_num, cfg.topk_ratio,
                           cfg.topk_exact, cfg.qsgd_block)
    ws = trainer.state.workers[0]
    leaves = [to_jax(p.grad, s.kind) for p, s in
              zip(leaf_params(ws.model, trainer.specs), trainer.specs)]
    if resolve_fusion(cfg, len(leaves)) == "bucket":
        leaves, _ = bucket_tree(leaves, int(cfg.fusion_threshold_mb * (1 << 20)))
    with torch.no_grad():
        return sum(comp.compress(prng.key(i), leaf).wire_bytes
                   for i, leaf in enumerate(leaves))


def check_ring_run(name, res, trainer, launched, steps) -> dict:
    """The ring transports' checks: the bytes the ring moved against the
    plan, and one ring-kernel launch per encode and per hop."""
    moved = trainer.world.ppermute_bytes / steps
    planned = res.wire.per_rank_exchange_bytes
    units = len(res.wire.per_layer_up)
    if res.wire.transport == "fused_q" and moved != planned:
        raise AssertionError(f"{name}: the ring moved {moved} B per step, "
                             f"the wire plan says {planned} B")
    if res.wire.transport in ("fused_q", "ring_rs"):
        want = {"chunk_encode": steps * units * WORLD,
                "dequant_acc_requant": steps * units * WORLD * (WORLD - 1)}
        got = {k: launched[k] for k in want}
        if got != want:
            raise AssertionError(f"{name}: ring kernel launches {got}, "
                                 f"the rings hop {want}")
    return dict(ring_bytes_per_step=moved, planned_per_rank_bytes=planned)


RUNS = [  # (name, steps, flags)
    ("M1", 5, ["--method", "1"]),
    ("M2", 5, ["--method", "2"]),
    ("M4", 5, ["--method", "4"]),
    ("M5", 5, ["--method", "5"]),
    ("M6", 20, ["--method", "6"]),
    ("M3 fused_q", 5, ["--method", "3", "--collective", "fused_q"]),
    ("M2 ring_rs", 5, ["--method", "2", "--gather-type", "ring_rs",
                       "--qsgd-block", "4096"]),
    ("M4 ring_rs", 5, ["--method", "4", "--gather-type", "ring_rs",
                       "--qsgd-block", "4096"]),
    ("M5 ring", 5, ["--method", "5", "--gather-type", "ring"]),
]


def train_phase(torch, kernels) -> tuple:
    """Phase 3: VGG11-BN at full width under Methods 1, 2, 4, 5, 6 and the
    ring transports."""
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.train.loop import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    per_method = {}
    counts = {k: 0 for k in kernels.LAUNCHES}
    for name, steps, flags in RUNS:
        argv = ["--network", "VGG11", "--dataset", "Cifar10",
                "--synthetic-data", "--num-workers", str(WORLD),
                "--batch-size", "128", "--topk-ratio", "0.01",
                "--max-steps", str(steps), "--epochs", "100",
                "--log-every", "1000", "--no-bf16", *flags]
        trainer = Trainer(from_args(argv))
        trainer.world.ppermute_bytes = 0
        kernels.reset_launches()   # this run of the main path starts here
        t0 = time.perf_counter()
        res = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dict(kernels.LAUNCHES)  # read just after it
        for k, v in launched.items():
            counts[k] += v
        if not math.isfinite(res.final_loss):
            raise AssertionError(f"{name}: non-finite loss {res.final_loss}")
        if res.steps != steps:
            raise AssertionError(f"{name}: ran {res.steps} of {steps} steps")
        extra = {}
        if res.wire.transport != "fused_q":
            shipped = shipped_up_bytes(trainer)
            if shipped != res.wire.up_bytes:
                raise AssertionError(f"{name}: payloads ship {shipped} B up, "
                                     f"the wire plan says {res.wire.up_bytes} B")
        if trainer.cfg.collective == "fused_q" or \
                trainer.cfg.gather_type in ("ring", "ring_rs"):
            extra = check_ring_run(name, res, trainer, launched, steps)
        ev = trainer.evaluate()
        if not math.isfinite(ev["loss"]):
            raise AssertionError(f"{name}: non-finite eval loss")
        per_method[name] = dict(
            steps=steps, final_loss=res.final_loss,
            mean_step_ms=res.mean_step_s * 1e3, wall_s=wall,
            wire_per_step=res.wire.per_step_bytes,
            transport=res.wire.transport,
            units=len(res.wire.per_layer_up), launches=launched,
            launches_per_step={k: v / steps for k, v in launched.items()},
            **extra)
        print(f"train {name}: steps={steps} loss={res.final_loss:.4f} "
              f"mean_step={res.mean_step_s * 1e3:.2f}ms wall={wall:.1f}s "
              f"wire_per_step={res.wire.per_step_bytes} B "
              f"units={len(res.wire.per_layer_up)} launches={launched} "
              f"eval_loss={ev['loss']:.4f} {extra}", flush=True)
        del trainer
        torch.cuda.empty_cache()
    print("kernels: " + json.dumps(counts), flush=True)
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 "main path")
    return counts, per_method


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from ewdml_tpu_torch import kernels as build
        from ewdml_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the ewdml_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    # Phase 1: build.
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f}s (nvcc {build.build_seconds:.1f}s)",
          flush=True)

    # Phase 2: kernels against their plain versions.
    timer = Timer(torch)
    checks = check_kernels(torch, kernels, timer)
    del timer
    torch.cuda.empty_cache()
    for name, c in checks.items():
        print(f"kernel {name} {c['shape']}: {c['ms']:.4f} ms (bound "
              f"{c['bound_ms']:.4f} ms by {c['bound_by']}), plain "
              f"{c['plain_ms']:.4f} ms, library {c['library_ms']}, "
              f"max_abs_err {c['max_abs_err']}", flush=True)

    # Phase 3: the training main path.
    counts, per_method = train_phase(torch, kernels)

    line = {"kernels": [dict(
        name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
        launches=counts[name], max_abs_err=c["max_abs_err"], ms=c["ms"],
        plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
        library_ms=c["library_ms"]) for name, c in checks.items()]}
    print("train: " + json.dumps(per_method), flush=True)
    print(json.dumps(line), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
