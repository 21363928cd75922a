#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ewdml_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. Build the CUDA kernels from ``ewdml_tpu_torch/kernels/compress.cu``,
   ``precision.cu`` and ``random.cu`` (one ``nvcc`` per source, started
   together; the last two include ``threefry.cuh``).
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the training paths give it (VGG11-BN's largest 8 MB gradient
   bucket, 2 359 296 elements): quantize per tensor and blockwise (bit),
   dequant_mean at W = 4 (bit: the kernel keeps the plain version's order),
   block_top1 on that bucket's (104, 23 680) block view (bit); the ring
   kernels chunk_encode and dequant_acc_requant (scale 1 and 1/4) on the
   ``--collective fused_q`` chunk of VGG11-BN at W = 4 (2 441 216
   elements) and on a chunk with a tail block (levels and norms bit).
   The worker-axis reduces (bit, with the mode switch forcing the kernel
   at every size): int_accumulate at K = 1, 4, 8, 9 over the bucket, 16 over
   530 442, and on unaligned rows, unaligned bases and n = 130, 17, 5;
   dequant_mean at W = 1, 8 and 9 (blockwise 4096) over the bucket, at
   [4, 530 442] (rows 1 and 3 2-byte aligned) per tensor and blockwise, on a
   base 1 byte into its storage and at [3, 12 290] 3 bytes in. acc_decode
   per tensor at k = 4 and 3 and blockwise 4096 and 8192 over the bucket and
   over a tail (bit). Each is timed with CUDA events (median of repeats, L2
   flushed before each launch) beside its bound, its plain version, one
   PyTorch call for the same function where there is one, and its own time
   on the card from a ``torch.profiler`` trace. A bound is the larger of the
   bytes over the HBM rate and the instructions over the instruction rate at the
   SM clock nvidia-smi reports. Then the per-shape table (``shape``
   lines): block_top1 at every (R, C) view VGG11-BN's M5 step gives it at
   1% (beside ``vector_norm(inf)``), the ring hop and chunk_encode at
   every ``ring_rs --qsgd-block 4096`` chunk and at the ``fused_q`` chunk,
   qsgd_quantize and dequant_mean (W = 4) per tensor at every unit of at
   least ``MIN_ELEMS`` elements and blockwise 4096 at the largest, and
   int_accumulate (K = 4) at every leaf of VGG11-BN the homomorphic apply
   sums, each bit-equal to its plain version there and timed beside its
   bound and its launches per step or round,
   and its kernel's own time on the card read from a ``torch.profiler``
   trace (``device``; "not measured" where the trace holds no device
   time);
   block_top1 also on planted ties at (8, 128), (1000, 256), (104, 384)
   and every path shape, and the hop on n = 4096, 4097, 33 * 4096,
   144 * 4096 and the fused_q chunk with blocks of 4096, 8192 and 16384 at
   scale 1 and 1/4 (bit); and the per-launch floor, a one-element
   ``zero_()`` under the same timer. The same table again (``shape
   ResNet50 ...`` lines) at ResNet50's shapes (161 leaves, 14 units of
   1 048 576 to 2 359 296 elements): block_top1 at its (104, 10 496) to
   (104, 23 680) views, the hop and chunk_encode at its ``ring_rs``
   chunks of 64 to 144 blocks and its ``fused_q`` chunk of 1 436 blocks
   (above the hop's 264-block switch), qsgd_quantize and dequant_mean at
   every unit, among them 1 069 066 (2 mod 4, so rows 1 and 3 of
   dequant_mean's [4, n] start on 2-byte boundaries), and int_accumulate
   at every ResNet50 leaf of at least ``MIN_ELEMS`` elements; and
   acc_decode per tensor at every leaf the homomorphic apply decodes (the
   34 of ResNet50, the 8 of VGG11-BN), each bit-equal there. Then 6a (the
   store kernel) and:
2b. The threefry draw kernel (``random_bits``, ``kernels/random.cu``)
   against its plain version at the path's sizes (every VGG11-BN and
   ResNet50 leaf size, whole for QSGD's threefry stream below
   ``MIN_ELEMS`` and the async server's shared-scale encode, and the 1%
   top-k count of each for its Top-k QSGD encode, uniform, up to 2 359 296
   elements, past the size where the kernel's grid stops growing and its
   threads loop; the feed's (128,) draws and the 50 000-element
   permutation, bits) and at n = 1, 7, 4099 and
   2^17 - 1, bits and uniform (bit, one launch a draw), under host keys
   and captured under key-table keys (each replay's keys); timed at every
   path size beside its bound, its plain version and its own time from a
   trace; the kernels the card runs for one draw, plain and kernel.
   ``--kernels-only`` stops here.
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
   and the counts of each run are zeroed just before it and read just
   after it, so the checks around a run do not count.
3b. The same runs, steps and checks on ResNet50 at full width (same data,
   batch, W and precision; its 14 transport units, the 1 436-block
   ``fused_q`` chunk). Every run of phases 3 and 3b prints a ``train`` line
   with its ``network=`` and its launches per step.
3c. The device-resident feed and the scan window (``--feed device
   --scan-window K``): VGG11-BN at the same shapes under M1, M4, M5 and M4
   ``ring_rs --qsgd-block 4096`` with K = 8 for 24 steps, M6 with the auto
   K = 20 (its sync period) for 60 steps, and ResNet50 M4 with K = 8 for
   16 steps (capture at 161 leaves, one replay). Each runs twice from the same state,
   per-step (``--scan-window 1``) and windowed (a warm-up window of K
   per-step dispatches, then one CUDA graph captured and replayed once per
   window), with deterministic kernels. Every metrics row, parameter,
   BatchNorm statistic, momentum buffer and residual must be bit-equal
   between the two, the windowed run must make one replay per window after
   the first, and both must launch each kernel as often (the graph's
   launches times its windows). ``window`` lines print the ms per step both
   ways.
4. Run the in-process async parameter server (``--mode async``) through the
   CLI's config on the same models and shapes: W = 4 worker threads on the
   card, K = 4 (``--num-aggregate 4``), 4 steps per worker (2 on
   ResNet50), ``--fusion none`` (the server ships one payload per leaf, which the wire plan then
   prices): QSGD under ``--server-agg decode`` and ``homomorphic``, QSGD
   with ``--qsgd-block 4096`` and Top-k QSGD at 1% under ``homomorphic`` on
   VGG11-BN; QSGD under ``homomorphic`` on ResNet50 (161 leaves, 34 of
   them summed by int_accumulate and decoded by acc_decode each round).
   Each must make 16 pushes and 4 updates (8 and 2 on ResNet50), pay one
   decode per round
   (homomorphic) or K (decode), launch the kernels exactly as often as its
   leaves and rounds say, report only finite losses, and receive exactly
   the bytes of the wire plan's up-link in the pushes' frames.

5. Checkpoints, resume, the polling evaluator and the trace layer on
   VGG11-BN at the same shapes, ``--feed device`` under deterministic
   kernels: M4 per step (8 + 8 steps, ``--eval-freq 8``), M6 per step saved
   inside its local phase (10 + 10, ``--eval-freq 10``, sync period 20, a
   full ``[W, ...]`` blob whose workers differ) and M4 windowed (K = 8,
   8 + 8). Each run stopped at its save, restored in a fresh Trainer and
   carried on must equal the uninterrupted run bit for bit (parameters,
   BatchNorm statistics, momentum, residuals, metrics rows), and the
   restored tensors the saved ones; the windowed run's fresh Trainer has
   captured its graph before the restore and replays it on the restored
   state, under ``--profile-dir`` (the Chrome trace must hold
   ``qsgd_quantize_kernel`` and ``dequant_mean_kernel``; the share of the
   profiled window some kernel runs is printed). The M4 run's stopped
   Trainer runs with ``--trace-dir`` (the shard's span counts are checked),
   and ``python -m ewdml_tpu_torch.train.evaluator --max-polls 1`` on its
   checkpoint must give worker 0's loss, top-1 and top-5 to 1e-6 relative.
   Phase 4's homomorphic VGG11-BN run traces too (its ``ps/*`` and
   ``worker/grad`` spans are counted). Printed with the card's name and
   power limit: the checkpoint's size, save and restore seconds (VGG11-BN,
   and ResNet50 at W = 4), and the FLOPs of one VGG11-BN M1 step
   (``torch.utils.flop_counter``) with its MFU at phase 3c's windowed step
   time against the FP32 peak.

6. The precision policy, Adam, the paper's negative result and
   ``--overlap bucket`` on VGG11-BN at the same shapes (6a runs with phase
   2): (a) the stochastic-round kernel against its plain version at every
   VGG11-BN and ResNet50 leaf shape singly (conv leaves in PyTorch's
   layout, the draw by the JAX index) and on specials (bit; NaN by
   ``isnan``), and as each network's SGD, Adam and residual store sets in
   one call (``round_launches`` launches each), also captured under a
   key-table key and replayed for two windows; timed at the 512x512x3x3
   leaf and as a vector of its size beside its bound (6 bytes or 71.5
   operations an element; the SASS instructions an element of each index
   map counted with ``cuobjdump``), its plain version and its time alone;
   a whole VGG11-BN store set per step and replayed in a window; and a
   ``shape stochastic_round`` row per VGG11-BN leaf; (b) M1
   ``bf16_wire`` (the dense payload the step ships is the plan's and half
   of M1's f32 plan) and M4 ``--error-feedback --precision-policy
   bf16_wire_state`` (bf16 residuals and momentum, the kernel launched
   once a worker's optimizer set and once for the residual set a step, the
   replicas bit-identical), 5 steps each;
   (c) M2 ``--optimizer adam`` under f32 and ``bf16_wire_state``; (d)
   ``--compress-grad qsgd --ps-mode weights --lossy-weights-down`` beside
   ``--method 2``, 40 steps each (``--feed device``, deterministic
   kernels): after every step every weight leaf equals ``dec(compress(W))``
   of the plain compressor under the step's key (W from a twin Trainer
   without the lossy broadcast, from the same state), and the example's
   criterion holds (lossy final loss > 5 x max(0.01, M2's)); both loss
   curves are printed; (e) M1, M1 ``bf16_wire``, M3 ``fused_q`` and M4 EF
   under ``--overlap bucket`` at the auto bucket count and at 4: the
   side-stream schedule bit-equal to the inline one (rows, state,
   launches), the per-bucket bytes summing to ``per_step_bytes``, the step
   time with overlap on and off printed; (f) phase 3c's check on VGG11-BN
   M4 EF Adam ``bf16_wire_state`` and ResNet50 M4 ``bf16_wire_state`` (K =
   8, 24 and 16 steps) and phase 5's resume on the VGG11-BN one (8 + 8); (g) the
   async PS (phase 4's checks) with dense ``bf16_wire`` frames (half the
   f32 bytes, the plan's) and QSGD decode under Adam ``bf16_wire_state``.

7. The published-table reproduction (``ewdml_tpu_torch/experiments``).
   (a) In process, ``collect.run_cell`` at the smoke budget (VGG11-BN,
   batch 4 per worker, W = 2, 4 steps, the committed ``mnist10k32``
   stand-in) for ``baseline`` ``vgg11_cifar10/m5`` and ``baseline_bf16``
   ``vgg11_cifar10/m4``, each traced so that the measured comm/comp probe
   runs (its span in the shard, ``comm_split_source == "measured"``); the
   rows' ``comm_mb_per_iter`` and ``wire_mb_per_step_worker`` must equal
   the port's wire plan of the same config, and their hardware must name
   the card and its power limit; qsgd_quantize, dequant_mean and
   stochastic_round launch inside the cells (block_top1 does not: the
   table's M5/M6 keep the default top-k ratio 0.5, above the 1/8 its
   selection needs). Then ``baseline_scan`` ``lenet_mnist/m6_scan`` at its
   full-table config for 3 epochs of 70 steps: epoch by epoch, windows of
   K = 20 with a 10-step per-step tail, so each window phase (0 and 10)
   is captured once for the cell and replayed in every later epoch.
   (b) ``run_sweep("baseline", smoke=True)``: all 12 cells as child
   processes on the card with ``--fault-spec crash@1=3``: the crashed cell
   journals ``cell_retry`` with rc 13 and resumes from step 2, every cell
   finishes, ``REPRO.md`` is written, and a second invocation journals 12
   ``cell_skipped`` and launches no child. Each cell's wall is printed.

8. The async parameter server's down-link and the run-health watchdog,
   phase 4's shapes (W = K = 4, batch 128, 4 steps a worker, 2 on
   ResNet50, ``--fusion none``). (a) VGG11-BN ``--compress-grad qsgd --qsgd-block 4096
   --ps-down delta --ps-bootstrap bf16 --server-agg decode`` through
   ``cli.build_async``: ``bytes_down`` equals its reckoning (4 bf16
   bootstraps of half the dense bytes, then the deltas each pull shipped,
   every delta the same size, no dense fallback), the replay of the
   deltas from the f32 start equals the server's shadow and each worker's
   final pull lands on its bf16 base plus the later deltas, both bit for
   bit, and qsgd_quantize launches once per big leaf for every push, the
   schema's template, every update's delta step and its warm-up; beside
   it the ``--ps-down weights`` twin (its apply ms and dense bytes). (b)
   The same with ``--compress-grad topk_qsgd --topk-ratio 0.01``:
   block_top1 per leaf the Top-k stack selects in block mode, the same
   count of compresses. (c) ResNet50 with (a)'s flags. (d) The lossy
   weights-down relay, ``run_async_ps(relay_compress=True)``, beside the
   same run without it: VGG11-BN QSGD decode, W = 4 at K = 1, 40 updates;
   every pull ships the compressor's wire bytes; both loss curves
   printed (the paper's negative result on this path). (e) ``--health``
   through ``cli.main`` in process: VGG11-BN M4 ``--feed device
   --scan-window 8 --fault-spec nan@0=12`` exits 76 under ``abort`` at the
   read covering step 12 with one ``nan`` event in ``health.jsonl``;
   under ``warn`` it completes with the same event and its final
   checkpoint equals ``--health off``'s byte for byte (deterministic
   kernels); the async run of (a)'s flags at ``--lr 0.001`` with
   ``nan@1=2 --health abort`` exits 76 on a ``nan`` verdict, and the
   workers stop with fewer pushes than one worker's budget of 50. Each
   down-link run is followed by the server's apply and delta step alone
   (no worker threads).

9. The TCP tier (``ewdml_tpu_torch/parallel/ps_net.py``) on VGG11-BN at
   the same shapes (``--fusion none``). (a) A ``PSNetServer`` serving in a
   thread and four ``PSNetWorker`` threads over localhost sockets, 6 steps
   a worker, on each wire plane (``threads``, ``evloop``): QSGD
   ``--server-agg homomorphic`` at K = 4 and QSGD ``decode`` at K = 2.
   Every launch count equals phase 4's reckoning for the pushes and
   updates the ``stats`` reply reports, plus each endpoint's payload
   template (and, homomorphic, its scale template's three draws); the
   workers' socket bytes equal the server's, both ways, exactly;
   ``bytes_up`` and ``bytes_down`` equal the wire plan's push frames and
   the dense pulls; one decode a round homomorphic, K decode. Printed:
   ``apply_ms_mean`` and the push and pull queue/handler p50 and p99 of
   the reply's ``segments``. (b) A server with ``--server-state-dir`` and
   ``--snapshot-every 4`` applies 10 K = 2 batches of two TCP workers'
   frames; a second server recovers from the directory (the snapshot at 8
   and two WAL records) to the same version, parameters, momentum and
   shadow bit for bit, and acknowledges every recorded push again as a
   duplicate. Printed: the snapshot's bytes, a write's seconds, the WAL
   records, the recovery's seconds. (c) Across processes: ``python -m
   ewdml_tpu_torch.parallel.ps_net --role server --server-state-dir D
   --fault-spec serverkill@5 --server-agg homomorphic`` (K = 1; every
   process derives the scale contract on its own and each worker checks
   the server's scale CRC on its pulls), two worker processes of 8 steps
   and a late joiner (``join@2=3``, 4 steps); the server dies by SIGKILL
   at apply 5 and is started again on the same port and directory; every
   worker exits 0 with ``PS_NET_WORKER_DONE`` after at least one
   ``resync``, and the final ``stats`` shows version 20 (no push applied
   twice, the killed apply's re-sent push acknowledged), ``recoveries`` 1,
   ``joins`` 1, ``live_workers`` 3. Printed: the wall of each step of the
   run, beside the card's name and power limit.

Every kernel's launch count over the runs of phases 3, 3b, 3c, 4, 5, 6, 7a,
8 and 9 must be above 0. ``--phase8-only`` and ``--phase9-only`` build and
run phase 8 or phase 9 alone (no result line).

Then it prints the kernels' JSON line, the card's name and power limit
(nvidia-smi), and last ``{"ok": true, "device": {...}}``. Without a GPU, or
without the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# The card's memory rate in bytes per second, from the data-sheet table of
# ewdml_tpu_torch/train/flops.py (3.35e12 for an H100 SXM); set by main().
hbm_bytes_per_s = None
# Instructions per clock: 132 SMs x 4 warp schedulers x 32 lanes (H100
# SXM). Times the SM clock nvidia-smi reports as clocks.max.sm, this is the
# rate the operations side of each bound is counted against (33.4e12 per
# second at 1980 MHz); set by main().
LANES_PER_CLOCK = 132 * 128
ops_per_s = None
BUCKET = 2_359_296          # VGG11-BN's largest 8 MB bucket (fusion 'bucket')
VGG11_PARAMS = 9_756_426    # trainable parameters of build_model('VGG11')
WORLD = 4
NETWORKS = ("VGG11", "ResNet50")  # phase 3 and phase 3b
TAIL_CHUNK = 530_442        # 129 whole 4096-blocks and a tail of 2058
SOURCE = "ewdml_tpu_torch/kernels/compress.cu"
REPLACES = {
    "qsgd_quantize": "ewdml_tpu/ops/pallas_kernels.py:169",
    "dequant_mean": "ewdml_tpu/ops/pallas_kernels.py:232",
    "block_top1": "ewdml_tpu/ops/pallas_kernels.py:290",
    "chunk_encode": "ewdml_tpu/ops/pallas_kernels.py:431",
    "dequant_acc_requant": "ewdml_tpu/ops/pallas_kernels.py:479",
    "int_accumulate": "ewdml_tpu/ops/pallas_kernels.py:587",
    "acc_decode": "ewdml_tpu/ops/pallas_kernels.py:629",
    # Port-only kernels: the JAX package computes them in XLA, not Pallas.
    "stochastic_round": "ewdml_tpu/core/precision.py:87",
    "random_bits": "ewdml_tpu/ops/qsgd.py:122,230",
}
SOURCES = {"stochastic_round": "ewdml_tpu_torch/kernels/precision.cu",
           "random_bits": "ewdml_tpu_torch/kernels/random.cu"}
# The names of each wrapper's kernels in a torch.profiler trace.
KERNEL_NAMES = {
    "qsgd_quantize": ("qsgd_quantize_kernel",),
    "dequant_mean": ("dequant_mean_kernel",),
    "block_top1": ("block_top1_kernel",),
    "chunk_encode": ("ring_hop_kernel", "ring_encode_kernel"),
    "dequant_acc_requant": ("ring_hop_kernel", "ring_encode_kernel"),
    "int_accumulate": ("int_accumulate_kernel",),
    "acc_decode": ("acc_decode_kernel",),
    "stochastic_round": ("stochastic_round_kernel",),
    "random_bits": ("random_bits_kernel",),
}
# Instructions per element, for the operations side of each bound, each
# counted once against the instruction rate (an f32 multiply and an add that the
# kernels keep apart are two; no FMA is formed): the murmur hash (11) plus
# the quantize arithmetic and cast (~14); W multiply-adds plus one scale;
# one abs and one compare; the ring kernels' square-and-add of the block
# norm (2) plus the quantize (25), and a hop's decode-accumulate (4) before
# them; K widening adds; one convert and one multiply. The hash's three
# integer multiplies run on the INT32 pipes at half the lanes, which at 3
# of ~25 instructions stays inside the instruction rate.
OPS_PER_ELEM = {"qsgd_quantize": 25, "dequant_mean": 2 * WORLD + 1,
                "block_top1": 2, "chunk_encode": 2 + 25,
                "dequant_acc_requant": 4 + 2 + 25, "int_accumulate": WORLD,
                "acc_decode": 2}


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    from ewdml_tpu_torch.utils import provenance

    line = provenance.smi_name_power()
    if line is None:
        raise RuntimeError("nvidia-smi did not give the card's name and "
                           "power limit")
    return line


def sm_clock_mhz() -> float:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(smi.stdout.strip().splitlines()[0])


def bound_ms(nbytes: int, ops: int) -> tuple:
    t_bytes = nbytes / hbm_bytes_per_s * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def table_seed(torch, value: int):
    """A murmur seed as the drawing kernels take it on the training path:
    one int32 slot of a device buffer (the step's key table)."""
    buf = torch.zeros(8, dtype=torch.int32, device="cuda")
    buf[5] = value
    return buf[5:6]


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

    def device(self, fn, kernels: tuple, reps: int = 10, tries: int = 2):
        """The mean time on the card of the kernels whose names hold one of
        ``kernels`` over ``reps`` calls of ``fn`` (L2 flushed before each),
        from a ``torch.profiler`` trace: the kernel alone, without the
        launch. A trace that holds no device time for them is taken again,
        up to ``tries`` traces (now and then one misses the card's events
        that a second holds); None where none holds it."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        fn()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            total_us, count = 0.0, 0
            for e in prof.key_averages():
                if any(k in e.key for k in kernels):
                    total_us += getattr(e, "device_time_total",
                                        getattr(e, "cuda_time_total", 0.0))
                    count += e.count
            if count and total_us > 0:
                return total_us / count / 1e3
        return None


def check_kernels(torch, kernels, timer) -> dict:
    """Phase 2: each kernel against its plain version at the path's shapes."""
    g = torch.Generator(device="cuda").manual_seed(20)
    out = {}

    # -- quantize: per tensor (the default wire) and blockwise 4096 --
    x = torch.randn(BUCKET, device="cuda", generator=g) * 1e-2
    norm = torch.linalg.vector_norm(x)
    nb = BUCKET // 4096
    bnorms = torch.linalg.vector_norm(x.reshape(nb, 4096), dim=1)
    seed = table_seed(torch, -123456789)
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
    fn = lambda: kernels.qsgd_quantize(x, norm, seed, 127)
    ms = timer(fn)
    plain = timer(lambda: kernels.qsgd_quantize_ref(x, norm, seed, 127), reps=10)
    bnd, by = bound_ms(5 * BUCKET + 4, OPS_PER_ELEM["qsgd_quantize"] * BUCKET)
    out["qsgd_quantize"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                bound_ms=bnd, bound_by=by, library_ms=None,
                                shape=[BUCKET],
                                device_ms=timer.device(
                                    fn, KERNEL_NAMES["qsgd_quantize"]))

    # -- dequant_mean: W gathered int8 payloads, per-tensor norms --
    lv = torch.randint(-127, 128, (WORLD, BUCKET), device="cuda",
                       generator=g).to(torch.int8)
    nm = torch.rand(WORLD, device="cuda", generator=g) * 3
    a = kernels.dequant_mean(lv, nm, 127)
    b = kernels.dequant_mean_ref(lv, nm, 127)
    torch.cuda.synchronize()
    err = (a.double() - b.double()).abs()
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"dequant_mean: {int((a != b).sum())} values "
                             "differ from the plain version")
    fn = lambda: kernels.dequant_mean(lv, nm, 127)
    ms = timer(fn)
    plain = timer(lambda: kernels.dequant_mean_ref(lv, nm, 127), reps=10)
    bnd, by = bound_ms((WORLD + 4) * BUCKET + 4 * WORLD,
                       OPS_PER_ELEM["dequant_mean"] * BUCKET)
    out["dequant_mean"] = dict(max_abs_err=float(err.max()), ms=ms,
                               plain_ms=plain, bound_ms=bnd, bound_by=by,
                               library_ms=None, shape=[WORLD, BUCKET],
                               device_ms=timer.device(
                                   fn, KERNEL_NAMES["dequant_mean"]))

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
    fn = lambda: kernels.block_top1(x2)
    ms = timer(fn)
    plain = timer(lambda: kernels.block_top1_ref(x2), reps=10)
    # One PyTorch call for the winners' magnitudes: max |x| per column.
    lib = timer(lambda: torch.linalg.vector_norm(x2, float("inf"), dim=0))
    bnd, by = bound_ms(4 * blk_pad * nbc + 8 * nbc,
                       OPS_PER_ELEM["block_top1"] * blk_pad * nbc)
    out["block_top1"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                             bound_ms=bnd, bound_by=by, library_ms=lib,
                             shape=[blk_pad, nbc],
                             device_ms=timer.device(
                                 fn, KERNEL_NAMES["block_top1"]))
    out.update(check_ring_kernels(torch, kernels, timer, g))
    out.update(check_apply_kernels(torch, kernels, timer, g))
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
        for value in (0, -77, 2**31 - 1):
            seed = table_seed(torch, value)
            same(kernels.chunk_encode(x, seed, 127),
                 kernels.chunk_encode_ref(x, seed, 127), f"chunk_encode n={n}")
            lv, nm = kernels.chunk_encode_ref(x, value + 1, 127)
            local = torch.randn(n, device="cuda", generator=g) * 1e-2
            for scale in (1.0, 1.0 / WORLD):
                same(kernels.dequant_acc_requant(lv, nm, local, seed, 127,
                                                 scale=scale),
                     kernels.dequant_acc_requant_ref(lv, nm, local, seed, 127,
                                                     scale=scale),
                     f"dequant_acc_requant n={n} scale={scale}")
    nb = m // kernels.BLOCK_ELEMS
    x = chunks[m]
    seed = table_seed(torch, 5)
    fn = lambda: kernels.chunk_encode(x, seed, 127)
    ms = timer(fn)
    plain = timer(lambda: kernels.chunk_encode_ref(x, seed, 127), reps=10)
    bnd, by = bound_ms(4 * m + m + 4 * nb, OPS_PER_ELEM["chunk_encode"] * m)
    out["chunk_encode"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                               bound_ms=bnd, bound_by=by, library_ms=None,
                               shape=[m],
                               device_ms=timer.device(
                                   fn, KERNEL_NAMES["chunk_encode"]))
    lv, nm = kernels.chunk_encode(x, 6, 127)
    local = torch.randn(m, device="cuda", generator=g) * 1e-2
    seed = table_seed(torch, 7)
    fn = lambda: kernels.dequant_acc_requant(lv, nm, local, seed, 127,
                                             scale=1.0 / WORLD)
    ms = timer(fn)
    plain = timer(lambda: kernels.dequant_acc_requant_ref(
        lv, nm, local, seed, 127, scale=1.0 / WORLD), reps=10)
    bnd, by = bound_ms(m + 4 * m + m + 8 * nb,
                       OPS_PER_ELEM["dequant_acc_requant"] * m)
    out["dequant_acc_requant"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
        library_ms=None, shape=[m],
        device_ms=timer.device(fn, KERNEL_NAMES["dequant_acc_requant"]))
    return out


def same_dequant(torch, kernels, lv, nm, block, what) -> None:
    """dequant_mean bit-equal to its plain version, through the kernel."""
    before = kernels.LAUNCHES["dequant_mean"]
    a = kernels.dequant_mean(lv, nm, 127, block=block)
    b = kernels.dequant_mean_ref(lv, nm, 127, block=block)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["dequant_mean"] != before + 1:
        raise AssertionError(f"dequant_mean {what} did not launch the kernel")
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"dequant_mean {what}: {int((a != b).sum())} "
                             "values differ from the plain version")


def same_accumulate(torch, kernels, lv, what) -> None:
    """int_accumulate bit-equal to its plain version, through the kernel."""
    before = kernels.LAUNCHES["int_accumulate"]
    a = kernels.accumulate(lv)
    b = kernels.int_accumulate_ref(lv)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["int_accumulate"] != before + 1:
        raise AssertionError(f"int_accumulate {what} did not launch the "
                             "kernel")
    if not torch.equal(a, b):
        raise AssertionError(f"int_accumulate {what}: {int((a != b).sum())} "
                             "sums differ from the plain version")


def levels_on_card(torch, rows: int, n: int, g, offset: int = 0):
    """Random int8 levels [rows, n]; with ``offset`` a view that many bytes
    into its storage (a base that is not 16-byte aligned)."""
    flat = torch.randint(-127, 128, (rows * n + offset,), device="cuda",
                         generator=g).to(torch.int8)
    return flat[offset:].reshape(rows, n)


def dequant_norms(torch, world: int, n: int, block, g):
    shape = (world,) if block is None else (world, -(-n // block))
    return torch.rand(shape, device="cuda", generator=g) * 3


def check_apply_kernels(torch, kernels, timer, g) -> dict:
    """The worker-axis reduces and the server decode against their plain
    versions (bit): int_accumulate at K = 1 ... 9 and 16 over the bucket and
    at unaligned and forced-small shapes, dequant_mean at W = 1, 8, 9 and on
    a 2-byte-aligned row pitch and a base that is not 16-byte aligned,
    acc_decode per tensor and blockwise; then timed on the bucket at
    K = W = 4."""
    out = {}
    kernels.configure("on")  # the dispatchers take the kernel at every size
    try:
        for world, n, offset in ((WORLD, BUCKET, 0), (1, BUCKET, 0),
                                 (8, BUCKET, 0), (9, BUCKET, 0),
                                 (16, TAIL_CHUNK, 0), (WORLD, TAIL_CHUNK, 1),
                                 (5, 9000, 0), (8, 130, 0), (9, 17, 3),
                                 (2, 5, 1)):
            same_accumulate(torch, kernels,
                            levels_on_card(torch, world, n, g, offset),
                            f"K={world} n={n} offset={offset}")
        for world, n, block, offset in ((1, BUCKET, None, 0),
                                        (8, BUCKET, None, 0),
                                        (9, BUCKET, 4096, 0),
                                        (WORLD, TAIL_CHUNK, None, 0),
                                        (WORLD, TAIL_CHUNK, 4096, 0),
                                        (WORLD, TAIL_CHUNK, None, 1),
                                        (3, 12_290, 4096, 3)):
            same_dequant(torch, kernels,
                         levels_on_card(torch, world, n, g, offset),
                         dequant_norms(torch, world, n, block, g), block,
                         f"W={world} n={n} block={block} offset={offset}")
        for n in (BUCKET, TAIL_CHUNK):
            for k in (WORLD, 3):
                acc = torch.randint(-127 * k, 127 * k + 1, (n,), device="cuda",
                                    generator=g).to(torch.int32)
                for block in (None, 4096, 8192):
                    nb = 1 if block is None else -(-n // block)
                    sc = torch.rand(nb, device="cuda", generator=g) * 1e-3
                    before = kernels.LAUNCHES["acc_decode"]
                    a = kernels.decode_sum(acc, sc, k, block=block)
                    b = kernels.acc_decode_ref(acc, sc, k, block=block)
                    torch.cuda.synchronize()
                    if kernels.LAUNCHES["acc_decode"] != before + 1:
                        raise AssertionError("acc_decode did not launch the "
                                             "kernel")
                    if not torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)):
                        raise AssertionError(
                            f"acc_decode n={n} k={k} block={block}: "
                            f"{int((a != b).sum())} values differ from the "
                            "plain version")
    finally:
        kernels.configure("auto")
    lv = levels_on_card(torch, WORLD, BUCKET, g)
    fn = lambda: kernels.int_accumulate(lv)
    ms = timer(fn)
    plain = timer(lambda: kernels.int_accumulate_ref(lv), reps=10)
    lib = timer(lambda: torch.sum(lv, 0, dtype=torch.int32))
    bnd, by = bound_ms(WORLD * BUCKET + 4 * BUCKET,
                       OPS_PER_ELEM["int_accumulate"] * BUCKET)
    out["int_accumulate"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                 bound_ms=bnd, bound_by=by, library_ms=lib,
                                 shape=[WORLD, BUCKET],
                                 device_ms=timer.device(
                                     fn, KERNEL_NAMES["int_accumulate"]))
    acc = kernels.int_accumulate(lv)
    sc = torch.rand(1, device="cuda", generator=g) * 1e-3
    factor = sc * torch.tensor(1.0 / WORLD, dtype=torch.float32, device="cuda")
    fn = lambda: kernels.acc_decode(acc, sc, WORLD)
    ms = timer(fn)
    plain = timer(lambda: kernels.acc_decode_ref(acc, sc, WORLD), reps=10)
    lib = timer(lambda: torch.mul(acc, factor))
    bnd, by = bound_ms(4 * BUCKET + 4 + 4 * BUCKET,
                       OPS_PER_ELEM["acc_decode"] * BUCKET)
    out["acc_decode"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                             bound_ms=bnd, bound_by=by, library_ms=lib,
                             shape=[BUCKET],
                             device_ms=timer.device(
                                 fn, KERNEL_NAMES["acc_decode"]))
    return out


def path_shapes(network: str) -> tuple:
    """The shapes the network's transport units (W = 4) give block_top1, the
    ring kernels and qsgd_quantize: ``{(R, C, n): per M5 step}`` at the 1%
    ratio; ``{blocks: (units, path)}`` for the ring chunks at
    ``--qsgd-block 4096`` on ``ring_rs`` and on ``fused_q`` (per step each
    unit's chunk is encoded W times and hopped W (W - 1) times); and
    ``{n: units}`` for the units of at least ``MIN_ELEMS`` elements, each
    quantized W times per M2 step, W + 1 times per M4 step (the relay) and
    once, blockwise, per M4 ``ring_rs`` step (the relay)."""
    from ewdml_tpu_torch.core.config import from_args, resolved_unit_sizes
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs
    from ewdml_tpu_torch.ops import blocktopk, kernels, topk
    from ewdml_tpu_torch.parallel.collectives import fused_chunk_elems

    specs = leaf_specs(build_model(network, 10, dataset="Cifar10"))
    sizes = [math.prod(s.jax_shape) for s in specs]
    cfg = from_args(["--network", network, "--dataset", "Cifar10",
                     "--num-workers", str(WORLD), "--method", "5"])
    units = resolved_unit_sizes(cfg, sizes)
    top1, rings, quant = {}, {}, {}
    for n in units:
        if topk.resolve_mode(None, n, 0.01) == "block":
            nb, _, blk_pad = blocktopk.geometry(n, 0.01)
            top1[(blk_pad, nb, n)] = top1.get((blk_pad, nb, n), 0) + WORLD
        blocks = fused_chunk_elems(n, WORLD, 4096) // 4096
        rings[blocks] = (rings.get(blocks, (0,))[0] + 1, "ring_rs")
        if n >= kernels.MIN_ELEMS:
            quant[n] = quant.get(n, 0) + 1
    rings[fused_chunk_elems(sum(sizes), WORLD, 4096) // 4096] = (1, "fused_q")
    return (dict(sorted(top1.items(), reverse=True)), dict(sorted(rings.items())),
            dict(sorted(quant.items(), reverse=True)))


def top1_edge_matrix(torch, r: int, c: int, g):
    """Half-integers (ties in |x| all over), and planted columns: +-v and
    equal v in rows far apart (in different row slices of the kernel), an
    all-zero column whose first row is -0, an all -0 column, an all-equal
    column, and a maximum in the last row. The first row of the column
    maximum in columns 0-7 is 0, 0, 0, t, t, t, r - 1, 0 with
    t = min(3, r - 7); ``tests/test_torch_cuda.py`` holds the kernel to
    these planted cases as well."""
    x2 = torch.round(torch.randn(r, c, device="cuda", generator=g) * 2) / 2
    lo, hi = min(3, r - 1), max(r - 7, 0)
    x2[:, :8] = 0.5
    x2[:, 0] = 0.0
    x2[0, 0] = -0.0
    x2[:, 1] = -0.0
    x2[:, 2] = 2.5
    x2[lo, 3], x2[hi, 3] = 7.0, -7.0
    x2[lo, 4], x2[hi, 4] = -7.0, 7.0
    x2[lo, 5], x2[hi, 5] = 7.0, 7.0
    x2[r - 1, 6] = -9.0
    x2[0, 7], x2[r - 1, 7] = -9.0, 9.0
    return x2


def same_top1(torch, kernels, x2, what) -> None:
    va, la = kernels.block_top1(x2)
    vb, lb = kernels.block_top1_ref(x2)
    torch.cuda.synchronize()
    if not torch.equal(la, lb):
        raise AssertionError(f"block_top1 {what}: {int((la != lb).sum())} "
                             "rows differ from the plain version")
    if not torch.equal(va.view(torch.int32), vb.view(torch.int32)):
        raise AssertionError(f"block_top1 {what}: values differ from the "
                             "plain version")


def same_hop(torch, kernels, lv, nm, local, seed, block, scale,
             what) -> None:
    seed = table_seed(torch, seed)
    la, na = kernels.dequant_acc_requant(lv, nm, local, seed, 127,
                                         block=block, scale=scale)
    lb, nb = kernels.dequant_acc_requant_ref(lv, nm, local, seed, 127,
                                             block=block, scale=scale)
    torch.cuda.synchronize()
    if not torch.equal(na.view(torch.int32), nb.view(torch.int32)):
        raise AssertionError(f"dequant_acc_requant {what}: "
                             f"{int((na != nb).sum())} norms differ from the "
                             "plain version")
    if not torch.equal(la, lb):
        raise AssertionError(f"dequant_acc_requant {what}: "
                             f"{int((la != lb).sum())} levels differ from the "
                             "plain version")


def hop_inputs(torch, n: int, block: int, g) -> tuple:
    lv = torch.randint(-127, 128, (n,), device="cuda", generator=g).to(
        torch.int8)
    nm = torch.rand(-(-n // block), device="cuda", generator=g)
    local = torch.randn(n, device="cuda", generator=g) * 1e-2
    return lv, nm, local


def same_encode(torch, kernels, x, seed, what) -> None:
    seed = table_seed(torch, seed)
    la, na = kernels.chunk_encode(x, seed, 127)
    lb, nb = kernels.chunk_encode_ref(x, seed, 127)
    torch.cuda.synchronize()
    if not torch.equal(na.view(torch.int32), nb.view(torch.int32)):
        raise AssertionError(f"chunk_encode {what}: {int((na != nb).sum())} "
                             "norms differ from the plain version")
    if not torch.equal(la, lb):
        raise AssertionError(f"chunk_encode {what}: {int((la != lb).sum())} "
                             "levels differ from the plain version")


def shape_row(timer, fn, names, nbytes, ops, **row) -> dict:
    """A per-shape row: ``fn`` timed with events and, alone on the card,
    from the trace of the kernels whose names hold one of ``names`` (none:
    not traced)."""
    ms = timer(fn)
    bnd, _ = bound_ms(nbytes, ops)
    return dict(row, ms=ms, bound_ms=bnd, share=bnd / ms,
                device_ms=timer.device(fn, names) if names else None,
                bytes=nbytes)


def quantize_rows(torch, kernels, timer, quant, g) -> list:
    """qsgd_quantize bit-equal to its plain version and timed at every size
    of the path: per tensor, and blockwise 4096 at the largest."""
    rows = []
    names = KERNEL_NAMES["qsgd_quantize"]
    for n, units in quant.items():
        x = torch.randn(n, device="cuda", generator=g) * 1e-2
        blocks = [None] + ([4096] if n == max(quant) else [])
        for block in blocks:
            if block is None:
                norms = torch.linalg.vector_norm(x)
                per_step = f"x{units * WORLD}/x{units * (WORLD + 1)} per M2/M4"
            else:
                nb = -(-n // block)
                pad = torch.zeros(nb * block, device="cuda")
                pad[:n] = x
                norms = torch.linalg.vector_norm(pad.reshape(nb, block), dim=1)
                per_step = f"x{units} per M4 ring_rs"
            seed = table_seed(torch, n % 1000 - 500)
            a = kernels.qsgd_quantize(x, norms, seed, 127, block=block)
            b = kernels.qsgd_quantize_ref(x, norms, seed, 127, block=block)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"qsgd_quantize n={n} block={block}: "
                                     f"{int((a != b).sum())} levels differ "
                                     "from the plain version")
            rows.append(shape_row(
                timer,
                lambda: kernels.qsgd_quantize(x, norms, seed, 127, block=block),
                names, 5 * n + 4 * norms.numel(),
                OPS_PER_ELEM["qsgd_quantize"] * n, n=n, block=block,
                per_step=per_step))
    return rows


def apply_leaves(network: str) -> dict:
    """``{n: leaves}`` for the network's leaves of at least ``MIN_ELEMS``
    elements: the server's homomorphic apply (``--fusion none``) runs one
    int_accumulate on each per round."""
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs
    from ewdml_tpu_torch.ops import kernels

    leaves = {}
    for spec in leaf_specs(build_model(network, 10, dataset="Cifar10")):
        n = math.prod(spec.jax_shape)
        if n >= kernels.MIN_ELEMS:
            leaves[n] = leaves.get(n, 0) + 1
    return dict(sorted(leaves.items(), reverse=True))


def reduce_rows(torch, kernels, timer, quant, network, g) -> tuple:
    """dequant_mean at every unit M2/M4 decodes (per tensor, and blockwise
    4096 at the largest), and int_accumulate and acc_decode (per tensor) at
    every leaf the homomorphic apply sums and decodes, W = K = 4: each
    bit-equal to its plain version there, then timed."""
    dequant, accumulate, decode = [], [], []
    for n, units in quant.items():
        lv = levels_on_card(torch, WORLD, n, g)
        for block in [None] + ([4096] if n == max(quant) else []):
            nm = dequant_norms(torch, WORLD, n, block, g)
            same_dequant(torch, kernels, lv, nm, block, f"n={n} block={block}")
            per_step = (f"x{units} per M2/M4" if block is None else
                        f"x{units} per M2/M4 --qsgd-block 4096")
            dequant.append(shape_row(
                timer,
                lambda lv=lv, nm=nm, block=block: kernels.dequant_mean(
                    lv, nm, 127, block=block),
                KERNEL_NAMES["dequant_mean"], (WORLD + 4) * n + 4 * nm.numel(),
                OPS_PER_ELEM["dequant_mean"] * n, n=n, block=block,
                per_step=per_step))
    kernels.configure("on")
    try:
        for n, leaves in apply_leaves(network).items():
            lv = levels_on_card(torch, WORLD, n, g)
            same_accumulate(torch, kernels, lv, f"K={WORLD} n={n}")
            accumulate.append(shape_row(
                timer, lambda lv=lv: kernels.int_accumulate(lv),
                KERNEL_NAMES["int_accumulate"], (WORLD + 4) * n,
                OPS_PER_ELEM["int_accumulate"] * n, n=n,
                per_step=f"x{leaves} per round"))
            acc = kernels.int_accumulate(lv)
            sc = torch.rand(1, device="cuda", generator=g) * 1e-3
            same_decode(torch, kernels, acc, sc, f"k={WORLD} n={n}")
            decode.append(shape_row(
                timer, lambda acc=acc, sc=sc: kernels.acc_decode(acc, sc,
                                                                 WORLD),
                KERNEL_NAMES["acc_decode"], 8 * n + 4,
                OPS_PER_ELEM["acc_decode"] * n, n=n,
                per_step=f"x{leaves} per round"))
    finally:
        kernels.configure("auto")
    return dequant, accumulate, decode


def same_decode(torch, kernels, acc, sc, what) -> None:
    """acc_decode bit-equal to its plain version, through the kernel."""
    before = kernels.LAUNCHES["acc_decode"]
    a = kernels.decode_sum(acc, sc, WORLD)
    b = kernels.acc_decode_ref(acc, sc, WORLD)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["acc_decode"] != before + 1:
        raise AssertionError(f"acc_decode {what} did not launch the kernel")
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"acc_decode {what}: {int((a != b).sum())} "
                             "values differ from the plain version")


def check_path_shapes(torch, kernels, timer, network: str) -> dict:
    """block_top1, the ring kernels and qsgd_quantize bit-equal to their
    plain versions at the network's path shapes and the edge cases, then
    timed at the path's shapes beside their bounds (and, for block_top1,
    the library call), with the time of a one-element ``zero_()`` under the
    same timer as the per-launch floor."""
    g = torch.Generator(device="cuda").manual_seed(40)
    top1, rings, quant = path_shapes(network)
    hops = {b: (units * WORLD * (WORLD - 1), path)
            for b, (units, path) in rings.items()}
    for r, c in ((8, 128), (1000, 256), (104, 384)):
        same_top1(torch, kernels, top1_edge_matrix(torch, r, c, g),
                  f"edges ({r}, {c})")
    for n in (4096, 4097, 33 * 4096, 144 * 4096, max(hops) * 4096):
        for block in (4096, 8192, 16384):
            lv, nm, local = hop_inputs(torch, n, block, g)
            for scale in (1.0, 1.0 / WORLD):
                same_hop(torch, kernels, lv, nm, local, n % 1000 - 500,
                         block, scale, f"n={n} block={block} scale={scale}")
    one = torch.zeros(1, device="cuda")
    out = {"floor_ms": timer(lambda: one.zero_()), "block_top1": [],
           "dequant_acc_requant": [], "chunk_encode": []}
    for (r, c, n), per_step in top1.items():
        x2 = torch.zeros(r * c, device="cuda")
        x2[:n] = torch.randn(n, device="cuda", generator=g)
        x2 = x2.reshape(r, c)
        same_top1(torch, kernels, x2, f"({r}, {c})")
        same_top1(torch, kernels, top1_edge_matrix(torch, r, c, g),
                  f"edges ({r}, {c})")
        row = shape_row(timer, lambda: kernels.block_top1(x2),
                        KERNEL_NAMES["block_top1"], 4 * r * c + 8 * c,
                        OPS_PER_ELEM["block_top1"] * r * c, shape=[r, c],
                        per_m5_step=per_step)
        row["library_ms"] = timer(
            lambda: torch.linalg.vector_norm(x2, float("inf"), dim=0))
        out["block_top1"].append(row)
    ring_names = KERNEL_NAMES["chunk_encode"]
    seed = table_seed(torch, 7)
    for blocks, (per_step, path) in hops.items():
        n = blocks * 4096
        lv, nm, local = hop_inputs(torch, n, 4096, g)
        same_hop(torch, kernels, lv, nm, local, blocks, 4096, 1.0 / WORLD,
                 f"{blocks} blocks")
        out["dequant_acc_requant"].append(shape_row(
            timer,
            lambda: kernels.dequant_acc_requant(lv, nm, local, seed, 127,
                                                scale=1.0 / WORLD),
            ring_names, 6 * n + 8 * blocks,
            OPS_PER_ELEM["dequant_acc_requant"] * n, blocks=blocks, n=n,
            path=path, per_step=per_step))
    for blocks, (units, path) in rings.items():
        n = blocks * 4096
        x = torch.randn(n, device="cuda", generator=g) * 1e-2
        same_encode(torch, kernels, x, blocks, f"{blocks} blocks")
        out["chunk_encode"].append(shape_row(
            timer, lambda: kernels.chunk_encode(x, seed, 127), ring_names,
            5 * n + 4 * blocks, OPS_PER_ELEM["chunk_encode"] * n,
            blocks=blocks, n=n, path=path, per_step=units * WORLD))
    out["qsgd_quantize"] = quantize_rows(torch, kernels, timer, quant, g)
    out["dequant_mean"], out["int_accumulate"], out["acc_decode"] = \
        reduce_rows(torch, kernels, timer, quant, network, g)
    return out


def on_card(row: dict) -> str:
    """A row's profiled kernel time and the HBM rate it implies."""
    if row["device_ms"] is None:
        return "device not measured"
    rate = row["bytes"] / row["device_ms"] / 1e9  # TB/s
    return (f"device {row['device_ms']:.4f} ms ({rate:.2f} TB/s, "
            f"{100 * rate * 1e12 / hbm_bytes_per_s:.0f}% of HBM)")


def alone_vs_bound(c: dict) -> str:
    """A kernel line's profiled kernel time, and what share of it the
    bound is."""
    if c["device_ms"] is None:
        return "device not measured"
    return (f"device {c['device_ms']:.4f} ms "
            f"(the bound is {100 * c['bound_ms'] / c['device_ms']:.0f}% "
            "of it)")


def print_path_shapes(shapes: dict, network: str) -> None:
    print(f"shape {network} floor: one-element zero_() "
          f"{shapes['floor_ms']:.4f} ms", flush=True)
    for row in shapes["block_top1"]:
        print(f"shape {network} block_top1 {tuple(row['shape'])} "
              f"x{row['per_m5_step']} "
              f"per M5 step: {row['ms']:.4f} ms, bound {row['bound_ms']:.5f} "
              f"ms ({100 * row['share']:.1f}%), vector_norm(inf) "
              f"{row['library_ms']:.4f} ms; {on_card(row)}", flush=True)
    def timed(row):
        return (f"{row['ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
                f"({100 * row['share']:.1f}%); {on_card(row)}")

    for name in ("dequant_acc_requant", "chunk_encode"):
        for row in shapes[name]:
            print(f"shape {network} {name} {row['blocks']} blocks "
                  f"x{row['per_step']} per {row['path']} step: "
                  f"{timed(row)}", flush=True)
    for row in shapes["qsgd_quantize"]:
        how = "per tensor" if row["block"] is None else f"block {row['block']}"
        print(f"shape {network} qsgd_quantize {row['n']} {how} "
              f"{row['per_step']} step: {timed(row)}", flush=True)
    for row in shapes["dequant_mean"]:
        how = "per tensor" if row["block"] is None else f"block {row['block']}"
        print(f"shape {network} dequant_mean [{WORLD}, {row['n']}] {how} "
              f"{row['per_step']} step: {timed(row)}", flush=True)
    for row in shapes["int_accumulate"]:
        print(f"shape {network} int_accumulate [{WORLD}, {row['n']}] "
              f"{row['per_step']}: {timed(row)}", flush=True)
    for row in shapes["acc_decode"]:
        print(f"shape {network} acc_decode {row['n']} per tensor k={WORLD} "
              f"{row['per_step']}: {timed(row)}", flush=True)
    print(f"shapes {network}: " + json.dumps(shapes), flush=True)


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
        # The dense payload: each gradient leaf at the policy's wire dtype.
        from ewdml_tpu_torch.core.precision import wire_cast
        grads = [p.grad for p in trainer.state.workers[0].model.parameters()]
        return sum(t.numel() * t.element_size()
                   for t in wire_cast(grads, cfg.precision.wire_dtype))
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


def train_phase(torch, kernels, network: str) -> tuple:
    """Phases 3 and 3b: the network at full width under Methods 1, 2, 4, 5,
    6 and the ring transports."""
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.train.loop import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    per_method = {}
    counts = {k: 0 for k in kernels.LAUNCHES}
    for name, steps, flags in RUNS:
        argv = ["--network", network, "--dataset", "Cifar10",
                "--synthetic-data", "--num-workers", str(WORLD),
                "--batch-size", "128", "--topk-ratio", "0.01",
                "--max-steps", str(steps), "--epochs", "100",
                "--log-every", "1000", "--no-bf16", "--eval-freq", "0",
                *flags]
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
        per_step = {k: v / steps for k, v in launched.items() if v}
        per_method[name] = dict(
            network=network, steps=steps, final_loss=res.final_loss,
            mean_step_ms=res.mean_step_s * 1e3, wall_s=wall,
            wire_per_step=res.wire.per_step_bytes,
            transport=res.wire.transport,
            units=len(res.wire.per_layer_up), launches=launched,
            launches_per_step=per_step, **extra)
        print(f"train {name}: network={network} steps={steps} "
              f"loss={res.final_loss:.4f} "
              f"mean_step={res.mean_step_s * 1e3:.2f}ms wall={wall:.1f}s "
              f"wire_per_step={res.wire.per_step_bytes} B "
              f"units={len(res.wire.per_layer_up)} launches={launched} "
              f"per_step={per_step} eval_loss={ev['loss']:.4f} {extra}",
              flush=True)
        del trainer
        torch.cuda.empty_cache()
    return counts, per_method


# Phase 3c: the device-resident feed and the scan window. (name, network,
# steps, K, flags); K = 0 is the auto window (Method 6: its sync period, 20).
# Three windows a run: the warm-up (K per-step dispatches), the capture and
# its first replay, a replay.
WINDOW_RUNS = [
    ("M1", "VGG11", 24, 8, ["--method", "1"]),
    ("M4", "VGG11", 24, 8, ["--method", "4"]),
    ("M5", "VGG11", 24, 8, ["--method", "5"]),
    ("M4 ring_rs", "VGG11", 24, 8, ["--method", "4", "--gather-type",
                                     "ring_rs", "--qsgd-block", "4096"]),
    ("M6", "VGG11", 60, 0, ["--method", "6"]),
    # ResNet50's window is replayed once (16 steps), VGG11-BN's twice.
    ("M4", "ResNet50", 16, 8, ["--method", "4"]),
]


def opt_tensors(opt_state) -> list:
    """``(name, tensor)`` of an optimizer state: SGD's momentum buffers, or
    Adam's count and moments."""
    if hasattr(opt_state, "mu"):
        return ([("adam count", opt_state.count)]
                + [(f"adam mu {i}", t) for i, t in enumerate(opt_state.mu)]
                + [(f"adam nu {i}", t) for i, t in enumerate(opt_state.nu)])
    return [(f"momentum {i}", t) for i, t in enumerate(opt_state.momentum_buf)]


def same_state(a, b, what: str) -> None:
    """Every parameter, BatchNorm statistic, optimizer buffer and residual
    of two trainers' workers bit-equal."""
    import torch

    for w, (x, y) in enumerate(zip(a.state.workers, b.state.workers)):
        pairs = list(zip(x.model.state_dict().items(),
                         y.model.state_dict().items()))
        pairs += [((name, p), (None, q)) for (name, p), (_, q) in zip(
            opt_tensors(x.opt_state), opt_tensors(y.opt_state))]
        pairs += [((f"residual {i}", p), (None, q)) for i, (p, q) in
                  enumerate(zip(x.residual, y.residual))]
        for (name, p), (_, q) in pairs:
            if not torch.equal(p, q):
                raise AssertionError(f"{what}: worker {w} {name} differs "
                                     "between the two runs")


def window_phase(torch, kernels, runs_list=None) -> tuple:
    """Phase 3c (and 6f with ``runs_list``): each run twice from the same
    state, per-step (``--scan-window 1``) and windowed, through the CLI's
    config and the Trainer, both on ``--feed device``; deterministic
    kernels (cuDNN's weight gradients and ``index_add_`` sum with atomics
    otherwise)."""
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.train.loop import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cudnn.deterministic = True
    counts = {k: 0 for k in kernels.LAUNCHES}
    out = {}
    try:
        for name, network, steps, k, flags in runs_list or WINDOW_RUNS:
            runs = []
            for window in (1, k):
                argv = ["--network", network, "--dataset", "Cifar10",
                        "--synthetic-data", "--num-workers", str(WORLD),
                        "--batch-size", "128", "--topk-ratio", "0.01",
                        "--max-steps", str(steps), "--epochs", "100",
                        "--log-every", "1000", "--no-bf16", "--feed",
                        "device", "--eval-freq", "0", *flags]
                if window:
                    argv += ["--scan-window", str(window)]
                trainer = Trainer(from_args(argv))
                kernels.reset_launches()   # this run of the main path
                t0 = time.perf_counter()
                res = trainer.train()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launched = dict(kernels.LAUNCHES)  # read just after it
                for kk, v in launched.items():
                    counts[kk] += v
                if not math.isfinite(res.final_loss):
                    raise AssertionError(f"window {network} {name}: "
                                         f"non-finite loss {res.final_loss}")
                runs.append((trainer, res, launched, wall))
            (ref, rres, rl, rwall), (win, wres, wl, wwall) = runs
            what = f"window {network} {name}"
            ws = win.window_step
            kwin = win.scan_window
            windows = steps // kwin
            if ref.window_step is not None or ws is None:
                raise AssertionError(f"{what}: the runs are not per-step "
                                     "and windowed")
            if (ws.eager_windows, ws.captures, ws.replays) != (
                    1, 1, windows - 1):
                raise AssertionError(
                    f"{what}: {ws.eager_windows} eager windows, "
                    f"{ws.captures} captures, {ws.replays} replays; want "
                    f"1, 1, {windows - 1} (one replay per window)")
            if rres.rows.shape != (steps, WORLD, 3) or not torch.equal(
                    torch.from_numpy(wres.rows), torch.from_numpy(rres.rows)):
                raise AssertionError(f"{what}: metrics rows differ")
            same_state(ref, win, what)
            per_replay = next(iter(ws._graphs.values())).launches
            if wl != rl or any(per_replay[kk] * windows != rl[kk]
                               for kk in rl):
                raise AssertionError(
                    f"{what}: launches {wl} windowed, {rl} per-step, "
                    f"{per_replay} per replay of {windows} windows")
            row = dict(network=network, steps=steps, window=kwin,
                       per_step_ms=rres.mean_step_s * 1e3,
                       window_ms=wres.mean_step_s * 1e3,
                       capture_s=ws.capture_s, replays=ws.replays,
                       launches=wl, launches_per_replay=per_replay,
                       wall_s=[rwall, wwall], final_loss=wres.final_loss)
            out[f"{network} {name}"] = row
            print(f"window {name}: network={network} K={kwin} steps={steps} "
                  f"per_step={rres.mean_step_s * 1e3:.2f}ms "
                  f"windowed={wres.mean_step_s * 1e3:.2f}ms "
                  f"capture={ws.capture_s:.2f}s replays={ws.replays} "
                  f"per_replay={ {kk: v for kk, v in per_replay.items() if v} } "
                  f"bit_equal=rows,state,launches "
                  f"loss={wres.final_loss:.4f}", flush=True)
            del runs, ref, win, ws
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    return counts, out


# {network: [(name, flags)]}: phase 4, the async parameter server.
ASYNC_RUNS = {"VGG11": [
    ("qsgd decode", ["--compress-grad", "qsgd", "--server-agg", "decode"]),
    ("qsgd homomorphic", ["--compress-grad", "qsgd",
                          "--server-agg", "homomorphic"]),
    ("qsgd block4096 homomorphic", ["--compress-grad", "qsgd",
                                    "--qsgd-block", "4096",
                                    "--server-agg", "homomorphic"]),
    ("topk_qsgd homomorphic", ["--compress-grad", "topk_qsgd",
                               "--topk-ratio", "0.01",
                               "--server-agg", "homomorphic"]),
], "ResNet50": [
    ("qsgd homomorphic", ["--compress-grad", "qsgd",
                          "--server-agg", "homomorphic"]),
]}
# Steps per worker; ResNet50's runs are cut to 2 (2 updates) to keep the
# whole script well inside its time limit.
ASYNC_STEPS = {"VGG11": 4, "ResNet50": 2}
ASYNC_TRACED = ("VGG11", "qsgd homomorphic")  # the run with --trace-dir


def traced_spans(trace_dir: str, kind=None) -> dict:
    """Shut the process's tracer down (flushing its shard) and count the
    shard's events by name (of ``kind`` only, if given)."""
    from ewdml_tpu_torch.obs import trace

    trace.shutdown()
    shards = [f for f in os.listdir(trace_dir) if f.startswith("shard-")]
    if len(shards) != 1:
        raise AssertionError(f"{trace_dir} holds shards {shards}, want one")
    counts = {}
    with open(os.path.join(trace_dir, shards[0])) as f:
        meta = json.loads(f.readline())
        if meta.get("kind") != "meta":
            raise AssertionError(f"{shards[0]} has no meta line first")
        for line in f:
            ev = json.loads(line)
            if kind is None or ev["kind"] == kind:
                counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    shutil.rmtree(trace_dir)
    return counts


def expected_async_launches(cfg, specs, kernels, pushes, updates) -> dict:
    """Kernel launches of one async run: per push (and once for the payload
    schema's template) a quantize per leaf of at least MIN_ELEMS and a
    threefry draw per smaller leaf under decode, a draw per leaf (the
    shared-scale encode) under homomorphic; per round (and once for the
    warm apply) an accumulate and a decode per leaf of at least MIN_ELEMS
    under homomorphic (the decode only for Top-k), and a stochastic-round
    launch per ``round_launches`` of the optimizer's stored leaves."""
    want = {k: 0 for k in kernels.LAUNCHES}
    shapes = [s.jax_shape for s in specs]
    big = sum(1 for s in shapes if math.prod(s) >= kernels.MIN_ELEMS)
    if cfg.server_agg == "decode":
        if cfg.compress_grad == "qsgd":
            for k, v in compress_launches(cfg, shapes, kernels).items():
                want[k] = v * (pushes + 1)
    else:
        want["acc_decode"] = big * (updates + 1)
        if cfg.compress_grad == "qsgd":
            want["int_accumulate"] = big * (updates + 1)
        want["random_bits"] = len(shapes) * (pushes + 1)
    if cfg.precision.bf16_state:
        # The server's optimizer stores every leaf's state per update (and
        # once in the warm apply) as one set: Adam's two moments, SGD's
        # momentum.
        stores = 2 if cfg.optimizer == "adam" else 1
        want["stochastic_round"] = kernels.round_launches(
            len(specs) * stores) * (updates + 1)
    return want


def async_phase(torch, kernels, network: str, runs_flags) -> tuple:
    """Phase 4: the async parameter server on the network at full width."""
    import numpy as np

    from ewdml_tpu_torch import native
    from ewdml_tpu_torch.cli import run_async
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs
    from ewdml_tpu_torch.obs.registry import MetricsRegistry
    from ewdml_tpu_torch.train.metrics import wire_plan

    specs = leaf_specs(build_model(network, 10, dataset="Cifar10"))
    counts = {k: 0 for k in kernels.LAUNCHES}
    runs = {}
    for name, flags in runs_flags:
        argv = ["--mode", "async", "--network", network, "--dataset",
                "Cifar10", "--synthetic-data", "--num-workers", str(WORLD),
                "--num-aggregate", str(WORLD), "--batch-size", "128",
                "--max-steps", str(WORLD * ASYNC_STEPS[network]),
                "--fusion", "none",
                *flags]
        trace_dir = None
        if (network, name) == ASYNC_TRACED:
            trace_dir = tempfile.mkdtemp(prefix="ewdml_async_trace_")
            argv += ["--trace-dir", trace_dir]
        cfg = from_args(argv)
        reg = MetricsRegistry()
        kernels.reset_launches()   # this run of the main path starts here
        t0 = time.perf_counter()
        _, stats = run_async(cfg, registry=reg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dict(kernels.LAUNCHES)  # read just after it
        for k, v in launched.items():
            counts[k] += v
        pushes, updates = WORLD * ASYNC_STEPS[network], ASYNC_STEPS[network]
        if (stats.pushes, stats.updates) != (pushes, updates):
            raise AssertionError(f"async {name}: {stats.pushes} pushes and "
                                 f"{stats.updates} updates, want {pushes} "
                                 f"and {updates}")
        gauges = reg.snapshot()["gauges"]
        if (gauges["ps.pushes"], gauges["ps.updates"]) != (pushes, updates):
            raise AssertionError(f"async {name}: the registry holds "
                                 f"{gauges}, want {pushes} pushes and "
                                 f"{updates} updates")
        per_round = (0 if not cfg.compression_enabled
                     else 1 if cfg.server_agg == "homomorphic" else WORLD)
        if stats.decode_count != per_round * stats.apply_rounds:
            raise AssertionError(f"async {name}: {stats.decode_count} decodes "
                                 f"in {stats.apply_rounds} rounds")
        want = expected_async_launches(cfg, specs, kernels, pushes, updates)
        if launched != want:
            raise AssertionError(f"async {name}: launches {launched}, want "
                                 f"{want}")
        losses = [l for _, l in stats.loss_history]
        if len(losses) != pushes or not all(map(math.isfinite, losses)):
            raise AssertionError(f"async {name}: losses {losses}")
        plan = wire_plan(cfg, [(s.name, s.jax_shape) for s in specs],
                         world=WORLD)
        frame = native.encoded_arrays_size([np.empty(plan.up_bytes,
                                                     np.uint8)])
        if stats.bytes_up != pushes * frame:
            raise AssertionError(f"async {name}: {stats.bytes_up} B up, the "
                                 f"wire plan's frames are {pushes} x {frame}")
        if trace_dir is not None:
            spans = traced_spans(trace_dir, "span")
            want = {"ps/pull": pushes, "ps/push": pushes,
                    "worker/grad": pushes, "ps/apply": updates}
            if spans != want:
                raise AssertionError(f"async {name}: trace spans {spans}, "
                                     f"want {want}")
            print(f"trace async {name}: network={network} spans={spans}",
                  flush=True)
        runs[name] = dict(network=network, leaves=len(specs),
                          pushes=stats.pushes, updates=stats.updates,
                          decode_count=stats.decode_count,
                          apply_rounds=stats.apply_rounds,
                          apply_ms_mean=stats.apply_ms_mean, wall_s=wall,
                          bytes_up=stats.bytes_up, plan_up=plan.up_bytes,
                          loss_tail=stats.loss_tail_mean(4),
                          mean_staleness=stats.mean_staleness,
                          launches=launched)
        print(f"async {name}: network={network} leaves={len(specs)} "
              f"pushes={stats.pushes} updates={stats.updates} "
              f"decodes={stats.decode_count}/{stats.apply_rounds} rounds "
              f"apply_ms_mean={stats.apply_ms_mean:.3f} wall={wall:.1f}s "
              f"up={stats.bytes_up} B (plan {plan.up_bytes} B/push) "
              f"loss_tail={stats.loss_tail_mean(4):.4f} launches={launched}",
              flush=True)
        torch.cuda.empty_cache()
    return counts, runs


# Phase 5: checkpoints, resume, the evaluator, the trace layer and the
# profiler on VGG11-BN at full width, --feed device, deterministic kernels.
# (name, steps before the save, steps in all, flags).
RESUME_RUNS = [
    ("M4", 8, 16, ["--method", "4", "--scan-window", "1",
                   "--eval-freq", "8"]),
    # Saved at step 10, inside the local phase of the 20-step sync period.
    ("M6", 10, 20, ["--method", "6", "--scan-window", "1",
                    "--eval-freq", "10"]),
    ("M4 windowed", 8, 16, ["--method", "4", "--scan-window", "8",
                            "--eval-freq", "8"]),
]
TRACE_SPANS = {"train/dispatch": 8, "train/compile": 1, "train/window": 1,
               "train/checkpoint": 2, "eval/full_test": 1}


def vgg_argv(steps: int, flags, train_dir: str, network: str = "VGG11"):
    return ["--network", network, "--dataset", "Cifar10", "--synthetic-data",
            "--num-workers", str(WORLD), "--batch-size", "128",
            "--topk-ratio", "0.01", "--max-steps", str(steps), "--epochs",
            "100", "--log-every", "1000", "--no-bf16", "--feed", "device",
            "--train-dir", train_dir, *flags]


def cpu_tree(tree):
    """A worker tree's leaves copied to the host."""
    if isinstance(tree, dict):
        return {k: cpu_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def same_tree(torch, a, b, what: str, path: str = "") -> None:
    if isinstance(a, dict):
        if list(a) != list(b):
            raise AssertionError(f"{what}: keys differ at {path}")
        for k in a:
            same_tree(torch, a[k], b[k], what, f"{path}/{k}")
    elif not torch.equal(a.cpu(), b.cpu()):
        raise AssertionError(f"{what}: {path} differs")


def blob_world(path: str) -> int:
    """The worker count a checkpoint records (its arrays are not read)."""
    import mmap

    from ewdml_tpu_torch.utils.msgpack import Reader

    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        reader = Reader(mm, arrays=False)
        try:
            return int(reader.value()["world"])
        finally:
            reader.release()


def kernel_share(profile_dir: str) -> dict:
    """From a ``--profile-dir`` Chrome trace: the kernels' names and the
    share of the profiled window (the first ``train/dispatch`` range's start
    to the last kernel's end) during which some kernel runs."""
    (name,) = os.listdir(profile_dir)
    with open(os.path.join(profile_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "kernel" and "dur" in e)
    starts = [float(e["ts"]) for e in events
              if e.get("name") == "train/dispatch" and "dur" in e]
    if not spans or not starts:
        raise AssertionError(f"{name}: {len(spans)} kernels, "
                             f"{len(starts)} train/dispatch ranges")
    t0, t1 = min(starts), max(end for _, end in spans)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    names = {e["name"] for e in events if e.get("cat") == "kernel"}
    shutil.rmtree(profile_dir)
    return dict(share=busy / (t1 - t0), busy_ms=busy / 1e3,
                window_ms=(t1 - t0) / 1e3, kernels=len(spans), names=names)


def timed(fn) -> float:
    """Seconds of one call of ``fn``, the card idle before and after."""
    from ewdml_tpu_torch.utils import timing

    timing.synchronize()
    return timing.timed_window(fn, iters=1) / 1e3


def run_evaluator(argv: list) -> dict:
    """``python -m ewdml_tpu_torch.train.evaluator`` on the card, one poll;
    its one ``validation`` line. TF32 is off there as here."""
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
    out = subprocess.run(
        [sys.executable, "-m", "ewdml_tpu_torch.train.evaluator", *argv,
         "--max-polls", "1", "--eval-interval", "0"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"evaluator exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("validation ")]
    if len(lines) != 1:
        raise AssertionError(f"evaluator printed {lines}")
    return json.loads(lines[0][len("validation "):])


def resume_run(torch, kernels, counts, name, first, total, flags, root,
               smi) -> dict:
    """One run of phase 5: uninterrupted, and stopped at a save then
    restored in a fresh Trainer and carried on; bit-equal. The windowed
    run's fresh Trainer first trains on its own (capturing its graph), is
    then restored in place and replays that graph on the restored state,
    under ``--profile-dir``. The M4 per-step run's stopped Trainer traces
    (``--trace-dir``), times a save and a restore, and its checkpoint is
    evaluated by the polling evaluator in a second process."""
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.train import checkpoint
    from ewdml_tpu_torch.train.loop import Trainer
    from ewdml_tpu_torch.train.state import state_tree

    def run(trainer, max_steps=None):
        kernels.reset_launches()   # this run of the main path starts here
        res = trainer.train(max_steps)
        torch.cuda.synchronize()
        for k, v in kernels.LAUNCHES.items():  # read just after it
            counts[k] += v
        return res

    what = f"resume {name}"
    per_step_m4 = name == "M4"
    windowed = "--scan-window" in flags and \
        flags[flags.index("--scan-window") + 1] != "1"
    out = {}
    full = Trainer(from_args(vgg_argv(total, flags,
                                      os.path.join(root, "full"))))
    fres = run(full)
    d = os.path.join(root, "stopped")
    argv = vgg_argv(first, flags, d)
    trace_dir = tempfile.mkdtemp(prefix="ewdml_trace_") if per_step_m4 \
        else None
    stopped = Trainer(from_args(argv + (["--trace-dir", trace_dir]
                                        if trace_dir else [])))
    sres = run(stopped)
    path = checkpoint.latest_path(d)
    if checkpoint.peek_step(path) != first:
        raise AssertionError(f"{what}: the checkpoint is at step "
                             f"{checkpoint.peek_step(path)}, not {first}")
    world = blob_world(path)
    saved = cpu_tree(state_tree(stopped.state.workers, stopped.specs,
                                stacked=True))
    if world != WORLD:  # VGG11-BN's statistics are per worker
        raise AssertionError(f"{what}: a blob of world {world}")
    leaf = saved["params"]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    differ = not all(torch.equal(leaf[0], leaf[r]) for r in range(1, WORLD))
    if name == "M6" and not differ:
        raise AssertionError(f"{what}: the workers' parameters are equal "
                             "inside the local phase")
    if per_step_m4:
        ref = stopped.evaluate()
        spans = traced_spans(trace_dir)
        if spans != TRACE_SPANS:
            raise AssertionError(f"{what}: trace spans {spans}, want "
                                 f"{TRACE_SPANS}")
        out["spans"] = spans
        print(f"trace {name}: network=VGG11 spans={spans}; {smi}",
              flush=True)
        out["save_s"] = timed(lambda: stopped._save_ckpt(first))
        out["bytes"] = os.path.getsize(path)
        got = run_evaluator(argv)
        for key in ("loss", "top1", "top5"):
            if abs(got[key] - ref[key]) > 1e-6 * abs(ref[key]):
                raise AssertionError(f"{what}: the evaluator's {key} "
                                     f"{got[key]} against {ref[key]}")
        if got["step"] != first:
            raise AssertionError(f"{what}: the evaluator read step "
                                 f"{got['step']}")
        out["evaluator"] = got
        print(f"evaluator {name}: network=VGG11 step={got['step']} "
              f"loss={got['loss']!r} top1={got['top1']!r} "
              f"top5={got['top5']!r}, run_eval of worker 0 loss="
              f"{ref['loss']!r} top1={ref['top1']!r} top5={ref['top5']!r}; "
              f"{smi}", flush=True)
    del stopped
    if windowed:
        pre = os.path.join(root, "pre")
        resumed = Trainer(from_args(vgg_argv(total, flags, pre)))
        run(resumed)
        shutil.copyfile(path, os.path.join(pre, checkpoint.CKPT_BASENAME))
        captures = resumed.window_step.captures
    else:
        resumed = Trainer(from_args(vgg_argv(total, flags, d)))
    restore_s = timed(resumed.maybe_restore)
    if resumed.state.step != first:
        raise AssertionError(f"{what}: restored at {resumed.state.step}")
    same_tree(torch, state_tree(resumed.state.workers, resumed.specs,
                                stacked=True), saved,
              f"{what}: restored against saved")
    if per_step_m4:
        out["restore_s"] = restore_s
    if windowed:
        replays = resumed.window_step.replays
        resumed.cfg.profile_dir = tempfile.mkdtemp(prefix="ewdml_profile_")
    rres = run(resumed)
    if windowed:
        ws = resumed.window_step
        if ws.captures != captures or ws.replays != replays + 1:
            raise AssertionError(f"{what}: {ws.captures - captures} "
                                 "captures and "
                                 f"{ws.replays - replays} replays after the "
                                 "restore; want 0 and 1")
        prof = kernel_share(resumed.cfg.profile_dir)
        for kname in ("qsgd_quantize_kernel", "dequant_mean_kernel"):
            if not any(kname in n for n in prof["names"]):
                raise AssertionError(f"{what}: no {kname} in the profile")
        out["kernel_share"] = prof["share"]
        print(f"profile {name}: one replay of K=8 steps after the restore: "
              f"kernels busy {100 * prof['share']:.1f}% of the profiled "
              f"window ({prof['busy_ms']:.3f} of {prof['window_ms']:.3f} "
              f"ms, {prof['kernels']} kernels); {smi}", flush=True)
    same_state(full, resumed, what)
    if not torch.equal(torch.from_numpy(fres.rows[first:]),
                       torch.from_numpy(rres.rows)):
        raise AssertionError(f"{what}: metrics rows after the restore differ")
    out.update(first=first, total=total, world=world,
               workers_differ=differ)
    print(f"resume {name}: network=VGG11 {first}+{total - first} steps, "
          f"blob world={world}, workers differ={differ}, bit_equal="
          f"restored,params,stats,momentum,residuals,rows; {smi}",
          flush=True)
    return out


def checkpoint_phase(torch, kernels, windows: dict, smi: str) -> tuple:
    """Phase 5 (see the module docstring)."""
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.train import flops
    from ewdml_tpu_torch.train.loop import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cudnn.deterministic = True
    counts = {k: 0 for k in kernels.LAUNCHES}
    out = {}
    root = tempfile.mkdtemp(prefix="ewdml_ckpt_")
    try:
        for name, first, total, flags in RESUME_RUNS:
            out[name] = resume_run(torch, kernels, counts, name, first,
                                   total, flags, os.path.join(root, name),
                                   smi)
            torch.cuda.empty_cache()
        m4 = out["M4"]
        print(f"checkpoint VGG11 W={WORLD}: {m4['bytes']} B, save "
              f"{m4['save_s']:.3f} s, restore {m4['restore_s']:.3f} s; "
              f"{smi}", flush=True)
        r50 = Trainer(from_args(vgg_argv(0, ["--method", "4"],
                                         os.path.join(root, "r50"),
                                         network="ResNet50")))
        save_s = timed(lambda: r50._save_ckpt(0))
        size = os.path.getsize(os.path.join(root, "r50", "model_step_"))
        restore_s = timed(r50.maybe_restore)
        out["ResNet50"] = dict(bytes=size, save_s=save_s,
                               restore_s=restore_s)
        print(f"checkpoint ResNet50 W={WORLD}: {size} B, save {save_s:.3f} "
              f"s, restore {restore_s:.3f} s; {smi}", flush=True)
        del r50
        # The FLOPs of one VGG11-BN M1 step (W = 4 workers on this card),
        # and its MFU at phase 3c's windowed step time.
        m1 = Trainer(from_args(vgg_argv(1, ["--method", "1",
                                            "--scan-window", "1",
                                            "--eval-freq", "0"],
                                        os.path.join(root, "m1"))))
        x, y = m1._device_split(m1._train_split())
        fl = flops.count_flops(m1.train_step, m1.state, x, y, m1.base_key)
        step_s = windows["VGG11 M1"]["window_ms"] / 1e3
        mfu = flops.mfu(fl, step_s, device=torch.device("cuda"), bf16=False)
        peak = flops.peak_tflops(torch.device("cuda"), bf16=False)
        out["flops_m1"] = dict(flops=fl, step_s=step_s, mfu=mfu,
                               peak_tflops=peak)
        print(f"flops VGG11 M1: {fl:.6g} FLOP a step (W={WORLD}, batch 128 "
              f"each), windowed {step_s * 1e3:.2f} ms a step, mfu {mfu} of "
              f"the FP32 peak {peak} TFLOP/s; {smi}", flush=True)
        del m1
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    return counts, out


def apply_alone(torch, flags, network: str, rounds: int = 6):
    """The server's apply with no worker threads running: K = W = 4 pushes
    of the network's payloads (compressed from one random gradient) per
    round, from one thread; returns the server's ``PSStats``, whose
    ``apply_ms_mean`` (and, under ``--ps-down delta``, ``delta_ms_mean``)
    is an observation beside the async runs', which share the card and the
    interpreter with the workers."""
    from ewdml_tpu_torch import native
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs, to_jax
    from ewdml_tpu_torch.ops import make_compressor
    from ewdml_tpu_torch.ops.homomorphic import make_homomorphic
    from ewdml_tpu_torch.optim import make_optimizer
    from ewdml_tpu_torch.parallel import ps
    from ewdml_tpu_torch.train.state import leaf_params
    from ewdml_tpu_torch.utils import prng, transfer

    cfg = from_args(flags)
    model = build_model(network, 10, dataset="Cifar10").cuda()
    specs = leaf_specs(model)
    params = [to_jax(p.detach(), s.kind).contiguous()
              for p, s in zip(leaf_params(model, specs), specs)]
    g = torch.Generator(device="cuda").manual_seed(3)
    grads = [torch.randn(p.shape, device="cuda", generator=g) * 1e-2
             for p in params]
    comp = make_compressor(cfg.compress_grad, cfg.quantum_num,
                           cfg.topk_ratio, cfg.topk_exact, cfg.qsgd_block)
    if cfg.server_agg == "homomorphic":
        comp = make_homomorphic(comp, grads)
    server = ps.ParameterServer(params, make_optimizer("sgd", 0.01, 0.9),
                                comp, num_aggregate=WORLD,
                                server_agg=cfg.server_agg, device="cuda",
                                down_mode=cfg.ps_down,
                                bootstrap=cfg.ps_bootstrap)
    compress = ps.make_compress_tree(comp)
    server.register_payload_schema(compress(grads, prng.key(0)))
    pack = transfer.make_device_packer()
    msgs = [native.encode_arrays([pack(compress(grads, prng.key(w)))
                                  .cpu().numpy()]) for w in range(WORLD)]
    for _ in range(rounds):
        for w, msg in enumerate(msgs):
            server.push(ps.PushRecord(w, server.version, msg, 0.0))
    return server.stats


# -- Phase 6: the precision policy, Adam, the negative result, overlap --------

SROUND_SHAPE = (512, 512, 3, 3)   # VGG11-BN's largest leaf, a conv kernel
SROUND_SPECIALS = [0.0, -0.0, 1e-40, -1e-40, 3.4028235e38, -3.4028235e38,
                   float("inf"), float("-inf"), float("nan"), 1.0, -2.5,
                   0.15625]
# The function's own operations an element, the bound's operations side of
# both threefry kernels, counted as the card's three-input adds and logic
# ops and its funnel shift compute them, with the counter's high word (0
# below 2^32 elements) folded into the key: the low word plus its key (1),
# 20 rounds of an add, a rotation and an xor (60; the first four key
# injections into x0 fold into the next round's three-input add), the five
# injections into x1 and the last into x0 (6), and the output's xor (1):
# 68 (THREEFRY_OPS). The store adds the dither's add (its 16-bit mask folds
# into the xor), the NaN test and its select, and half a byte permute that
# packs two bf16 into a word (71.5: the compiled identity loop takes 74.50
# SASS instructions an element, loads, store and loop control included);
# the draw adds nothing for the bits (the int64's high word is a zero
# register) and a shift-with-add and a subtract for a uniform (70). The
# rotations and xors (40 an element) run on the INT32 pipe, at half the
# issue rate: 64 lanes an SM a clock (INT32_LANES_PER_CLOCK).
THREEFRY_OPS = 68
SROUND_OPS = THREEFRY_OPS + 3.5
DRAW_OPS = {"bits": THREEFRY_OPS, "uniform": THREEFRY_OPS + 2}
INT32_OPS = 40
INT32_LANES_PER_CLOCK = 132 * 64
RESIDUAL_TAG = 0x0E5F   # train/trainer.RESIDUAL_TAG


def sass_ops_per_elem(build) -> dict:
    """Instructions an element of the round kernel's three index maps, from
    the SASS of the built library (``cuobjdump -sass``): each of its
    vector loops (the backward branches whose body holds a 16-byte store)
    over the elements its stores write (8 a store). The smallest is the
    identity layout, the largest the carry chain of an innermost dim
    shorter than 8, the middle one every other permuted leaf.
    ``{"identity": n, "permuted": n, "narrow": n}``."""
    import re

    lib = build.build()
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    txt = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    for m in re.finditer(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)",
                         txt, re.S):
        if "stochastic_round_kernel" not in m.group(1):
            continue
        ins = []
        for line in m.group(2).splitlines():
            mm = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
            if mm:
                ins.append((int(mm.group(1), 16), mm.group(2)))
        loops = []
        for addr, text in ins:
            b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if b and int(b.group(1), 16) < addr:
                lo = int(b.group(1), 16)
                body = [t for a, t in ins if lo <= a <= addr
                        and not t.strip().startswith("NOP")]
                stores = sum(1 for t in body if "STG.E.128" in t)
                if stores:
                    loops.append(len(body) / (8 * stores))
        if len(loops) == 3:
            ident, wide, narrow = sorted(loops)
            return {"identity": ident, "permuted": wide, "narrow": narrow}
        raise AssertionError(f"{m.group(1)}: vector loops {loops}, want 3")
    raise AssertionError("no stochastic_round_kernel SASS found")


def same_bf16(torch, a, b, what: str) -> None:
    """Bit-equal bf16 tensors, NaN lanes compared by ``isnan``."""
    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    if not torch.equal(na, nb) or not torch.equal(
            a.view(torch.int16)[~na], b.view(torch.int16)[~nb]):
        raise AssertionError(f"{what}: the kernel differs from its plain "
                             "version")


def leaf_shapes(network: str, unique: bool = True) -> list:
    """``(kind, torch shape)`` of the network's leaves, each once (sorted),
    or all of them in the JAX order."""
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs

    model = build_model(network, 10, dataset="Cifar10")
    named = dict(model.named_parameters())
    leaves = [(s.kind, tuple(named[s.torch_name].shape))
              for s in leaf_specs(model)]
    return sorted(set(leaves)) if unique else leaves


def store_sets(torch, network: str, g) -> dict:
    """The network's three store sets on the card, as the training path
    gives them: ``name: (xs, kinds, paths)`` for an SGD update (paths
    ``(i,)``), an Adam update (``(i, 0)``, ``(i, 1)``) and the residuals of
    W workers (flat, ``(RESIDUAL_TAG, r, i)``), specials in every leaf."""
    leaves = leaf_shapes(network, unique=False)
    xs, kinds = [], [k for k, _ in leaves]
    for _, shape in leaves:
        x = torch.randn(shape, device="cuda", generator=g) * 1e-2
        n = min(len(SROUND_SPECIALS), x.numel())
        x.view(-1)[:n] = torch.tensor(SROUND_SPECIALS[:n], device="cuda")
        xs.append(x)
    n = len(xs)
    flat = [x.reshape(-1) for x in xs]
    return {"sgd": (xs, kinds, [(i,) for i in range(n)]),
            "adam": (xs + xs, kinds * 2,
                     [(i, 0) for i in range(n)] + [(i, 1) for i in range(n)]),
            "residual": (flat * WORLD, ["vector"] * n * WORLD,
                         [(RESIDUAL_TAG, r, i) for r in range(WORLD)
                          for i in range(n)])}


def captured(torch, fn):
    """``fn()`` captured in a CUDA graph (after a warm-up call on a side
    stream): ``(graph, what the capture returned)``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def check_sets(torch, kernels, g) -> dict:
    """6a's sets: each of the network's three store sets, in one call of
    the grouped kernel, against the grouped plain version under two host
    keys (launches: ``round_launches`` of the set), then captured under a
    key-table key and replayed for two windows (each replay's parent key,
    from the table); ResNet50's under one key and one replay."""
    from ewdml_tpu_torch.utils import prng
    from ewdml_tpu_torch.utils.keytable import KeyTable

    out = {}
    for network in NETWORKS:
        # ResNet50's sets (161 to 644 leaves) under one host key and one
        # replay: the plain version's time, not the kernel's, is the cost.
        keys = ((0, 42), (0x9E3779B9, 0x7F4A7C15))[:2 if network == "VGG11"
                                                    else 1]
        starts = (0, 9)[:len(keys)]
        for name, (xs, kinds, paths) in store_sets(torch, network,
                                                   g).items():
            for key in keys:
                before = kernels.LAUNCHES["stochastic_round"]
                got = kernels.stochastic_round_set(key, xs, paths, kinds)
                launched = kernels.LAUNCHES["stochastic_round"] - before
                if launched != kernels.round_launches(len(xs)):
                    raise AssertionError(
                        f"{network} {name} set: {launched} launches for "
                        f"{len(xs)} leaves")
                want = kernels.stochastic_round_set_ref(key, xs, paths,
                                                        kinds)
                torch.cuda.synchronize()
                for a, b, p in zip(got, want, paths):
                    same_bf16(torch, a, b, f"{network} {name} set {p}")
            table = KeyTable(prng.key(6), "cuda", 0)
            graph, got = captured(torch, lambda: kernels.stochastic_round_set(
                prng.fold_in(table.step_key(0), 0x0917), xs, paths, kinds))
            for start in starts:
                table.load(start)
                graph.replay()
                want = kernels.stochastic_round_set_ref(
                    prng.fold_in(prng.step_key(prng.key(6), start), 0x0917),
                    xs, paths, kinds)
                torch.cuda.synchronize()
                for a, b, p in zip(got, want, paths):
                    same_bf16(torch, a, b, f"{network} {name} set {p}, "
                                           f"replay at {start}")
            del graph, got
            out[f"{network} {name}"] = dict(
                leaves=len(xs), launches=kernels.round_launches(len(xs)),
                elements=sum(x.numel() for x in xs))
            print(f"set {network} {name}: {len(xs)} leaves, "
                  f"{out[f'{network} {name}']['elements']} elements, "
                  f"{kernels.round_launches(len(xs))} launch(es), bit-equal "
                  "under host keys and replayed key-table keys", flush=True)
    return out


def time_set(torch, kernels, timer, g) -> dict:
    """One whole VGG11-BN SGD store set (its 38 leaves): per step (the
    host packs the descriptors and launches, 20 calls back to back, host
    clock to the synchronize) and inside a window (one captured launch
    under a key-table key, replayed 20 times between CUDA events); the
    kernel's own time from a trace; the bound of the set's elements."""
    from ewdml_tpu_torch.utils import prng
    from ewdml_tpu_torch.utils.keytable import KeyTable

    xs, kinds, paths = store_sets(torch, "VGG11", g)["sgd"]
    outs = [torch.empty(x.shape, dtype=torch.bfloat16, device="cuda")
            for x in xs]
    n = sum(x.numel() for x in xs)
    fn = lambda: kernels.stochastic_round_set((0, 5), xs, paths, kinds, outs)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / 20 * 1e3
    table = KeyTable(prng.key(6), "cuda", 0)
    graph, _ = captured(torch, lambda: kernels.stochastic_round_set(
        table.step_key(0), xs, paths, kinds, outs))
    table.load(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    for _ in range(20):
        graph.replay()
    end.record()
    end.synchronize()
    window = start.elapsed_time(end) / 20
    bnd, by = bound_ms(6 * n, SROUND_OPS * n)
    row = dict(leaves=len(xs), elements=n, per_step_ms=per_step,
               window_ms=window, bound_ms=bnd, bound_by=by,
               device_ms=timer.device(fn, KERNEL_NAMES["stochastic_round"]),
               launches=kernels.round_launches(len(xs)))
    dev = ("device not measured" if row["device_ms"] is None
           else f"device {row['device_ms']:.4f} ms")
    print(f"set VGG11 sgd timed: {len(xs)} leaves ({n} elements) in "
          f"{row['launches']} launch: {per_step:.4f} ms a call per step, "
          f"{window:.4f} ms a replay in a window, {dev}, bound "
          f"{bnd:.4f} ms ({by})", flush=True)
    return row
def check_sround(torch, kernels, timer, build) -> tuple:
    """6a: the stochastic-round kernel against its plain version at every
    VGG11-BN and ResNet50 leaf shape singly (a set of one) and as each
    network's SGD, Adam and residual store sets (also captured under
    key-table keys); timed at VGG11-BN's largest leaf and as a vector of
    its size beside the bound (6 bytes or 71.5 operations an element) and
    the SASS instructions an element, its plain version and its own time
    from a trace; a whole VGG11-BN set per step and in a window; per-shape
    rows at VGG11-BN's leaves."""
    g = torch.Generator(device="cuda").manual_seed(60)
    key = (0x5EED, 0x0917)
    cases = 0
    for network in NETWORKS:
        for kind, shape in leaf_shapes(network):
            x = torch.randn(shape, device="cuda", generator=g) * 1e-2
            flat = x.view(-1)
            n = min(len(SROUND_SPECIALS), flat.numel())
            flat[:n] = torch.tensor(SROUND_SPECIALS[:n], device="cuda")
            a = kernels.stochastic_round_bf16(x, key, kind)
            b = kernels.stochastic_round_ref(x, key, kind)
            torch.cuda.synchronize()
            same_bf16(torch, a, b, f"stochastic_round {network} {kind} "
                                   f"{shape}")
            cases += 1
    sets = check_sets(torch, kernels, g)
    ops = sass_ops_per_elem(build)
    print(f"sass stochastic_round_kernel: {ops['identity']:.2f} instructions "
          f"an element (identity layout), {ops['permuted']:.2f} (permuted), "
          f"{ops['narrow']:.2f} (innermost dim under 8); {cases} leaf "
          f"shapes bit-equal singly, {len(sets)} sets", flush=True)
    rows, timed = [], {}
    for kind, shape in (("conv", SROUND_SHAPE),
                        ("vector", (math.prod(SROUND_SHAPE),))):
        x = torch.randn(shape, device="cuda", generator=g)
        n = x.numel()
        out = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        fn = lambda: kernels.stochastic_round_bf16(x, key, kind, out=out)
        bnd, by = bound_ms(6 * n, SROUND_OPS * n)
        timed[kind] = dict(
            max_abs_err=0.0, ms=timer(fn), bound_ms=bnd, bound_by=by,
            plain_ms=timer(lambda: kernels.stochastic_round_ref(x, key, kind),
                           reps=10),
            library_ms=None, shape=list(shape),
            device_ms=timer.device(fn, KERNEL_NAMES["stochastic_round"]),
            sass_ops=ops, cases=cases)
        int32 = INT32_OPS * n / (ops_per_s / LANES_PER_CLOCK
                                 * INT32_LANES_PER_CLOCK) * 1e3
        sass = ops[index_map(kernels, shape, kind)]
        print(f"stochastic_round {shape}: bytes "
              f"{6 * n / hbm_bytes_per_s * 1e3:.5f} ms, {SROUND_OPS} "
              f"operations {SROUND_OPS * n / ops_per_s * 1e3:.5f} ms at the "
              f"issue rate, {INT32_OPS} INT32 operations {int32:.5f} ms at "
              f"the INT32 pipe's, {sass:.2f} SASS instructions "
              f"{sass * n / ops_per_s * 1e3:.5f} ms; event {timed[kind]['ms']:.4f} ms, "
              f"{alone_vs_bound(timed[kind])}", flush=True)
    row = timed["conv"]
    row["vector"] = timed["vector"]
    row["sets"] = sets
    row["set_time"] = time_set(torch, kernels, timer, g)
    for kind, shape in leaf_shapes("VGG11"):
        xs = torch.randn(shape, device="cuda", generator=g)
        m = xs.numel()
        rows.append(shape_row(
            timer, lambda: kernels.stochastic_round_bf16(xs, key, kind),
            KERNEL_NAMES["stochastic_round"], 6 * m, SROUND_OPS * m,
            kind=kind, shape=list(shape), n=m,
            sass=ops[index_map(kernels, shape, kind)]))
    return row, rows


def index_map(kernels, shape, kind: str) -> str:
    """Which of the round kernel's index maps a leaf takes (the keys of
    :func:`sass_ops_per_elem`)."""
    lay = kernels.round_layout(tuple(shape), kind)
    if not lay.permuted:
        return "identity"
    return "permuted" if lay.d2 >= kernels.ROUND_VEC else "narrow"


def print_sround_rows(rows, launches_per_step: dict) -> None:
    for r in rows:
        print(f"shape stochastic_round {r['kind']} {tuple(r['shape'])} "
              f"({launches_per_step}): "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({100 * r['share']:.1f}%); {on_card(r)}", flush=True)


def draw_sizes() -> dict:
    """The path's draw sizes. Uniform: every leaf size of VGG11-BN and
    ResNet50 (QSGD's threefry stream below ``MIN_ELEMS``, the async
    server's shared-scale encode of a whole leaf at any size) and the top-k
    count of each at the 1% ratio the phases run (the shared-scale Top-k
    QSGD encode draws a uniform of its winners). Bits: the feed's (128,)
    crops and flips and the 50 000-element permutation."""
    from ewdml_tpu_torch.ops import topk

    whole = {math.prod(shape) for net in NETWORKS
             for _, shape in leaf_shapes(net)}
    winners = {topk.static_k(n, 0.01) for n in whole}
    return {"uniform": sorted(whole | winners), "bits": [128, 50_000]}


def device_kernels(torch, fn):
    """The operations the card ran for one call of ``fn`` (kernels, copies
    and fills), from a ``torch.profiler`` trace of the card alone: every
    event but the CUDA runtime's own (``cuda*``, ``cu*``); None where the
    trace holds none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    count = sum(1 for e in prof.events() if not e.name.startswith("cu"))
    return count or None


def check_draws(torch, kernels, timer) -> tuple:
    """Phase 2b: the threefry draw kernel against its plain version at the
    path's sizes and at n = 1, 7, 4099 and 2^17 - 1, bits and uniform,
    under two host keys (one launch a draw) and captured under key-table
    keys (each replay's keys); timed at every path size beside its bound
    (8 or 4 bytes, or 68 or 70 operations, an element), its plain version and its
    own time from a trace; kernels on the card a draw, plain and kernel."""
    from ewdml_tpu_torch.utils import prng
    from ewdml_tpu_torch.utils.keytable import KeyTable

    sizes = draw_sizes()
    every = sorted(set(sizes["uniform"] + sizes["bits"]
                       + [1, 7, 4099, 2**17 - 1]))
    cases = 0
    for n in every:
        for key in ((0, 42), (0x9E3779B9, 0x7F4A7C15)):
            for uniform in (False, True):
                before = kernels.LAUNCHES["random_bits"]
                a = kernels.random_bits(key, n, "cuda", uniform=uniform)
                if kernels.LAUNCHES["random_bits"] != before + 1:
                    raise AssertionError(f"random_bits n={n}: not one launch")
                b = kernels.random_bits_ref(key, n, "cuda", uniform=uniform)
                torch.cuda.synchronize()
                if not torch.equal(a.view(torch.int32) if uniform else a,
                                   b.view(torch.int32) if uniform else b):
                    raise AssertionError(f"random_bits n={n} key={key} "
                                         f"uniform={uniform}: the kernel "
                                         "differs from its plain version")
                cases += 1
    table = KeyTable(prng.key(13), "cuda", 0)

    def draws():
        k = table.step_key(0)
        return ([prng.uniform(prng.fold_in(k, i), (n,), "cuda")
                 for i, n in enumerate(sizes["uniform"])]
                + [prng.random_bits(prng.fold_in(k, 1000 + i), n, "cuda")
                   for i, n in enumerate(sizes["bits"])])
    graph, got = captured(torch, draws)
    for start in (0, 7):
        table.load(start)
        graph.replay()
        k = prng.step_key(prng.key(13), start)
        want = ([kernels.random_bits_ref(prng.fold_in(k, i), n, "cuda", True)
                 for i, n in enumerate(sizes["uniform"])]
                + [kernels.random_bits_ref(prng.fold_in(k, 1000 + i), n,
                                           "cuda")
                   for i, n in enumerate(sizes["bits"])])
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if not torch.equal(a.view(torch.int32) if a.is_floating_point()
                               else a, b.view(torch.int32)
                               if b.is_floating_point() else b):
                raise AssertionError(f"random_bits replay at {start}: the "
                                     "kernel differs from its plain version")
            cases += 1
    del graph, got
    rows = []
    # The kernel's own time from a trace at the smallest and largest
    # uniform and at the bits' sizes (a trace a size takes about a second).
    traced = {sizes["uniform"][0], sizes["uniform"][-1], *sizes["bits"]}
    for kind, ns in sizes.items():
        uniform = kind == "uniform"
        for n in ns:
            fn = lambda: kernels.random_bits((3, 4), n, "cuda", uniform)
            nbytes = (4 if uniform else 8) * n
            r = shape_row(timer, fn, KERNEL_NAMES["random_bits"] if n in
                          traced else (), nbytes, DRAW_OPS[kind] * n,
                          kind=kind, shape=[n], n=n)
            r["plain_ms"] = timer(lambda: kernels.random_bits_ref(
                (3, 4), n, "cuda", uniform), reps=10)
            rows.append(r)
    n = sizes["bits"][-1]
    per_draw = {
        "plain": device_kernels(torch, lambda: kernels.random_bits_ref(
            (3, 4), n, "cuda")),
        "kernel": device_kernels(torch, lambda: kernels.random_bits(
            (3, 4), n, "cuda"))}
    head = max(rows, key=lambda r: r["n"] if r["kind"] == "uniform" else 0)
    bnd, by = bound_ms(head["bytes"], DRAW_OPS["uniform"] * head["n"])
    row = dict(max_abs_err=0.0, ms=head["ms"], plain_ms=head["plain_ms"],
               bound_ms=bnd, bound_by=by, library_ms=None,
               shape=[head["n"]], device_ms=head["device_ms"], cases=cases,
               kernels_per_draw=per_draw)
    print(f"random_bits: {cases} draws bit-equal (host keys, replayed "
          f"key-table keys); kernels on the card a draw of {n}: plain "
          f"{per_draw['plain']}, kernel {per_draw['kernel']}", flush=True)
    for r in rows:
        print(f"shape random_bits {r['kind']} ({r['n']},): {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({100 * r['share']:.1f}%); {on_card(r)}", flush=True)
    return row, rows


def policy_argv(steps: int, flags, network: str = "VGG11") -> list:
    return ["--network", network, "--dataset", "Cifar10", "--synthetic-data",
            "--num-workers", str(WORLD), "--batch-size", "128",
            "--topk-ratio", "0.01", "--max-steps", str(steps), "--epochs",
            "100", "--log-every", "1000", "--no-bf16", "--eval-freq", "0",
            *flags]


def run_counted(torch, kernels, counts, trainer, max_steps=None):
    """Train ``trainer`` as a run of the main path: the counts are zeroed
    just before and read just after. Returns ``(res, launched, wall)``."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = trainer.train(max_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(kernels.LAUNCHES)
    for k, v in launched.items():
        counts[k] += v
    if not math.isfinite(res.final_loss):
        raise AssertionError(f"non-finite loss {res.final_loss}")
    return res, launched, wall


POLICY_RUNS = [  # 6b and 6c: (name, flags, optimizer stores a leaf,
    #                              bf16 residuals)
    ("M1 bf16_wire", ["--method", "1", "--precision-policy", "bf16_wire"], 0,
     False),
    ("M4 EF bf16_wire_state", ["--method", "4", "--error-feedback",
                               "--precision-policy", "bf16_wire_state"], 1,
     True),
    ("M2 adam", ["--method", "2", "--optimizer", "adam", "--lr", "0.001"], 0,
     False),
    ("M2 adam bf16_wire_state", ["--method", "2", "--optimizer", "adam",
                                 "--lr", "0.001", "--precision-policy",
                                 "bf16_wire_state"], 2, False),
]
POLICY_STEPS = 5


def policy_runs(torch, kernels, counts) -> dict:
    """6b and 6c: the policies and Adam on VGG11-BN, 5 steps each."""
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.train.loop import Trainer
    from ewdml_tpu_torch.train.metrics import wire_plan

    out = {}
    for name, flags, stores, residuals in POLICY_RUNS:
        trainer = Trainer(from_args(policy_argv(POLICY_STEPS, flags)))
        res, launched, wall = run_counted(torch, kernels, counts, trainer)
        cfg = trainer.cfg
        leaves = len(trainer.specs)
        # A step stores one set a worker's optimizer update and one set of
        # every worker's residuals.
        want = POLICY_STEPS * (
            (WORLD * kernels.round_launches(leaves * stores) if stores
             else 0)
            + (kernels.round_launches(leaves * WORLD) if residuals else 0))
        if launched["stochastic_round"] != want:
            raise AssertionError(
                f"policy {name}: {launched['stochastic_round']} "
                f"stochastic-round launches, want {want}")
        ws = trainer.state.workers
        if cfg.precision.bf16_state:
            bufs = [t for _, t in opt_tensors(ws[0].opt_state)
                    if t.dim() > 0]
            if any(t.dtype != torch.bfloat16 for t in bufs + ws[0].residual):
                raise AssertionError(f"policy {name}: a state buffer is not "
                                     "bf16")
            # The optimizer key is rank-shared: the replicas stay equal.
            for w in ws[1:]:
                for a, b in zip(ws[0].model.parameters(),
                                w.model.parameters()):
                    if not torch.equal(a, b):
                        raise AssertionError(f"policy {name}: the replicas "
                                             "differ")
        extra = {}
        if not cfg.compression_enabled:
            shipped = shipped_up_bytes(trainer)
            f32 = wire_plan(from_args(policy_argv(POLICY_STEPS, ["--method",
                                                                 "1"])),
                            [(s.name, s.jax_shape) for s in trainer.specs],
                            world=WORLD)
            if shipped != res.wire.up_bytes or 2 * shipped != f32.up_bytes:
                raise AssertionError(
                    f"policy {name}: the payloads ship {shipped} B, the plan "
                    f"says {res.wire.up_bytes} B, f32 {f32.up_bytes} B")
            extra = dict(shipped=shipped, f32_plan=f32.up_bytes)
        out[name] = dict(final_loss=res.final_loss,
                         mean_step_ms=res.mean_step_s * 1e3, wall_s=wall,
                         wire_per_step=res.wire.per_step_bytes,
                         launches=launched,
                         round_launches_per_step=want / POLICY_STEPS, **extra)
        print(f"policy {name}: network=VGG11 steps={POLICY_STEPS} "
              f"stochastic_round={want // POLICY_STEPS} a step "
              f"loss={res.final_loss:.4f} mean_step="
              f"{res.mean_step_s * 1e3:.2f}ms wire_per_step="
              f"{res.wire.per_step_bytes} B launches="
              f"{ {k: v for k, v in launched.items() if v} } {extra}",
              flush=True)
        del trainer
        torch.cuda.empty_cache()
    return out


NEGATIVE_STEPS = 40


def deterministic(torch, on: bool) -> None:
    torch.use_deterministic_algorithms(on)
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cudnn.deterministic = on


def negative_phase(torch, kernels, counts) -> dict:
    """6d: ``--lossy-weights-down`` (the settings of
    ``examples/weight_compression_negative.py`` at this phase's shapes)
    beside ``--method 2``, 40 steps each, ``--feed device`` and
    deterministic kernels. After each lossy step every weight leaf must
    equal ``dec(compress(W))`` of the plain compressor (the kernel wrapper
    swapped for its plain version) under the step's key, W the weights a
    twin Trainer without the lossy broadcast reaches from the same state.
    Then the example's criterion: lossy final loss > 5 x max(0.01, M2's)."""
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.models.convert import from_jax, to_jax
    from ewdml_tpu_torch.ops import make_compressor
    from ewdml_tpu_torch.train.loop import Trainer
    from ewdml_tpu_torch.train.state import (leaf_params, load_state_tree,
                                             state_tree)
    from ewdml_tpu_torch.utils import prng

    weights = ["--compress-grad", "qsgd", "--ps-mode", "weights"]
    feed = ["--feed", "device", "--scan-window", "1", "--lr", "0.01"]
    lossy = Trainer(from_args(policy_argv(NEGATIVE_STEPS, weights + feed
                                          + ["--lossy-weights-down"])))
    twin = Trainer(from_args(policy_argv(NEGATIVE_STEPS, weights + feed)))
    comp = make_compressor("qsgd", 127)
    x, y = lossy._device_split(lossy._train_split())
    tx, ty = twin._device_split(twin._train_split())
    curve = []
    deterministic(torch, True)
    try:
        for step in range(NEGATIVE_STEPS):
            load_state_tree(twin.state.workers,
                            state_tree(lossy.state.workers, lossy.specs,
                                       stacked=True),
                            lossy.specs, stacked=True)
            twin.state.step = step
            kernels.reset_launches()   # this step of the main path
            m = lossy.train_step(lossy.state, x, y, lossy.base_key)
            torch.cuda.synchronize()
            for k, v in kernels.LAUNCHES.items():
                counts[k] += v
            twin.train_step(twin.state, tx, ty, twin.base_key)
            curve.append(float(m[:, 0].mean()))
            wkey = prng.fold_in(prng.step_key(lossy.base_key, step), 0xBAD)
            quantize = kernels.qsgd_quantize
            kernels.qsgd_quantize = kernels.qsgd_quantize_ref
            try:
                with torch.no_grad():
                    for ws, tw in zip(lossy.state.workers,
                                      twin.state.workers):
                        for i, (p, q, s) in enumerate(zip(
                                leaf_params(ws.model, lossy.specs),
                                leaf_params(tw.model, twin.specs),
                                lossy.specs)):
                            dec = comp.decompress(comp.compress(
                                prng.layer_key(wkey, i),
                                to_jax(q, s.kind).contiguous()))
                            want = from_jax(dec.reshape(s.jax_shape), s.kind)
                            if not torch.equal(p, want):
                                raise AssertionError(
                                    f"negative: step {step} leaf {s.name} "
                                    "is not dec(compress(W))")
            finally:
                kernels.qsgd_quantize = quantize
    finally:
        deterministic(torch, False)
    del lossy, twin
    m2 = Trainer(from_args(policy_argv(NEGATIVE_STEPS, ["--method", "2"]
                                       + feed + ["--log-every", "1"])))
    res, _, _ = run_counted(torch, kernels, counts, m2)
    m2_curve = [float(r[:, 0].mean()) for r in res.rows]
    reproduced = curve[-1] > 5 * max(0.01, m2_curve[-1])
    print("negative lossy-weights-down curve: "
          + " ".join(f"{v:.4g}" for v in curve), flush=True)
    print("negative method2-grads curve: "
          + " ".join(f"{v:.4g}" for v in m2_curve), flush=True)
    if not reproduced:
        raise AssertionError(f"negative: lossy final {curve[-1]} is not > 5 x "
                             f"max(0.01, M2 final {m2_curve[-1]})")
    print(f"negative: reproduced, lossy final {curve[-1]:.6g} > 5 x max(0.01,"
          f" M2 final {m2_curve[-1]:.6g}); every weight leaf of every step "
          "equals dec(compress(W)) of the plain compressor", flush=True)
    del m2
    torch.cuda.empty_cache()
    return dict(lossy_curve=curve, m2_curve=m2_curve, steps=NEGATIVE_STEPS)


OVERLAP_RUNS = [  # 6e
    ("M1", ["--method", "1"]),
    ("M1 bf16_wire", ["--method", "1", "--precision-policy", "bf16_wire"]),
    ("M3 fused_q", ["--method", "3", "--collective", "fused_q"]),
    ("M4 EF", ["--method", "4", "--error-feedback"]),
]
OVERLAP_STEPS = 5


def overlap_phase(torch, kernels, counts) -> dict:
    """6e: ``--overlap bucket`` on VGG11-BN, each run at the auto bucket
    count and at 4, on the side-stream schedule and inline (bit-equal,
    deterministic kernels), and once with overlap off (the step time beside
    it, an observation). The per-bucket bytes sum to ``per_step_bytes``."""
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.parallel import overlap
    from ewdml_tpu_torch.train.loop import Trainer

    out = {}
    deterministic(torch, True)
    try:
        for name, flags in OVERLAP_RUNS:
            row = {}
            off = Trainer(from_args(policy_argv(OVERLAP_STEPS, flags)))
            res, _, _ = run_counted(torch, kernels, counts, off)
            row["off_ms"] = res.mean_step_s * 1e3
            del off
            for buckets in ("0", "4"):
                runs = []
                for schedule in ("stream", "inline"):
                    overlap.configure(schedule)
                    t = Trainer(from_args(policy_argv(
                        OVERLAP_STEPS, flags + ["--overlap", "bucket",
                                                "--overlap-buckets",
                                                buckets])))
                    res, launched, _ = run_counted(torch, kernels, counts, t)
                    runs.append((t, res, launched))
                overlap.configure("stream")
                (a, ares, al), (b, bres, bl) = runs
                what = f"overlap {name} buckets={buckets}"
                if al != bl or not torch.equal(torch.from_numpy(ares.rows),
                                               torch.from_numpy(bres.rows)):
                    raise AssertionError(f"{what}: the schedules differ in "
                                         "launches or metrics")
                same_state(a, b, what)
                plan = ares.wire
                if sum(plan.per_bucket_bytes.values()) != plan.per_step_bytes:
                    raise AssertionError(f"{what}: the per-bucket bytes do "
                                         "not sum to per_step_bytes")
                row[f"buckets_{buckets}"] = dict(
                    n_buckets=len(plan.per_bucket_up),
                    per_bucket_bytes=plan.per_bucket_bytes,
                    stream_ms=ares.mean_step_s * 1e3,
                    inline_ms=bres.mean_step_s * 1e3)
                print(f"overlap {name} buckets={buckets}: network=VGG11 "
                      f"{len(plan.per_bucket_up)} buckets, per_bucket="
                      f"{list(plan.per_bucket_bytes.values())} B, stream "
                      f"{ares.mean_step_s * 1e3:.2f} ms, inline "
                      f"{bres.mean_step_s * 1e3:.2f} ms, off "
                      f"{row['off_ms']:.2f} ms a step; bit_equal="
                      "rows,state,launches", flush=True)
                del runs, a, b
                torch.cuda.empty_cache()
            out[name] = row
    finally:
        overlap.configure("stream")
        deterministic(torch, False)
    return out


POLICY_WINDOW_RUNS = [  # 6f
    ("M4 EF adam bf16_wire_state", "VGG11", 24, 8,
     ["--method", "4", "--error-feedback", "--optimizer", "adam", "--lr",
      "0.001", "--precision-policy", "bf16_wire_state"]),
    ("M4 bf16_wire_state", "ResNet50", 16, 8,
     ["--method", "4", "--precision-policy", "bf16_wire_state"]),
]
POLICY_RESUME = ("M4 EF adam bf16_wire_state", 8, 16,
                 ["--method", "4", "--error-feedback", "--optimizer", "adam",
                  "--lr", "0.001", "--precision-policy", "bf16_wire_state",
                  "--scan-window", "1", "--eval-freq", "8"])
ASYNC_POLICY_RUNS = {"VGG11": [  # 6g
    ("dense bf16_wire", ["--compress-grad", "none", "--precision-policy",
                         "bf16_wire"]),
    ("qsgd decode adam bf16_wire_state",
     ["--compress-grad", "qsgd", "--server-agg", "decode", "--optimizer",
      "adam", "--lr", "0.001", "--precision-policy", "bf16_wire_state"]),
]}


def policy_phase(torch, kernels, smi: str) -> tuple:
    """Phase 6b-6g (see the module docstring); 6a runs with phase 2."""
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.train.metrics import wire_plan
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = {k: 0 for k in kernels.LAUNCHES}
    out = {"policy": policy_runs(torch, kernels, counts)}
    out["negative"] = negative_phase(torch, kernels, counts)
    out["overlap"] = overlap_phase(torch, kernels, counts)
    wcounts, out["window"] = window_phase(torch, kernels, POLICY_WINDOW_RUNS)
    name, first, total, flags = POLICY_RESUME
    root = tempfile.mkdtemp(prefix="ewdml_policy_ckpt_")
    deterministic(torch, True)
    try:
        out["resume"] = resume_run(torch, kernels, counts, name, first, total,
                                   flags, root, smi)
    finally:
        deterministic(torch, False)
        shutil.rmtree(root, ignore_errors=True)
    acounts, out["async"] = async_phase(torch, kernels, "VGG11",
                                        ASYNC_POLICY_RUNS["VGG11"])
    specs = leaf_specs(build_model("VGG11", 10, dataset="Cifar10"))
    leaves = [(s.name, s.jax_shape) for s in specs]
    dense = wire_plan(from_args(["--mode", "async", "--compress-grad", "none",
                                 "--fusion", "none"]), leaves, world=WORLD)
    bf16 = out["async"]["dense bf16_wire"]["plan_up"]
    if 2 * bf16 != dense.up_bytes:
        raise AssertionError(f"async dense bf16_wire: {bf16} B a push, f32 "
                             f"{dense.up_bytes} B")
    for c in (wcounts, acounts):
        for k, v in c.items():
            counts[k] += v
    return counts, out


# -- Phase 7: the published-table reproduction ---------------------------------

# (table, cell) of 7a, traced; and the windowed cell with its epochs.
REPRO_CELLS = (("baseline", "vgg11_cifar10/m5"),
               ("baseline_bf16", "vgg11_cifar10/m4"))
REPRO_SCAN = ("baseline_scan", "lenet_mnist/m6_scan", 3)
# 7a's cells launch these; block_top1 needs a top-k ratio <= 1/8 and the
# table's M5/M6 keep the default 0.5, so it must stay at 0 there.
REPRO_KERNELS = ("qsgd_quantize", "dequant_mean", "stochastic_round")
REPRO_CRASH = "crash@1=3"  # lenet_mnist/m2 dies at step 3


def repro_cell(torch, kernels, counts, table: str, cell_id: str, root: str,
               smi: str, epochs: int = 0) -> dict:
    """One cell through ``collect.run_cell`` in this process: smoke, traced
    (the measured split), or at its full config for ``epochs`` epochs."""
    from ewdml_tpu_torch.experiments import collect, registry
    from ewdml_tpu_torch.obs import trace
    from ewdml_tpu_torch.train.metrics import wire_plan

    spec = {c.cell_id: c for c in registry.table_cells(table)}[cell_id]
    train_dir = os.path.join(root, table, cell_id)
    cfg = spec.to_config(data_dir="data/", train_dir=train_dir,
                         smoke=not epochs)
    trace_dir = None
    if not epochs:
        trace.shutdown()
        trace_dir = os.path.join(root, "trace", table, cell_id)
        cfg.trace_dir = trace_dir
    kernels.reset_launches()   # this cell's run of the main path starts here
    row = collect.run_cell(cfg, device="cuda", max_epochs=epochs or None,
                           budget_epochs=epochs or None,
                           per_epoch_eval=bool(epochs))
    torch.cuda.synchronize()
    launched = dict(kernels.LAUNCHES)   # read just after it
    for k, v in launched.items():
        counts[k] += v
    what = f"repro {table} {cell_id}"
    if not all(v is not None and math.isfinite(v)
               for v in (row["final_loss"], row["eval"]["loss"])):
        raise AssertionError(f"{what}: loss not finite: {row['final_loss']}, "
                             f"{row['eval']}")
    if row["data_source"] != "real":
        raise AssertionError(f"{what}: trained on {row['data_source']} data")
    from ewdml_tpu_torch.models import build_model, num_classes_for
    from ewdml_tpu_torch.models.convert import leaf_specs

    specs = leaf_specs(build_model(cfg.network, num_classes_for(cfg.dataset),
                                   dataset=cfg.dataset))
    plan = wire_plan(cfg, [(s.name, s.jax_shape) for s in specs],
                     world=cfg.num_workers)
    want = {"comm_mb_per_iter": round(plan.per_step_bytes * cfg.num_workers
                                      / 1e6, 4),
            "wire_mb_per_step_worker": round(plan.per_step_bytes / 1e6, 4)}
    got = {"comm_mb_per_iter": row["metrics"]["comm_mb_per_iter"],
           "wire_mb_per_step_worker": row["wire_mb_per_step_worker"]}
    if got != want:
        raise AssertionError(f"{what}: wire fields {got}, plan {want}")
    if row["hardware"].get("name_power_limit") != smi:
        raise AssertionError(f"{what}: hardware names "
                             f"{row['hardware'].get('name_power_limit')!r}, "
                             f"the card is {smi!r}")
    out = {"launches": {k: v for k, v in launched.items() if v},
           "wall_s": row["wall_s"], "mean_step_ms": row["mean_step_ms"],
           "comm_split_source": row["comm_split_source"],
           "comm_frac": row["comm_frac"], "top1_pct":
           row["metrics"]["top1_pct"], **want}
    if trace_dir is not None:
        if row["comm_split_source"] != "measured":
            raise AssertionError(f"{what}: comm/comp split "
                                 f"{row['comm_split_source']}, want measured")
        spans = traced_spans(trace_dir, kind="span")
        if spans.get("collect/comm_probe") != 1:
            raise AssertionError(f"{what}: trace spans {spans}")
        out["probe"] = row["comm_split_probe"]
    if epochs:
        win = row["window"]
        spe = row["steps_per_epoch"]
        k = win["k"]
        windows = sum((spe - spe % k) // k for _ in range(epochs))
        phases = {(e * spe) % k for e in range(epochs)}
        if (row["epochs_trained"] != epochs or win["captures"] != len(phases)
                or win["eager_windows"] != 1
                or win["replays"] != windows - 1):
            raise AssertionError(
                f"{what}: {row['epochs_trained']} epochs, window {win}; want "
                f"{len(phases)} captures (phases {sorted(phases)}), 1 eager "
                f"window, {windows - 1} replays")
        out["window"] = win
        out["epochs"] = row["epochs_trained"]
    print(f"{what}: " + json.dumps(out), flush=True)
    return out


def repro_sweep(root: str) -> dict:
    """7b: the smoke sweep of the ``baseline`` table, each cell a child
    process on the card, one of them crashed and resumed; then its
    re-invocation, which skips every cell."""
    from ewdml_tpu_torch.experiments import runner
    from ewdml_tpu_torch.parallel.faults import CRASH_EXIT_CODE

    out_dir = os.path.join(root, "sweep")
    t0 = time.perf_counter()
    summary = runner.run_sweep("baseline", out_dir=out_dir, smoke=True,
                               platform="cuda", fault_spec=REPRO_CRASH)
    first_s = time.perf_counter() - t0
    events = runner.Ledger(os.path.join(out_dir, "ledger.jsonl")).events()
    if summary["failed"] or summary["done_total"] != 12:
        raise AssertionError(f"repro sweep: {summary}")
    retries = [e for e in events if e["event"] == "cell_retry"]
    if (len(retries) != 1 or retries[0]["cell"] != "lenet_mnist/m2"
            or not retries[0]["reason"].startswith(f"rc={CRASH_EXIT_CODE};")
            or retries[0]["resume_step"] != 2):
        raise AssertionError(f"repro sweep: retries {retries}")
    done = {e["cell"]: e for e in events if e["event"] == "cell_done"}
    crashed = done["lenet_mnist/m2"]["row"]
    if crashed["resumed_from_step"] != 2 or done["lenet_mnist/m2"][
            "attempts"] != 2:
        raise AssertionError(f"repro sweep: the crashed cell's row "
                             f"{crashed['resumed_from_step']}")
    if not os.path.isfile(summary["repro_md"]):
        raise AssertionError("repro sweep: no REPRO.md")
    starts = {}
    cells = {}
    for e in events:
        if e["event"] == "cell_start":
            starts.setdefault(e["cell"], e["ts"])
        elif e["event"] == "cell_done":
            row = e["row"]
            cells[e["cell"]] = {
                "wall_s": row["wall_s"],
                "child_s": round(e["ts"] - starts[e["cell"]], 3),
                "mean_step_ms": row["mean_step_ms"],
                "top1_pct": row["metrics"]["top1_pct"],
                "comm_mb_per_iter": row["metrics"]["comm_mb_per_iter"]}
            if row["hardware"]["platform"] != "gpu":
                raise AssertionError(f"repro sweep: {e['cell']} ran on "
                                     f"{row['hardware']['platform']}")
            print(f"repro cell {e['cell']}: " + json.dumps(cells[e["cell"]]),
                  flush=True)
    t1 = time.perf_counter()
    again = runner.run_sweep("baseline", out_dir=out_dir, smoke=True,
                             platform="cuda", fault_spec=REPRO_CRASH)
    second_s = time.perf_counter() - t1
    events2 = runner.Ledger(os.path.join(out_dir, "ledger.jsonl")).events()
    new = events2[len(events):]
    skips = [e for e in new if e["event"] == "cell_skipped"]
    if (len(skips) != 12 or again["ran"] or again["failed"]
            or any(e["event"] == "cell_start" for e in new)):
        raise AssertionError(f"repro re-invocation: {again}")
    with open(summary["repro_md"]) as f:
        md = f.read()
    if "Pending cells" in md or "NVIDIA" not in md:
        raise AssertionError("repro sweep: REPRO.md is partial or names no "
                             "card")
    return {"sweep_s": round(first_s, 1), "reinvocation_s": round(second_s, 1),
            "retry": retries[0]["reason"][:40], "cells": cells}


def repro_phase(torch, kernels, smi: str) -> tuple:
    """Phase 7 (see the module docstring)."""
    counts = {k: 0 for k in kernels.LAUNCHES}
    root = tempfile.mkdtemp(prefix="ewdml_repro_")
    out = {}
    try:
        cell_counts = {k: 0 for k in kernels.LAUNCHES}
        for table, cell_id in REPRO_CELLS:
            out[f"{table} {cell_id}"] = repro_cell(
                torch, kernels, cell_counts, table, cell_id, root, smi)
        for name in REPRO_KERNELS:
            if cell_counts[name] <= 0:
                raise AssertionError(f"phase 7a: {name} never launched "
                                     f"inside a cell: {cell_counts}")
        if cell_counts["block_top1"]:
            raise AssertionError(f"phase 7a: block_top1 launched at the "
                                 f"table's top-k ratio: {cell_counts}")
        table, cell_id, epochs = REPRO_SCAN
        out[f"{table} {cell_id}"] = repro_cell(
            torch, kernels, cell_counts, table, cell_id, root, smi, epochs)
        for k, v in cell_counts.items():
            counts[k] += v
        torch.cuda.empty_cache()
        out["sweep"] = repro_sweep(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts, out


# -- Phase 8: the async down-link and the run-health watchdog -----------------

DELTA_FLAGS = ["--compress-grad", "qsgd", "--qsgd-block", "4096",
               "--ps-down", "delta", "--ps-bootstrap", "bf16",
               "--server-agg", "decode"]
DOWNLINK_RUNS = [  # 8a (with its --ps-down weights twin), 8b, 8c
    ("qsgd delta", "VGG11", DELTA_FLAGS),
    ("qsgd weights", "VGG11", DELTA_FLAGS[:4] + ["--server-agg", "decode"]),
    ("topk_qsgd delta", "VGG11",
     ["--compress-grad", "topk_qsgd", "--topk-ratio", "0.01"]
     + DELTA_FLAGS[2:]),
    ("qsgd delta", "ResNet50", DELTA_FLAGS),
]
DEVICE = "cuda"       # where phase 8 builds what it compares
RELAY_STEPS = 10      # 8d: per worker at K = 1, so 40 updates
HEALTH_STEPS = 24     # 8e: three windows of K = 8
HEALTH_ASYNC_STEPS = 50  # 8e: the async step budget per worker


def async_argv(network: str, steps: int, flags) -> list:
    """Phase 4's async run: W = K = 4, batch 128, ``steps`` per worker."""
    return ["--mode", "async", "--network", network, "--dataset", "Cifar10",
            "--synthetic-data", "--num-workers", str(WORLD),
            "--num-aggregate", str(WORLD), "--batch-size", "128",
            "--max-steps", str(WORLD * steps), "--fusion", "none", *flags]


def compress_launches(cfg, shapes, kernels) -> dict:
    """Kernel launches of one compress of the whole tree (a push, the
    payload schema's template, a delta step): a quantize per quantized
    vector of at least MIN_ELEMS, else a threefry draw (``prng.uniform``),
    a block_top1 per leaf the Top-k stack selects in block mode
    (``ops/topk.resolve_mode``)."""
    from ewdml_tpu_torch.ops import blocktopk, topk

    want = {k: 0 for k in kernels.LAUNCHES}
    for shape in shapes:
        n = math.prod(shape)
        if cfg.compress_grad == "topk_qsgd":
            if topk.resolve_mode(cfg.topk_exact, n, cfg.topk_ratio) == "block":
                want["block_top1"] += 1
                n = blocktopk.geometry(n, cfg.topk_ratio)[0]
            else:
                n = topk.static_k(n, cfg.topk_ratio)
        if n >= kernels.MIN_ELEMS:
            want["qsgd_quantize"] += 1
        elif n > 0:
            want["random_bits"] += 1
    return want


def initial_params(torch, cfg) -> list:
    """The async run's initial parameters on the card, as ``run_async_ps``
    takes them from the model ``cli.run_async`` builds (JAX leaf order and
    layout)."""
    from ewdml_tpu_torch.models import build_model, num_classes_for
    from ewdml_tpu_torch.models.convert import leaf_specs, to_jax
    from ewdml_tpu_torch.train.state import leaf_params

    model = build_model(cfg.network, num_classes_for(cfg.dataset),
                        dataset=cfg.dataset, seed=cfg.seed).to(DEVICE)
    specs = leaf_specs(model)
    return [to_jax(p.detach(), s.kind).contiguous().clone()
            for p, s in zip(leaf_params(model, specs), specs)]


def check_replays(torch, name, server, workers, init, updates) -> None:
    """The shadow at every version is the replay of the deltas from the f32
    start, bit for bit; each worker's final pull replays onto its base
    (the shadow at its first pull, in bf16) plus the later deltas, bit for
    bit, by the same ops on the same card."""
    from ewdml_tpu_torch.parallel import ps

    apply_delta = ps.make_apply_delta(server.compressor,
                                      server.payload_unpack)
    deltas = [torch.from_numpy(server._deltas[v].copy()).to(DEVICE)
              for v in range(1, updates + 1)]
    shadows = [init]
    for d in deltas:
        shadows.append(apply_delta(shadows[-1], d))
    if not all(torch.equal(a, b) for a, b in zip(shadows[-1],
                                                 server._shadow)):
        raise AssertionError(f"downlink {name}: the replay from the start "
                             "is not the server's shadow")
    for w in workers:
        w.pull_params()
        base = [x.to(torch.bfloat16).to(torch.float32)
                for x in shadows[w.base_version]]
        for d in deltas[w.base_version:]:
            base = apply_delta(base, d)
        if w.version != updates or not all(
                torch.equal(a, b) for a, b in zip(w.params, base)):
            raise AssertionError(f"downlink {name}: worker {w.index} at "
                                 f"version {w.version} did not replay onto "
                                 f"its base of version {w.base_version}")
    torch.cuda.synchronize()


def downlink_run(torch, kernels, counts, name, network, flags) -> dict:
    """8a-8c: one async run through ``cli.build_async`` (``run_async``'s
    run, its server and workers kept); launches, the down-link's bytes
    reckoned pull by pull, and the replays."""
    from ewdml_tpu_torch.cli import build_async
    from ewdml_tpu_torch.core.config import from_args

    cfg = from_args(async_argv(network, ASYNC_STEPS[network], flags))
    kernels.reset_launches()   # this run of the main path starts here
    t0 = time.perf_counter()
    run = build_async(cfg)
    _, stats = run.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(kernels.LAUNCHES)  # read just after it
    for k, v in launched.items():
        counts[k] += v
    server, workers = run.server, run.workers
    label = f"{network} {name}"
    pushes, updates = WORLD * ASYNC_STEPS[network], ASYNC_STEPS[network]
    if (stats.pushes, stats.updates) != (pushes, updates):
        raise AssertionError(f"downlink {label}: {stats.pushes} pushes, "
                             f"{stats.updates} updates")
    delta = cfg.ps_down == "delta"
    init = initial_params(torch, cfg)
    per_call = compress_launches(cfg, [p.shape for p in init], kernels)
    # The pushes and the schema's template; in delta mode the delta step
    # of every update and its warm-up.
    calls = pushes + 1 + (updates + 1 if delta else 0)
    want = {k: v * calls for k, v in per_call.items()}
    if launched != want:
        raise AssertionError(f"downlink {label}: launches {launched}, want "
                             f"{want} ({per_call} a compress, {calls})")
    dense = sum(p.numel() * 4 for p in init)
    modes = dict(stats.pulls_by_mode)
    if sum(modes.values()) != pushes:
        raise AssertionError(f"downlink {label}: pulls {modes}")
    if delta:
        sizes = {b.nbytes for b in server._deltas.values()}
        if sorted(server._deltas) != list(range(1, updates + 1)) or \
                len(sizes) != 1:
            raise AssertionError(f"downlink {label}: deltas {sizes}")
        per_delta = sizes.pop()
        if modes.get("weights_bf16") != WORLD or modes.get("weights", 0):
            raise AssertionError(f"downlink {label}: pulls {modes}, want "
                                 f"{WORLD} bf16 bootstraps, no fallback")
        reckoned = WORLD * dense // 2 + stats.deltas_down * per_delta
    else:
        per_delta = 0
        reckoned = pushes * dense
    if stats.bytes_down != reckoned:
        raise AssertionError(f"downlink {label}: {stats.bytes_down} B down, "
                             f"reckoned {reckoned}")
    losses = [l for _, l in stats.loss_history]
    if len(losses) != pushes or not all(map(math.isfinite, losses)):
        raise AssertionError(f"downlink {label}: losses {losses}")
    if delta:
        check_replays(torch, label, server, workers, init, updates)
    del server, workers, run
    # The server alone (no worker threads): the apply, and the delta step
    # (the weights twin's apply is the same program).
    alone = apply_alone(torch, flags, network) if delta else None
    row = dict(network=network, pushes=pushes, updates=updates,
               pulls=modes, deltas_down=stats.deltas_down,
               delta_bytes=per_delta, bytes_down=stats.bytes_down,
               dense_pull=dense, apply_ms_mean=stats.apply_ms_mean,
               delta_ms_mean=stats.delta_ms_mean,
               apply_alone_ms=alone and alone.apply_ms_mean,
               delta_alone_ms=alone and alone.delta_ms_mean, wall_s=wall,
               loss_tail=stats.loss_tail_mean(4), launches=launched,
               launches_per_compress=per_call)
    print(f"downlink {label}: bytes_down={stats.bytes_down} (pulls {modes}, "
          f"{stats.deltas_down} deltas of {per_delta} B, dense pull "
          f"{dense} B) apply_ms_mean={stats.apply_ms_mean:.3f} "
          f"delta_ms_mean={stats.delta_ms_mean:.3f}"
          + (f" (alone {alone.apply_ms_mean:.3f} and "
             f"{alone.delta_ms_mean:.3f})" if alone else "")
          + f" wall={wall:.1f}s loss_tail={stats.loss_tail_mean(4):.4f} "
          f"launches={launched}"
          + (" replays bit-equal" if delta else ""), flush=True)
    torch.cuda.empty_cache()
    return row


def relay_runs(torch, kernels, counts) -> dict:
    """8d: the lossy weights-down relay (``run_async_ps(relay_compress=
    True)``, every pulled version through compress then decompress on the
    server) beside the same run without it, VGG11-BN QSGD decode, W = 4 at
    K = 1, 40 updates each: the paper's negative result on the PS path."""
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.data import datasets, loader
    from ewdml_tpu_torch.models import build_model, num_classes_for
    from ewdml_tpu_torch.ops import make_compressor
    from ewdml_tpu_torch.optim import make_optimizer
    from ewdml_tpu_torch.parallel.ps import run_async_ps

    cfg = from_args(async_argv("VGG11", RELAY_STEPS, [
        "--compress-grad", "qsgd", "--num-aggregate", "1"]))
    shapes = [p.shape for p in initial_params(torch, cfg)]
    comp = make_compressor("qsgd", cfg.quantum_num)
    big = compress_launches(cfg, shapes, kernels)["qsgd_quantize"]
    wire = sum(comp.wire_bytes(tuple(s)) for s in shapes)
    ds = datasets.load(cfg.dataset, cfg.data_dir, train=True,
                       synthetic=cfg.synthetic_data, seed=cfg.seed,
                       synthetic_size=cfg.synthetic_size)
    pushes = WORLD * RELAY_STEPS
    out = {}
    for relay in (False, True):
        name = "relay" if relay else "no relay"
        kernels.reset_launches()   # this run of the main path starts here
        t0 = time.perf_counter()
        _, stats = run_async_ps(
            build_model(cfg.network, num_classes_for(cfg.dataset),
                        dataset=cfg.dataset, seed=cfg.seed),
            make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum,
                           cfg.weight_decay, cfg.nesterov),
            lambda i: loader.global_batches(ds, cfg.batch_size, 1,
                                            seed=cfg.seed + i, feed="f32"),
            num_workers=WORLD, steps_per_worker=RELAY_STEPS,
            compressor=comp, num_aggregate=1, relay_compress=relay,
            seed=cfg.seed, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dict(kernels.LAUNCHES)  # read just after it
        for k, v in launched.items():
            counts[k] += v
        if (stats.pushes, stats.updates) != (pushes, pushes):
            raise AssertionError(f"relay {name}: {stats.pushes} pushes, "
                                 f"{stats.updates} updates")
        ups = big * (pushes + 1)   # the pushes and the template
        relayed = launched["qsgd_quantize"] - ups
        # Under the relay, one quantize per big leaf per version packed
        # (at least once; racing pulls may each pack a new version).
        lo, hi = (big, big * pushes) if relay else (0, 0)
        if relayed % max(1, big) or not lo <= relayed <= hi:
            raise AssertionError(f"relay {name}: launches {launched}, "
                                 f"{ups} for the pushes")
        per_pull = wire if relay else sum(math.prod(s) * 4 for s in shapes)
        if stats.bytes_down != pushes * per_pull or \
                stats.pulls_by_mode != {"weights": pushes}:
            raise AssertionError(f"relay {name}: {stats.bytes_down} B down "
                                 f"in {stats.pulls_by_mode}, want "
                                 f"{pushes} x {per_pull}")
        tail = stats.loss_tail_mean(10)
        curve = [l for _, l in stats.loss_history]
        out[name] = dict(loss_tail10=tail, bytes_down=stats.bytes_down,
                         per_pull=per_pull,
                         versions_packed=relayed // max(1, big),
                         wall_s=wall,
                         apply_ms_mean=stats.apply_ms_mean)
        print(f"relay {name}: loss_tail10={tail:.6g} bytes_down="
              f"{stats.bytes_down} ({pushes} x {per_pull} B) versions "
              f"packed through the relay={out[name]['versions_packed']} "
              f"wall={wall:.1f}s curve=" + " ".join(f"{v:.4g}" for v in curve),
              flush=True)
        torch.cuda.empty_cache()
    print(f"relay: the negative result on the PS path, loss tail "
          f"{out['relay']['loss_tail10']:.6g} against "
          f"{out['no relay']['loss_tail10']:.6g} without the relay",
          flush=True)
    return out


def cli_rc(argv) -> tuple:
    """``cli.main(argv)`` in process: (return code, its standard output)."""
    import contextlib
    import io

    from ewdml_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    sys.stdout.write(buf.getvalue())
    return rc, buf.getvalue()


def health_runs(torch, kernels, counts, root: str) -> dict:
    """8e: ``--health`` through ``cli.main`` in process. Sync: VGG11-BN M4,
    ``--feed device --scan-window 8``, ``nan@0=12`` under ``abort`` exits
    76 at the read after the window covering step 12 (step 15) with one
    ``nan`` event in ``health.jsonl``; under ``warn`` the run completes and
    its final checkpoint is byte-equal to ``--health off``'s (deterministic
    kernels). Async: ``nan@1=2`` under ``abort`` exits 76, and the workers
    together push fewer times than one worker's budget."""
    from ewdml_tpu_torch.cli import build_async
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.obs.health import HealthAbort, read_events
    from ewdml_tpu_torch.train import checkpoint

    out = {}
    sync = ["--method", "4", "--scan-window", "8", "--log-every", "8",
            "--fault-spec", "nan@0=12"]
    ckpts = {}
    deterministic(torch, True)
    try:
        for mode in ("abort", "warn", "off"):
            d = os.path.join(root, f"sync_{mode}")
            kernels.reset_launches()   # this run of the main path
            t0 = time.perf_counter()
            rc, text = cli_rc(vgg_argv(HEALTH_STEPS, sync
                                       + ["--health", mode], d))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for k, v in kernels.LAUNCHES.items():  # read just after it
                counts[k] += v
            events = [(e["kind"], e["step"]) for e in
                      read_events(os.path.join(d, "health.jsonl"))]
            want_rc, want_events = {"abort": (76, [("nan", 15)]),
                                    "warn": (0, [("nan", 15)]),
                                    "off": (0, [])}[mode]
            if rc != want_rc or events != want_events or (
                    mode == "abort"
                    and "HEALTH_ABORT kind=nan step=15" not in text):
                raise AssertionError(f"health sync {mode}: rc {rc}, events "
                                     f"{events}")
            if mode != "abort":
                path = checkpoint.latest_path(d)
                if checkpoint.peek_step(path) != HEALTH_STEPS:
                    raise AssertionError(f"health sync {mode}: checkpoint "
                                         f"at {checkpoint.peek_step(path)}")
                with open(path, "rb") as f:
                    ckpts[mode] = f.read()
            out[f"sync {mode}"] = dict(rc=rc, events=events, wall_s=wall)
            print(f"health sync {mode}: rc={rc} events={events} "
                  f"wall={wall:.1f}s", flush=True)
    finally:
        deterministic(torch, False)
    if ckpts["warn"] != ckpts["off"]:
        raise AssertionError("health sync: the warn run's final checkpoint "
                             "differs from the off run's")
    print(f"health sync: warn's final checkpoint equals off's byte for byte "
          f"({len(ckpts['off'])} B)", flush=True)
    # lr 0.001 so that the injected NaN is the verdict checked: at the
    # default 0.01 both packages' watchdogs read the first update's loss
    # drop (3.3 to 2.4) as a spike and abort a healthy run (ROADMAP Queue
    # 3 item 17, pinned on the CPU by tests/test_torch_health.py).
    argv = async_argv("VGG11", HEALTH_ASYNC_STEPS, DELTA_FLAGS + [
        "--lr", "0.001", "--fault-spec", "nan@1=2", "--health", "abort"])
    d = os.path.join(root, "async_abort")
    kernels.reset_launches()   # this run of the main path
    rc, text = cli_rc(argv + ["--train-dir", d])
    torch.cuda.synchronize()
    for k, v in kernels.LAUNCHES.items():
        counts[k] += v
    events = [e["kind"] for e in read_events(os.path.join(d, "health.jsonl"))]
    if rc != 76 or "HEALTH_ABORT kind=nan" not in text or events[:1] != [
            "nan"]:
        raise AssertionError(f"health async: rc {rc}, events {events}")
    kernels.reset_launches()
    run = build_async(from_args(argv + ["--train-dir", d + "_run"]))
    try:
        run.run()
        raise AssertionError("health async: no abort")
    except HealthAbort as e:
        verdict = (e.kind, e.step)
    torch.cuda.synchronize()
    for k, v in kernels.LAUNCHES.items():
        counts[k] += v
    server, workers = run.server, run.workers
    pushes = server.stats.pushes
    if verdict[0] != "nan" or any(w.is_alive() for w in workers) or \
            pushes >= HEALTH_ASYNC_STEPS:
        raise AssertionError(f"health async: verdict {verdict}, {pushes} "
                             f"pushes of {WORLD * HEALTH_ASYNC_STEPS}")
    out["async abort"] = dict(rc=rc, verdict=verdict, pushes=pushes,
                              budget=WORLD * HEALTH_ASYNC_STEPS)
    print(f"health async: rc={rc} verdict={verdict}, the workers stopped "
          f"after {pushes} pushes of a {WORLD * HEALTH_ASYNC_STEPS}-push "
          f"budget", flush=True)
    del server, workers, run
    torch.cuda.empty_cache()
    return out


def downlink_phase(torch, kernels) -> tuple:
    """Phase 8 (see the module docstring)."""
    counts = {k: 0 for k in kernels.LAUNCHES}
    out = {"downlink": {}}
    for name, network, flags in DOWNLINK_RUNS:
        out["downlink"][f"{network} {name}"] = downlink_run(
            torch, kernels, counts, name, network, flags)
    out["relay"] = relay_runs(torch, kernels, counts)
    root = tempfile.mkdtemp(prefix="ewdml_health_")
    try:
        out["health"] = health_runs(torch, kernels, counts, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k in ("qsgd_quantize", "block_top1"):
        if counts[k] <= 0:
            raise AssertionError(f"phase 8: {k} never launched")
    return counts, out


# Phase 9: the TCP tier (parallel/ps_net.py) on VGG11-BN at full width.
TCP_WORKERS = 4
TCP_STEPS = 6                # per worker in 9a
TCP_RUNS = [                 # 9a: (name, K, flags), each on both planes
    ("qsgd homomorphic", 4, ["--compress-grad", "qsgd",
                             "--server-agg", "homomorphic"]),
    ("qsgd decode", 2, ["--compress-grad", "qsgd", "--server-agg", "decode"]),
]
DURABLE_BATCHES = 10         # 9b: K = 2 batches of real worker frames
KILL_AT = 5                  # 9c: serverkill@5
KILL_STEPS = 8               # 9c: per worker process; the joiner takes 4


def tcp_argv(k: int, flags, *extra) -> list:
    """A ps_net config: VGG11-BN, CIFAR-10 shapes, synthetic data, batch
    128, ``--fusion none`` (the wire plan prices one payload per leaf)."""
    return ["--network", "VGG11", "--dataset", "Cifar10", "--synthetic-data",
            "--batch-size", "128", "--num-aggregate", str(k), "--fusion",
            "none", *flags, *extra]


def tcp_expected_launches(cfg, specs, kernels, pushes, updates,
                          endpoints) -> dict:
    """Phase 4's count for ``pushes`` and ``updates``, plus what each of the
    ``endpoints`` (the server and every worker) launches in
    ``build_endpoint_setup``: one compress of the payload template (the
    server's is the ``+ 1`` of ``expected_async_launches``), and under
    homomorphic the scale template's normal draw and randint's two draws."""
    want = expected_async_launches(cfg, specs, kernels,
                                   pushes + endpoints - 1, updates)
    if cfg.server_agg == "homomorphic":
        want["random_bits"] += 3 * endpoints
    return want


def segment_ms(stats: dict) -> dict:
    """The push and pull queue/handler p50 and p99 (ms) of a stats reply."""
    out = {}
    for op in ("push", "pull"):
        seg = stats["segments"].get(op, {})
        for field in ("queue_s", "handler_s"):
            s = seg.get(field, {})
            out[f"{op}_{field[:-2]}"] = (s.get("p50_ms"), s.get("p99_ms"))
    return out


def tcp_run(torch, kernels, counts, name, k, flags, plane) -> dict:
    """9a: one server and TCP_WORKERS workers in threads of this process."""
    import dataclasses
    import threading

    import numpy as np

    from ewdml_tpu_torch import native
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.parallel import ps_net
    from ewdml_tpu_torch.train.metrics import wire_plan

    cfg = from_args(tcp_argv(k, flags, "--wire-plane", plane))
    kernels.reset_launches()   # this run of the main path starts here
    t0 = time.perf_counter()
    server = ps_net.PSNetServer(cfg, port=0)
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    workers = [ps_net.PSNetWorker(cfg, i, server.address)
               for i in range(TCP_WORKERS)]
    t_setup = time.perf_counter() - t0
    results, errors = {}, []

    def work(w):
        try:
            results[w.index] = w.run(TCP_STEPS)
        except Exception as e:  # noqa: BLE001 -- raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(w,)) for w in workers]
    t1 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t1
    launched = dict(kernels.LAUNCHES)  # read just after it
    for key, v in launched.items():
        counts[key] += v
    if errors:
        raise errors[0]
    sent = sum(w.bytes.sent for w in workers)
    received = sum(w.bytes.received for w in workers)
    if (sent, received) != (server.bytes.received, server.bytes.sent):
        raise AssertionError(f"tcp {name} {plane}: workers sent {sent} B and "
                             f"received {received} B, the server received "
                             f"{server.bytes.received} B and sent "
                             f"{server.bytes.sent} B")
    stats, _ = ps_net.client_call(server.address, {"op": "stats"})
    ps_net.client_call(server.address, {"op": "shutdown"})
    serve.join(60)
    server.close()
    pushes = TCP_WORKERS * TCP_STEPS
    updates = pushes // k
    if (stats["pushes"], stats["updates"], stats["version"]) != (
            pushes, updates, updates):
        raise AssertionError(f"tcp {name} {plane}: stats {stats['pushes']} "
                             f"pushes, {stats['updates']} updates")
    per_round = 1 if cfg.server_agg == "homomorphic" else k
    if stats["decode_count"] != per_round * stats["apply_rounds"]:
        raise AssertionError(f"tcp {name} {plane}: {stats['decode_count']} "
                             f"decodes in {stats['apply_rounds']} rounds")
    specs = workers[0].specs
    want = tcp_expected_launches(cfg, specs, kernels, pushes, updates,
                                 TCP_WORKERS + 1)
    if launched != want:
        raise AssertionError(f"tcp {name} {plane}: launches {launched}, want "
                             f"{want}")
    # Priced as phase 4's async run: the plan's async pricing keys on
    # --mode async, which the TCP entry does not set (as in the JAX one).
    plan = wire_plan(dataclasses.replace(cfg, mode="async"),
                     [(s.name, s.jax_shape) for s in specs],
                     world=TCP_WORKERS)
    frame = native.encoded_arrays_size([np.empty(plan.up_bytes, np.uint8)])
    dense = sum(math.prod(s.jax_shape) * 4 for s in specs)
    if (stats["bytes_up"], stats["bytes_down"]) != (pushes * frame,
                                                    pushes * dense):
        raise AssertionError(f"tcp {name} {plane}: {stats['bytes_up']} B up "
                             f"and {stats['bytes_down']} B down, the "
                             f"in-process reckoning {pushes} x {frame} and "
                             f"{pushes} x {dense}")
    losses = [r["loss"] for r in results.values()]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"tcp {name} {plane}: losses {losses}")
    seg = segment_ms(stats)
    row = dict(plane=plane, k=k, pushes=pushes, updates=updates,
               decode_count=stats["decode_count"],
               apply_ms_mean=stats["apply_ms_mean"], setup_s=t_setup,
               run_s=t_run, socket_sent=stats["socket_sent"],
               socket_received=stats["socket_received"],
               bytes_up=stats["bytes_up"], bytes_down=stats["bytes_down"],
               segments_ms=seg, losses=losses, launches=launched)
    print(f"tcp {name} plane={plane}: K={k} pushes={pushes} "
          f"updates={updates} decodes={stats['decode_count']} "
          f"apply_ms_mean={stats['apply_ms_mean']:.3f} setup={t_setup:.1f}s "
          f"run={t_run:.1f}s ({t_run / TCP_STEPS * 1e3:.1f} ms a step) "
          f"up={stats['bytes_up']} B down={stats['bytes_down']} B "
          f"socket={sent}/{received} B segments_ms(p50,p99)={seg} "
          f"launches={launched}", flush=True)
    return row


def same_server_state(torch, a, b, what: str) -> None:
    """Bit-equality of two parameter servers' version, parameters,
    optimizer state and shadow."""
    def tensors(s):
        return [*s.params, *(t for _, t in opt_tensors(s.opt_state)),
                *s._shadow]

    ta, tb = tensors(a), tensors(b)
    same = a.version == b.version and len(ta) == len(tb) and all(
        x.dtype == y.dtype and torch.equal(x.reshape(-1).view(torch.uint8),
                                           y.reshape(-1).view(torch.uint8))
        for x, y in zip(ta, tb))
    if not same:
        raise AssertionError(f"{what}: the recovered server differs (version "
                             f"{b.version} against {a.version})")


def durable_run(torch, kernels, counts, root: str) -> dict:
    """9b: a durable server (``--snapshot-every 4``) applies DURABLE_BATCHES
    K = 2 batches of two TCP workers' frames; a second server recovers
    from its directory, bit-equal, and acknowledges every recorded push
    again as a duplicate."""
    import threading

    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.parallel import ps_net
    from ewdml_tpu_torch.parallel.server_state import ServerStateStore

    flags = ["--compress-grad", "qsgd", "--server-agg", "homomorphic"]
    state = os.path.join(root, "state")
    cfg = from_args(tcp_argv(2, flags, "--server-state-dir", state,
                             "--snapshot-every", "4"))
    kernels.reset_launches()   # this run of the main path
    server = ps_net.PSNetServer(cfg, port=0)
    recorded = []
    push = server.server.push

    def recording_push(record, retried=False):
        recorded.append(record)
        return push(record, retried)

    server.server.push = recording_push
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    workers = [ps_net.PSNetWorker(cfg, i, server.address) for i in range(2)]
    threads = [threading.Thread(target=w.run, args=(DURABLE_BATCHES,))
               for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ps_net.client_call(server.address, {"op": "shutdown"})
    serve.join(60)
    torch.cuda.synchronize()
    for key, v in kernels.LAUNCHES.items():
        counts[key] += v
    live = server.server
    if (live.version, live.stats.wal_records) != (DURABLE_BATCHES,
                                                  DURABLE_BATCHES):
        raise AssertionError(f"durable: version {live.version}, WAL records "
                             f"{live.stats.wal_records}")
    snapshots = live.stats.snapshots
    snap_bytes = os.path.getsize(os.path.join(state, "snapshot.bin"))
    wal_records = live.stats.wal_records
    # One more snapshot write, timed alone: re-arming on a directory of its
    # own writes one now. The recovery below reads the cadence's snapshot
    # (version 8) and its two-record WAL tail, as a kill leaves them.
    t0 = time.perf_counter()
    live.arm_durability(ServerStateStore(os.path.join(root, "timed")),
                        snapshot_every=0)
    write_s = time.perf_counter() - t0
    store = ServerStateStore(state)
    server.close()
    fresh_cfg = from_args(tcp_argv(2, flags))
    kernels.reset_launches()
    fresh = ps_net.PSNetServer(fresh_cfg, port=0)
    t0 = time.perf_counter()
    summary = fresh.server.recover(store)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    for key, v in kernels.LAUNCHES.items():
        counts[key] += v
    same_server_state(torch, live, fresh.server, "durable")
    acks = [fresh.server.push(r) for r in recorded]
    if not all(acks) or fresh.server.stats.dup_pushes != len(recorded) or \
            fresh.server.version != DURABLE_BATCHES:
        raise AssertionError(f"durable: replayed pushes {acks}, "
                             f"{fresh.server.stats.dup_pushes} duplicates")
    same_server_state(torch, live, fresh.server, "durable after the re-sends")
    fresh.close()
    if summary["replayed"] != DURABLE_BATCHES % 4:
        raise AssertionError(f"durable: recovered {summary}")
    out = dict(version=DURABLE_BATCHES, snapshot_bytes=snap_bytes,
               snapshot_write_s=write_s, wal_records=wal_records,
               snapshots=snapshots, recover_s=recover_s,
               recovered=summary, resent=len(recorded))
    print(f"durable: VGG11 qsgd homomorphic K=2 {DURABLE_BATCHES} batches, "
          f"snapshot {snap_bytes} B written in {write_s:.3f}s, "
          f"{wal_records} WAL records, {snapshots} "
          f"snapshots, recovered {summary} in {recover_s:.3f}s, bit-equal; "
          f"{len(recorded)} re-sent pushes acknowledged as duplicates",
          flush=True)
    return out


def ps_net_proc(args: list, log: str):
    """``python -m ewdml_tpu_torch.parallel.ps_net`` as a child process on
    the card, its output into ``log``."""
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    f = open(log, "w")
    proc = subprocess.Popen([sys.executable, "-m",
                             "ewdml_tpu_torch.parallel.ps_net", *args],
                            env=env, stdout=f, stderr=subprocess.STDOUT,
                            text=True)
    proc.log = f
    return proc


def wait_for_line(proc, log: str, marker: str, timeout_s: float) -> str:
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        with open(log) as f:
            for line in f:
                if marker in line:
                    return line
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    with open(log) as f:
        tail = f.read()[-3000:]
    raise AssertionError(f"{marker} never came (rc {proc.poll()}):\n{tail}")


def kill_recover_run(root: str) -> dict:
    """9c: across processes. A server process with ``serverkill@5`` and a
    state directory, two worker processes of KILL_STEPS and a late joiner
    (``join@2=3``, 4 steps), K = 1, under ``--server-agg homomorphic``: the
    scale contract derived in separate processes must agree (the workers
    check its CRC, the restarted server's ``recover`` checks the
    snapshot's). The server dies at apply 5; this script
    starts it again on the same port and directory; the workers retry
    through the outage, resync and finish."""
    import socket

    from ewdml_tpu_torch.parallel import ps_net

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    state = os.path.join(root, "kill_state")
    common = tcp_argv(1, ["--compress-grad", "qsgd", "--server-agg",
                          "homomorphic"], "--port", str(port),
                      "--net-retries", "14", "--net-backoff", "0.5")
    server_args = ["--role", "server", *common, "--server-state-dir", state,
                   "--snapshot-every", "2", "--fault-spec",
                   f"serverkill@{KILL_AT}"]
    walls = {}
    procs = []
    t0 = time.perf_counter()
    try:
        first = ps_net_proc(server_args, os.path.join(root, "server1.log"))
        procs.append(first)
        wait_for_line(first, os.path.join(root, "server1.log"),
                      "PS_NET_READY", 180)
        walls["server_ready_s"] = time.perf_counter() - t0
        logs = [os.path.join(root, f"worker{i}.log") for i in range(3)]
        workers = [ps_net_proc(["--role", "worker", *common,
                                "--worker-index", str(i), "--steps",
                                str(KILL_STEPS)], logs[i]) for i in (0, 1)]
        workers.append(ps_net_proc(["--role", "worker", *common,
                                    "--worker-index", "2", "--steps", "4",
                                    "--fault-spec", "join@2=3"], logs[2]))
        procs += workers
        rc = first.wait(timeout=300)
        walls["killed_at_s"] = time.perf_counter() - t0
        if rc != -9:
            raise AssertionError(f"kill: the first server exited {rc}, not "
                                 f"by SIGKILL")
        second = ps_net_proc(server_args, os.path.join(root, "server2.log"))
        procs.append(second)
        wait_for_line(second, os.path.join(root, "server2.log"),
                      "PS_NET_READY", 180)
        walls["restarted_s"] = time.perf_counter() - t0
        done = []
        for i, w in enumerate(workers):
            rc = w.wait(timeout=300)
            line = wait_for_line(w, logs[i], "PS_NET_WORKER_DONE", 1)
            if rc != 0:
                raise AssertionError(f"kill: worker {i} exited {rc}")
            done.append(json.loads(line.split(" ", 1)[1]))
        walls["workers_done_s"] = time.perf_counter() - t0
        stats, _ = ps_net.client_call(("127.0.0.1", port), {"op": "stats"})
        ps_net.client_call(("127.0.0.1", port), {"op": "shutdown"})
        if second.wait(timeout=60) != 0:
            raise AssertionError("kill: the restarted server did not exit 0")
        walls["shutdown_s"] = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.log.close()
    total = 2 * KILL_STEPS + 4
    resyncs = [d["resyncs"] for d in done]
    if min(resyncs[:2]) < 1 or stats["recoveries"] != 1 or \
            stats["version"] != total or stats["joins"] != 1 or \
            stats["live_workers"] != 3 or stats["dup_pushes"] < 1:
        raise AssertionError(f"kill: resyncs {resyncs}, stats "
                             + json.dumps({k: stats[k] for k in (
                                 "version", "recoveries", "joins",
                                 "live_workers", "dup_pushes")}))
    out = dict(walls, version=stats["version"], recoveries=1,
               dup_pushes=stats["dup_pushes"], joins=stats["joins"],
               live_workers=stats["live_workers"], resyncs=resyncs,
               retries=[d["retries"] for d in done])
    print(f"kill-recover: homomorphic, serverkill@{KILL_AT}, {total} "
          f"pushes at K=1 -> "
          f"version {stats['version']} with {stats['dup_pushes']} re-sent "
          f"push(es) acknowledged, recoveries 1, joins 1, live 3, resyncs "
          f"{resyncs}; walls {json.dumps({k: round(v, 1) for k, v in walls.items()})}",
          flush=True)
    return out


def tcp_phase(torch, kernels) -> tuple:
    """Phase 9 (see the module docstring)."""
    torch.backends.cudnn.allow_tf32 = False  # f32, as phases 3-8
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = {k: 0 for k in kernels.LAUNCHES}
    out = {"tcp": {}}
    walls = {}
    t = time.perf_counter()
    for plane in ("threads", "evloop"):
        for name, k, flags in TCP_RUNS:
            out["tcp"][f"{name} {plane}"] = tcp_run(
                torch, kernels, counts, name, k, flags, plane)
            torch.cuda.empty_cache()
    walls["9a_s"] = time.perf_counter() - t
    root = tempfile.mkdtemp(prefix="ewdml_tcp_")
    try:
        t = time.perf_counter()
        out["durable"] = durable_run(torch, kernels, counts, root)
        walls["9b_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out["kill_recover"] = kill_recover_run(root)
        walls["9c_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["walls"] = walls
    print("phase 9 walls: " + json.dumps(walls) + " on " + smi_line(),
          flush=True)
    for k in ("qsgd_quantize", "int_accumulate", "acc_decode", "random_bits"):
        if counts[k] <= 0:
            raise AssertionError(f"phase 9: {k} never launched")
    return counts, out


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after phases 2, 6a and 2b (no training, "
                             "no result line)")
    parser.add_argument("--phase8-only", action="store_true",
                        help="build, then run phase 8 alone (no result "
                             "line)")
    parser.add_argument("--phase9-only", action="store_true",
                        help="build, then run phase 9 alone (no result "
                             "line)")
    args = parser.parse_args(argv)
    kernels_only = args.kernels_only

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    # Phase 3c's deterministic cuBLAS needs this before the first handle.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from ewdml_tpu_torch import kernels as build
        from ewdml_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the ewdml_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    from ewdml_tpu_torch.train import flops
    from ewdml_tpu_torch.utils import provenance

    global hbm_bytes_per_s, ops_per_s
    t_start = time.perf_counter()
    print("provenance: " + json.dumps(provenance.hardware_provenance(1)),
          flush=True)
    gbs = flops.hbm_peak_gbs(torch.device("cuda"))
    if gbs is None:
        raise RuntimeError(f"no memory rate known for "
                           f"{torch.cuda.get_device_name(0)!r}")
    hbm_bytes_per_s = gbs * 1e9
    clock = sm_clock_mhz()
    ops_per_s = LANES_PER_CLOCK * clock * 1e6
    print(f"instruction rate: {ops_per_s:.4g} instructions/s at {clock:g} MHz",
          flush=True)

    # Phase 1: build.
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f}s (nvcc {build.build_seconds:.1f}s)",
          flush=True)
    if args.phase8_only:
        t8 = time.perf_counter()
        _, downlink = downlink_phase(torch, kernels)
        print(f"phase 8: {time.perf_counter() - t8:.1f}s", flush=True)
        print("downlink: " + json.dumps(downlink), flush=True)
        print(smi_line(), flush=True)
        return 0
    if args.phase9_only:
        t9 = time.perf_counter()
        _, tcp = tcp_phase(torch, kernels)
        print(f"phase 9: {time.perf_counter() - t9:.1f}s", flush=True)
        print("tcp: " + json.dumps(tcp), flush=True)
        print(smi_line(), flush=True)
        return 0

    # Phase 2: kernels against their plain versions.
    timer = Timer(torch)
    checks = check_kernels(torch, kernels, timer)
    shapes = {net: check_path_shapes(torch, kernels, timer, net)
              for net in NETWORKS}
    # Phase 6a: the stochastic-round kernel, with the other seven.
    checks["stochastic_round"], sround_rows = check_sround(torch, kernels,
                                                           timer, build)
    # Phase 2b: the threefry draw kernel.
    checks["random_bits"], draw_rows = check_draws(torch, kernels, timer)
    del timer
    torch.cuda.empty_cache()
    for name, c in checks.items():
        print(f"kernel {name} {c['shape']}: {c['ms']:.4f} ms (bound "
              f"{c['bound_ms']:.4f} ms by {c['bound_by']}), plain "
              f"{c['plain_ms']:.4f} ms, library {c['library_ms']}, "
              f"max_abs_err {c['max_abs_err']}; {alone_vs_bound(c)}",
              flush=True)
    for net in NETWORKS:
        print_path_shapes(shapes[net], net)
    r = kernels.round_launches
    print_sround_rows(sround_rows, {
        f"launches a step, {net} bf16_wire_state":
            f"{WORLD * r(n)}, {WORLD * r(n) + r(n * WORLD)} with EF"
        for net, n in (("VGG11", 38), ("ResNet50", 161))})
    print("shapes stochastic_round: " + json.dumps(sround_rows), flush=True)
    print("shapes random_bits: " + json.dumps(draw_rows), flush=True)
    if kernels_only:
        return 0

    counts = {k: 0 for k in kernels.LAUNCHES}
    per_method, async_runs = {}, {}
    # Phase 3 (VGG11-BN) and 3b (ResNet50): the training main path.
    for net in NETWORKS:
        net_counts, runs = train_phase(torch, kernels, net)
        per_method.update({f"{net} {k}": v for k, v in runs.items()})
        for k, v in net_counts.items():
            counts[k] += v
    # Phase 3c: the device feed and the scan window (CUDA graphs).
    net_counts, windows = window_phase(torch, kernels)
    for k, v in net_counts.items():
        counts[k] += v
    # Phase 4: the async parameter server.
    for net, runs_flags in ASYNC_RUNS.items():
        net_counts, runs = async_phase(torch, kernels, net, runs_flags)
        for name, flags in runs_flags:
            alone = apply_alone(torch, flags, net).apply_ms_mean
            runs[name]["apply_alone_ms"] = alone
            print(f"apply alone {net} {name}: {alone:.3f} ms per round",
                  flush=True)
        async_runs.update({f"{net} {k}": v for k, v in runs.items()})
        for k, v in net_counts.items():
            counts[k] += v
    # Phase 5: checkpoints, resume, the evaluator, trace and profile.
    t5 = time.perf_counter()
    net_counts, ckpt = checkpoint_phase(torch, kernels, windows, smi_line())
    print(f"phase 5: {time.perf_counter() - t5:.1f}s", flush=True)
    for k, v in net_counts.items():
        counts[k] += v
    # Phase 6: the precision policy, Adam, the negative result, overlap.
    t6 = time.perf_counter()
    net_counts, policy = policy_phase(torch, kernels, smi_line())
    print(f"phase 6: {time.perf_counter() - t6:.1f}s", flush=True)
    for k, v in net_counts.items():
        counts[k] += v
    # Phase 7: the published-table reproduction.
    t7 = time.perf_counter()
    net_counts, repro = repro_phase(torch, kernels, smi_line())
    print(f"phase 7: {time.perf_counter() - t7:.1f}s", flush=True)
    for k, v in net_counts.items():
        counts[k] += v
    # Phase 8: the async down-link and the run-health watchdog.
    t8 = time.perf_counter()
    net_counts, downlink = downlink_phase(torch, kernels)
    print(f"phase 8: {time.perf_counter() - t8:.1f}s", flush=True)
    for k, v in net_counts.items():
        counts[k] += v
    # Phase 9: the TCP tier, durability and kill-recover.
    t9 = time.perf_counter()
    net_counts, tcp = tcp_phase(torch, kernels)
    print(f"phase 9: {time.perf_counter() - t9:.1f}s", flush=True)
    for k, v in net_counts.items():
        counts[k] += v
    print("kernels: " + json.dumps(counts), flush=True)
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 "main path")

    line = {"kernels": [dict(
        name=name, route="cuda", source=SOURCES.get(name, SOURCE),
        replaces=REPLACES[name],
        launches=counts[name], max_abs_err=c["max_abs_err"], ms=c["ms"],
        plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
        library_ms=c["library_ms"]) for name, c in checks.items()]}
    print("train: " + json.dumps(per_method), flush=True)
    print("async: " + json.dumps(async_runs), flush=True)
    print("window: " + json.dumps(windows), flush=True)
    print("checkpoint: " + json.dumps(ckpt), flush=True)
    print("policy: " + json.dumps(policy), flush=True)
    print("repro: " + json.dumps(repro), flush=True)
    print("downlink: " + json.dumps(downlink), flush=True)
    print("tcp: " + json.dumps(tcp), flush=True)
    print(f"wall: {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps(line), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
