#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ewdml_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. Build the CUDA kernels from ``ewdml_tpu_torch/kernels/compress.cu``,
   ``decode.cu``, ``precision.cu`` and ``random.cu`` (one ``nvcc`` per
   source, started together; the last two include ``threefry.cuh``).
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
   (a decode set of one) per tensor at k = 4 and 3 and blockwise 4096 and
   8192 over the bucket and over a tail (bit). Each is timed with CUDA events (median of repeats, L2
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
   at every ResNet50 leaf of at least ``MIN_ELEMS`` elements. Then the
   decode set (``acc_decode_set``, ``kernels/decode.cu``): bit-equal to
   ``decode_sum_set_ref`` in ``decode_set_launches`` launches at the
   homomorphic apply set of VGG11-BN (38 leaves), ResNet50 (161),
   ResNet152 (467, two launches) and LeNet (8) per tensor at k = 4,
   VGG11-BN's set blockwise 4096, a mixed adaptive plan's mean on
   VGG11-BN (Top-k, QSGD and dense leaves: one decode launch, every leaf
   bit-equal to the mean under ``--pallas off``) and an edge set (1, 3,
   4 095, 4 097 and 530 442 elements at k = 3, 4 and 6, per tensor and
   blockwise 4096); each model set timed by events and alone beside its
   bound (8 bytes an element), the per-leaf route on the same inputs (a
   launch per leaf of at least ``MIN_ELEMS``, the plain version below; its
   device ops counted), one ``torch.mul`` a leaf and the plain version (``decode
   set`` lines). Then 6a (the store kernel) and:
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
3b. The same runs and checks on ResNet50 at full width, the 5-step runs
   for 3 steps (same data, batch, W and precision; its 14 transport units,
   the 1 436-block
   ``fused_q`` chunk). Every run of phases 3 and 3b prints a ``train`` line
   with its ``network=`` and its launches per step.
3c. The device-resident feed and the scan window (``--feed device
   --scan-window K``): VGG11-BN at the same shapes under M4, M1, M5 and
   M4 ``ring_rs --qsgd-block 4096`` with K = 8 for 16 steps (one replay;
   M4 24 steps, two replays, until phase 17), M6 with the auto
   K = 20 (its sync period) for 40 steps, and ResNet50 M4 with K = 8 for
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
   them summed by int_accumulate, all decoded in one acc_decode_set launch
   each round).
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
   ``--method 2``, 16 steps each (``--feed device``, deterministic
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
   8, 16 steps each) and phase 5's resume on the VGG11-BN one (8 + 8); (g) the
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
   (b) ``run_sweep("baseline", smoke=True)`` over one LeNet cell
   (``SWEEP_CELLS``: M2) as a child process on the card
   with ``--fault-spec crash@0=3``: the crashed cell journals
   ``cell_retry`` with rc 13 and resumes from step 2, the cell finishes,
   ``REPRO.md`` is written with the other eleven cells pending, and a
   second invocation journals 1 ``cell_skipped`` and launches no child.
   Each cell's wall is printed.

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
   same run without it: VGG11-BN QSGD decode, W = 4 at K = 1, 20 updates;
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
   thread and four ``PSNetWorker`` threads over localhost sockets, 3 steps
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
   ``--snapshot-every 4`` applies 6 K = 2 batches of two TCP workers'
   frames; a second server recovers from the directory (the snapshot at 4
   and two WAL records) to the same version, parameters, momentum and
   shadow bit for bit, and acknowledges every recorded push again as a
   duplicate. Printed: the snapshot's bytes, a write's seconds, the WAL
   records, the recovery's seconds. (c) Across processes: ``python -m
   ewdml_tpu_torch.parallel.ps_net --role server --server-state-dir D
   --fault-spec serverkill@5 --server-agg homomorphic`` (K = 1; every
   process derives the scale contract on its own and each worker checks
   the server's scale CRC on its pulls), two worker processes of 5 steps
   and a late joiner (``join@2=3``, 4 steps); the server dies by SIGKILL
   at apply 5 and is started again on the same port and directory; every
   worker exits 0 with ``PS_NET_WORKER_DONE`` after at least one
   ``resync``, and the final ``stats`` shows version 20 (no push applied
   twice, the killed apply's re-sent push acknowledged), ``recoveries`` 1,
   ``joins`` 1, ``live_workers`` 3. Printed: the wall of each step of the
   run, beside the card's name and power limit.

10. The read replicas and the aggregation tree (``parallel/replica.py``,
    ``parallel/aggtree.py``) on VGG11-BN at the same shapes, QSGD
    ``--server-agg homomorphic``. (a) In process: the same k leaf payloads
    through a flat root (k int8 pushes: ``int_accumulate``, then
    the decode set at k) and a tree root (two int16 pseudo-pushes through
    ``push_subtree``, summed as an aggregator sums them: a torch sum, then
    the decode set at k) at leaf weights 2+2, 1+2 and 3+3: parameters and
    momentum bit-equal, one decode each, no ``int_accumulate`` on the tree
    arm and every launch at its count. (b) A server with ``--pull-delta --keyframe-every 4`` takes 6
    K = 1 applies: a ``subscribe`` after each replays through
    ``pd_apply_delta`` onto the server's publication shadow bit for bit,
    and onto the parameters at each keyframe; a keyframe is 4 n bytes and
    a delta n + 4 ceil(n/4096); one ``random_bits`` launch a delta
    publish; a replica then serves 40 pulls from four clients (its pull
    handler's p50 and p99 printed). (c) Across processes: an apply server
    on the card (K = 4, ``--pull-delta``), two replica processes, two
    aggregator processes and four worker processes on the card
    (``--replicas``, ``--agg-tree``), 3 steps a worker; replica 0 is
    SIGKILLed at version 2 and the workers fail over to replica 1. The
    apply server serves no pull; the leaf weight admitted equals the
    leaf pushes; one decode a round; the root's in-link is its
    pseudo-pushes' int16 frames exactly; replica 1's pull at the final
    version equals a replay of the server's stream. (d) The same without
    replicas and with ``aggkill@0=2`` on aggregator 0: it dies by SIGKILL
    after its second forward, its leaves rehome to aggregator 1, and the
    run completes. Printed: versions, pseudo-pushes, weights, the
    duplicate members, the walls.

11. Federated rounds in one process (``ewdml_tpu_torch/federated``), each
    run checked for one decode a round (homomorphic), its journal's
    dropouts and replacements against the run's, ``bytes_up`` equal to the
    admitted pushes times their encoded frame, and every kernel's launches
    equal to the reckoning (``expected_fed_launches``: the endpoint's
    templates, a compress per client round, an accumulate and a decode per
    big leaf per apply and for the warm apply). (a) The federated table's
    ``lenet_mnist/fed_c8_dir01_drop`` cell through ``cli.main``: LeNet on
    the committed ``mnist10k``, M4, batch 64, lr 0.01, momentum 0,
    homomorphic, pool 64, cohort 8, 5 local steps, Dirichlet 0.1,
    ``crash@3=1,crash@11=1,crash@42=1``, 10 rounds; its round ledger
    byte-equal to the same command's with ``--platform cpu``. (b) VGG11-BN
    at full width on ``mnist10k32``, homomorphic, pool 16, cohort 8, 2
    local steps, 3 rounds, then ``evaluate_params`` with the initial
    BatchNorm statistics passed. (c) (b) under ``--server-agg decode``,
    cohort 4, ``--num-aggregate 3``, 2 rounds: ``qsgd_quantize`` once per
    big leaf per client round, ``quota_dropped == fed_rejected == 2``. (d)
    (b) thread-batched four clients at a time, 2 rounds: each round's
    accepted set a subset of its cohort, of the accept size. Printed per
    run: the eval top-1 and loss, the round wall p50, ``federated.client_s``
    p50 and ``apply_ms_mean``, beside the card's name and power limit.

12. Federated rounds over TCP and the round pipeline
    (``federated/loop.NetTransport``, ``federated/pipeline.py``, the
    server's ``fed_*`` ops). (a) 11a's config for 3 rounds across
    processes: a server on the event-loop plane and a ``--role
    fed_driver``, both on the card; the server's round ledger byte-equal
    to the same config's in-process ``--platform cpu`` run (run here
    meanwhile). (b) 11b's config over TCP on the threads plane, the server
    and the thread-batched driver (the whole cohort a push wave) in this
    process, two aggregator processes (``--agg-tree``) and one replica
    process (``--replicas``): one pseudo-push per aggregator holding
    members per round, no pull at the apply server (its per-op segments),
    the launches at their reckoning (two endpoint set-ups; the tree root's
    int16 sum launches no ``int_accumulate``), the driver's per-op wire
    latencies printed. (c) 11b under ``--round-pipeline overlap``, accept 7
    of 8, a round-0 straggler sleeping 2 s before its push: round 1 begins
    before round 0 commits, one decode a commit, at least one round-stale
    drop. (d) 11b under ``--round-pipeline async``, accept 8 (a 32-tick
    quota), a deferred straggler, run twice: the two journals byte-equal,
    at least one down-weighted delta, no round-stale drop; then
    ``int_accumulate`` at every (K, n) the runs summed (K = 32 among them,
    and the commits' larger heights) bit-equal to its plain version. (e)
    ``lenet_mnist/fed_c8_dir01_drop`` through the experiments runner's
    cell entry (``runner.run_cell_child``) at smoke scale: one decode a
    round. Each in-process run's launches are checked against the
    reckoning.

13. Adaptive compression (``ewdml_tpu_torch/adapt``). First the operating
    points the plans reach, each bit-equal to its plain version and timed
    beside its bound and alone: ``qsgd_quantize`` at s = 7 (the 4-bit rung)
    at every VGG11-BN leaf of at least ``MIN_ELEMS`` elements and
    blockwise 4096 at the largest; ``block_top1`` at the 1% and 5% views
    of every VGG11-BN leaf above 2^18 elements and of LeNet's fc1. (a)
    The sync trainer: VGG11-BN, W = 4, batch 128, M5 at 1%, ``--adapt
    variance --adapt-every 5``, 20 steps in 5-step windows under
    deterministic algorithms: at least one switch, every journaled
    ``bytes_per_sync`` within the budget, after each switch the wire
    plan's up bytes and the payloads shipped equal to
    ``plan_wire_bytes``, every step's ``qsgd_quantize``, ``dequant_mean``
    and ``block_top1`` at its plan's reckoning (``plan_step_launches``;
    the bytes estimate's step on a copy of the state counted the same);
    then ``--adapt replay`` of the ledger: the same applied sequence and
    every worker's state bit-equal; the mean step time per plan. Then M4
    with ``--qsgd-block 4096`` for 15 steps, the same checks without the
    replay: its plans start from blockwise 8-bit QSGD (``qsgd_quantize``
    and ``dequant_mean`` on the path; M5's budget buys only Top-k and
    dense leaves). (b) The
    async server: VGG11-BN, K = 4, QSGD under ``--server-agg
    homomorphic``, ``--adapt-every 3``: a switch, ``pushes == updates x K
    + dropped_plan_stale + dropped_stale + pending``, every apply's and
    every registration's warm apply's ``int_accumulate`` and
    ``acc_decode`` at its plan's reckoning (``plan_apply_launches``),
    ``apply_ms_mean`` per plan, then both kernels bit-equal to their
    plain versions at every plan's contract. (c) The TCP tier: a server
    process (threads plane, ``--server-state-dir``, ``serverkill@5``) and
    two worker processes under ``--adapt variance --adapt-every 3``; the
    server is restarted: its recovered ``plan_version`` is the ledger's
    plan in force, and the WAL shows every plan version's pushes from both
    workers. (d) The table's ``lenet_mnist/adaptive`` cell through
    ``runner.run_cell_child`` at smoke scale: its row carries the
    ``adapt`` block.

14. The horovod-style substrate (``ewdml_tpu_torch/hvd``) and the live
    metrics plane (``obs/serve.py``, ``obs/{merge,export,rounds,report}``).
    (a) ``hvd.keras.Model.fit`` of VGG11-BN (seed 0) at CIFAR-10 shapes,
    W = 4 (``hvd.init(4)``), batch 128 a worker, f32, for HVD_STEPS steps
    under ``Compression.qsgd()``, ``Compression.topk_qsgd(0.01)`` and
    ``op="Adasum"`` with QSGD, then ``DistributedOptimizer(
    quirk_average_levels=True)`` called directly on the W gradients:
    every run's ``qsgd_quantize``, ``dequant_mean``, ``block_top1`` and
    ``random_bits`` launches equal the reckoning from VGG11-BN's leaf
    sizes and the 2^17 gate (``hvd_launches``); under deterministic
    algorithms the QSGD run's final state with the kernels is bit-equal
    to the same run with their plain versions; the quirk's ranks differ.
    Then ``python -m ewdml_tpu_torch.examples.horovod_style`` on LeNet with
    the committed ``mnist10k`` (W = 4, 2 epochs). (b) The sync CLI
    (VGG11-BN M4, LIVE_STEPS steps, deterministic) in two child processes
    at once, one with ``--metrics-port 0 --trace-dir``: its
    ``TRAINER_METRICS`` endpoint scraped in both formats while it runs,
    its checkpoint byte-equal to the other's. Then a server, a replica
    and two workers as processes (QSGD ``--server-agg homomorphic``, K =
    2, ``--pull-delta``, pulls from the replica), each with
    ``--metrics-port 0`` and one ``--trace-dir``: every role's endpoint
    scraped while it runs; ``cli obs rounds``, ``export`` and ``report``
    on the directory: a row a round, every complete round's segments
    summing to its wall, a cross-process flow for every round's gating
    push, one decode a round; the server process's own int_accumulate and
    acc_decode launches (its ``stats`` reply) at their reckoning
    (``tcp_apply_launches``) and none of its leaves decoded on the card
    with the plain version; the scrape latency and the rounds' split
    printed.
15. The static-analysis pass (``ewdml_tpu_torch/analysis``): ``python -m
    ewdml_tpu_torch.cli lint --json`` in a child process on this host
    must exit 0 with no finding against the committed (empty) baseline;
    it prints a ``lint files N new 0 suppressed S seconds T`` line. It
    launches no kernel.
16. Multi-slice training on one card and the four examples. (a)
    VGG11-BN at CIFAR-10 shapes, W = 8 in two slices of four
    (``--num-workers 8 --num-slices 2``), batch 128 a worker, f32, TF32
    off, under M1, M4, M5 (``--topk-ratio 0.01 --error-feedback``) and
    M6 (21 steps: one sync, one adoption), each beside the same run at
    one slice: the qsgd_quantize, dequant_mean and block_top1 launches
    equal the reckoning from the two levels' units
    (``slice_step_launches``), and the up-link bytes each level's
    gathers ship equal ``wire_plan``'s rows (the ``dcn/`` ones per
    worker); the step-time difference is the second level's cost. (b)
    M5 with error feedback at 2 x 4, 16 steps, per-step against ``--feed
    device --scan-window 8`` (one CUDA graph a window phase; deterministic
    algorithms): rows, state and launches bit-equal, launches at the
    reckoning. (c) The three kernels against their plain versions at the
    ICI and DCN shapes of VGG11-BN's units (dequant_mean at K = 4 and
    K = 2), dequant_mean at both K timed. (d) The four examples of
    ``ewdml_tpu_torch/examples/`` on the card: the negative result at its
    docstring's setting must end on its own verdict (the lossy weight
    broadcast diverges: its final loss not finite or above 5x Method
    2's), the experiment matrix (LeNet, six methods), the compressor
    round trip (levels and indices equal to the CPU's), VGG11 and
    ResNet18 on the real ``mnist10k32``.
17. The sync trainer across OS processes (``parallel/launcher.py``,
    ``core/world.ProcessWorld``): child processes of ``cli.main`` with
    the variables torchrun sets, under phase 16's determinism settings.
    (a) One NCCL rank on cuda:0 (W = L = 4, VGG11-BN on ``mnist10k32``,
    batch 128 a worker, M4, 3 steps) and (c) three gloo ranks of LeNet
    M6 (21 steps, one adoption) beside its emulated twin train at once;
    then (b) VGG11-BN M4 and M5 (1%, error feedback, two slices: slice s
    = process s) as two gloo ranks of L = 2 on the one card, then the
    emulated W = 4 run (17a's twin too, for M4), one after the other;
    every child is started at once and waits for its turn to train, so
    the startups overlap and the step times do not. Every checkpoint equals
    its twin's byte for byte; each process's qsgd_quantize, dequant_mean
    and block_top1 launches equal ``world_step_launches`` (it encodes its
    own workers' payloads and decodes every mean itself), its staged
    bytes a step equal ``wire_plan``'s rows (L x the up-link, or L x the
    ``dcn/`` rows), no leaf is decoded on the card by the plain version,
    and each 17b process's step ms is printed beside the emulated run's.
    A child that fails or outlives its wall timeout fails the phase. The
    phase runs after phase 15, its children started with it, and before
    phase 16.

Every kernel's launch count over the runs of phases 3, 3b, 3c, 4, 5, 6, 7a,
8, 9, 10, 11, 12, 13, 14, 16 and 17 must be above 0, and the in-process
runs of phases 4 and 9 to 14, and 14b's server process, must decode no
leaf on the card with the plain version (every homomorphic apply decodes
every quantized leaf in ``decode_set_launches`` launches: one up to 448
leaves). ``--phase8-only`` to ``--phase17-only`` build and run that
phase alone (no result line).

Then it prints the kernels' JSON line, the card's name and power limit
(nvidia-smi), and last ``{"ok": true, "device": {...}}``. Without a GPU, or
without the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
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
SOURCES = {"acc_decode": "ewdml_tpu_torch/kernels/decode.cu",
           "stochastic_round": "ewdml_tpu_torch/kernels/precision.cu",
           "random_bits": "ewdml_tpu_torch/kernels/random.cu"}
# The kernels line's name where it is not the wrapper's launch count's: the
# decode is one launch for a set of leaves.
LINE_NAMES = {"acc_decode": "acc_decode_set"}
# The names of each wrapper's kernels in a torch.profiler trace.
KERNEL_NAMES = {
    "qsgd_quantize": ("qsgd_quantize_kernel",),
    "dequant_mean": ("dequant_mean_kernel",),
    "block_top1": ("block_top1_kernel",),
    "chunk_encode": ("ring_hop_kernel", "ring_encode_kernel"),
    "dequant_acc_requant": ("ring_hop_kernel", "ring_encode_kernel"),
    "int_accumulate": ("int_accumulate_kernel",),
    "acc_decode": ("acc_decode_set_kernel",),
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


# The plain decode's calls on CUDA tensors (``kernels.acc_decode_ref``,
# three device ops a leaf), counted while ``counting``: the main path
# decodes every quantized leaf in the set kernel, so a phase that drives it
# must end with none. The checks that hold the kernel against the plain
# version call it inside ``plain_reference()``, which is not counted.
PLAIN_DECODES = {"calls": 0, "counting": True}


def count_plain_decodes(kernels) -> None:
    real = kernels.acc_decode_ref

    def counted(acc, *a, **kw):
        if acc.is_cuda and PLAIN_DECODES["counting"]:
            PLAIN_DECODES["calls"] += 1
        return real(acc, *a, **kw)

    kernels.acc_decode_ref = counted


@contextlib.contextmanager
def plain_reference():
    PLAIN_DECODES["counting"] = False
    try:
        yield
    finally:
        PLAIN_DECODES["counting"] = True


def no_plain_decodes(phase: str) -> None:
    """Fail ``phase`` if its runs decoded a leaf on the card with the plain
    version (then zero the count for the next phase)."""
    calls, PLAIN_DECODES["calls"] = PLAIN_DECODES["calls"], 0
    if calls:
        raise AssertionError(f"{phase}: {calls} leaves decoded on the card "
                             "by the plain version, not the set kernel")


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
                    with plain_reference():
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
    4096 at the largest), and int_accumulate at every leaf the homomorphic
    apply sums, W = K = 4: each bit-equal to its plain version there, then
    timed (the apply's decode is one set: ``check_decode_sets``)."""
    dequant, accumulate = [], []
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
    finally:
        kernels.configure("auto")
    return dequant, accumulate


def same_decode(torch, kernels, acc, sc, what) -> None:
    """acc_decode bit-equal to its plain version, through the kernel."""
    before = kernels.LAUNCHES["acc_decode"]
    a = kernels.decode_sum(acc, sc, WORLD)
    with plain_reference():
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
    out["dequant_mean"], out["int_accumulate"] = reduce_rows(
        torch, kernels, timer, quant, network, g)
    return out


# The apply sets the decode kernel is held and timed at (tentpole of the
# decode set): every leaf of each network is quantized under --server-agg
# homomorphic (qsgd / topk_qsgd), so one apply decodes all of them.
DECODE_NETWORKS = ("VGG11", "ResNet50", "ResNet152", "LeNet")
DECODE_EDGE = (1, 3, 4095, 4097, TAIL_CHUNK)


def apply_sizes(network: str) -> list:
    """The element count of every leaf of ``network`` (CIFAR-10 heads;
    LeNet on MNIST), in the JAX tree's leaf order."""
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs

    dataset = "mnist" if network == "LeNet" else "Cifar10"
    return [math.prod(s.jax_shape)
            for s in leaf_specs(build_model(network, 10, dataset=dataset))]


def decode_items(torch, sizes, k: int, block, g, offset: int = 0) -> list:
    """A decode set on the card: per leaf a random K-way int32 sum and its
    scales (one, or one per ``block``); with ``offset``, each sum a view
    that many elements into its storage (the wrapper realigns it)."""
    items = []
    for n in sizes:
        acc = torch.randint(-127 * k, 127 * k + 1, (n + offset,),
                            device="cuda", generator=g).to(torch.int32)
        nb = 1 if block is None else -(-n // block)
        sc = torch.rand(nb, device="cuda", generator=g) * 1e-3 + 1e-6
        items.append((acc[offset:], sc, k, block))
    return items


def same_decode_set(torch, kernels, items, what, decode=None) -> int:
    """The set kernel bit-equal to ``decode_sum_set_ref`` leaf for leaf, in
    ``decode_set_launches`` launches, each mean on a 16-byte boundary;
    ``decode`` the call under test (``acc_decode_set`` of ``items`` if
    None). Returns the launches."""
    before = kernels.LAUNCHES["acc_decode"]
    got = (decode or (lambda: kernels.acc_decode_set(items)))()
    with plain_reference():
        want = kernels.decode_sum_set_ref(items)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["acc_decode"] - before
    live = sum(1 for it in items if it[0].numel())
    if launches != kernels.decode_set_launches(live):
        raise AssertionError(f"acc_decode_set {what}: {launches} launches "
                             f"for {live} leaves")
    for i, (a, b) in enumerate(zip(got, want)):
        if a.data_ptr() % 16 or not torch.equal(a.view(torch.int32),
                                                b.view(torch.int32)):
            raise AssertionError(
                f"acc_decode_set {what}: leaf {i} of {a.numel()} elements: "
                f"{int((a != b).sum())} values differ from the plain "
                "version (or it is off a 16-byte boundary)")
    return launches


def decode_layout(torch, kernels, sizes, k: int, block, g) -> tuple:
    """A ``kernels.DecodeSet`` of ``sizes`` as the homomorphic apply keeps
    one, its sums arena filled with random K-way sums, and the same set as
    ``(acc, scales, k, block)`` items on the arena's views."""
    scales = [torch.rand(1 if block is None else -(-n // block),
                         device="cuda", generator=g) * 1e-3 + 1e-6
              for n in sizes]
    dset = kernels.DecodeSet([(n, sc, k, block)
                              for n, sc in zip(sizes, scales)], "cuda")
    acc = dset.acc_arena()
    acc.copy_(torch.randint(-127 * k, 127 * k + 1, (dset.total,),
                            device="cuda", generator=g))
    items = [(a, sc, k, block) for a, sc in zip(dset.views(acc), scales)]
    return dset, acc, items


def per_leaf_decode(kernels, items) -> list:
    """The per-leaf route the apply took before its decode set, on the same
    inputs: per leaf of at least MIN_ELEMS one launch (a set of one), below
    it the plain version (three device ops)."""
    with plain_reference():
        return [kernels.acc_decode(acc, sc, k, block=block)
                if acc.numel() >= kernels.MIN_ELEMS
                else kernels.acc_decode_ref(acc, sc, k, block=block)
                for acc, sc, k, block in items]


def decode_set_row(torch, kernels, timer, network: str, g) -> dict:
    """One network's apply set (per tensor, K = 4) bit-equal and timed:
    the decode the apply runs (``DecodeSet.launch``, packed once) by
    events and alone, beside its bound (8 bytes an element and a scale a
    leaf); the same set packed on the call (``acc_decode_set``); the
    per-leaf route with its device ops; one ``torch.mul`` a leaf (the
    library route); and the plain version."""
    sizes = apply_sizes(network)
    dset, acc, items = decode_layout(torch, kernels, sizes, WORLD, None, g)
    launches = same_decode_set(torch, kernels, items, network,
                               lambda: dset.decode(acc))
    same_decode_set(torch, kernels, items, f"{network} packed per call")
    elements = sum(sizes)
    bnd, by = bound_ms(8 * elements + 4 * len(sizes),
                       OPS_PER_ELEM["acc_decode"] * elements)
    fn = lambda: dset.launch(acc)
    ms = timer(fn)
    alone = timer.device(fn, KERNEL_NAMES["acc_decode"])  # per launch
    packed = lambda: kernels.acc_decode_set(items)
    per_leaf = lambda: per_leaf_decode(kernels, items)
    big = sum(1 for n in sizes if n >= kernels.MIN_ELEMS)
    factors = [sc * torch.tensor(1.0 / k, dtype=torch.float32, device="cuda")
               for _, sc, k, _ in items]
    library = lambda: [torch.mul(a, f)
                       for (a, _, _, _), f in zip(items, factors)]

    def plain():
        with plain_reference():
            return kernels.decode_sum_set_ref(items)
    return dict(
        network=network, leaves=len(sizes), big=big, elements=elements,
        shape=[len(sizes), elements], launches=launches, ms=ms,
        device_ms=None if alone is None else alone * launches,
        bound_ms=bnd, bound_by=by, share=bnd / ms,
        set_device_ops=device_kernels(torch, fn),
        packed_ms=timer(packed),
        per_leaf_ms=timer(per_leaf), per_leaf_launches=big,
        per_leaf_device_ops=device_kernels(torch, per_leaf),
        library_ms=timer(library), plain_ms=timer(plain, reps=10),
        max_abs_err=0.0)


def mixed_plan_decode(torch, kernels, g) -> dict:
    """A mixed adaptive plan's homomorphic mean on VGG11-BN (Top-k QSGD at
    1%, 8-bit QSGD blockwise 4096 and dense leaves in turn, as the adaptive
    plans mix them): K = 4 payloads through ``homomorphic_mean`` on the
    card, one decode launch for every quantized leaf, every leaf bit-equal
    to the same mean under ``kernels.configure("off")``."""
    from ewdml_tpu_torch.adapt import plan as aplan
    from ewdml_tpu_torch.ops import homomorphic
    from ewdml_tpu_torch.parallel import ps
    from ewdml_tpu_torch.utils import prng

    sizes = apply_sizes("VGG11")
    kinds = (("topk_qsgd", 127, 0.01), ("qsgd", 127, 0.0), ("dense", 0, 0.0))
    mix = aplan.Plan(1, 5, tuple(
        aplan.UnitDecision(u, f"l{u}", *kinds[u % 3])
        for u in range(len(sizes))))
    grads = [torch.randn(n, device="cuda", generator=g) * 1e-2 for n in sizes]
    comp = homomorphic.make_homomorphic(
        aplan.build_planned_compressor(mix, block=4096), grads)
    compress = ps.make_compress_tree(comp)
    trees = [compress([x * (1 + w / 4) for x in grads], prng.key(w))
             for w in range(WORLD)]
    quantized = sum(1 for u in range(len(sizes)) if u % 3 != 2)
    before = kernels.LAUNCHES["acc_decode"]
    got = homomorphic.homomorphic_mean(comp, trees)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["acc_decode"] - before
    kernels.configure("off")
    try:
        with plain_reference():
            want = homomorphic.homomorphic_mean(comp, trees)
    finally:
        kernels.configure("auto")
    if launches != kernels.decode_set_launches(quantized):
        raise AssertionError(f"mixed plan: {launches} decode launches for "
                             f"{quantized} quantized leaves")
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"mixed plan leaf {i}: {int((a != b).sum())}"
                                 " values differ from the plain mean")
    return dict(leaves=len(sizes), quantized=quantized, launches=launches)


def check_decode_sets(torch, kernels, timer) -> tuple:
    """The decode set (``kernels/decode.cu``) bit-equal to its plain
    version on the card: the homomorphic apply set of VGG11-BN (38 leaves),
    ResNet50 (161), ResNet152 (467: two launches) and LeNet (8) per
    tensor, VGG11-BN's blockwise 4096, a mixed adaptive plan's mean, and an
    edge set (1, 3, 4 095, 4 097 and 530 442 elements at k = 3, 4 and 6,
    per tensor and blockwise 4096, the sums off a 16-byte boundary once);
    each model set timed (``decode_set_row``). Returns the kernels line's
    entry (VGG11-BN's set) and every row."""
    g = torch.Generator(device="cuda").manual_seed(70)
    rows = {net: decode_set_row(torch, kernels, timer, net, g)
            for net in DECODE_NETWORKS}
    dset, acc, items = decode_layout(torch, kernels, apply_sizes("VGG11"),
                                     WORLD, 4096, g)
    same_decode_set(torch, kernels, items, "VGG11 block 4096",
                    lambda: dset.decode(acc))
    edge = 0
    for k in (3, 4, 6):
        for block in (None, 4096):
            edge += same_decode_set(
                torch, kernels,
                decode_items(torch, DECODE_EDGE, k, block, g,
                             offset=int(k == 6)),
                f"edge k={k} block={block}")
    rows["mixed_plan"] = mixed_plan_decode(torch, kernels, g)
    rows["edge_launches"] = edge
    vgg = rows["VGG11"]
    entry = {key: vgg[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "shape", "device_ms")}
    return entry, rows


def print_decode_sets(rows: dict) -> None:
    def ms(v):
        return "not measured" if v is None else f"{v:.4f} ms"

    for net in DECODE_NETWORKS:
        r = rows[net]
        print(f"decode set {net}: {r['leaves']} leaves ({r['big']} of 2^17 "
              f"or more), {r['elements']} elements, k={WORLD}: "
              f"{r['launches']} launch(es) {r['ms']:.4f} ms, alone "
              f"{ms(r['device_ms'])}, bound {r['bound_ms']:.4f} ms "
              f"({100 * r['share']:.1f}% by events), device ops "
              f"{r['set_device_ops']}; packed on the call "
              f"{r['packed_ms']:.4f} ms; the per-leaf route "
              f"{r['per_leaf_launches']} "
              f"launches + plain below 2^17: {r['per_leaf_ms']:.4f} ms, "
              f"{r['per_leaf_device_ops']} device ops; library (torch.mul a "
              f"leaf) {r['library_ms']:.4f} ms; plain {r['plain_ms']:.4f} "
              "ms", flush=True)
    m = rows["mixed_plan"]
    print(f"decode set mixed plan VGG11: {m['quantized']} of {m['leaves']} "
          f"leaves quantized, {m['launches']} launch, bit-equal to the "
          f"plain mean; edge sets {rows['edge_launches']} launches, "
          "bit-equal", flush=True)
    print("decode sets: " + json.dumps(rows), flush=True)


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


RESNET50_STEPS = 3  # 3b: the runs of 5 VGG11-BN steps (5 until phase 16)
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
        if network == "ResNet50" and steps == 5:
            steps = RESNET50_STEPS
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
# its first replay, a replay of the graph already captured; two (no second
# replay) for the runs of 16 steps, cut from 24 when phase 16 came.
WINDOW_RUNS = [
    ("M1", "VGG11", 16, 8, ["--method", "1"]),
    ("M4", "VGG11", 16, 8, ["--method", "4"]),   # 24 until phase 17
    ("M5", "VGG11", 16, 8, ["--method", "5"]),
    ("M4 ring_rs", "VGG11", 16, 8, ["--method", "4", "--gather-type",
                                     "ring_rs", "--qsgd-block", "4096"]),
    ("M6", "VGG11", 40, 0, ["--method", "6"]),   # 60 until phase 17
    # Each window is replayed once (VGG11-BN's M4 twice until phase 17).
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
            if rres.rows.shape != (steps, ref.world.size, 3) or not torch.equal(
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
    warm apply) under homomorphic an accumulate per leaf of at least
    MIN_ELEMS (QSGD only: Top-k's sum is a scatter-add) and one decode set
    of every leaf (``decode_set_launches``), and a stochastic-round launch
    per ``round_launches`` of the optimizer's stored leaves."""
    want = {k: 0 for k in kernels.LAUNCHES}
    shapes = [s.jax_shape for s in specs]
    big = sum(1 for s in shapes if math.prod(s) >= kernels.MIN_ELEMS)
    if cfg.server_agg == "decode":
        if cfg.compress_grad == "qsgd":
            for k, v in compress_launches(cfg, shapes, kernels).items():
                want[k] = v * (pushes + 1)
    else:
        want["acc_decode"] = (kernels.decode_set_launches(len(shapes))
                              * (updates + 1))
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
    PLAIN_DECODES["calls"] = 0
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
    no_plain_decodes("phase 4")
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
    event but the CUDA runtime's own (``cuda*``, ``cu*``) and the
    profiler's ``Activity Buffer Request``; None where the trace holds
    none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # The runtime's own events, and the profiler's buffer requests.
    count = sum(1 for e in prof.events()
                if not e.name.startswith(("cu", "Activity Buffer")))
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


NEGATIVE_STEPS = 16   # 40 until phase 17


def deterministic(torch, on: bool) -> None:
    torch.use_deterministic_algorithms(on)
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cudnn.deterministic = on


def negative_phase(torch, kernels, counts) -> dict:
    """6d: ``--lossy-weights-down`` (the settings of
    ``examples/weight_compression_negative.py`` at this phase's shapes)
    beside ``--method 2``, 16 steps each, ``--feed device`` and
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
OVERLAP_STEPS = 3       # 5 until phase 16


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
    ("M4 EF adam bf16_wire_state", "VGG11", 16, 8,   # 24 until phase 17
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
REPRO_CRASH = "crash@0=3"  # lenet_mnist/m2 dies at step 3
# 7b's sweep: one LeNet cell of the table (the sweep's machinery, not the
# cells, is under test; 7a trains VGG11-BN cells in process), crashed and
# resumed. Cut from the 12 cells once the whole script passed 1 000 s with
# phase 12, to three when phase 14 came and to one when the script reached
# 1 200 s on a slow host with phase 16: each child costs ~18-32 s, mostly
# its start.
SWEEP_CELLS = ("lenet_mnist/m2",)


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
    """7b: the smoke sweep of the ``baseline`` table's SWEEP_CELLS, each
    cell a child process on the card, one of them crashed and resumed;
    then its re-invocation, which skips every cell; the other cells are
    reported pending."""
    from ewdml_tpu_torch.experiments import runner
    from ewdml_tpu_torch.parallel.faults import CRASH_EXIT_CODE

    out_dir = os.path.join(root, "sweep")
    t0 = time.perf_counter()
    summary = runner.run_sweep("baseline", out_dir=out_dir, smoke=True,
                               platform="cuda", fault_spec=REPRO_CRASH,
                               cells=list(SWEEP_CELLS))
    first_s = time.perf_counter() - t0
    events = runner.Ledger(os.path.join(out_dir, "ledger.jsonl")).events()
    if summary["failed"] or summary["done_total"] != len(SWEEP_CELLS):
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
                             platform="cuda", fault_spec=REPRO_CRASH,
                             cells=list(SWEEP_CELLS))
    second_s = time.perf_counter() - t1
    events2 = runner.Ledger(os.path.join(out_dir, "ledger.jsonl")).events()
    new = events2[len(events):]
    skips = [e for e in new if e["event"] == "cell_skipped"]
    if (len(skips) != len(SWEEP_CELLS) or again["ran"] or again["failed"]
            or any(e["event"] == "cell_start" for e in new)):
        raise AssertionError(f"repro re-invocation: {again}")
    with open(summary["repro_md"]) as f:
        md = f.read()
    pending = [c.cell_id for c in runner.registry.table_cells("baseline")
               if c.cell_id not in SWEEP_CELLS]
    if (f"**Pending cells** ({len(pending)}): " + ", ".join(pending)
            not in md or "NVIDIA" not in md):
        raise AssertionError("repro sweep: REPRO.md does not list the "
                             "cells left out as pending or names no card")
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
RELAY_STEPS = 5       # 8d: per worker at K = 1, so 20 updates (40 until
                      # phase 16)
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
    K = 1, 20 updates each: the paper's negative result on the PS path."""
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
TCP_STEPS = 3                # per worker in 9a (6 until phase 14, 4
                             # until phase 17)
TCP_RUNS = [                 # 9a: (name, K, flags), each on both planes
    ("qsgd homomorphic", 4, ["--compress-grad", "qsgd",
                             "--server-agg", "homomorphic"]),
    ("qsgd decode", 2, ["--compress-grad", "qsgd", "--server-agg", "decode"]),
]
DURABLE_BATCHES = 6          # 9b: K = 2 batches of real worker frames
                             # (10 until phase 17)
KILL_AT = 5                  # 9c: serverkill@5
KILL_STEPS = 5               # 9c: per worker process (8 until phase
                             # 17); the joiner takes 4


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
    PLAIN_DECODES["calls"] = 0
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
    no_plain_decodes("phase 9")
    return counts, out


TREE_WEIGHTS = [(2, 2), (1, 2), (3, 3)]   # 10a: two pseudo-pushes a round
STREAM_APPLIES = 6           # 10b: K = 1 applies under --pull-delta
                             # (10 until phase 17)
STREAM_EVERY = 4             # 10b and 10c: --keyframe-every
TIER_STEPS = 3               # 10c and 10d: per worker process (6 until
                             # phase 14, 4 until phase 17)
TIER_WORKERS = 4
REPLICA_KILL_AT = 2          # 10c: replica 0 is SIGKILLed at this version
AGGKILL = "aggkill@0=2"      # 10d


def tier_cfg(k: int, *extra):
    from ewdml_tpu_torch.core.config import from_args

    return from_args(tcp_argv(k, ["--compress-grad", "qsgd", "--server-agg",
                                  "homomorphic"], *extra))


def leaf_frames(torch, setup, count: int) -> list:
    """``count`` push frames of shared-scale QSGD payloads (the workers'
    encode, its draws on ``random_bits``) of gradients near the scale
    template: the template times a seeded uniform in [0.5, 1.5)."""
    from ewdml_tpu_torch import native
    from ewdml_tpu_torch.utils import prng, transfer

    g = torch.Generator(device=setup.device)
    g.manual_seed(10)
    pack = transfer.make_device_packer()
    frames = []
    with torch.no_grad():
        for i in range(count):
            grads = [t * (0.5 + torch.rand(t.shape, generator=g,
                                           device=t.device))
                     for t in setup.grads_scale]
            tree = setup.compress_tree(grads, prng.key(1000 + i))
            frames.append(native.encode_arrays([pack(tree).cpu().numpy()]))
    return frames


def agg_frame(frames: list) -> bytes:
    """What an aggregator forwards for ``frames``
    (``parallel/aggtree.AggregatorServer._forward_chunk``): the int32 sum
    of the leaves' int8 levels, sent as int16."""
    import numpy as np

    from ewdml_tpu_torch import native

    acc = None
    for f in frames:
        lv = native.decode_arrays(f)[0].view(np.int8)
        acc = lv.astype(np.int32) if acc is None else acc + lv
    return native.encode_arrays([acc.astype(np.int16).view(np.uint8)])


def tier_server(cfg, setup, k: int, tree: bool, **kw):
    """A ``ParameterServer`` as ``PSNetServer`` builds it for ``cfg``: flat
    at K = ``k``, or an aggregation tree's root of two slots whose round
    weighs ``k`` leaves."""
    from ewdml_tpu_torch.ops.homomorphic import widen_payload_tree
    from ewdml_tpu_torch.optim import make_optimizer
    from ewdml_tpu_torch.parallel import ps

    opt = make_optimizer(cfg.optimizer, cfg.lr, cfg.momentum,
                         cfg.weight_decay, cfg.nesterov)
    server = ps.ParameterServer(setup.params, opt, setup.comp,
                                num_aggregate=k, server_agg="homomorphic",
                                device=setup.device, seed=cfg.seed, **kw)
    if tree:
        server.register_payload_schema(widen_payload_tree(setup.template),
                                       schema_k=2, agg_weight=k)
    else:
        server.register_payload_schema(setup.template)
    return server


def tree_root_runs(torch, kernels, counts) -> dict:
    """10a: the same k leaf payloads through a flat root (k int8 pushes:
    int_accumulate, then the decode set at k) and a tree root (two int16
    pseudo-pushes through push_subtree: a torch sum, then the decode set at
    k), at leaf weights (2, 2), (1, 2) and (3, 3): the parameters and
    momentum bit-equal, one decode each, every launch at its count."""
    from ewdml_tpu_torch.parallel import ps_net
    from ewdml_tpu_torch.parallel.ps import PushRecord

    cfg = tier_cfg(4, "--momentum", "0.9")
    setup = ps_net.build_endpoint_setup(cfg)
    frames = leaf_frames(torch, setup, max(a + b for a, b in TREE_WEIGHTS))
    sizes = apply_sizes(cfg.network)
    big = sum(1 for n in sizes if n >= kernels.MIN_ELEMS)
    out = {}
    for w0, w1 in TREE_WEIGHTS:
        k = w0 + w1
        arms = {}
        for arm in ("flat", "tree"):
            kernels.reset_launches()   # this arm of the main path
            t0 = time.perf_counter()
            server = tier_server(cfg, setup, k, arm == "tree")
            if arm == "flat":
                for i in range(k):
                    if not server.push(PushRecord(worker=i, version=0,
                                                  message=frames[i],
                                                  loss=0.0)):
                        raise AssertionError(f"tree {k}: push {i} refused")
            else:
                for j, members in enumerate((range(w0), range(w0, k))):
                    members = tuple(members)
                    rec = PushRecord(
                        worker=-(1 + j), version=0, loss=0.0,
                        message=agg_frame([frames[m] for m in members]),
                        push_id=f"agg{j}:0:0", weight=len(members),
                        members=members)
                    if server.push_subtree(rec) != (True, ()):
                        raise AssertionError(f"tree {k}: pseudo-push {j}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = dict(kernels.LAUNCHES)  # read just after it
            for key, v in launched.items():
                counts[key] += v
            s = server.stats
            if (server.version, s.decode_count, s.apply_rounds) != (1, 1, 1):
                raise AssertionError(f"tree {k} {arm}: version "
                                     f"{server.version}, {s.decode_count} "
                                     f"decodes in {s.apply_rounds} rounds")
            arms[arm] = (server, launched, wall, s.bytes_up,
                         s.apply_ms_mean)
        (flat, fl, fw, fup, fms), (tree, tl, tw, tup, tms) = (arms["flat"],
                                                              arms["tree"])
        same_server_state(torch, flat, tree, f"tree k={k}")
        if tree.stats.agg_pushes != 2 or tree.stats.agg_weight != k:
            raise AssertionError(f"tree {k}: {tree.stats.agg_pushes} "
                                 f"pseudo-pushes of {tree.stats.agg_weight}")
        # Both arms decode every leaf in one set at registration's warm
        # apply and at the round; only the flat arm launches
        # int_accumulate, on each leaf of at least MIN_ELEMS.
        if (tl["int_accumulate"], fl["int_accumulate"]) != (0, 2 * big) or \
                tl["acc_decode"] != fl["acc_decode"] or \
                fl["acc_decode"] != 2 * kernels.decode_set_launches(
                    len(sizes)):
            raise AssertionError(f"tree {k}: launches flat {fl}, tree {tl}")
        out[f"k={k}"] = dict(
            weights=[w0, w1], flat_launches=fl, tree_launches=tl,
            flat_bytes_up=fup, tree_bytes_up=tup, flat_apply_ms=fms,
            tree_apply_ms=tms, flat_wall_s=fw, tree_wall_s=tw)
        print(f"tree root k={k} ({w0}+{w1}): parameters and momentum "
              f"bit-equal to the flat root, one decode each; flat "
              f"int_accumulate {fl['int_accumulate']} acc_decode "
              f"{fl['acc_decode']}, tree int_accumulate "
              f"{tl['int_accumulate']} acc_decode {tl['acc_decode']} "
              f"(warm apply included); bytes up flat {fup} tree {tup}; "
              f"apply ms flat {fms:.3f} tree {tms:.3f}", flush=True)
        del flat, tree, arms
        torch.cuda.empty_cache()
    return out


def stream_run(torch, kernels, counts) -> dict:
    """10b: a ``PSNetServer`` with ``--pull-delta --keyframe-every 4``,
    armed by a first ``subscribe``, takes STREAM_APPLIES K = 1 applies; a
    poll after each replays through ``pd_apply_delta`` onto the shadow bit
    for bit, onto the parameters at each keyframe; a replay from
    ``since=-1`` at the end equals the final shadow. Then a
    ``PullReplicaServer`` follows it and four clients pull 40 times: the
    replica's pull handler p50/p99."""
    import threading

    import numpy as np

    from ewdml_tpu_torch.parallel import ps_net
    from ewdml_tpu_torch.parallel.ps import PushRecord, pd_apply_delta
    from ewdml_tpu_torch.parallel.replica import PullReplicaServer
    from ewdml_tpu_torch.utils import transfer

    cfg = tier_cfg(1, "--pull-delta", "--keyframe-every", str(STREAM_EVERY),
                   "--momentum", "0.9")
    kernels.reset_launches()   # this run of the main path
    server = ps_net.PSNetServer(cfg, port=0)
    srv = server.server
    setup = ps_net.build_endpoint_setup(cfg)
    frames = leaf_frames(torch, setup, 3)
    n = sum(p.numel() for p in srv.params)
    kf_bytes, delta_bytes = 4 * n, n + 4 * -(-n // 4096)
    mode, version, _, bufs = srv.subscribe_stream(-1)
    if (mode, version, len(bufs), bufs[0].nbytes) != ("keyframe", 0, 1,
                                                      kf_bytes):
        raise AssertionError(f"stream: bootstrap {mode} {version} "
                             f"{[b.nbytes for b in bufs]}")
    flat = np.frombuffer(bufs[0], np.float32).copy()
    pack = transfer.make_device_packer()
    before = dict(kernels.LAUNCHES)
    apply_s = []
    for v in range(1, STREAM_APPLIES + 1):
        t0 = time.perf_counter()
        srv.push(PushRecord(worker=0, version=v - 1, loss=0.0,
                            message=frames[v % 3]))
        apply_s.append(time.perf_counter() - t0)
        mode, version, kf, bufs = srv.subscribe_stream(v - 1)
        keyframe = v % STREAM_EVERY == 0
        if version != v or mode != ("keyframe" if keyframe else "delta"):
            raise AssertionError(f"stream v{v}: {mode} at {version}")
        if keyframe:
            flat = np.frombuffer(bufs[0], np.float32).copy()
            params = pack(srv.params).cpu().numpy()
            if bufs[0].nbytes != kf_bytes or \
                    flat.tobytes() != params.tobytes():
                raise AssertionError(f"stream v{v}: the keyframe is not "
                                     "the parameters")
        else:
            if sum(b.nbytes for b in bufs) != delta_bytes:
                raise AssertionError(f"stream v{v}: a delta of "
                                     f"{[b.nbytes for b in bufs]} B")
            flat = pd_apply_delta(flat, bufs[0], bufs[1])
        if flat.tobytes() != srv._pd_shadow.tobytes():
            raise AssertionError(f"stream v{v}: the replay is not the "
                                 "shadow")
    torch.cuda.synchronize()
    publishes = STREAM_APPLIES - STREAM_APPLIES // STREAM_EVERY
    draws = kernels.LAUNCHES["random_bits"] - before["random_bits"]
    mode, version, kf, bufs = srv.subscribe_stream(-1)
    replay = np.frombuffer(bufs[0], np.float32).copy()
    for i in range(1, len(bufs), 2):
        replay = pd_apply_delta(replay, bufs[i], bufs[i + 1])
    if (mode, version, kf) != ("keyframe", STREAM_APPLIES,
                               STREAM_APPLIES // STREAM_EVERY
                               * STREAM_EVERY) or \
            replay.tobytes() != srv._pd_shadow.tobytes():
        raise AssertionError(f"stream: since=-1 gave {mode} {version} {kf}"
                             ", not the shadow")
    launched = dict(kernels.LAUNCHES)  # read just after it
    for key, v in launched.items():
        counts[key] += v
    if draws != publishes:
        raise AssertionError(f"stream: {draws} random_bits launches for "
                             f"{publishes} delta publishes")
    # The replica's pull handler, beside phase 9's apply server.
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    replica = PullReplicaServer(cfg, server.address)
    rserve = threading.Thread(target=replica.serve_forever, daemon=True)
    rserve.start()
    errors = []

    def puller():
        try:
            for _ in range(10):
                h, secs = ps_net.client_call(replica.address, {
                    "op": "pull", "worker_version": -1})
                if h["version"] != STREAM_APPLIES or \
                        bytes(secs[0]) != srv._pd_shadow.tobytes():
                    raise AssertionError(f"replica pull {h}")
        except Exception as e:  # noqa: BLE001 -- raised below
            errors.append(e)

    pullers = [threading.Thread(target=puller) for _ in range(4)]
    for t in pullers:
        t.start()
    for t in pullers:
        t.join()
    hist = replica.registry.snapshot()["histograms"]
    for addr in (replica.address, server.address):
        ps_net.client_call(addr, {"op": "shutdown"})
    rserve.join(60)
    serve.join(60)
    replica.close()
    server.close()
    if errors:
        raise errors[0]
    pull = {f: (round(hist[f"ps_net.pull.{f}"]["p50"] * 1e3, 3),
                round(hist[f"ps_net.pull.{f}"]["p99"] * 1e3, 3))
            for f in ("handler_s", "latency_s")}
    out = dict(applies=STREAM_APPLIES, keyframe_bytes=kf_bytes,
               delta_bytes=delta_bytes, delta_publishes=publishes,
               random_bits_per_publish=draws / publishes,
               push_apply_publish_ms=[round(s * 1e3, 3) for s in apply_s],
               replica_pull_ms_p50_p99=pull, launches=launched)
    print(f"stream: {STREAM_APPLIES} applies, keyframe every "
          f"{STREAM_EVERY}: every version's replay equal to the shadow "
          f"(the parameters at each keyframe); keyframe {kf_bytes} B, delta "
          f"{delta_bytes} B, random_bits {draws / publishes:g} a publish; "
          f"push+apply+publish ms {out['push_apply_publish_ms']}; replica "
          f"pull (p50, p99) ms {pull}", flush=True)
    return out


def free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def tier_deployment(root: str, name: str, replicas: bool,
                    agg_faults: str = "") -> dict:
    """10c/10d across processes: an apply server on the card (K = 4,
    ``--pull-delta``), two aggregators, two replicas (``replicas``), and
    TIER_WORKERS worker processes on the card routed through them, each
    TIER_STEPS steps. 10c SIGKILLs replica 0 once the server reaches
    version REPLICA_KILL_AT; 10d gives aggregator 0 ``agg_faults``."""
    import numpy as np

    from ewdml_tpu_torch import native
    from ewdml_tpu_torch.parallel import ps_net
    from ewdml_tpu_torch.parallel.ps import pd_apply_delta

    port, *ports = free_ports(5)
    rports, aports = ports[:2], ports[2:4]
    tree = ",".join(f"127.0.0.1:{p}" for p in aports)
    reps = ",".join(f"127.0.0.1:{p}" for p in rports)
    common = tcp_argv(4, ["--compress-grad", "qsgd", "--server-agg",
                          "homomorphic"], "--port", str(port),
                      "--net-retries", "14", "--net-backoff", "0.5",
                      "--pull-delta", "--keyframe-every", str(STREAM_EVERY),
                      "--agg-tree", tree)
    walls, procs, logs = {}, [], {}

    def start(label, args):
        logs[label] = os.path.join(root, f"{name}_{label}.log")
        proc = ps_net_proc(args, logs[label])
        procs.append(proc)
        return proc

    t0 = time.perf_counter()
    try:
        server = start("server", ["--role", "server", *common])
        wait_for_line(server, logs["server"], "PS_NET_READY", 180)
        walls["server_ready_s"] = time.perf_counter() - t0
        reps_p = [start(f"replica{i}", [
            "--role", "replica", *common, "--replica-port", str(p)])
            for i, p in enumerate(rports)] if replicas else []
        aggs = [start(f"agg{i}", [
            "--role", "aggregator", *common, "--agg-port", str(p),
            "--agg-index", str(i),
            *(["--fault-spec", agg_faults] if agg_faults and i == 0
              else [])]) for i, p in enumerate(aports)]
        wflags = ["--replicas", reps] if replicas else []
        workers = [start(f"worker{i}", [
            "--role", "worker", *common, *wflags, "--worker-index", str(i),
            "--steps", str(TIER_STEPS)]) for i in range(TIER_WORKERS)]
        for i, p in enumerate(reps_p):
            wait_for_line(p, logs[f"replica{i}"], "PS_REPLICA_READY", 120)
        walls["tier_ready_s"] = time.perf_counter() - t0
        killed_at = None
        if replicas:
            deadline = time.perf_counter() + 300
            while time.perf_counter() < deadline:
                h, _ = ps_net.client_call(("127.0.0.1", port),
                                          {"op": "stats"})
                if h["version"] >= REPLICA_KILL_AT:
                    break
                time.sleep(0.1)
            reps_p[0].kill()
            reps_p[0].wait()
            killed_at = h["version"]
            walls["replica_killed_s"] = time.perf_counter() - t0
        done = []
        for i, w in enumerate(workers):
            rc = w.wait(timeout=400)
            line = wait_for_line(w, logs[f"worker{i}"],
                                 "PS_NET_WORKER_DONE", 1)
            if rc != 0:
                raise AssertionError(f"{name}: worker {i} exited {rc}")
            done.append(json.loads(line.split(" ", 1)[1]))
        walls["workers_done_s"] = time.perf_counter() - t0
        stats, _ = ps_net.client_call(("127.0.0.1", port), {"op": "stats"})
        agg_rc = aggs[0].poll()
        agg_stats = [ps_net.client_call(("127.0.0.1", p), {
            "op": "agg_stats"}, retries=0)[0] if a.poll() is None else None
            for a, p in zip(aggs, aports)]
        final = stats["version"]
        served = None
        if replicas:
            raddr = ("127.0.0.1", rports[1])
            deadline = time.perf_counter() + 60
            while True:
                h, secs = ps_net.client_call(raddr, {"op": "pull",
                                                     "worker_version": -1})
                if h["version"] == final or time.perf_counter() > deadline:
                    break
                time.sleep(0.05)
            # A replay of the server's stream from scratch.
            h2, bufs = ps_net.client_call(("127.0.0.1", port), {
                "op": "subscribe", "since": -1})
            replay = np.frombuffer(bufs[0], np.float32).copy()
            for i in range(1, len(bufs), 2):
                replay = pd_apply_delta(replay, np.frombuffer(bufs[i],
                                                              np.int8),
                                        np.frombuffer(bufs[i + 1],
                                                      np.float32))
            if h["version"] != final or h2["version"] != final or \
                    bytes(secs[0]) != replay.tobytes():
                raise AssertionError(f"{name}: replica 1 at {h['version']}"
                                     f", stream at {h2['version']}, final "
                                     f"{final}: its bytes are not the "
                                     "stream's replay")
            rstats, _ = ps_net.client_call(raddr, {"op": "stats"})
            served = dict(replica1_pulls=rstats["replica_pulls"],
                          replica1_keyframes=rstats["replica_keyframes"],
                          replica1_deltas=rstats["replica_deltas"])
            ps_net.client_call(raddr, {"op": "shutdown"})
        for a, p in zip(aggs, aports):
            if a.poll() is None:
                ps_net.client_call(("127.0.0.1", p), {"op": "shutdown"})
        ps_net.client_call(("127.0.0.1", port), {"op": "shutdown"})
        for label, proc in (("server", server), *(
                (f"agg{i}", a) for i, a in enumerate(aggs)), *(
                (f"replica{i}", r) for i, r in enumerate(reps_p))):
            rc = proc.wait(timeout=60)
            if rc != 0 and not (label == "replica0" and replicas) and \
                    not (label == "agg0" and agg_faults):
                raise AssertionError(f"{name}: {label} exited {rc}")
        walls["shutdown_s"] = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.log.close()
    n = VGG11_PARAMS
    wide = native.encoded_arrays_size([np.empty(2 * n, np.uint8)])
    leaf = native.encoded_arrays_size([np.empty(n, np.uint8)])
    pushes = TIER_WORKERS * TIER_STEPS
    segs = stats["segments"]
    if replicas and "pull" in segs:
        raise AssertionError(f"{name}: the apply server served "
                             f"{segs['pull']} pulls")
    if stats["decode_count"] != stats["apply_rounds"] or \
            stats["updates"] != final or \
            stats["bytes_up"] != stats["agg_pushes"] * wide:
        raise AssertionError(f"{name}: stats " + json.dumps(
            {k: stats[k] for k in ("version", "updates", "decode_count",
                                   "apply_rounds", "agg_pushes",
                                   "agg_weight", "bytes_up")}))
    out = dict(walls, version=final, updates=stats["updates"],
               agg_pushes=stats["agg_pushes"],
               agg_weight=stats["agg_weight"],
               agg_dup_members=stats["agg_dup_members"],
               decode_count=stats["decode_count"],
               apply_ms_mean=stats["apply_ms_mean"],
               bytes_up=stats["bytes_up"], wide_frame=wide,
               flat_reckoning=pushes * leaf, leaf_pushes=pushes,
               agg_push_segments=segs.get("agg_push"),
               subscribe_segments=segs.get("subscribe"),
               agg_stats=agg_stats, agg0_rc=agg_rc,
               replica_killed_at=killed_at if replicas else None,
               served=served,
               worker_retries=[d["retries"] for d in done],
               worker_rejected=[d["rejected"] for d in done],
               losses=[d["loss"] for d in done])
    print(f"tier {name}: version {final}, {stats['agg_pushes']} "
          f"pseudo-pushes of total weight {stats['agg_weight']} for "
          f"{pushes} leaf pushes, {stats['decode_count']} decodes in "
          f"{stats['apply_rounds']} rounds, apply_ms_mean "
          f"{stats['apply_ms_mean']}, dup members "
          f"{stats['agg_dup_members']}; root in-link {stats['bytes_up']} B "
          f"({stats['agg_pushes']} x {wide}) against {pushes} x {leaf} "
          f"flat; "
          + (f"apply-server pulls 0, replica 0 killed at version "
             f"{killed_at}, replica 1 served {served} and equals the "
             f"stream's replay; " if replicas else "")
          + f"aggregators {agg_stats} (agg0 rc {agg_rc}); walls "
          f"{json.dumps({k: round(v, 1) for k, v in walls.items()})}",
          flush=True)
    return out


def tier_phase(torch, kernels) -> tuple:
    """Phase 10 (see the module docstring)."""
    PLAIN_DECODES["calls"] = 0
    torch.backends.cudnn.allow_tf32 = False  # f32, as phases 3-9
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = {k: 0 for k in kernels.LAUNCHES}
    out, walls = {}, {}
    t = time.perf_counter()
    out["tree_root"] = tree_root_runs(torch, kernels, counts)
    walls["10a_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["stream"] = stream_run(torch, kernels, counts)
    walls["10b_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="ewdml_tier_")
    try:
        t = time.perf_counter()
        out["deployment"] = tier_deployment(root, "10c", replicas=True)
        walls["10c_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["aggkill"] = tier_deployment(root, "10d", replicas=False,
                                         agg_faults=AGGKILL)
        walls["10d_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    d, k = out["deployment"], out["aggkill"]
    if d["agg_weight"] != d["leaf_pushes"]:
        raise AssertionError(f"10c: weight {d['agg_weight']} for "
                             f"{d['leaf_pushes']} leaf pushes")
    if k["agg0_rc"] != -9:
        raise AssertionError(f"10d: aggregator 0 exited {k['agg0_rc']}, "
                             "not by its aggkill clause")
    out["walls"] = walls
    print("phase 10 walls: " + json.dumps(walls) + " on " + smi_line(),
          flush=True)
    for key in ("int_accumulate", "acc_decode", "random_bits"):
        if counts[key] <= 0:
            raise AssertionError(f"phase 10: {key} never launched")
    no_plain_decodes("phase 10")
    return counts, out


FED_LENET = [  # 11a: lenet_mnist/fed_c8_dir01_drop of the federated table
    "--federated", "--network", "LeNet", "--dataset", "mnist10k",
    "--method", "4", "--batch-size", "64", "--lr", "0.01", "--momentum", "0",
    "--quantum-num", "127", "--server-agg", "homomorphic",
    "--pool-size", "64", "--cohort", "8", "--local-steps", "5",
    "--partition", "dirichlet", "--partition-alpha", "0.1",
    "--fault-spec", "crash@3=1,crash@11=1,crash@42=1", "--fed-rounds",
    "10"]   # the cell runs 20 rounds; 10 since phase 17 (all three
            # crashing clients are sampled by round 10, not by round 5)
FED_VGG = [  # 11b; 11c and 11d change it
    "--federated", "--network", "VGG11", "--dataset", "mnist10k32",
    "--method", "4", "--batch-size", "64", "--lr", "0.01", "--momentum", "0",
    "--quantum-num", "127", "--server-agg", "homomorphic",
    "--pool-size", "16", "--cohort", "8", "--local-steps", "2",
    "--partition", "iid", "--fed-rounds", "3"]
SCALE_DRAWS = 3  # the scale template's normal and randint draws (phase 9)


def expected_fed_launches(cfg, kernels, client_rounds: int,
                          applies: int) -> dict:
    """Kernel launches of one federated run: the endpoint set-up's payload
    template is one compress of the tree, and homomorphic its scale
    template draws SCALE_DRAWS times; then one compress per client round
    (homomorphic: a shared-scale draw per leaf; decode: a quantize per leaf
    of at least MIN_ELEMS, a draw per smaller one); per apply, and once for
    the server's warm apply, under homomorphic an accumulate per leaf of at
    least MIN_ELEMS and one decode set of every leaf."""
    from ewdml_tpu_torch.models import build_model, num_classes_for
    from ewdml_tpu_torch.models.convert import leaf_specs

    specs = leaf_specs(build_model(cfg.network, num_classes_for(cfg.dataset),
                                   dataset=cfg.dataset))
    shapes = [s.jax_shape for s in specs]
    big = sum(1 for s in shapes if math.prod(s) >= kernels.MIN_ELEMS)
    want = {k: 0 for k in kernels.LAUNCHES}
    if cfg.server_agg == "homomorphic":
        want["random_bits"] = len(shapes) * (client_rounds + 1) + SCALE_DRAWS
        want["int_accumulate"] = big * (applies + 1)
        want["acc_decode"] = (kernels.decode_set_launches(len(shapes))
                              * (applies + 1))
    else:
        for k, v in compress_launches(cfg, shapes, kernels).items():
            want[k] = v * (client_rounds + 1)
    return want


def fed_counted(torch, kernels, counts, name: str, cfg, via_cli=None,
                **kw) -> tuple:
    """Drive one federated run as a run of the main path (the counts
    zeroed just before it and read just after): ``run_federated`` with a
    registry, or ``cli.main(via_cli)`` (its result captured from the
    ``run_federated`` it calls, its stdout echoed). Checks the launches
    against :func:`expected_fed_launches`, one decode a round
    (homomorphic), the ledger's dropouts and replacements against the
    result, and ``bytes_up`` against the admitted pushes' frames."""
    import contextlib
    import io

    import numpy as np

    import ewdml_tpu_torch.federated as fed
    from ewdml_tpu_torch import native
    from ewdml_tpu_torch.obs.registry import MetricsRegistry
    from ewdml_tpu_torch.train.metrics import federated_wire_plan

    reg = MetricsRegistry()
    real = fed.run_federated
    got = {}

    def captured(c, **k):
        got["res"] = real(c, registry=reg, **k)
        return got["res"]

    out = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    if via_cli is not None:
        from ewdml_tpu_torch import cli

        fed.run_federated = captured
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(via_cli)
        finally:
            fed.run_federated = real
        if rc != 0:
            raise AssertionError(f"{name}: cli.main exited {rc}")
    else:
        captured(cfg, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(kernels.LAUNCHES)  # read just after it
    for k, v in launched.items():
        counts[k] += v
    for line in out.getvalue().splitlines():
        print(f"federated {name} | {line}", flush=True)
    res = got["res"]
    s = res.stats
    records = fed.read_ledger(res.ledger_path)
    drops = [r for r in records if r["event"] == "dropout"]
    done = [r for r in records if r["event"] == "round_done"]
    accepted = sum(len(r["accepted"]) for r in done)
    client_rounds = s.pushes + s.fed_rejected
    if (len(done), s.apply_rounds) != (res.rounds, res.rounds):
        raise AssertionError(f"{name}: {len(done)} rounds journaled, "
                             f"{s.apply_rounds} applied of {res.rounds}")
    hom = cfg.server_agg == "homomorphic"
    if s.decode_count != (s.apply_rounds if hom else s.pushes):
        raise AssertionError(f"{name}: {s.decode_count} decodes in "
                             f"{s.apply_rounds} rounds")
    if (res.dropouts, res.resampled) != (
            len(drops), sum(1 for r in drops if r["replacement"] >= 0)):
        raise AssertionError(f"{name}: dropouts {res.dropouts} resampled "
                             f"{res.resampled}, ledger {drops}")
    plan = federated_wire_plan(cfg, res.params)
    frame = len(native.encode_arrays([np.zeros(plan.delta_bytes,
                                               np.uint8)]))
    if s.pushes != accepted or s.bytes_up != s.pushes * frame:
        raise AssertionError(f"{name}: bytes_up {s.bytes_up} for "
                             f"{s.pushes} pushes of {frame} B ({accepted} "
                             "accepted)")
    want = expected_fed_launches(cfg, kernels, client_rounds, s.apply_rounds)
    if launched != want:
        raise AssertionError(f"{name}: launches {launched}, reckoned {want}")
    if not all(math.isfinite(x) for x in res.round_losses):
        raise AssertionError(f"{name}: round losses {res.round_losses}")
    hist = reg.snapshot()["histograms"]
    row = dict(
        rounds=res.rounds, client_rounds=client_rounds, pushes=s.pushes,
        fed_rejected=s.fed_rejected, quota_dropped=res.coordinator[
            "quota_dropped"], dropouts=res.dropouts, resampled=res.resampled,
        decodes=s.decode_count, bytes_up=s.bytes_up,
        bytes_down=s.bytes_down, frame_bytes=frame, launches=launched,
        round_wall_p50_s=statistics.median(res.round_walls_s),
        client_s_p50=hist["federated.client_s"]["p50"],
        apply_ms_mean=s.apply_ms_mean, drive_wall_s=res.drive_wall_s,
        wall_s=wall, final_loss=res.final_loss, skew=res.skew)
    print(f"federated {name}: {json.dumps(row)}", flush=True)
    return res, row


def federated_phase(torch, kernels) -> tuple:
    """Phase 11 (see the module docstring)."""
    PLAIN_DECODES["calls"] = 0
    import contextlib
    import io

    from ewdml_tpu_torch import cli
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.federated import read_ledger
    from ewdml_tpu_torch.federated.loop import evaluate_params
    from ewdml_tpu_torch.models import build_model, num_classes_for
    from ewdml_tpu_torch.train.state import _stat_buffers

    torch.backends.cudnn.allow_tf32 = False  # f32, as phases 3-10
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = {k: 0 for k in kernels.LAUNCHES}
    out, walls = {}, {}
    root = tempfile.mkdtemp(prefix="ewdml_fed_")
    try:
        # 11a: the table's hardest LeNet cell through cli.main, and the
        # same config on the CPU for the ledger.
        t = time.perf_counter()
        argv = FED_LENET + ["--train-dir", os.path.join(root, "a") + "/"]
        res, row = fed_counted(torch, kernels, counts, "11a",
                               from_args(argv), via_cli=argv)
        cpu_argv = FED_LENET + ["--platform", "cpu", "--train-dir",
                                os.path.join(root, "a_cpu") + "/"]
        with contextlib.redirect_stdout(io.StringIO()):
            if cli.main(cpu_argv) != 0:
                raise AssertionError("11a: the CPU run failed")
        with open(res.ledger_path, "rb") as f, \
                open(os.path.join(root, "a_cpu", "fed_rounds.jsonl"),
                     "rb") as g:
            if f.read() != g.read():
                raise AssertionError("11a: the card's round ledger differs "
                                     "from the CPU run's")
        cfg = from_args(argv)
        ev = evaluate_params(cfg, res.params)
        row.update(eval_top1=ev["top1"], eval_loss=ev["loss"])
        if res.dropouts != 3 or row["decodes"] != 10:
            raise AssertionError(f"11a: {row}")
        out["11a"] = row
        walls["11a_s"] = time.perf_counter() - t
        print(f"federated 11a: ledger byte-equal to the CPU run; eval top1 "
              f"{ev['top1']:.4f} loss {ev['loss']:.4f}; round wall p50 "
              f"{row['round_wall_p50_s'] * 1e3:.1f} ms, client p50 "
              f"{row['client_s_p50'] * 1e3:.1f} ms, apply "
              f"{row['apply_ms_mean']:.3f} ms on {smi_line()}", flush=True)
        # 11b: VGG11-BN at full width, K = 8 over every big leaf.
        t = time.perf_counter()
        cfg = from_args(FED_VGG + ["--train-dir",
                                   os.path.join(root, "b") + "/"])
        res, row = fed_counted(torch, kernels, counts, "11b", cfg)
        model = build_model(cfg.network, num_classes_for(cfg.dataset),
                            dataset=cfg.dataset, seed=cfg.seed)
        stats0 = {path: b.detach() for path, b in _stat_buffers(model)}
        ev = evaluate_params(cfg, res.params, batch_stats=stats0)
        if not (math.isfinite(ev["loss"]) and ev["examples"] > 0):
            raise AssertionError(f"11b: eval {ev}")
        row.update(eval_top1=ev["top1"], eval_loss=ev["loss"])
        print(f"federated 11b: eval with the initial BatchNorm statistics "
              f"top1 {ev['top1']:.4f} loss {ev['loss']:.4f}", flush=True)
        out["11b"] = row
        walls["11b_s"] = time.perf_counter() - t
        # 11c: the decode arm, accept 3 of 4.
        t = time.perf_counter()
        cfg = from_args(FED_VGG + [
            "--server-agg", "decode", "--cohort", "4", "--num-aggregate",
            "3", "--fed-rounds", "2",
            "--train-dir", os.path.join(root, "c") + "/"])
        res, row = fed_counted(torch, kernels, counts, "11c", cfg)
        if not (row["quota_dropped"] == row["fed_rejected"] == 2):
            raise AssertionError(f"11c: {row}")
        out["11c"] = row
        walls["11c_s"] = time.perf_counter() - t
        # 11d: thread-batched, four clients at a time.
        t = time.perf_counter()
        cfg = from_args(FED_VGG + ["--fed-rounds", "2", "--train-dir",
                                   os.path.join(root, "d") + "/"])
        res, row = fed_counted(torch, kernels, counts, "11d", cfg,
                               thread_batch=4)
        begun = {r["round"]: set(r["cohort"])
                 for r in read_ledger(res.ledger_path)
                 if r["event"] == "round_begin"}
        for rec in res.round_records:
            if (len(rec["accepted"]) != cfg.cohort
                    or not set(rec["accepted"]) <= begun[rec["round"]]):
                raise AssertionError(f"11d: round {rec} of {begun}")
        out["11d"] = row
        walls["11d_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["walls"] = walls
    print("phase 11 walls: " + json.dumps(walls) + " on " + smi_line(),
          flush=True)
    for key in ("int_accumulate", "acc_decode", "random_bits",
                "qsgd_quantize"):
        if counts[key] <= 0:
            raise AssertionError(f"phase 11: {key} never launched")
    no_plain_decodes("phase 11")
    return counts, out


FED_ROUNDS_12A = 3    # 12a: FED_LENET over TCP (20 rounds, then 10,
                      # then 3 since phase 17)
PIPE_DELAY_S = 2.0    # 12c: the overlap straggler's sleep before its push


def fed_net_launches(cfg, kernels, client_rounds: int, applies: int,
                     tree: bool) -> dict:
    """Kernel launches of a federated run whose server and driver are both
    in this process (12b): :func:`expected_fed_launches` with a second
    endpoint set-up (one more template compress and its SCALE_DRAWS). A
    tree root sums the aggregators' int16 pseudo-pushes with a torch sum,
    so no ``int_accumulate`` there."""
    want = expected_fed_launches(cfg, kernels, client_rounds + 1, applies)
    want["random_bits"] += SCALE_DRAWS
    if tree:
        want["int_accumulate"] = 0
    return want


def record_accumulates(kernels, seen: set):
    """Wrap ``kernels.accumulate`` to record the (K, n) of every stack it
    sums on the card at or above MIN_ELEMS; returns the restore."""
    real = kernels.accumulate

    def recorded(levels, out=None):
        if levels.is_cuda and levels.shape[1] >= kernels.MIN_ELEMS:
            seen.add((int(levels.shape[0]), int(levels.shape[1])))
        return real(levels, out)

    kernels.accumulate = recorded
    return lambda: setattr(kernels, "accumulate", real)


def pipe_counted(torch, kernels, counts, name: str, cfg, **kw) -> tuple:
    """One federated run of the main path in this process (the counts
    zeroed just before it and read just after), with ``run_federated``'s
    keywords ``kw``; checks one decode a commit, ``bytes_up`` against the
    admitted pushes' frames, finite losses and the launches against
    :func:`expected_fed_launches` (a compress per client round, admitted,
    refused or round-stale). Returns the result, the row and the (K, n)
    the accumulate summed."""
    import numpy as np

    from ewdml_tpu_torch import native
    from ewdml_tpu_torch.federated import run_federated
    from ewdml_tpu_torch.obs.registry import MetricsRegistry
    from ewdml_tpu_torch.train.metrics import federated_wire_plan

    reg = MetricsRegistry()
    seen: set = set()
    restore = record_accumulates(kernels, seen)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        res = run_federated(cfg, registry=reg, **kw)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    launched = dict(kernels.LAUNCHES)  # read just after it
    for k, v in launched.items():
        counts[k] += v
    s = res.stats
    client_rounds = s.pushes + s.fed_rejected + s.dropped_round_stale
    plan = federated_wire_plan(cfg, res.params)
    frame = len(native.encode_arrays([np.zeros(plan.delta_bytes,
                                               np.uint8)]))
    if s.decode_count != s.apply_rounds or s.bytes_up != s.pushes * frame:
        raise AssertionError(f"{name}: {s.decode_count} decodes in "
                             f"{s.apply_rounds} applies, bytes_up "
                             f"{s.bytes_up} for {s.pushes} x {frame}")
    want = expected_fed_launches(cfg, kernels, client_rounds, s.apply_rounds)
    if launched != want:
        raise AssertionError(f"{name}: launches {launched}, reckoned {want}")
    if not all(math.isfinite(x) for x in res.round_losses):
        raise AssertionError(f"{name}: round losses {res.round_losses}")
    hist = reg.snapshot()["histograms"]
    row = dict(
        rounds=res.rounds, client_rounds=client_rounds, pushes=s.pushes,
        fed_rejected=s.fed_rejected, round_stale=s.dropped_round_stale,
        async_ticks=s.async_ticks, async_downweighted=s.async_downweighted,
        applies=s.apply_rounds, decodes=s.decode_count,
        accumulate_k=sorted({k for k, _ in seen}), launches=launched,
        round_wall_p50_s=statistics.median(res.round_walls_s),
        client_s_p50=hist["federated.client_s"]["p50"],
        apply_ms_mean=s.apply_ms_mean, drive_wall_s=res.drive_wall_s,
        wall_s=wall, final_loss=res.final_loss)
    print(f"pipeline {name}: {json.dumps(row)}", flush=True)
    return res, row, seen


def straggler_for(cfg) -> int:
    """A client of round 0's cohort that rounds 1 and 2 do not sample (so
    its delay holds round 0 alone), else round 0's first."""
    from ewdml_tpu_torch.federated import CohortSampler

    sampler = CohortSampler(cfg.pool_size, cfg.cohort, cfg.seed)
    pool = range(cfg.pool_size)
    later = set(sampler.sample(1, pool)) | set(sampler.sample(2, pool))
    first = sampler.sample(0, pool)
    return next((c for c in first if c not in later), first[0])


def fed_tcp_lenet(root: str) -> dict:
    """12a: FED_LENET for FED_ROUNDS_12A rounds across processes, a server
    on the event-loop plane and a ``--role fed_driver``, both on the card;
    the server's journal against the same config's in-process CPU run."""
    import contextlib
    import io

    from ewdml_tpu_torch import cli
    from ewdml_tpu_torch.parallel import ps_net

    port, = free_ports(1)
    flags = FED_LENET + ["--fed-rounds", str(FED_ROUNDS_12A), "--port",
                         str(port), "--net-timeout", "60"]
    walls, procs, logs = {}, [], {}
    t0 = time.perf_counter()
    try:
        logs["server"] = os.path.join(root, "a_server.log")
        server = ps_net_proc(["--role", "server", "--wire-plane", "evloop",
                              *flags, "--train-dir",
                              os.path.join(root, "a_srv") + "/"],
                             logs["server"])
        procs.append(server)
        wait_for_line(server, logs["server"], "PS_NET_READY", 120)
        walls["server_ready_s"] = time.perf_counter() - t0
        logs["driver"] = os.path.join(root, "a_driver.log")
        driver = ps_net_proc(["--role", "fed_driver", *flags, "--train-dir",
                              os.path.join(root, "a_drv") + "/"],
                             logs["driver"])
        procs.append(driver)
        # The CPU reference runs in this process meanwhile.
        cpu_argv = FED_LENET + ["--fed-rounds", str(FED_ROUNDS_12A),
                                "--platform", "cpu", "--train-dir",
                                os.path.join(root, "a_cpu") + "/"]
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            if cli.main(cpu_argv) != 0:
                raise AssertionError("12a: the CPU run failed")
        walls["cpu_run_s"] = time.perf_counter() - t
        if driver.wait(timeout=300) != 0:
            raise AssertionError(f"12a: fed_driver exited {driver.returncode}")
        done = json.loads(wait_for_line(driver, logs["driver"],
                                        "PS_NET_FED_DONE", 1).split(" ", 1)[1])
        walls["driver_done_s"] = time.perf_counter() - t0
        stats, _ = ps_net.client_call(("127.0.0.1", port), {"op": "stats"})
        ps_net.client_call(("127.0.0.1", port), {"op": "shutdown"})
        if server.wait(timeout=60) != 0:
            raise AssertionError(f"12a: server exited {server.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.log.close()
    with open(os.path.join(root, "a_srv", "fed_rounds.jsonl"), "rb") as f, \
            open(os.path.join(root, "a_cpu", "fed_rounds.jsonl"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("12a: the TCP server's round ledger differs "
                                 "from the in-process CPU run's")
    fed = stats["federated"]
    if (done["rounds"], fed["rounds_done"], stats["decode_count"]) != (
            FED_ROUNDS_12A,) * 3 or fed["dropouts"] != done["dropouts"]:
        raise AssertionError(f"12a: {done} {fed} decodes "
                             f"{stats['decode_count']}")
    out = dict(walls, done=done, decodes=stats["decode_count"],
               apply_ms_mean=stats["apply_ms_mean"],
               segments=segment_ms(stats))
    print(f"pipeline 12a: ledger byte-equal to the CPU run; {json.dumps(out)}"
          f" on {smi_line()}", flush=True)
    return out


def fed_tcp_vgg(torch, kernels, counts, root: str) -> dict:
    """12b: FED_VGG over TCP on the threads plane, its server and driver in
    this process (thread-batched, the whole cohort a wave), two aggregator
    processes and one replica process."""
    import threading

    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.federated import run_federated
    from ewdml_tpu_torch.obs.registry import MetricsRegistry
    from ewdml_tpu_torch.parallel import ps_net

    port, rport, *aports = free_ports(4)
    tree = ",".join(f"127.0.0.1:{p}" for p in aports)
    common = FED_VGG + ["--agg-tree", tree, "--net-timeout", "60",
                        "--net-retries", "8"]
    walls, procs, logs = {}, [], {}
    reg = MetricsRegistry()
    t0 = time.perf_counter()
    kernels.reset_launches()   # 12b's run of the main path starts here
    # The server keeps its own registry: the driver's per-op client
    # latencies go to reg under the same names.
    server = ps_net.PSNetServer(from_args(common + [
        "--train-dir", os.path.join(root, "b_srv") + "/"]), port=port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        up = [*common, "--port", str(port)]
        for label, args in [("replica", ["--role", "replica", *up,
                                         "--replica-port", str(rport)])] + [
                (f"agg{i}", ["--role", "aggregator", *up, "--agg-port",
                             str(p), "--agg-index", str(i)])
                for i, p in enumerate(aports)]:
            logs[label] = os.path.join(root, f"b_{label}.log")
            procs.append(ps_net_proc(args + ["--platform", "cpu"],
                                     logs[label]))
        for proc, label, marker in zip(procs, ("replica", "agg0", "agg1"), (
                "PS_REPLICA_READY", "PS_AGG_READY", "PS_AGG_READY")):
            wait_for_line(proc, logs[label], marker, 120)
        walls["tier_ready_s"] = time.perf_counter() - t0
        cfg = from_args(common + ["--replicas", f"127.0.0.1:{rport}",
                                  "--train-dir",
                                  os.path.join(root, "b_drv") + "/"])
        t = time.perf_counter()
        res = run_federated(cfg, addr=("127.0.0.1", port),
                            thread_batch=cfg.cohort, registry=reg)
        torch.cuda.synchronize()
        walls["drive_s"] = time.perf_counter() - t
        stats, _ = ps_net.client_call(("127.0.0.1", port), {"op": "stats"})
        for p in [rport] + aports:
            ps_net.client_call(("127.0.0.1", p), {"op": "shutdown"})
        ps_net.client_call(("127.0.0.1", port), {"op": "shutdown"})
        thread.join(60)
        for label, proc in zip(("replica", "agg0", "agg1"), procs):
            if proc.wait(timeout=60) != 0:
                raise AssertionError(f"12b: {label} exited "
                                     f"{proc.returncode}")
    finally:
        server.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.log.close()
    launched = dict(kernels.LAUNCHES)  # read just after it
    for k, v in launched.items():
        counts[k] += v
    homes = [len({c % len(aports) for c in rec["accepted"]})
             for rec in res.round_records]
    segs = stats["segments"]
    # Every sampled client pushes once (no dropout, accept = cohort); the
    # root's "pushes" are the aggregators' pseudo-pushes.
    client_rounds = cfg.cohort * res.rounds
    want = fed_net_launches(cfg, kernels, client_rounds,
                            stats["apply_rounds"], tree=True)
    if stats["agg_pushes"] != sum(homes) or "pull" in segs or \
            res.rejected or stats["agg_weight"] != client_rounds or \
            not (stats["decode_count"] == stats["apply_rounds"]
                 == cfg.fed_rounds):
        raise AssertionError(f"12b: {stats['agg_pushes']} pseudo-pushes of "
                             f"weight {stats['agg_weight']} for homes "
                             f"{homes}; segments {sorted(segs)}; "
                             f"{stats['decode_count']} decodes, "
                             f"{res.rejected} refused")
    if launched != want:
        raise AssertionError(f"12b: launches {launched}, reckoned {want}")
    hist = reg.snapshot()["histograms"]
    op_ms = {}
    for op in ("pull", "push", "fed_begin", "fed_end", "resync",
               "agg_register", "fed_register"):
        h = hist.get(f"ps_net.{op}.latency_s")
        if h and h.get("count"):
            op_ms[op] = dict(count=h["count"], p50_ms=h["p50"] * 1e3,
                             p99_ms=h["p99"] * 1e3)
    out = dict(walls, rounds=res.rounds, agg_pushes=stats["agg_pushes"],
               agg_weight=stats["agg_weight"], homes=homes,
               client_rounds=client_rounds, decodes=stats["decode_count"],
               apply_ms_mean=stats["apply_ms_mean"], launches=launched,
               round_walls_s=res.round_walls_s,
               client_s_p50=hist["federated.client_s"]["p50"],
               driver_op_ms=op_ms, server_segments={
                   op: segs[op] for op in ("agg_push", "fed_begin",
                                           "fed_end", "subscribe")
                   if op in segs},
               final_loss=res.final_loss)
    print(f"pipeline 12b: {stats['agg_pushes']} pseudo-pushes for "
          f"{res.rounds} rounds (homes {homes}), no pull at the apply "
          f"server; {json.dumps(out)} on {smi_line()}", flush=True)
    return out


def pipeline_phase(torch, kernels) -> tuple:
    """Phase 12 (see the module docstring)."""
    PLAIN_DECODES["calls"] = 0
    import contextlib
    import io

    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.experiments import registry, runner
    from ewdml_tpu_torch.federated import read_ledger

    torch.backends.cudnn.allow_tf32 = False  # f32, as phases 3-11
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = {k: 0 for k in kernels.LAUNCHES}
    out, walls = {}, {}
    root = tempfile.mkdtemp(prefix="ewdml_pipe_")
    try:
        t = time.perf_counter()
        out["12a"] = fed_tcp_lenet(root)
        walls["12a_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["12b"] = fed_tcp_vgg(torch, kernels, counts, root)
        walls["12b_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        # 12c: overlap, accept 7 of 8, a straggler in round 0.
        t = time.perf_counter()
        cfg = from_args(FED_VGG + ["--round-pipeline", "overlap",
                                   "--num-aggregate", "7",
                                   "--train-dir",
                                   os.path.join(root, "c") + "/"])
        cfg.fault_spec = f"delay@{straggler_for(cfg)}={PIPE_DELAY_S}"
        res, row, _ = pipe_counted(torch, kernels, counts, "12c", cfg)
        ev = [(r["event"], r["round"]) for r in read_ledger(res.ledger_path)
              if r["event"] in ("round_pipeline_begin", "round_commit")]
        if (row["decodes"], row["applies"]) != (3, 3) or \
                row["round_stale"] < 1 or \
                ("round_pipeline_begin", 1) not in ev[
                    :ev.index(("round_commit", 0))]:
            raise AssertionError(f"12c: {row} {ev}")
        row["events"] = ev
        out["12c"] = row
        walls["12c_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        # 12d: async, accept 8 (a 32-tick quota), a deferred straggler;
        # twice, for the journal.
        t = time.perf_counter()
        ledgers, seen = [], set()
        for i in range(2):
            cfg = from_args(FED_VGG + ["--round-pipeline", "async",
                                       "--num-aggregate", "8",
                                       "--train-dir",
                                       os.path.join(root, f"d{i}") + "/"])
            cfg.fault_spec = f"delay@{straggler_for(cfg)}=1"
            res, row, ks = pipe_counted(torch, kernels, counts, f"12d{i}",
                                        cfg)
            seen |= ks
            with open(res.ledger_path, "rb") as f:
                ledgers.append(f.read())
            if row["async_downweighted"] < 1 or row["round_stale"] != 0:
                raise AssertionError(f"12d: {row}")
        if ledgers[0] != ledgers[1]:
            raise AssertionError("12d: two async runs journaled different "
                                 "ledgers")
        # The accumulate at every (K, n) the runs summed, against its plain
        # version (launches made for the comparison, not counted).
        g = torch.Generator(device="cuda")
        g.manual_seed(12)
        for k, n in sorted(seen):
            same_accumulate(torch, kernels, levels_on_card(torch, k, n, g),
                            f"12d K={k} n={n}")
        ks = sorted({k for k, _ in seen})
        if 32 not in ks:
            raise AssertionError(f"12d: the accumulate summed K {ks}")
        row["accumulate_checked"] = sorted(seen)
        out["12d"] = row
        walls["12d_s"] = time.perf_counter() - t
        print(f"pipeline 12d: ledgers of two runs byte-equal; int_accumulate "
              f"bit-equal to its plain version at (K, n) {sorted(seen)}",
              flush=True)
        torch.cuda.empty_cache()
        # 12e: one federated table cell through the experiments runner.
        t = time.perf_counter()
        cell = "lenet_mnist/fed_c8_dir01_drop"
        kernels.reset_launches()   # 12e's run of the main path
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = runner.run_cell_child(
                "federated", cell, out_dir=os.path.join(root, "e"),
                data_dir="data/", smoke=True, platform="cuda")
        torch.cuda.synchronize()
        launched = dict(kernels.LAUNCHES)
        for k, v in launched.items():
            counts[k] += v
        line = next(x for x in buf.getvalue().splitlines()
                    if x.startswith(runner.RESULT_MARK))
        erow = json.loads(line[len(runner.RESULT_MARK):])
        if rc != 0 or not (erow["decode_count"] == erow["apply_rounds"]
                           == 3) or launched["acc_decode"] <= 0:
            raise AssertionError(f"12e: rc {rc} row {erow}")
        spec = {c.cell_id: c for c in registry.table_cells("federated")}[cell]
        out["12e"] = {k: erow[k] for k in (
            "rounds", "decode_count", "apply_rounds", "dropouts",
            "resampled", "final_loss", "top1", "round_wall_ms_mean",
            "wall_s")}
        out["12e"]["spec_hash"] = spec.spec_hash(smoke=True)
        walls["12e_s"] = time.perf_counter() - t
        print(f"pipeline 12e: {json.dumps(out['12e'])}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["walls"] = walls
    print("phase 12 walls: " + json.dumps(walls) + " on " + smi_line(),
          flush=True)
    for key in ("int_accumulate", "acc_decode", "random_bits"):
        if counts[key] <= 0:
            raise AssertionError(f"phase 12: {key} never launched")
    no_plain_decodes("phase 12")
    return counts, out


# -- phase 13: adaptive compression (adapt/) ------------------------------------

ADAPT_EVERY = 5
# 13a's runs: (name, flags, steps, replayed). Under M5 at 1% the budget
# (the static payload, 0.21 MB a sync) buys Top-k and dense leaves only;
# the M4 run starts from 8-bit QSGD, blockwise, so the path also reaches
# qsgd_quantize and dequant_mean. The 4-bit rung never wins a leaf of
# MIN_ELEMS or more: its noise (sqrt(n)/7, sqrt(4096)/7 blockwise) is
# above the sparse rungs'.
ADAPT_SYNC_RUNS = [
    ("M5", ["--method", "5", "--topk-ratio", "0.01"], 20, True),  # 30
    # steps until phase 17
    ("M4 block 4096", ["--method", "4", "--qsgd-block", "4096"], 15, False),
]
ADAPT_ASYNC = (4, 6, 3)  # 13b: K = 4 workers, steps per worker, decide every
ADAPT_TCP_STEPS = 8      # 13c: per worker process
ADAPT_KILL_AT = 5        # 13c: serverkill@5, after the switch at version 3
ADAPT_TRIO = ("qsgd_quantize", "dequant_mean", "block_top1")


def adapt_argv(steps: int, every: int, flags, *extra) -> list:
    """13a: VGG11-BN at full width, W = 4, batch 128, a method preset
    (``flags``), ``--adapt``."""
    return ["--network", "VGG11", "--dataset", "Cifar10", "--synthetic-data",
            "--num-workers", str(WORLD), "--batch-size", "128",
            "--max-steps", str(steps), "--epochs", "100", "--log-every",
            "1000", "--no-bf16", "--eval-freq", "0", "--adapt-every",
            str(every), *flags, *extra]


def plan_step_launches(plan, sizes, kernels) -> dict:
    """qsgd_quantize, dequant_mean and block_top1 launches of one sync step
    under ``plan`` (W workers and the relay of M4/M5): per unit, each
    worker's compress and the relay's (a Top-k leaf's relay quantizes the
    winners of its candidate or block support: the same count) quantize on
    the kernel from MIN_ELEMS elements up, a block_top1 per worker for a
    leaf in the block mode, and one dequant_mean for an unpacked QSGD leaf
    whose W x n levels reach MIN_ELEMS."""
    from ewdml_tpu_torch.ops import blocktopk, packing, topk

    want = {k: 0 for k in ADAPT_TRIO}
    for d, n in zip(plan.decisions, sizes):
        if d.method == "dense":
            continue
        m = n
        if d.method == "topk_qsgd":
            if topk.resolve_mode(None, n, d.ratio) == "block":
                want["block_top1"] += WORLD
                m = blocktopk.geometry(n, d.ratio)[0]
            else:
                m = topk.static_k(n, d.ratio)
        elif packing.width_for(d.s) >= 8 and WORLD * n >= kernels.MIN_ELEMS:
            want["dequant_mean"] += 1
        if m >= kernels.MIN_ELEMS:
            want["qsgd_quantize"] += WORLD + 1
    return want


def plan_apply_launches(plan, sizes, kernels) -> dict:
    """int_accumulate and acc_decode launches of one homomorphic apply
    under ``plan``: per QSGD leaf of at least MIN_ELEMS one accumulate
    (Top-k's sum is a scatter-add), and one decode set of every QSGD and
    Top-k leaf whatever its size (none where the plan is all dense)."""
    quantized = [n for d, n in zip(plan.decisions, sizes)
                 if d.method != "dense"]
    return {"int_accumulate": sum(
                1 for d, n in zip(plan.decisions, sizes)
                if d.method == "qsgd" and n >= kernels.MIN_ELEMS),
            "acc_decode": kernels.decode_set_launches(len(quantized))}


def adapt_kernel_points(torch, kernels, g) -> dict:
    """13's operating points against the plain versions on the card:
    qsgd_quantize at s = 7 (the 4-bit rung) at every VGG11-BN leaf of at
    least MIN_ELEMS elements, and blockwise 4096 at the largest;
    block_top1 at the 1% and 5% views of every VGG11-BN leaf above 2^18
    elements and of LeNet's fc1. Each bit-equal, timed beside its bound and
    alone on the card."""
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs
    from ewdml_tpu_torch.ops import blocktopk, topk

    timer = Timer(torch)
    rows = {"qsgd_quantize_s7": [], "block_top1": []}
    vgg = sorted({math.prod(s.jax_shape) for s in
                  leaf_specs(build_model("VGG11", 10, dataset="Cifar10"))},
                 reverse=True)
    lenet = [math.prod(s.jax_shape) for s in
             leaf_specs(build_model("LeNet", 10, dataset="mnist"))]
    for n in [n for n in vgg if n >= kernels.MIN_ELEMS]:
        x = torch.randn(n, device="cuda", generator=g) * 1e-2
        for block in [None] + ([4096] if n == vgg[0] else []):
            if block is None:
                norms = torch.linalg.vector_norm(x)
            else:
                pad = torch.zeros(-(-n // block) * block, device="cuda")
                pad[:n] = x
                norms = torch.linalg.vector_norm(pad.reshape(-1, block),
                                                 dim=1)
            seed = table_seed(torch, n % 977)
            a = kernels.qsgd_quantize(x, norms, seed, 7, block=block)
            b = kernels.qsgd_quantize_ref(x, norms, seed, 7, block=block)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"qsgd_quantize s=7 n={n} block={block}:"
                                     f" {int((a != b).sum())} levels differ "
                                     "from the plain version")
            rows["qsgd_quantize_s7"].append(shape_row(
                timer, lambda: kernels.qsgd_quantize(x, norms, seed, 7,
                                                     block=block),
                KERNEL_NAMES["qsgd_quantize"], 5 * n + 4 * norms.numel(),
                OPS_PER_ELEM["qsgd_quantize"] * n, n=n, block=block, s=7))
    for net, sizes in (("VGG11", vgg), ("LeNet", sorted(set(lenet)))):
        for n in sizes:
            for ratio in (0.01, 0.05):
                if topk.resolve_mode(None, n, ratio) != "block":
                    continue
                nb, _, blk_pad = blocktopk.geometry(n, ratio)
                x2 = torch.randn(blk_pad, nb, device="cuda", generator=g)
                same_top1(torch, kernels, x2, f"{net} n={n} at {ratio}")
                rows["block_top1"].append(shape_row(
                    timer, lambda: kernels.block_top1(x2),
                    KERNEL_NAMES["block_top1"], 4 * blk_pad * nb + 8 * nb,
                    OPS_PER_ELEM["block_top1"] * blk_pad * nb, network=net,
                    n=n, ratio=ratio, shape=[blk_pad, nb]))
    del timer
    for name, rs in rows.items():
        for r in rs:
            print(f"adapt point {name}: " + json.dumps(r), flush=True)
    return rows


def adapt_contract_points(torch, kernels, rt, sizes, g) -> int:
    """int_accumulate (K = 4) and acc_decode bit-equal to their plain
    versions at every leaf of at least MIN_ELEMS elements of every plan's
    scale contract the async run built (its shapes, its scales)."""
    checked = 0
    for comp in rt._compressors.values():
        for i, n in enumerate(sizes):
            sub = comp.for_leaf(i)
            scales = getattr(sub, "scales", None)
            if scales is None or n < kernels.MIN_ELEMS:
                continue
            lv = levels_on_card(torch, WORLD, n, g)
            same_accumulate(torch, kernels, lv, f"plan leaf {i} n={n}")
            acc = kernels.int_accumulate_ref(lv)
            same_decode(torch, kernels, acc, scales.to("cuda").reshape(-1),
                        f"plan leaf {i} n={n} block={sub.block}")
            checked += 1
    return checked


def adapt_sync(torch, kernels, counts, root: str) -> dict:
    """13a: each run of ``ADAPT_SYNC_RUNS``."""
    out = {}
    for name, flags, steps, replayed in ADAPT_SYNC_RUNS:
        out[name] = adapt_sync_run(torch, kernels, counts, root, name, flags,
                                   steps, replayed)
    return out


def adapt_sync_run(torch, kernels, counts, root: str, name: str, flags,
                   steps: int, replayed: bool) -> dict:
    """One 13a run: the sync trainer records (and replays) its ledger."""
    from ewdml_tpu_torch.adapt.ledger import read_decisions
    from ewdml_tpu_torch.adapt.plan import plan_wire_bytes
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.models.convert import to_jax
    from ewdml_tpu_torch.train import loop
    from ewdml_tpu_torch.train.state import leaf_params
    from ewdml_tpu_torch.utils import prng

    ledger = os.path.join(root, name.replace(" ", "_") + "_ledger.jsonl")
    calls = []
    build_step = loop.make_train_step

    def counted(trainer_ref):
        def make(*a, **k):
            fn = build_step(*a, **k)
            plan = k["compressor"].plan

            def step(state, *rest):
                before = dict(kernels.LAUNCHES)
                out = fn(state, *rest)
                calls.append((state is trainer_ref[0].state, plan,
                              {n: kernels.LAUNCHES[n] - before[n]
                               for n in before}))
                return out
            return step
        return make

    runs, out = {}, {}
    deterministic(torch, True)
    try:
        for mode in ("variance", "replay")[:1 + int(replayed)]:
            ref = [None]
            # Every step the trainer builds (one per plan) is counted.
            loop.make_train_step = counted(ref)
            trainer = loop.Trainer(from_args(adapt_argv(
                steps, ADAPT_EVERY, flags, "--adapt", mode,
                "--adapt-ledger", ledger)))
            ref[0] = trainer
            rt = trainer._adapt
            sizes = rt.sizes
            del calls[:]
            windows = []
            kernels.reset_launches()   # this run of the main path
            t0 = time.perf_counter()
            for k in range(1, steps // ADAPT_EVERY + 1):
                plan = rt.plan
                res = trainer.train(max_steps=k * ADAPT_EVERY)
                if not math.isfinite(res.final_loss):
                    raise AssertionError(f"13a {mode}: non-finite loss")
                windows.append(dict(version=plan.version,
                                    mean_step_ms=res.mean_step_s * 1e3))
                if rt.plan is not plan:
                    # A switch: the wire plan and the shipped payloads are
                    # the new plan's.
                    comp = trainer._step_compressor
                    want = plan_wire_bytes(rt.plan, sizes,
                                           block=trainer.cfg.qsgd_block)
                    ws = trainer.state.workers[0]
                    with torch.no_grad():
                        shipped = sum(
                            comp.for_leaf(i).compress(
                                prng.key(i), to_jax(p.grad, s.kind)).wire_bytes
                            for i, (p, s) in enumerate(zip(
                                leaf_params(ws.model, trainer.specs),
                                trainer.specs)))
                    if not (trainer.wire.up_bytes == want == shipped
                            and trainer.wire.per_step_bytes == 2 * want):
                        raise AssertionError(
                            f"13a {mode}: plan v{rt.plan.version} prices "
                            f"{want} B, the wire plan {trainer.wire.up_bytes}"
                            f" B up, the payloads {shipped} B")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = dict(kernels.LAUNCHES)
            for k, v in launched.items():
                counts[k] += v
            stepped = [c for c in calls if c[0]]
            for _, plan, got in calls:
                want = plan_step_launches(plan, sizes, kernels)
                if {k: got[k] for k in ADAPT_TRIO} != want:
                    raise AssertionError(f"13a {mode}: plan v{plan.version} "
                                         f"step launched {got}, its "
                                         f"reckoning {want}")
            if len(stepped) != steps:
                raise AssertionError(f"13a {mode}: {len(stepped)} steps")
            per_plan = {}
            for w in windows:  # each window's first step counts as compile
                per_plan.setdefault(w["version"], []).append(w["mean_step_ms"])
            runs[mode] = dict(
                trainer=trainer, applied=[(s, p.key()) for s, p in rt.applied],
                wall_s=wall, probes=len(calls) - len(stepped),
                launches=launched,
                per_plan_step_ms={v: statistics.mean(ms)
                                  for v, ms in per_plan.items()},
                per_plan_launches={p.version: plan_step_launches(
                    p, sizes, kernels) for _, p in rt.applied})
            print(f"adapt 13a {name} {mode}: {len(rt.applied)} plans "
                  f"{[(s, p.version, p.method_counts()) for s, p in rt.applied]}"
                  f" mean step per plan {runs[mode]['per_plan_step_ms']} ms, "
                  f"probe steps {runs[mode]['probes']}, wall {wall:.1f}s, "
                  f"launches {launched} on {smi_line()}", flush=True)
    finally:
        loop.make_train_step = build_step
        deterministic(torch, False)
    rec = runs["variance"]
    rows = read_decisions(ledger)
    budget = rec["trainer"]._adapt.budget_bytes
    if len(rec["applied"]) < 2:
        raise AssertionError("13a: no decision switched the plan")
    if any(r["bytes_per_sync"] > budget for r in rows):
        raise AssertionError(f"13a: a journaled plan exceeds the budget "
                             f"{budget} B")
    if replayed:
        rep = runs["replay"]
        if rep["applied"] != rec["applied"]:
            raise AssertionError("13a: the replay applied another sequence")
        for a, b in zip(rec["trainer"].state.workers,
                        rep["trainer"].state.workers):
            for p, q in zip(a.model.state_dict().values(),
                            b.model.state_dict().values()):
                if not torch.equal(p, q):
                    raise AssertionError("13a: the replay's state is not "
                                         "bit-equal to the recording's")
        out["replay_bit_equal"] = True
    for mode, r in runs.items():
        out[mode] = {k: r[k] for k in ("wall_s", "probes", "launches",
                                       "per_plan_step_ms",
                                       "per_plan_launches")}
    out["plans"] = [dict(step=r["step"], version=r["plan_version"],
                         switched=r["switched"],
                         bytes_per_sync=r["bytes_per_sync"],
                         comm_frac=(r["signals"] or {}).get("comm_frac"))
                    for r in rows]
    out["budget_bytes"] = budget
    del runs
    torch.cuda.empty_cache()
    return out


def adapt_async_argv(root: str) -> list:
    """13b: VGG11-BN at CIFAR-10 shapes, K = 4 of 4 workers, QSGD under
    homomorphic aggregation, ``--adapt variance --adapt-every 3``."""
    k_n, steps, every = ADAPT_ASYNC
    return ["--mode", "async", "--network", "VGG11", "--dataset", "Cifar10",
            "--synthetic-data", "--batch-size", "128", "--num-workers",
            str(k_n), "--num-aggregate", str(k_n), "--max-steps",
            str(k_n * steps), "--compress-grad", "qsgd", "--server-agg",
            "homomorphic", "--fusion", "none", "--adapt", "variance",
            "--adapt-every", str(every), "--train-dir", root + "/"]


def adapt_async(torch, kernels, counts, g) -> dict:
    """13b: the in-process server under homomorphic aggregation."""
    from ewdml_tpu_torch import cli
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.parallel import ps

    k_n = ADAPT_ASYNC[0]
    root = tempfile.mkdtemp(prefix="ewdml_adapt_ps_")
    cfg = from_args(adapt_async_argv(root))
    applies, warms = [], []
    run_apply, register = (ps.ParameterServer._run_apply,
                           ps.ParameterServer.register_payload_schema)

    def counted_apply(self, batch, wsum=None):
        before = dict(kernels.LAUNCHES)
        res = run_apply(self, batch, wsum)
        applies.append((self.compressor.plan, res[4],
                        {n: kernels.LAUNCHES[n] - before[n]
                         for n in ("int_accumulate", "acc_decode")}))
        return res

    def counted_register(self, template, **kw):
        before = dict(kernels.LAUNCHES)
        register(self, template, **kw)
        warms.append((self.compressor.plan,
                      {n: kernels.LAUNCHES[n] - before[n]
                       for n in ("int_accumulate", "acc_decode")}))

    ps.ParameterServer._run_apply = counted_apply
    ps.ParameterServer.register_payload_schema = counted_register
    try:
        run = cli.build_async(cfg)
        kernels.reset_launches()   # 13b's run of the main path
        t0 = time.perf_counter()
        _, stats = run.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dict(kernels.LAUNCHES)
    finally:
        ps.ParameterServer._run_apply = run_apply
        ps.ParameterServer.register_payload_schema = register
    for k, v in launched.items():
        counts[k] += v
    server, rt = run.server, run.server.adapt
    sizes = rt.sizes
    if len(rt.applied) < 2:
        raise AssertionError("13b: no decision switched the plan")
    pending = len(server._pending)
    if stats.pushes != (stats.updates * k_n + stats.dropped_plan_stale
                        + stats.dropped_stale + pending):
        raise AssertionError(f"13b: pushes {stats.pushes} != updates "
                             f"{stats.updates} x {k_n} + plan-stale "
                             f"{stats.dropped_plan_stale} + stale "
                             f"{stats.dropped_stale} + pending {pending}")
    for plan, _, got in applies + [(p, 0, d) for p, d in warms]:
        want = plan_apply_launches(plan, sizes, kernels)
        if got != want:
            raise AssertionError(f"13b: an apply under plan v{plan.version} "
                                 f"launched {got}, its reckoning {want}")
    per_plan = {}
    for plan, apply_s, _ in applies:
        per_plan.setdefault(plan.version, []).append(apply_s * 1e3)
    checked = adapt_contract_points(torch, kernels, rt, sizes, g)
    out = dict(pushes=stats.pushes, updates=stats.updates,
               dropped_plan_stale=stats.dropped_plan_stale,
               dropped_stale=stats.dropped_stale, pending=pending,
               plans=[(s, p.version, p.method_counts())
                      for s, p in rt.applied],
               apply_ms_mean_per_plan={v: statistics.mean(ms)
                                       for v, ms in per_plan.items()},
               per_plan_launches={p.version: plan_apply_launches(
                   p, sizes, kernels) for _, p in rt.applied},
               contract_leaves_checked=checked, wall_s=wall,
               launches=launched)
    print(f"adapt 13b: {json.dumps(out)} on {smi_line()}", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    del run, server
    torch.cuda.empty_cache()
    return out


def adapt_tcp(root: str) -> dict:
    """13c: a server process (threads plane, a state directory, serverkill
    after the first switch) and two worker processes under ``--adapt
    variance``; the server is restarted and recovers the plan in force."""
    import socket

    from ewdml_tpu_torch.adapt.ledger import ReplaySchedule, read_decisions
    from ewdml_tpu_torch.parallel import ps_net
    from ewdml_tpu_torch.parallel.server_state import ServerStateStore

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    state = os.path.join(root, "adapt_state")
    ledger = os.path.join(root, "adapt_tcp_ledger.jsonl")
    common = tcp_argv(2, ["--compress-grad", "qsgd"], "--port", str(port),
                      "--net-retries", "14", "--net-backoff", "0.5",
                      "--adapt", "variance", "--adapt-every", "3",
                      "--adapt-ledger", ledger)
    server_args = ["--role", "server", *common, "--server-state-dir", state,
                   "--snapshot-every", "0", "--wire-plane", "threads",
                   "--fault-spec", f"serverkill@{ADAPT_KILL_AT}"]
    procs, walls = [], {}
    t0 = time.perf_counter()
    try:
        first = ps_net_proc(server_args, os.path.join(root, "as1.log"))
        procs.append(first)
        wait_for_line(first, os.path.join(root, "as1.log"), "PS_NET_READY",
                      180)
        logs = [os.path.join(root, f"aw{i}.log") for i in (0, 1)]
        workers = [ps_net_proc(["--role", "worker", *common, "--worker-index",
                                str(i), "--steps", str(ADAPT_TCP_STEPS)],
                               logs[i]) for i in (0, 1)]
        procs += workers
        if first.wait(timeout=300) != -9:
            raise AssertionError("13c: the first server did not die by "
                                 "SIGKILL")
        walls["killed_at_s"] = time.perf_counter() - t0
        wal = ServerStateStore(state).read_wal()
        second = ps_net_proc(server_args[:-2],
                             os.path.join(root, "as2.log"))
        procs.append(second)
        wait_for_line(second, os.path.join(root, "as2.log"), "PS_NET_READY",
                      180)
        stats0, _ = ps_net.client_call(("127.0.0.1", port), {"op": "stats"})
        for i, w in enumerate(workers):
            if w.wait(timeout=300) != 0:
                raise AssertionError(f"13c: worker {i} failed")
            wait_for_line(w, logs[i], "PS_NET_WORKER_DONE", 1)
        stats, _ = ps_net.client_call(("127.0.0.1", port), {"op": "stats"})
        ps_net.client_call(("127.0.0.1", port), {"op": "shutdown"})
        if second.wait(timeout=60) != 0:
            raise AssertionError("13c: the restarted server did not exit 0")
        wal += [r for r in ServerStateStore(state).read_wal()
                if "plan_version" in r]
        walls["done_s"] = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.log.close()
    rows = read_decisions(ledger)
    in_force = ReplaySchedule(rows).plan_at_or_before(stats0["version"])
    if stats0["plan_version"] != in_force.version or stats0["version"] < \
            ADAPT_KILL_AT:
        raise AssertionError(f"13c: recovered plan v{stats0['plan_version']}"
                             f" at version {stats0['version']}, the ledger's"
                             f" plan in force v{in_force.version}")
    if not any(r["switched"] for r in rows if r["step"] <= ADAPT_KILL_AT):
        raise AssertionError("13c: no switch before the kill")
    by_version = {}
    for r in wal:
        if "workers" in r:
            by_version.setdefault(int(r["plan_version"]), []).append(
                set(r["workers"]))
    for v, batches in by_version.items():
        if len(batches) >= 2 and set().union(*batches) != {0, 1}:
            raise AssertionError(f"13c: plan v{v}'s pushes came from "
                                 f"{set().union(*batches)} only")
    out = dict(walls, recovered_version=stats0["version"],
               recovered_plan_version=stats0["plan_version"],
               plan_versions_pushed={v: len(b) for v, b in
                                     sorted(by_version.items())},
               final_version=stats["version"],
               dropped_plan_stale=stats["dropped_plan_stale"],
               decisions=len(rows))
    print(f"adapt 13c: {json.dumps(out)}", flush=True)
    return out


def adapt_runner(torch, kernels, counts, root: str) -> dict:
    """13d: the table's ``lenet_mnist/adaptive`` cell through the runner's
    cell entry at smoke scale."""
    import contextlib
    import io

    from ewdml_tpu_torch.experiments import registry, runner

    cell = "lenet_mnist/adaptive"
    kernels.reset_launches()   # 13d's run of the main path
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = runner.run_cell_child("baseline_adaptive", cell,
                                   out_dir=os.path.join(root, "d"),
                                   data_dir="data/", smoke=True,
                                   platform=DEVICE)
    torch.cuda.synchronize()
    for k, v in kernels.LAUNCHES.items():
        counts[k] += v
    line = next(x for x in buf.getvalue().splitlines()
                if x.startswith(runner.RESULT_MARK))
    row = json.loads(line[len(runner.RESULT_MARK):])
    ad = row.get("adapt") or {}
    if rc != 0 or ad.get("mode") != "variance" or ad.get("decisions", 0) < 2:
        raise AssertionError(f"13d: rc {rc} adapt {ad}")
    spec = {c.cell_id: c for c in
            registry.table_cells("baseline_adaptive")}[cell]
    out = dict(decisions=ad["decisions"], switches=ad["switches"],
               steps=row["steps"], final_loss=row["final_loss"],
               wire_mb_per_step_worker=row["wire_mb_per_step_worker"],
               spec_hash=spec.spec_hash(smoke=True))
    print(f"adapt 13d: {json.dumps(out)}", flush=True)
    return out


def adapt_phase(torch, kernels) -> tuple:
    """Phase 13 (see the module docstring)."""
    PLAIN_DECODES["calls"] = 0
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = {k: 0 for k in kernels.LAUNCHES}
    out, walls = {}, {}
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    root = tempfile.mkdtemp(prefix="ewdml_adapt_")
    try:
        for name, fn in (
                ("points", lambda: adapt_kernel_points(torch, kernels, g)),
                ("13a", lambda: adapt_sync(torch, kernels, counts, root)),
                ("13b", lambda: adapt_async(torch, kernels, counts, g)),
                ("13c", lambda: adapt_tcp(root)),
                ("13d", lambda: adapt_runner(torch, kernels, counts, root))):
            t = time.perf_counter()
            out[name] = fn()
            walls[f"{name}_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["walls"] = walls
    print("phase 13 walls: " + json.dumps(walls) + " on " + smi_line(),
          flush=True)
    for key in ("qsgd_quantize", "dequant_mean", "block_top1",
                "int_accumulate", "acc_decode"):
        if counts[key] <= 0:
            raise AssertionError(f"phase 13 launched no {key}")
    no_plain_decodes("phase 13")
    return counts, out


# -- phase 14: the horovod-style substrate and the live plane ----------------

HVD_STEPS = 2            # 14a: fit steps a run (one epoch of 2 global batches)
HVD_BATCH = 128          # 14a: a worker's batch
HVD_RUNS = [             # 14a: (name, compression, op)
    ("qsgd", "qsgd", "Average"),
    ("topk_qsgd 1%", "topk_qsgd", "Average"),
    ("adasum qsgd", "qsgd", "Adasum"),
]
LIVE_STEPS = 16          # 14b: the sync CLI run (M4, windows of 8)
LIVE_TCP_STEPS = 3       # 14b: per worker process, K = 2 of 2 (4 until
                         # phase 17)
_CLI_CHILD = """
import sys
import torch
torch.use_deterministic_algorithms(True)
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from ewdml_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""


@contextlib.contextmanager
def plain_kernels(kernels):
    """The kernel wrappers of the hvd path replaced by their plain
    versions (the same arithmetic in PyTorch ops on the card)."""
    names = ("qsgd_quantize", "dequant_mean", "block_top1", "random_bits")
    saved = {n: getattr(kernels, n) for n in names}
    for n in names:
        setattr(kernels, n, getattr(kernels, n + "_ref"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)


def hvd_launches(kernels, shapes, compression: str, op: str,
                 steps: int) -> dict:
    """14a's reckoning: every step each of the W ranks compresses every
    leaf (``compress_launches``: a quantize per vector of at least
    ``MIN_ELEMS``, else a threefry draw; a block_top1 where Top-k picks
    block mode); the Average of QSGD payloads decodes each leaf's gather
    in one dequant_mean where ``W x n >= MIN_ELEMS`` (the gate is on the
    gathered levels). Adasum and the quirk decode rank by rank, in plain
    ops; Top-k gathers decode in plain ops."""
    import types

    cfg = types.SimpleNamespace(compress_grad=compression, topk_exact=None,
                                topk_ratio=0.01)
    one = compress_launches(cfg, shapes, kernels)
    want = {k: v * WORLD * steps for k, v in one.items()}
    if compression == "qsgd" and op == "Average":
        want["dequant_mean"] += steps * sum(
            1 for s in shapes if WORLD * math.prod(s) >= kernels.MIN_ELEMS)
    return want


def same_launches(kernels, want: dict, what: str) -> dict:
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{what}: launches {got}, reckoned {want}")
    return got


def module_state(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def hvd_fit(torch, kernels, counts, data, compression, op, name,
            plain=False, count=True) -> tuple:
    """One ``hvd.keras.Model.fit`` of VGG11-BN (seed 0) for HVD_STEPS steps
    on the card; its final state, its mean ms a step and its launches
    (added to ``counts`` unless ``plain`` or not ``count``)."""
    from ewdml_tpu_torch import hvd
    from ewdml_tpu_torch.hvd import keras as K
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.optim import SGD

    images, labels = data
    model = K.Model(build_model("VGG11", 10, dataset="cifar10", seed=0),
                    input_shape=(32, 32, 3))
    model.compile(SGD(0.01, momentum=0.9), compression=getattr(
        hvd.Compression, compression)(), op=op)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with plain_kernels(kernels) if plain else contextlib.nullcontext():
        hist = model.fit(images, labels, batch_size=HVD_BATCH, epochs=1,
                         verbose=0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / HVD_STEPS
    launches = dict(kernels.LAUNCHES)
    if count and not plain:
        for k, v in launches.items():
            counts[k] += v
    loss = hist.history["loss"][0]
    if not math.isfinite(loss):
        raise AssertionError(f"14a {name}: loss {loss}")
    return model, module_state(model.module), ms, launches, loss


def hvd_quirk(torch, kernels, counts, data, shapes) -> dict:
    """14a: ``DistributedOptimizer(quirk_average_levels=True)`` called
    directly on VGG11-BN's W per-worker gradients (one forward and backward
    a worker of batch 128): W replicas stepped, their results differ, each
    finite; the launches at their reckoning."""
    from ewdml_tpu_torch import hvd
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs, to_jax
    from ewdml_tpu_torch.optim import SGD
    from ewdml_tpu_torch.train.state import leaf_params
    from ewdml_tpu_torch.train.trainer import cross_entropy
    from ewdml_tpu_torch.utils import prng

    images, labels = data
    base = build_model("VGG11", 10, dataset="cifar10", seed=0)
    base = base.to(DEVICE)
    specs = leaf_specs(base)
    grads = []
    b = HVD_BATCH
    for r in range(WORLD):
        x = torch.from_numpy(images[r * b:(r + 1) * b]).to(DEVICE)
        y = torch.from_numpy(labels[r * b:(r + 1) * b].astype(
            "int64")).to(DEVICE)
        base.zero_grad(set_to_none=True)
        gen = prng.generator(prng.fold_in(prng.key(0), r), DEVICE)
        cross_entropy(base(x, train=True, generator=gen).float(),
                      y).backward()
        grads.append([to_jax(p.grad, s.kind).contiguous()
                      for p, s in zip(leaf_params(base, specs), specs)])
    params = [[p.detach().clone() for p in leaf_params(base, specs)]
              for _ in range(WORLD)]
    dopt = hvd.DistributedOptimizer(SGD(0.01), compressor=hvd.Compression
                                    .qsgd(), quirk_average_levels=True)
    states = [dopt.init(p) for p in params]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    reduced = dopt.update(grads, states, params, key=prng.key(7),
                          kinds=[s.kind for s in specs])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    for k, v in kernels.LAUNCHES.items():
        counts[k] += v
    got = same_launches(kernels, hvd_launches(kernels, shapes, "qsgd",
                                              "quirk", 1), "14a quirk")
    if len({id(r) for r in reduced}) != WORLD:
        raise AssertionError("14a quirk: the ranks share a result")
    big = max(range(len(shapes)), key=lambda i: math.prod(shapes[i]))
    if torch.equal(params[0][big], params[WORLD - 1][big]):
        raise AssertionError("14a quirk: ranks 0 and W-1 agree")
    if not all(torch.isfinite(p).all() for ps in params for p in ps):
        raise AssertionError("14a quirk: a non-finite parameter")
    return dict(update_ms=ms, launches=got)


def hvd_phase(torch, kernels, counts, root: str) -> dict:
    """14a (see the module docstring)."""
    import io

    from ewdml_tpu_torch import hvd
    from ewdml_tpu_torch.data import datasets
    from ewdml_tpu_torch.examples import horovod_style
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs

    hvd.init(WORLD, platform=DEVICE)
    shapes = [s.jax_shape for s in leaf_specs(build_model(
        "VGG11", 10, dataset="cifar10"))]
    ds = datasets.load("Cifar10", train=True, synthetic=True,
                       synthetic_size=HVD_STEPS * WORLD * HVD_BATCH)
    data = (ds.images, ds.labels)
    out = {}
    # An uncounted dense fit first: the runs below time warm steps.
    hvd_fit(torch, kernels, counts, data, "none", "Average", "warm-up",
            count=False)
    for name, compression, op in HVD_RUNS:
        plain = name == "qsgd"
        if plain:
            deterministic(torch, True)
        try:
            _, state, ms, launches, loss = hvd_fit(
                torch, kernels, counts, data, compression, op, name)
            want = hvd_launches(kernels, shapes, compression, op, HVD_STEPS)
            got = same_launches(kernels, want, f"14a {name}")
            row = dict(step_ms=ms, loss=loss, launches=got)
            if plain:
                # The same run with the plain versions on the card.
                _, ref, ref_ms, ref_launches, _ = hvd_fit(
                    torch, kernels, counts, data, compression, op, name,
                    plain=True)
                if any(ref_launches.values()):
                    raise AssertionError(f"14a plain run launched "
                                         f"{ref_launches}")
                for k in state:
                    if not torch.equal(state[k], ref[k]):
                        raise AssertionError(f"14a {name}: {k} differs "
                                             "from the plain versions' run")
                row.update(plain_step_ms=ref_ms, bit_equal_plain=True)
        finally:
            if plain:
                deterministic(torch, False)
        out[name] = row
        print(f"hvd {name}: {ms:.1f} ms a step (W = {WORLD}, batch "
              f"{HVD_BATCH}), "
              f"loss {loss:.4f}, launches {got}"
              + (f"; bit-equal to the plain versions' run "
                 f"({row['plain_step_ms']:.1f} ms a step)" if plain else ""),
              flush=True)
        torch.cuda.empty_cache()
    out["quirk"] = hvd_quirk(torch, kernels, counts, data, shapes)
    print(f"hvd quirk: update {out['quirk']['update_ms']:.1f} ms, launches "
          f"{out['quirk']['launches']}, ranks differ", flush=True)
    # The example on LeNet with the committed mnist10k (counted, not
    # reckoned).
    ex_dir = os.path.join(root, "example")
    os.makedirs(ex_dir)
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(ex_dir), contextlib.redirect_stdout(buf):
        rc = horovod_style.main([
            "--dataset", "mnist10k", "--no-synthetic", "--data-dir",
            os.path.join(os.path.dirname(os.path.abspath(__file__)), "data"),
            "--num-workers", str(WORLD), "--epochs", "2", "--batch-size",
            "64", "--platform", DEVICE])
    for k, v in kernels.LAUNCHES.items():
        counts[k] += v
    text = buf.getvalue()
    hist = [ln for ln in text.splitlines() if ln.startswith("loss history")]
    ev = [ln for ln in text.splitlines() if ln.startswith("eval:")]
    if rc != 0 or not hist or not ev or not os.path.exists(
            os.path.join(ex_dir, "checkpoint-1.npz")):
        raise AssertionError(f"14a example: rc {rc}\n{text[-2000:]}")
    out["example"] = dict(wall_s=time.perf_counter() - t0,
                          loss_history=hist[0].split(":", 1)[1].strip(),
                          eval=ev[0].split(":", 1)[1].strip(),
                          launches={k: v for k, v in kernels.LAUNCHES.items()
                                    if v})
    print(f"hvd example (LeNet, mnist10k, W = {WORLD}): "
          + json.dumps(out["example"]), flush=True)
    return out


def scrape(port: int, path: str) -> tuple:
    """One GET of the live plane: (body, ms)."""
    import urllib.request

    t0 = time.perf_counter()
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=10).read()
    return body, (time.perf_counter() - t0) * 1e3


def scrape_role(port: int, role: str) -> dict:
    """Both formats of one role's endpoint; the JSON names the role."""
    prom, prom_ms = scrape(port, "/metrics")
    doc, json_ms = scrape(port, "/metrics.json")
    doc = json.loads(doc)
    if doc["role"] != role or doc["port"] != port:
        raise AssertionError(f"scrape of {role}: {doc['role']}@{doc['port']}")
    samples = [ln for ln in prom.decode().splitlines()
               if ln and not ln.startswith("#")]
    if any(f'role="{role}"' not in ln for ln in samples):
        raise AssertionError(f"scrape of {role}: a sample of another role")
    return dict(prom_ms=prom_ms, json_ms=json_ms, samples=len(samples),
                metrics=sum(len(v) for v in doc["metrics"].values()))


def cli_child(argv: list, log: str):
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0",
               CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    f = open(log, "w")
    proc = subprocess.Popen([sys.executable, "-c", _CLI_CHILD, *argv],
                            env=env, stdout=f, stderr=subprocess.STDOUT,
                            text=True)
    proc.log = f
    return proc


def live_sync(root: str) -> dict:
    """14b: the sync CLI (VGG11-BN M4, LIVE_STEPS steps, deterministic) in
    two child processes at once, one with ``--metrics-port 0
    --trace-dir``: its endpoint scraped in both formats while it runs, and
    its checkpoint byte-equal to the other's."""
    runs = {}
    for name, extra in (("served", ["--metrics-port", "0", "--trace-dir",
                                    os.path.join(root, "sync_trace")]),
                        ("plain", [])):
        tdir = os.path.join(root, f"sync_{name}") + "/"
        argv = vgg_argv(LIVE_STEPS, ["--method", "4", "--eval-freq",
                                     str(LIVE_STEPS), *extra], tdir)
        log = os.path.join(root, f"sync_{name}.log")
        runs[name] = (cli_child(argv, log), log, tdir)
    scrapes = []
    try:
        proc, log, _ = runs["served"]
        line = wait_for_line(proc, log, "TRAINER_METRICS", 300)
        port = int(line.split()[1])
        while proc.poll() is None:
            try:
                scrapes.append(scrape_role(port, "trainer"))
            except OSError:
                if not scrapes:
                    raise
                break  # the run closed its endpoint on its way out
            time.sleep(0.2)
        for name, (p, log, _) in runs.items():
            if p.wait(timeout=300) != 0:
                with open(log) as f:
                    raise AssertionError(f"14b sync {name}: rc {p.returncode}"
                                         f"\n{f.read()[-2000:]}")
    finally:
        for p, _, _ in runs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            p.log.close()
    if not scrapes:
        raise AssertionError("14b sync: no scrape while the run lived")
    blobs = []
    for _, _, tdir in runs.values():
        with open(os.path.join(tdir, "model_step_"), "rb") as f:
            blobs.append(f.read())
    if blobs[0] != blobs[1]:
        raise AssertionError("14b sync: the served run's checkpoint differs "
                             "from the plain run's")
    return dict(scrapes=len(scrapes),
                prom_ms=statistics.median(s["prom_ms"] for s in scrapes),
                json_ms=statistics.median(s["json_ms"] for s in scrapes),
                samples=max(s["samples"] for s in scrapes),
                checkpoint_bytes=len(blobs[0]), bit_equal=True)


def gating_reqs(merged: list) -> dict:
    """(version, fed round) -> the request id of the server push whose
    dispatch holds the apply of that round."""
    pushes = [e for e in merged if e.get("name") == "ps_net/push"]
    out = {}
    for ap in (e for e in merged if e.get("name") == "ps/apply"):
        a = ap.get("args") or {}
        hold = [p for p in pushes if p["ts"] <= ap["ts"]
                and p["ts"] + p["dur"] >= ap["ts"] + ap["dur"]
                and p.get("role") == ap.get("role")]
        if hold:
            out[(a.get("version"), a.get("round"))] = str(
                hold[-1]["args"]["req"])
    return out


def tcp_apply_launches(kernels, applies: int) -> dict:
    """14b's reckoning of the server's int_accumulate and acc_decode
    launches over ``applies`` homomorphic applies of VGG11-BN under QSGD:
    each apply sums every leaf of at least MIN_ELEMS in one accumulate and
    decodes all 38 leaves in one decode set."""
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs

    sizes = [math.prod(s.jax_shape) for s in leaf_specs(build_model(
        "VGG11", 10, dataset="cifar10"))]
    return {"int_accumulate": applies * sum(
                1 for n in sizes if n >= kernels.MIN_ELEMS),
            "acc_decode": applies * kernels.decode_set_launches(len(sizes))}


def live_tcp(kernels, counts, root: str) -> dict:
    """14b: a server, a replica and two workers as processes on the card
    (VGG11-BN, QSGD ``--server-agg homomorphic``, K = 2, ``--pull-delta``,
    the workers' pulls from the replica), each with ``--metrics-port 0``
    and one ``--trace-dir``: every role scraped while it runs; the server's
    own kernel launches (its ``stats`` reply) at ``tcp_apply_launches``,
    counting the apply that registration warms, and no leaf decoded on the
    card with the plain version there, its launches added to ``counts``;
    then ``cli obs rounds|export|report`` on the directory."""
    import io

    from ewdml_tpu_torch.cli import main as cli_main
    from ewdml_tpu_torch.obs import export as oexport
    from ewdml_tpu_torch.obs import merge as omerge
    from ewdml_tpu_torch.obs import rounds as orounds
    from ewdml_tpu_torch.parallel import ps_net

    tdir = os.path.join(root, "tcp_trace")
    port, rport = free_ports(2)
    common = tcp_argv(2, ["--compress-grad", "qsgd", "--server-agg",
                          "homomorphic"], "--port", str(port),
                      "--net-retries", "14", "--net-backoff", "0.5",
                      "--pull-delta", "--keyframe-every", "4",
                      "--metrics-port", "0", "--trace-dir", tdir)
    procs, logs, scraped = [], {}, {}

    def start(label, args):
        logs[label] = os.path.join(root, f"tcp_{label}.log")
        proc = ps_net_proc(args, logs[label])
        procs.append(proc)
        return proc

    def scrape_marker(label, proc):
        line = wait_for_line(proc, logs[label], "PS_NET_METRICS", 300)
        role, mport = line.split()[1:]
        scraped[role] = scrape_role(int(mport), role)

    t0 = time.perf_counter()
    try:
        server = start("server", ["--role", "server", *common])
        wait_for_line(server, logs["server"], "PS_NET_READY", 180)
        scrape_marker("server", server)
        # The workers start with the replica; their first pull retries
        # until it serves.
        replica = start("replica", ["--role", "replica", *common,
                                    "--replica-port", str(rport)])
        workers = [start(f"worker{i}", [
            "--role", "worker", *common, "--replicas",
            f"127.0.0.1:{rport}", "--worker-index", str(i), "--steps",
            str(LIVE_TCP_STEPS)]) for i in range(2)]
        wait_for_line(replica, logs["replica"], "PS_REPLICA_READY", 120)
        scrape_marker("replica", replica)
        for i, w in enumerate(workers):
            scrape_marker(f"worker{i}", w)
        for i, w in enumerate(workers):
            rc = w.wait(timeout=400)
            wait_for_line(w, logs[f"worker{i}"], "PS_NET_WORKER_DONE", 1)
            if rc != 0:
                raise AssertionError(f"14b tcp: worker {i} exited {rc}")
        stats, _ = ps_net.client_call(("127.0.0.1", port), {"op": "stats"})
        for p in (rport, port):
            ps_net.client_call(("127.0.0.1", p), {"op": "shutdown"})
        for label, proc in (("server", server), ("replica", replica)):
            if proc.wait(timeout=60) != 0:
                raise AssertionError(f"14b tcp: {label} exited "
                                     f"{proc.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.log.close()
    wall = time.perf_counter() - t0
    if sorted(scraped) != ["ps-replica", "ps-server", "worker-0",
                           "worker-1"]:
        raise AssertionError(f"14b tcp: scraped {sorted(scraped)}")
    if stats["decode_count"] != stats["apply_rounds"]:
        raise AssertionError(f"14b tcp: {stats['decode_count']} decodes in "
                             f"{stats['apply_rounds']} rounds")
    server_launches = {k: v for k, v in stats["kernel_launches"].items()
                       if v}
    want = tcp_apply_launches(kernels, stats["apply_rounds"] + 1)
    if {k: server_launches.get(k, 0) for k in want} != want:
        raise AssertionError(f"14b tcp: server launches {server_launches}, "
                             f"reckoned {want}")
    if stats["plain_decodes_on_card"]:
        raise AssertionError(f"14b tcp: the server decoded "
                             f"{stats['plain_decodes_on_card']} leaves on "
                             "the card with the plain version")
    for k, v in server_launches.items():
        counts[k] += v
    merged = omerge.merge_dir(tdir)
    analysis = orounds.analyze(merged)
    complete = [r for r in analysis["rounds"] if r.get("complete")]
    if not complete or len(analysis["rounds"]) != stats["updates"]:
        raise AssertionError(f"14b rounds: {analysis['completed']} complete "
                             f"of {len(analysis['rounds'])}, "
                             f"{stats['updates']} updates")
    for r in complete:
        total = sum(r["segments_ms"][k] for k in orounds.SEGMENT_KEYS)
        if abs(total - r["wall_ms"]) > 0.004:
            raise AssertionError(f"14b rounds: round {r['round']} segments "
                                 f"sum to {total}, wall {r['wall_ms']}")
    doc = oexport.chrome_trace(merged)
    flows = {e["args"]["req"] for e in doc["traceEvents"]
             if e.get("cat") == "flow" and e["ph"] == "s"}
    gating = gating_reqs(merged)
    missing = [r["round"] for r in analysis["rounds"]
               if gating.get((r["round"], r.get("fed_round"))) not in flows]
    if missing:
        raise AssertionError(f"14b export: no flow for rounds {missing}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for sub in (["rounds", tdir], ["export", tdir], ["report", tdir]):
            if cli_main(["obs", *sub]) != 0:
                raise AssertionError(f"14b: cli obs {sub[0]} failed")
    text = buf.getvalue()
    print(text[:text.index("\n[") if "\n[" in text else len(text)],
          flush=True)
    segs = {k: statistics.median(r["segments_ms"][k] for r in complete)
            for k in orounds.SEGMENT_KEYS}
    return dict(wall_s=wall, scrapes=scraped, rounds=len(analysis["rounds"]),
                complete=len(complete), flow_pairs=analysis["flow_pairs"],
                flows=len(flows), wall_ms_median=statistics.median(
                    r["wall_ms"] for r in complete),
                segments_ms_median=segs,
                gating_counts=analysis["gating_counts"],
                apply_ms_mean=stats["apply_ms_mean"],
                server_launches=server_launches)


def live_phase(torch, kernels) -> tuple:
    """Phase 14 (see the module docstring)."""
    PLAIN_DECODES["calls"] = 0
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = {k: 0 for k in kernels.LAUNCHES}
    out, walls = {}, {}
    root = tempfile.mkdtemp(prefix="ewdml_live_")
    try:
        for name, fn in (
                ("14a", lambda: hvd_phase(torch, kernels, counts, root)),
                ("14b sync", lambda: live_sync(root)),
                ("14b tcp", lambda: live_tcp(kernels, counts, root))):
            t = time.perf_counter()
            out[name] = fn()
            walls[f"{name}_s"] = time.perf_counter() - t
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["walls"] = walls
    print("phase 14 walls: " + json.dumps(walls) + " on " + smi_line(),
          flush=True)
    for key in ("qsgd_quantize", "dequant_mean", "block_top1",
                "int_accumulate", "acc_decode"):
        if counts[key] <= 0:
            raise AssertionError(f"phase 14 launched no {key}")
    no_plain_decodes("phase 14")
    return counts, out


# -- phase 15: the static-analysis pass (analysis/) ----------------------------

def lint_phase() -> dict:
    """Phase 15: the port's lint, as a user runs it, in a child process:
    exit 0 and a report with no finding and no stale baseline entry."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ewdml_tpu_torch.cli", "lint", "--json"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 15: lint exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout)
    if (not report["ok"] or report["violations"] or report["baselined"]
            or report["stale_baseline"]):
        raise AssertionError(f"phase 15: lint not clean: {proc.stdout}")
    print(f"lint files {report['files']} new {len(report['violations'])} "
          f"suppressed {report['suppressed']} seconds {seconds:.1f}",
          flush=True)
    return {"files": report["files"], "new": len(report["violations"]),
            "suppressed": report["suppressed"], "seconds": seconds}


# Phase 16: multi-slice training (--num-slices 2 over W = 8: two slices of
# four workers), then the four examples.
SLICES = 2
SLICE_WORKERS = 8
SLICE_TRIO = ("qsgd_quantize", "dequant_mean", "block_top1")
SLICE_RUNS = [  # 16a: (name, steps, flags), at two slices and at one
    ("M1", 5, ["--method", "1"]),
    ("M4", 5, ["--method", "4"]),
    ("M5 EF", 5, ["--method", "5", "--error-feedback"]),
    ("M6", 21, ["--method", "6"]),   # one sync (step 19): one adoption
]
SLICE_WINDOW = [  # 16b: window_phase's (name, network, steps, K, flags)
    ("M5 EF 2x4", "VGG11", 16, 8,   # 24 steps until phase 17
     ["--method", "5", "--error-feedback", "--num-workers",
      str(SLICE_WORKERS), "--num-slices", str(SLICES)]),
]


def slice_argv(steps: int, flags, slices: int) -> list:
    """16a: VGG11-BN at full width, CIFAR-10 shapes, W = 8 in ``slices``
    slices, batch 128 a worker, Top-k at 1%."""
    return ["--network", "VGG11", "--dataset", "Cifar10", "--synthetic-data",
            "--num-workers", str(SLICE_WORKERS), "--num-slices", str(slices),
            "--batch-size", "128", "--topk-ratio", "0.01",
            "--max-steps", str(steps), "--epochs", "100", "--log-every",
            "1000", "--no-bf16", "--eval-freq", "0", *flags]


def slice_units(cfg) -> list:
    """Element counts of VGG11-BN's transport units under ``cfg``."""
    from ewdml_tpu_torch.core.config import resolved_unit_sizes
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs

    specs = leaf_specs(build_model(cfg.network, 10, dataset=cfg.dataset))
    return resolved_unit_sizes(cfg, [math.prod(s.jax_shape) for s in specs])


def slice_step_launches(cfg, units, kernels) -> dict:
    """qsgd_quantize, dequant_mean and block_top1 launches of one sync step
    of the hierarchical exchange: per unit, W payloads in the slices and S
    over DCN (the DCN stage runs once for all W/S columns, every column's
    inputs and keys being the same), a block_top1 for each where the unit
    selects in blocks, a quantize for each and for the relay where the
    quantized vector (the unit, its Top-k or its block winners) has at
    least MIN_ELEMS elements; QSGD decodes once a slice (K = W/S rows)
    and once over DCN (K = S) where the K x n levels reach MIN_ELEMS."""
    return world_step_launches(cfg, units, kernels, SLICE_WORKERS, SLICES,
                               SLICE_WORKERS)


def world_step_launches(cfg, units, kernels, size: int, slices: int,
                        local: int) -> dict:
    """The same launches in a process holding ``local`` of the ``size``
    workers (``local = size``: one process holds them all). Each process
    encodes its own workers' payloads and, at S > 1, the averages of the
    h = local / (W/S) slices it holds (whole slices: the layout phase 17
    runs), and the relay; it decodes every mean itself: one of K = W rows
    flat, or one a held slice (K = W/S) and the DCN one (K = S)."""
    from ewdml_tpu_torch.ops import blocktopk, topk

    want = {k: 0 for k in SLICE_TRIO}
    if not cfg.compression_enabled:
        return want
    per = size // slices
    held = local // per if slices > 1 else 0
    relay = int(cfg.relay_compress and cfg.ps_mode == "grads")
    encodes = local + held
    for n in units:
        m = n
        if cfg.compress_grad == "topk_qsgd":
            if topk.resolve_mode(cfg.topk_exact, n, cfg.topk_ratio) == "block":
                want["block_top1"] += encodes
                m = blocktopk.geometry(n, cfg.topk_ratio)[0]
            else:
                m = topk.static_k(n, cfg.topk_ratio)
        elif slices > 1:
            want["dequant_mean"] += (held * (per * n >= kernels.MIN_ELEMS)
                                     + (slices * n >= kernels.MIN_ELEMS))
        else:
            want["dequant_mean"] += size * n >= kernels.MIN_ELEMS
        if m >= kernels.MIN_ELEMS:
            want["qsgd_quantize"] += encodes + relay
    return want


@contextlib.contextmanager
def level_bytes():
    """Count the payload bytes the gathers of each level ship (one
    worker's payload a gather, its ``wire_bytes``): ``{"ici": .., "dcn":
    ..}`` summed over the calls while the context is open. A gather over
    W/S workers is a slice's, one over S a DCN column's."""
    from ewdml_tpu_torch.core.world import LocalWorld, value_nbytes

    seen = {"ici": 0, "dcn": 0}
    gather = LocalWorld.all_gather

    def counted(self, values):
        level = {SLICE_WORKERS // SLICES: "ici", SLICES: "dcn"}.get(self.size)
        if level is not None:
            seen[level] += getattr(values[0], "wire_bytes", None) \
                or value_nbytes(values[0])
        return gather(self, values)

    LocalWorld.all_gather = counted
    try:
        yield seen
    finally:
        LocalWorld.all_gather = gather


def slice_run(torch, kernels, counts, name, steps, flags, slices) -> dict:
    """One 16a run through the CLI's config and the Trainer: the launches
    of the three kernels against the reckoning, and at two slices the
    up-link bytes each level's gathers ship against ``wire_plan``'s rows
    (the ``dcn/`` ones amortized over W/S)."""
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.train.loop import Trainer

    cfg = from_args(slice_argv(steps, flags, slices))
    trainer = Trainer(cfg)
    what = f"slices {name} S={slices}"
    if (trainer.world.size, trainer.world.num_slices) != (SLICE_WORKERS,
                                                          slices):
        raise AssertionError(f"{what}: world {trainer.world.size} in "
                             f"{trainer.world.num_slices} slices")
    with level_bytes() as shipped:
        kernels.reset_launches()   # this run of the main path starts here
        t0 = time.perf_counter()
        res = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dict(kernels.LAUNCHES)  # read just after it
    for k, v in launched.items():
        counts[k] += v
    if not math.isfinite(res.final_loss) or res.steps != steps:
        raise AssertionError(f"{what}: {res.steps} of {steps} steps, loss "
                             f"{res.final_loss}")
    syncs = sum(1 for s in range(steps) if cfg.sync_every <= 1
                or s % cfg.sync_every == cfg.sync_every - 1)
    row = dict(slices=slices, steps=steps, syncs=syncs,
               final_loss=res.final_loss, mean_step_ms=res.mean_step_s * 1e3,
               wall_s=wall, wire_per_step=res.wire.per_step_bytes,
               launches={k: launched[k] for k in SLICE_TRIO})
    if slices > 1:
        per_step = slice_step_launches(cfg, slice_units(cfg), kernels)
        want = {k: v * syncs for k, v in per_step.items()}
        if row["launches"] != want:
            raise AssertionError(f"{what}: launches {row['launches']}, the "
                                 f"two levels' units reckon {want}")
        row["per_step_launches"] = per_step
    if slices > 1 and cfg.compression_enabled:
        # (M1's dense mean is one pmean over the W workers: no gather.)
        up = res.wire.per_layer_up
        dcn_up = sum(v for k, v in up.items() if k.startswith("dcn/"))
        ici = shipped["ici"] / SLICES / syncs
        dcn = shipped["dcn"] / (SLICE_WORKERS // SLICES) / syncs
        if not (math.isclose(ici, res.wire.up_bytes - dcn_up, rel_tol=1e-12)
                and math.isclose(dcn, dcn_up, rel_tol=1e-12)):
            raise AssertionError(
                f"{what}: the gathers ship {ici} B (ICI) and {dcn} B (DCN, "
                f"per worker) up a sync step, the plan says "
                f"{res.wire.up_bytes - dcn_up} and {dcn_up}")
        if not any(k.startswith("dcn/") for k in up):
            raise AssertionError(f"{what}: the plan has no dcn/ rows")
        row.update(ici_up_bytes=ici, dcn_up_bytes=dcn)
    ev = trainer.evaluate()
    if not math.isfinite(ev["loss"]):
        raise AssertionError(f"{what}: non-finite eval loss")
    print(f"slices {name}: S={slices} W={SLICE_WORKERS} steps={steps} "
          f"loss={res.final_loss:.4f} "
          f"mean_step={res.mean_step_s * 1e3:.2f}ms wall={wall:.1f}s "
          f"wire_per_step={res.wire.per_step_bytes} B "
          f"launches={row['launches']} eval_loss={ev['loss']:.4f}"
          + (f" ici_up={row['ici_up_bytes']} B dcn_up={row['dcn_up_bytes']}"
             " B (= plan)" if "ici_up_bytes" in row else ""), flush=True)
    del trainer
    torch.cuda.empty_cache()
    return row


def slice_kernel_points(torch, kernels, timer) -> dict:
    """16c: each kernel the hierarchical exchange launches against its
    plain version at the ICI and DCN shapes of VGG11-BN's units (bit):
    qsgd_quantize at each unit of MIN_ELEMS or more, dequant_mean at K =
    W/S and K = S rows of each unit where they reach MIN_ELEMS, block_top1
    at each unit's 1% block view; dequant_mean at both K timed at the
    largest unit beside its bound."""
    from ewdml_tpu_torch.core.config import from_args
    from ewdml_tpu_torch.ops import blocktopk, topk

    g = torch.Generator(device="cuda").manual_seed(160)
    units = sorted(set(slice_units(from_args(slice_argv(1, ["--method", "4"],
                                                        SLICES)))),
                   reverse=True)
    per = SLICE_WORKERS // SLICES
    checked = {k: 0 for k in SLICE_TRIO}
    for n in units:
        x = torch.randn(n, device="cuda", generator=g) * 1e-2
        if n >= kernels.MIN_ELEMS:
            norms = torch.linalg.vector_norm(x)
            seed = table_seed(torch, n % 1000 - 500)
            a = kernels.qsgd_quantize(x, norms, seed, 127)
            b = kernels.qsgd_quantize_ref(x, norms, seed, 127)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"qsgd_quantize n={n}: "
                                     f"{int((a != b).sum())} levels differ")
            checked["qsgd_quantize"] += 1
        for k in (per, SLICES):
            if k * n >= kernels.MIN_ELEMS:
                same_dequant(torch, kernels, levels_on_card(torch, k, n, g),
                             dequant_norms(torch, k, n, None, g), None,
                             f"K={k} n={n}")
                checked["dequant_mean"] += 1
        if topk.resolve_mode(None, n, 0.01) == "block":
            nb, _, blk_pad = blocktopk.geometry(n, 0.01)
            x2 = torch.zeros(blk_pad * nb, device="cuda")
            x2[:n] = x
            same_top1(torch, kernels, x2.reshape(blk_pad, nb),
                      f"({blk_pad}, {nb})")
            checked["block_top1"] += 1
    n = units[0]
    rows = []
    for k in (per, SLICES):
        lv = levels_on_card(torch, k, n, g)
        nm = dequant_norms(torch, k, n, None, g)
        rows.append(shape_row(
            timer, lambda lv=lv, nm=nm: kernels.dequant_mean(lv, nm, 127),
            KERNEL_NAMES["dequant_mean"], (k + 4) * n + 4 * k,
            (2 * k + 1) * n, n=n, k=k,
            level="ICI" if k == per else "DCN"))
    for r in rows:
        print(f"shape slices dequant_mean K={r['k']} ({r['level']}) "
              f"n={r['n']}: {r['ms']:.4f} ms, {on_card(r)} (bound "
              f"{r['bound_ms']:.4f} ms)", flush=True)
    print(f"slices kernels: {checked} bit-equal to their plain versions",
          flush=True)
    return dict(checked=checked, dequant_mean=rows)


def example_run(module, argv) -> tuple:
    """Run an example's ``main`` in this process; its exit code and its
    output (also printed)."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="", flush=True)
    if rc != 0:
        raise AssertionError(f"{module.__name__} {argv}: exit {rc}")
    return out, seconds


def examples_run(torch) -> dict:
    """16d: the four examples on the card. The negative result at its
    docstring's setting (VGG11, W = 2, batch 8, lr 0.01, 40 steps, s = 127)
    must be its own verdict (exit 0: the lossy weight broadcast diverges,
    the last finite loss on its curve above 5x Method 2's final loss) with
    Method 2 below 3; the round trip's levels and indices on the card
    equal the CPU's (the threefry draw kernel against its plain version)."""
    import re

    from ewdml_tpu_torch.examples import (compressor_roundtrip,
                                          deep_real_pixels, experiment_matrix,
                                          weight_compression_negative)

    out, secs = {}, {}
    text, secs["weight_compression_negative"] = example_run(
        weight_compression_negative, [])
    lossy = float(re.search(r"lossy-weights-down: final=(\S+)", text)[1])
    finite = float(re.search(r"lossy-weights-down: .* last_finite=(\S+)",
                             text)[1])
    m2 = float(re.search(r"method2-grads: final=(\S+)", text)[1])
    if not weight_compression_negative.diverged(finite, m2) or not m2 < 3:
        raise AssertionError(f"negative result: lossy {lossy} (last finite "
                             f"{finite}), M2 {m2}")
    curve = re.search(r"lossy-weights-down: .* curve: (.*)", text)[1]
    out["negative"] = dict(lossy_final_loss=str(lossy),
                           lossy_last_finite=finite, m2_final_loss=m2,
                           lossy_curve=curve)
    text, secs["experiment_matrix"] = example_run(
        experiment_matrix, ["--network", "LeNet", "--dataset", "MNIST",
                            "--max-steps", "5", "--num-workers", "4"])
    out["matrix_methods"] = len([ln for ln in text.splitlines()
                                 if ln.startswith("method ")])
    if out["matrix_methods"] != 6:
        raise AssertionError(f"experiment matrix: {out['matrix_methods']} "
                             "methods of 6")
    _, secs["compressor_roundtrip"] = example_run(compressor_roundtrip, [])
    for (name, _, _, p, dec), (_, _, _, q, ref) in zip(
            compressor_roundtrip.roundtrips("cuda"),
            compressor_roundtrip.roundtrips("cpu")):
        for field in ("levels", "indices"):
            if hasattr(p, field) and not torch.equal(
                    getattr(p, field).cpu(), getattr(q, field)):
                raise AssertionError(f"round trip {name}: {field} differ "
                                     "between the card and the CPU")
        # The norms may round an ulp apart between the two devices.
        if not torch.allclose(dec.cpu(), ref, rtol=1e-6, atol=0):
            raise AssertionError(f"round trip {name}: decompressed values "
                                 "differ between the card and the CPU")
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    text, secs["deep_real_pixels"] = example_run(
        deep_real_pixels, ["--num-workers", "2", "--max-steps", "5",
                           "--data-dir", data + "/",
                           "--only", "VGG11/M1", "ResNet18/M5+EF@1%"])
    out["deep_rows"] = text.count("(1000 real)")
    if out["deep_rows"] != 2:
        raise AssertionError("deep_real_pixels: 2 configs expected")
    out["seconds"] = secs
    print(f"examples: {json.dumps(out)}", flush=True)
    return out


def slices_phase(torch, kernels) -> tuple:
    """Phase 16: multi-slice training on one card (16a-c), then the four
    examples (16d)."""
    from ewdml_tpu_torch.core.config import from_args

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = {k: 0 for k in kernels.LAUNCHES}
    runs = {}
    for name, steps, flags in SLICE_RUNS:
        two = slice_run(torch, kernels, counts, name, steps, flags, SLICES)
        one = slice_run(torch, kernels, counts, name, steps, flags, 1)
        runs[name] = dict(two, one_slice_ms=one["mean_step_ms"],
                          second_level_ms=two["mean_step_ms"]
                          - one["mean_step_ms"])
    win_counts, windows = window_phase(torch, kernels, SLICE_WINDOW)
    for k, v in win_counts.items():
        counts[k] += v
    for (name, _, steps, _, flags), row in zip(SLICE_WINDOW,
                                               windows.values()):
        cfg = from_args(slice_argv(steps, flags, SLICES))
        want = {k: v * steps for k, v in slice_step_launches(
            cfg, slice_units(cfg), kernels).items()}
        got = {k: row["launches"][k] for k in SLICE_TRIO}
        if got != want:
            raise AssertionError(f"window {name}: launches {got}, the two "
                                 f"levels reckon {want}")
    timer = Timer(torch)
    points = slice_kernel_points(torch, kernels, timer)
    del timer
    torch.cuda.empty_cache()
    examples = examples_run(torch)
    torch.cuda.empty_cache()
    return counts, dict(runs=runs, window=windows, kernels=points,
                        examples=examples)


# Phase 17: the multi-process world (parallel/launcher.py, ProcessWorld):
# CLI child processes joined as torchrun joins them, each checkpoint held
# byte for byte against the emulated (LocalWorld) run of the same config.
P17_TIMEOUT_S = 150
P17_VGG = ["--network", "VGG11", "--dataset", "mnist10k32", "--batch-size",
           "128", "--num-workers", "4", "--max-steps", "3", "--eval-freq",
           "3", "--epochs", "100", "--log-every", "1000", "--no-bf16",
           "--test-batch-size", "1000"]
P17_RUNS = {  # 17b: name -> flags, on VGG11-BN at P = 2 x L = 2 over gloo
    "M4": ["--method", "4"],
    "M5 EF 2 slices": ["--method", "5", "--topk-ratio", "0.01",
                       "--error-feedback", "--num-slices", "2"],
}
P17_LENET = ["--network", "LeNet", "--dataset", "mnist10k", "--batch-size",
             "32", "--num-workers", "3", "--method", "6", "--max-steps",
             "21", "--eval-freq", "21", "--log-every", "1000", "--no-bf16"]

# A phase-17 child: cli.main under phase 16's determinism settings, its
# Trainer recorded. It starts (imports, joins its cluster, builds its
# model and data) at once with every other child, then waits for its go
# file before it trains, so that the runs train one group at a time. The
# launches of its training run (counts zeroed just before train(), read
# just after), its world's staged bytes and its timings are printed as one
# PHASE17 line.
_P17_CHILD = """
import json, os, sys, time
t0 = time.perf_counter()
import torch
torch.use_deterministic_algorithms(True)
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from ewdml_tpu_torch import cli
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.parallel import launcher
seen = {}

class Recorded(cli.Trainer):
    def train(self, max_steps=None):
        ready = time.perf_counter()
        while not os.path.exists(os.environ["P17_GO"]):
            if time.perf_counter() - ready > 900:
                sys.exit("phase 17: no go file after 900 s")
            time.sleep(0.02)
        go = time.perf_counter()
        kernels.reset_launches()
        res = super().train(max_steps)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        up = self.wire.per_layer_up
        seen.update(
            process=launcher.process_index(), backend=launcher.backend(),
            world=type(self.world).__name__, size=self.world.size,
            ranks=list(self.world.ranks), device=str(self.device),
            launches=launches, steps=res.steps,
            mean_step_ms=res.mean_step_s * 1e3, final_loss=res.final_loss,
            gather_bytes=getattr(self.world, "gather_bytes", 0),
            up_bytes=self.wire.up_bytes,
            dcn_up_bytes=sum(v for k, v in up.items()
                             if k.startswith("dcn/")),
            plain_decodes=dict(kernels.PLAIN_DECODES_ON_CARD),
            start_s=ready - t0, train_s=time.perf_counter() - go)
        return res

cli.Trainer = Recorded
rc = cli.main(sys.argv[1:])
print("PHASE17 " + json.dumps(seen), flush=True)
sys.exit(rc)
"""


def p17_spawn(argv: list, log: str, dist_env: dict, go: str):
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0",
               CUBLAS_WORKSPACE_CONFIG=":4096:8", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
               P17_GO=go, **dist_env)
    f = open(log, "w")
    proc = subprocess.Popen([sys.executable, "-c", _P17_CHILD, *argv],
                            env=env, stdout=f, stderr=subprocess.STDOUT,
                            text=True)
    proc.log, proc.log_path = f, log
    return proc


def p17_cluster(argv: list, root: str, name: str, nprocs: int,
                backend: str, port: int, go: str) -> list:
    """``nprocs`` CLI children of one cluster, with the variables torchrun
    sets (``port`` on the loopback), on ``backend``."""
    return [p17_spawn(argv, os.path.join(root, f"{name}_{r}.log"), dict(
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
        WORLD_SIZE=str(nprocs), LOCAL_RANK=str(r),
        LOCAL_WORLD_SIZE=str(nprocs), EWDML_DIST_BACKEND=backend,
        GLOO_SOCKET_IFNAME="lo"), go) for r in range(nprocs)]


def p17_wait(procs: list, what: str) -> list:
    """Every child's PHASE17 record; a child that fails or outlives its
    wall timeout fails the phase."""
    deadline = time.perf_counter() + P17_TIMEOUT_S
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"phase 17 {what}: a child outlived "
                                 f"{P17_TIMEOUT_S} s")
    records = []
    for p in procs:
        p.log.close()
        with open(p.log_path) as f:
            text = f.read()
        if p.returncode != 0:
            raise AssertionError(f"phase 17 {what}: rc {p.returncode}\n"
                                 f"{text[-3000:]}")
        line = [ln for ln in text.splitlines() if ln.startswith("PHASE17 ")]
        records.append(json.loads(line[-1][len("PHASE17 "):]))
    return records


def p17_blob(train_dir: str) -> bytes:
    with open(os.path.join(train_dir, "model_step_"), "rb") as f:
        return f.read()


def p17_same(pdir: str, ldir: str, what: str) -> int:
    a, b = p17_blob(pdir), p17_blob(ldir)
    if a != b:
        raise AssertionError(f"phase 17 {what}: the coordinator's "
                             "checkpoint differs from the emulated run's")
    return len(a)


def p17_check(rec: dict, what: str, world: str, backend, ranks) -> None:
    if (rec["world"], rec["backend"], rec["ranks"]) != (world, backend,
                                                        ranks):
        raise AssertionError(f"phase 17 {what}: a {rec['world']} on "
                             f"{rec['backend']} holding {rec['ranks']}")
    if rec["plain_decodes"]["acc_decode"]:
        raise AssertionError(f"phase 17 {what}: leaves decoded on the card "
                             "by the plain version")


def p17_runs(root: str) -> list:
    """Phase 17's groups in the order they train: ``(name, {run: procs})``,
    every child started now, each group gated by its go file."""
    def tdir(name):
        return os.path.join(root, name) + "/"

    def local(name, argv, go):
        return [p17_spawn(argv + ["--train-dir", tdir(name)],
                          os.path.join(root, name + ".log"), {}, go)]

    ports = free_ports(2 + len(P17_RUNS))
    groups = []
    go = os.path.join(root, "go_ac")
    groups.append(("17a+17c", go, {
        # 17a's emulated twin is 17b M4's (the same configuration).
        "a_procs": p17_cluster(P17_VGG + P17_RUNS["M4"] + [
            "--train-dir", tdir("a_procs")], root, "a_procs", 1, "nccl",
            ports[0], go),
        "c_procs": p17_cluster(P17_LENET + ["--train-dir", tdir("c_procs")],
                               root, "c_procs", 3, "gloo", ports[1], go),
        "c_local": local("c_local", P17_LENET, go)}))
    for i, (name, flags) in enumerate(P17_RUNS.items()):
        tag = "b_" + "".join(c for c in name if c.isalnum())
        go_p, go_l = (os.path.join(root, f"go_{tag}_{k}")
                      for k in ("procs", "local"))
        groups.append((f"17b {name}", go_p, {tag + "_procs": p17_cluster(
            P17_VGG + flags + ["--train-dir", tdir(tag + "_procs")], root,
            tag + "_procs", 2, "gloo", ports[2 + i], go_p)}))
        groups.append((f"17b {name} emulated", go_l, {
            tag + "_local": local(tag + "_local", P17_VGG + flags, go_l)}))
    return groups


def p17_start() -> tuple:
    """Start every phase-17 child (they wait for their go files)."""
    root = tempfile.mkdtemp(prefix="phase17_")
    return root, p17_runs(root)


def p17_stop(started: tuple) -> None:
    """Stop every phase-17 child still running and remove its files."""
    root, groups = started
    for _, _, runs in groups:
        for procs in runs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                p.log.close()
    shutil.rmtree(root, ignore_errors=True)


def process_phase(torch, kernels, started=None) -> tuple:
    """Phase 17: the sync trainer across OS processes. (a) One NCCL rank
    on cuda:0 (W = L = 4, VGG11-BN M4) and (c) three gloo ranks of LeNet
    M6 through its first adoption (21 steps) with its emulated twin, train
    at once; then (b) each VGG11-BN run of P17_RUNS as two gloo ranks of
    L = 2 on the one card, then its emulated W = 4 twin (17a's too, for
    M4), one after the other, so that their step times are their own.
    Every child starts at once (``started``: already, by
    :func:`p17_start`) and waits for its group's turn to train."""
    from ewdml_tpu_torch.core.config import from_args

    started = started or p17_start()
    root, groups = started
    counts = {k: 0 for k in kernels.LAUNCHES}
    out = {"group_s": {}}

    def tdir(name):
        return os.path.join(root, name) + "/"

    recs = {}
    try:
        for name, go, runs in groups:
            t0 = time.perf_counter()
            open(go, "w").close()
            for run, procs in runs.items():
                recs[run] = p17_wait(procs, run)
            out["group_s"][name] = time.perf_counter() - t0
        p17_check(recs["a_procs"][0], "17a", "ProcessWorld", "nccl",
                  [0, 1, 2, 3])
        for r, rec in enumerate(recs["c_procs"]):
            p17_check(rec, "17c", "ProcessWorld", "gloo", [r])
        cfg = from_args(P17_VGG + P17_RUNS["M4"])
        want = {k: v * 3 for k, v in world_step_launches(
            cfg, slice_units(cfg), kernels, 4, 1, 4).items()}
        a = recs["a_procs"][0]
        got = {k: a["launches"][k] for k in SLICE_TRIO}
        if got != want:
            raise AssertionError(f"17a: launches {got}, reckoned {want}")
        if a["gather_bytes"] != 3 * 4 * a["up_bytes"]:
            raise AssertionError(f"17a: {a['gather_bytes']} B gathered, the "
                                 f"plan {3 * 4 * a['up_bytes']}")
        out["17a"] = dict(
            checkpoint_bytes=p17_same(tdir("a_procs"), tdir("b_M4_local"),
                                      "17a"),
            launches=got, gather_bytes=a["gather_bytes"],
            mean_step_ms=a["mean_step_ms"],
            local_mean_step_ms=recs["b_M4_local"][0]["mean_step_ms"])
        out["17c"] = dict(
            checkpoint_bytes=p17_same(tdir("c_procs"), tdir("c_local"),
                                      "17c"),
            steps=recs["c_procs"][0]["steps"],
            gather_bytes=[r["gather_bytes"] for r in recs["c_procs"]],
            mean_step_ms=[r["mean_step_ms"] for r in recs["c_procs"]],
            local_mean_step_ms=recs["c_local"][0]["mean_step_ms"])
        for rec in recs["a_procs"] + recs["c_procs"]:
            for k, v in rec["launches"].items():
                counts[k] += v
        print(f"17a nccl P=1 x L=4 VGG11-BN M4: checkpoint byte-equal "
              f"({out['17a']['checkpoint_bytes']} B), launches {got}, "
              f"gathered {a['gather_bytes']} B, {a['mean_step_ms']:.2f} ms "
              f"a step with 17c training beside it (emulated "
              f"{out['17a']['local_mean_step_ms']:.2f}, alone)", flush=True)
        print(f"17c gloo P=3 x L=1 LeNet M6, 21 steps: checkpoint "
              f"byte-equal ({out['17c']['checkpoint_bytes']} B)", flush=True)
        smi = smi_line()
        for name, flags in P17_RUNS.items():
            tag = "b_" + "".join(c for c in name if c.isalnum())
            procs, local = recs[tag + "_procs"], recs[tag + "_local"][0]
            cfg = from_args(P17_VGG + flags)
            per_step = world_step_launches(cfg, slice_units(cfg), kernels,
                                           4, cfg.num_slices, 2)
            want = {k: v * 3 for k, v in per_step.items()}
            row = dict(checkpoint_bytes=p17_same(
                tdir(tag + "_procs"), tdir(tag + "_local"), f"17b {name}"),
                per_step_launches=per_step, smi=smi,
                local_mean_step_ms=local["mean_step_ms"],
                local_train_s=local["train_s"], processes=[])
            for r, rec in enumerate(procs):
                p17_check(rec, f"17b {name}", "ProcessWorld", "gloo",
                          [2 * r, 2 * r + 1])
                got = {k: rec["launches"][k] for k in SLICE_TRIO}
                if got != want:
                    raise AssertionError(f"17b {name} process {r}: "
                                         f"launches {got}, reckoned {want}")
                rows = (rec["up_bytes"] if cfg.num_slices == 1
                        else rec["dcn_up_bytes"])
                staged = rec["gather_bytes"] / rec["steps"]
                if staged != 2 * rows:
                    raise AssertionError(
                        f"17b {name} process {r}: {staged} B staged a "
                        f"step, wire_plan's rows {2 * rows} (L = 2 x "
                        f"{rows})")
                for k, v in rec["launches"].items():
                    counts[k] += v
                row["processes"].append(dict(
                    launches=got, staged_bytes_per_step=staged,
                    mean_step_ms=rec["mean_step_ms"],
                    start_s=rec["start_s"], train_s=rec["train_s"]))
            out[f"17b {name}"] = row
            print(f"17b gloo P=2 x L=2 VGG11-BN {name}: checkpoint "
                  f"byte-equal ({row['checkpoint_bytes']} B), launches a "
                  f"process {want} (= reckoning), staged "
                  f"{row['processes'][0]['staged_bytes_per_step'] / 1e6:.6f}"
                  f" MB a step a process (= wire_plan), step ms "
                  f"{[round(p['mean_step_ms'], 2) for p in row['processes']]}"
                  f" against {local['mean_step_ms']:.2f} emulated; {smi}",
                  flush=True)
        print("phase 17 groups (s): " + json.dumps(out["group_s"]),
              flush=True)
        no_plain_decodes("phase 17")
    finally:
        p17_stop(started)
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
    parser.add_argument("--phase10-only", action="store_true",
                        help="build, then run phase 10 alone (no result "
                             "line)")
    parser.add_argument("--phase11-only", action="store_true",
                        help="build, then run phase 11 alone (no result "
                             "line)")
    parser.add_argument("--phase12-only", action="store_true",
                        help="build, then run phase 12 alone (no result "
                             "line)")
    parser.add_argument("--phase13-only", action="store_true",
                        help="build, then run phase 13 alone (no result "
                             "line)")
    parser.add_argument("--phase14-only", action="store_true",
                        help="build, then run phase 14 alone (no result "
                             "line)")
    parser.add_argument("--phase15-only", action="store_true",
                        help="build, then run phase 15 alone (no result "
                             "line)")
    parser.add_argument("--phase16-only", action="store_true",
                        help="build, then run phase 16 alone (no result "
                             "line)")
    parser.add_argument("--phase17-only", action="store_true",
                        help="build, then run phase 17 alone (no result "
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
    count_plain_decodes(kernels)
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
    if args.phase10_only:
        t10 = time.perf_counter()
        net_counts, tier = tier_phase(torch, kernels)
        print(f"phase 10: {time.perf_counter() - t10:.1f}s", flush=True)
        print("tier: " + json.dumps(tier), flush=True)
        print("phase 10 launches: " + json.dumps(net_counts), flush=True)
        print(smi_line(), flush=True)
        return 0
    if args.phase11_only:
        t11 = time.perf_counter()
        net_counts, federated = federated_phase(torch, kernels)
        print(f"phase 11: {time.perf_counter() - t11:.1f}s", flush=True)
        print("federated: " + json.dumps(federated), flush=True)
        print("phase 11 launches: " + json.dumps(net_counts), flush=True)
        print(smi_line(), flush=True)
        return 0
    if args.phase12_only:
        t12 = time.perf_counter()
        net_counts, pipeline = pipeline_phase(torch, kernels)
        print(f"phase 12: {time.perf_counter() - t12:.1f}s", flush=True)
        print("pipeline: " + json.dumps(pipeline), flush=True)
        print("phase 12 launches: " + json.dumps(net_counts), flush=True)
        print(smi_line(), flush=True)
        return 0

    if args.phase13_only:
        t13 = time.perf_counter()
        net_counts, adapt = adapt_phase(torch, kernels)
        print(f"phase 13: {time.perf_counter() - t13:.1f}s", flush=True)
        print("adapt: " + json.dumps(adapt), flush=True)
        print("phase 13 launches: " + json.dumps(net_counts), flush=True)
        print(smi_line(), flush=True)
        return 0
    if args.phase14_only:
        t14 = time.perf_counter()
        net_counts, live = live_phase(torch, kernels)
        print(f"phase 14: {time.perf_counter() - t14:.1f}s", flush=True)
        print("live: " + json.dumps(live), flush=True)
        print("phase 14 launches: " + json.dumps(net_counts), flush=True)
        print(smi_line(), flush=True)
        return 0
    if args.phase15_only:
        t15 = time.perf_counter()
        lint = lint_phase()
        print(f"phase 15: {time.perf_counter() - t15:.1f}s", flush=True)
        print("lint: " + json.dumps(lint), flush=True)
        print(smi_line(), flush=True)
        return 0
    if args.phase16_only:
        t16 = time.perf_counter()
        net_counts, slices = slices_phase(torch, kernels)
        print(f"phase 16: {time.perf_counter() - t16:.1f}s", flush=True)
        print("slices: " + json.dumps(slices), flush=True)
        print("phase 16 launches: " + json.dumps(net_counts), flush=True)
        print(smi_line(), flush=True)
        return 0
    if args.phase17_only:
        t17 = time.perf_counter()
        net_counts, processes = process_phase(torch, kernels)
        print(f"phase 17: {time.perf_counter() - t17:.1f}s", flush=True)
        print("processes: " + json.dumps(processes), flush=True)
        print("phase 17 launches: " + json.dumps(net_counts), flush=True)
        print(smi_line(), flush=True)
        return 0

    # Phase 2: kernels against their plain versions.
    timer = Timer(torch)
    checks = check_kernels(torch, kernels, timer)
    shapes = {net: check_path_shapes(torch, kernels, timer, net)
              for net in NETWORKS}
    # The decode set at the apply sets of four networks.
    checks["acc_decode"], decode_sets = check_decode_sets(torch, kernels,
                                                          timer)
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
    print_decode_sets(decode_sets)
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
    # Phase 10: the read replicas and the aggregation tree.
    t10 = time.perf_counter()
    net_counts, tier = tier_phase(torch, kernels)
    print(f"phase 10: {time.perf_counter() - t10:.1f}s", flush=True)
    print("phase 10 launches: " + json.dumps(net_counts), flush=True)
    for k, v in net_counts.items():
        counts[k] += v
    # Phase 11: the federated rounds.
    t11 = time.perf_counter()
    net_counts, federated = federated_phase(torch, kernels)
    print(f"phase 11: {time.perf_counter() - t11:.1f}s", flush=True)
    print("phase 11 launches: " + json.dumps(net_counts), flush=True)
    for k, v in net_counts.items():
        counts[k] += v
    # Phase 12: federated rounds over TCP and the round pipeline.
    t12 = time.perf_counter()
    net_counts, pipeline = pipeline_phase(torch, kernels)
    print(f"phase 12: {time.perf_counter() - t12:.1f}s", flush=True)
    print("phase 12 launches: " + json.dumps(net_counts), flush=True)
    for k, v in net_counts.items():
        counts[k] += v
    # Phase 13: adaptive compression on the three surfaces.
    t13 = time.perf_counter()
    net_counts, adapt = adapt_phase(torch, kernels)
    print(f"phase 13: {time.perf_counter() - t13:.1f}s", flush=True)
    print("phase 13 launches: " + json.dumps(net_counts), flush=True)
    for k, v in net_counts.items():
        counts[k] += v
    # Phase 14: the horovod-style substrate and the live metrics plane.
    t14 = time.perf_counter()
    net_counts, live = live_phase(torch, kernels)
    print(f"phase 14: {time.perf_counter() - t14:.1f}s", flush=True)
    print("phase 14 launches: " + json.dumps(net_counts), flush=True)
    for k, v in net_counts.items():
        counts[k] += v
    # Phase 17's children start up while phase 15 runs (on the host only).
    t17 = time.perf_counter()
    started = p17_start()
    # Phase 15: the static-analysis pass (no kernel).
    try:
        t15 = time.perf_counter()
        lint = lint_phase()
        print(f"phase 15: {time.perf_counter() - t15:.1f}s", flush=True)
    except BaseException:
        p17_stop(started)
        raise
    # Phase 17: the sync trainer across OS processes (before phase 16, so
    # that nothing else runs beside phase 16's timed steps).
    t17b = time.perf_counter()
    net_counts, processes = process_phase(torch, kernels, started)
    print(f"phase 17: {time.perf_counter() - t17b:.1f}s after phase 15 "
          f"({time.perf_counter() - t17:.1f}s with it: its children "
          "started with phase 15)", flush=True)
    print("phase 17 launches: " + json.dumps(net_counts), flush=True)
    for k, v in net_counts.items():
        counts[k] += v
    # Phase 16: multi-slice training and the four examples.
    t16 = time.perf_counter()
    net_counts, slices = slices_phase(torch, kernels)
    print(f"phase 16: {time.perf_counter() - t16:.1f}s", flush=True)
    print("phase 16 launches: " + json.dumps(net_counts), flush=True)
    for k, v in net_counts.items():
        counts[k] += v
    print("kernels: " + json.dumps(counts), flush=True)
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 "main path")

    line = {"kernels": [dict(
        name=LINE_NAMES.get(name, name), route="cuda",
        source=SOURCES.get(name, SOURCE),
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
    print("tier: " + json.dumps(tier), flush=True)
    print("federated: " + json.dumps(federated), flush=True)
    print("pipeline: " + json.dumps(pipeline), flush=True)
    print("adapt: " + json.dumps(adapt), flush=True)
    print("live: " + json.dumps(live), flush=True)
    print("lint: " + json.dumps(lint), flush=True)
    print("slices: " + json.dumps(slices), flush=True)
    print("processes: " + json.dumps(processes), flush=True)
    print(f"wall: {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps(line), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
