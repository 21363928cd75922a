"""Typed config and the reference-compatible CLI (``ewdml_tpu/core/config.py``).

A copy of the JAX package's config, field for field and flag for flag, so a
command line means the same run in both packages (the JAX package's module
imports only the standard library, but this package imports nothing of it).
Fields of subsystems the port does not have yet parse as before; the
trainer rejects a run that sets one of them (``train/trainer.py``).

``--pallas`` keeps its name and values: in the port it selects the
hand-written CUDA kernels (``ops/kernels.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Union

from ewdml_tpu_torch.data.partition import PARTITION_SCHEMES

# Every TrainConfig field is in exactly one of these: HASH_INCLUDED fields
# change the math of a run, HASH_EXCLUDED fields are run-local plumbing.
HASH_EXCLUDED = ("train_dir", "trace_dir", "adapt_ledger", "metrics_port",
                 "health", "wire_plane", "server_state_dir",
                 "snapshot_every", "replicas", "subscribe_every_s",
                 "agg_tree")

HASH_INCLUDED = (
    "network", "dataset", "batch_size", "test_batch_size", "lr",
    "momentum", "epochs", "max_steps", "eval_freq", "compress_grad",
    "gather_type", "comm_type", "mode", "kill_threshold", "num_aggregate",
    "max_staleness", "enable_gpu", "fault_spec", "net_timeout_s",
    "net_retries", "net_backoff_s", "quantum_num", "topk_ratio",
    "topk_exact", "qsgd_block", "sync_every", "ps_mode",
    "lossy_weights_down", "relay_compress", "error_feedback", "ps_down",
    "ps_bootstrap", "pull_delta", "keyframe_every", "fusion",
    "fusion_threshold_mb", "adapt",
    "adapt_every", "adapt_budget_mb", "collective", "server_agg",
    "overlap", "overlap_buckets",
    "federated", "pool_size", "cohort", "local_steps", "partition",
    "partition_alpha", "fed_rounds", "round_pipeline",
    "fed_staleness_decay", "fed_staleness_bound",
    "scan_window", "method", "platform", "seed", "num_workers",
    "num_slices", "optimizer", "weight_decay", "nesterov", "data_dir",
    "feed", "synthetic_data", "synthetic_size", "log_every",
    "precision_policy", "bf16_compute", "pallas", "profile_dir",
    "debug_nans",
)

#: Values of --precision-policy (the JAX package keeps them in
#: core/precision.py).
PRECISION_POLICIES = ("f32", "bf16_wire", "bf16_wire_state")


@dataclasses.dataclass
class TrainConfig:
    # -- reference CLI surface (distributed_nn.py:24-72) --
    network: str = "LeNet"            # LeNet | ResNet18..152 | VGG11 | ...
    dataset: str = "MNIST"            # MNIST | mnist10k | Cifar10 | ...
    batch_size: int = 128             # per-worker batch
    test_batch_size: int = 1000
    lr: float = 0.01
    momentum: float = 0.9
    epochs: int = 1
    max_steps: int = 10000
    eval_freq: int = 50
    train_dir: str = "output/models/"
    compress_grad: str = "compress"   # compress|qsgd|topk|topk_qsgd|none
    gather_type: str = "gather"       # gather (all_gather) | ring | ring_rs
    comm_type: str = "Bcast"          # historical
    mode: str = "normal"              # 'normal' (sync) | 'async' (host PS)
    kill_threshold: float = 0.0
    num_aggregate: int = 0            # K-of-N acceptance; 0 = all workers
    max_staleness: int = 0
    enable_gpu: bool = False          # historical

    # -- fault tolerance / wire (host parameter server) --
    fault_spec: str = ""
    net_timeout_s: float = 30.0
    net_retries: int = 3
    net_backoff_s: float = 0.5

    # -- compression switches --
    quantum_num: int = 127            # QSGD levels; 127 = int8 wire
    topk_ratio: float = 0.5
    topk_exact: Union[bool, str, None] = None  # True|False|'block'|None=auto
    qsgd_block: Optional[int] = None  # blockwise QSGD norms
    sync_every: int = 1               # Method 6 sync period
    ps_mode: str = "grads"            # 'grads' | 'weights' (M1)
    lossy_weights_down: bool = False
    relay_compress: bool = True       # compress the down-link too (M4/M5)
    error_feedback: bool = False
    ps_down: str = "weights"
    ps_bootstrap: str = "f32"
    pull_delta: bool = False
    keyframe_every: int = 64
    fusion: str = "auto"              # none | all | bucket | auto
    fusion_threshold_mb: float = 8.0  # bucket size for fusion='bucket'
    adapt: str = "off"
    adapt_every: int = 50
    adapt_ledger: str = ""
    adapt_budget_mb: float = 0.0
    collective: str = "gather"        # dense transport: gather | fused_q
    server_agg: str = "decode"
    overlap: str = "off"              # off | bucket
    overlap_buckets: int = 0
    federated: bool = False
    pool_size: int = 0
    cohort: int = 8
    local_steps: int = 1
    partition: str = "iid"
    partition_alpha: float = 0.5
    fed_rounds: int = 10
    round_pipeline: str = "off"
    fed_staleness_decay: float = 0.5
    fed_staleness_bound: int = 2
    scan_window: int = 0
    method: Optional[int] = None      # 1-6 preset; overrides the fields above

    # -- runtime --
    platform: Optional[str] = None    # 'cpu' | 'cuda'; None = CUDA
    seed: int = 42
    num_workers: Optional[int] = None  # workers on the data axis; None = all
    num_slices: int = 1
    optimizer: str = "sgd"
    weight_decay: float = 0.0
    nesterov: bool = False
    data_dir: str = "data/"
    feed: str = "u8"                  # u8 (normalize on device) | f32 | device
    synthetic_data: bool = False
    synthetic_size: Optional[int] = None
    log_every: int = 10
    precision_policy: str = "f32"
    bf16_compute: bool = True         # bf16 autocast for the model's compute
    pallas: str = "auto"              # auto | on | interpret | off
    profile_dir: Optional[str] = None
    trace_dir: Optional[str] = None
    metrics_port: Optional[int] = None
    health: str = "off"
    wire_plane: str = "evloop"
    server_state_dir: str = ""
    replicas: str = ""
    subscribe_every_s: float = 0.05
    agg_tree: str = ""
    snapshot_every: int = 20
    debug_nans: bool = False

    def __post_init__(self):
        if self.method is not None:
            apply_method_preset(self, self.method)

    def canonical_dict(self, exclude: tuple = HASH_EXCLUDED) -> dict:
        """Plain-dict view of the resolved config, without ``exclude``."""
        d = dataclasses.asdict(self)
        for k in exclude:
            d.pop(k, None)
        return d

    @property
    def compression_enabled(self) -> bool:
        return (self.compress_grad or "none").lower() not in ("none", "non", "dense")

    @property
    def precision(self):
        """The resolved :class:`~ewdml_tpu_torch.core.precision.
        PrecisionPolicy`: the dtype contract of every layer that moves or
        holds gradient-shaped bytes."""
        from ewdml_tpu_torch.core.precision import resolve_policy
        return resolve_policy(self.precision_policy)


# Trees with at least this many gradient leaves get fused buckets under
# fusion='auto': LeNet (8 leaves) stays per layer, VGG11-BN (38) fuses.
FUSION_AUTO_MIN_LEAVES = 16


def resolve_fusion(cfg: TrainConfig, num_leaves: int) -> str:
    """Resolve ``cfg.fusion='auto'`` for a gradient tree of ``num_leaves``."""
    if cfg.fusion != "auto":
        return cfg.fusion
    if not cfg.compression_enabled:
        return "none"
    return "bucket" if num_leaves >= FUSION_AUTO_MIN_LEAVES else "none"


def resolved_unit_sizes(cfg: TrainConfig, sizes) -> list:
    """Element counts of the transport units under the resolved fusion,
    built on the transport's own ``bucket_groups``."""
    fusion = resolve_fusion(cfg, len(sizes))
    if fusion == "none":
        return list(sizes)
    if (cfg.overlap == "bucket" and cfg.mode != "async"
            and cfg.num_slices == 1):
        # The overlap bucket is the fusion unit (its leaves ship as one
        # payload), so the units are the planner's buckets.
        from ewdml_tpu_torch.parallel.overlap import plan_buckets
        plan = plan_buckets([n * 4 for n in sizes], cfg.overlap_buckets)
        return [sum(sizes[i] for i in idxs) for idxs in plan.buckets]
    if fusion == "all":
        return [sum(sizes)]
    from ewdml_tpu_torch.parallel.collectives import bucket_groups
    groups = bucket_groups(sizes, int(cfg.fusion_threshold_mb * (1 << 20)))
    return [sum(sizes[i] for i in g) for g in groups]


def resolve_scan_window(cfg: TrainConfig) -> int:
    """The window length K of ``--scan-window`` (``config.py:662``): K
    steps per host launch (``train/trainer.make_window_step``; a CUDA graph
    on the GPU), which needs the device-resident feed.

    - ``--adapt``: 1 (its decisions are host work between steps);
    - a streaming feed (u8/f32): 1 (a host batch crosses every step);
    - an explicit K: K (at least 1);
    - auto under Method 6 (``sync_every > 1``): the sync period;
    - auto otherwise: ``min(log_every, 8)``.

    The same inside a ``torch.distributed`` world (``parallel/launcher.py``)
    as outside it, as in the JAX package.
    """
    if cfg.adapt != "off":
        return 1
    if cfg.feed != "device":
        return 1
    if cfg.scan_window:
        return max(1, cfg.scan_window)
    if cfg.sync_every > 1:
        return cfg.sync_every
    return max(1, min(cfg.log_every, 8))


def validate_collective(cfg: TrainConfig) -> None:
    """The ``--collective`` matrix of the sync trainer (fail before a step)."""
    if cfg.collective not in ("gather", "fused_q"):
        raise ValueError(f"--collective must be 'gather' or 'fused_q', "
                         f"got {cfg.collective!r}")
    if cfg.collective == "gather":
        return
    if cfg.compression_enabled:
        raise ValueError(
            "--collective fused_q is the DENSE exchange transport; "
            "compressed configs ride --gather-type ring_rs instead (its "
            "hops dispatch the same fused kernels when the payload is "
            "pallas-eligible)")
    if cfg.mode == "async":
        raise ValueError(
            "--collective fused_q applies to the sync SPMD trainer; the "
            "async PS paths exchange over the host wire, not a device "
            "collective")
    if cfg.num_slices > 1:
        raise ValueError(
            "--collective fused_q supports single-slice meshes only (the "
            "hierarchical ICI+DCN exchange has its own two-level "
            "requantization; fusing it is future work)")
    if cfg.precision_policy in ("bf16_wire", "bf16_wire_state"):
        raise ValueError(
            "--collective fused_q already narrows the dense wire to int8 "
            "levels + per-block f32 scales (4x under f32, 2x under bf16); "
            "--precision-policy bf16_wire/bf16_wire_state would be a "
            "second, weaker narrowing of the same bytes — use "
            "--precision-policy f32 with fused_q")
    if cfg.adapt != "off":
        raise ValueError(
            "--collective fused_q is a dense transport; --adapt needs a "
            "compressed config and per-leaf all_gather units "
            "(adapt.validate_config)")


def validate_overlap(cfg: TrainConfig) -> None:
    """The ``--overlap`` matrix of the sync trainer (fail before a step)."""
    if cfg.overlap not in ("off", "bucket"):
        raise ValueError(
            f"--overlap must be 'off' or 'bucket', got {cfg.overlap!r}")
    if cfg.overlap_buckets < 0:
        raise ValueError(f"--overlap-buckets must be >= 0 (0 = auto), "
                         f"got {cfg.overlap_buckets}")
    if cfg.overlap == "off":
        return
    if cfg.mode == "async":
        raise ValueError("--overlap bucket applies to the sync trainer")
    if cfg.num_slices > 1:
        raise ValueError(
            "--overlap bucket supports single-slice meshes only (the "
            "hierarchical ICI+DCN exchange has its own two-level schedule; "
            "bucketing it is the elastic multi-hop item, ROADMAP)")
    if cfg.adapt != "off":
        raise ValueError("--overlap bucket is incompatible with --adapt")
    if cfg.compression_enabled and cfg.gather_type in ("ring", "ring_rs"):
        raise ValueError("--overlap bucket rides the gather transport; drop "
                         "--gather-type " + cfg.gather_type)


def validate_lossy_weights(cfg: TrainConfig) -> None:
    """``--lossy-weights-down`` (``trainer.py:100``) reproduces the
    reference's compressed weight broadcast: it needs ``--ps-mode
    weights``, a compressor and relay compression."""
    if not cfg.lossy_weights_down:
        return
    if cfg.ps_mode != "weights" or not cfg.compression_enabled \
            or not cfg.relay_compress:
        raise ValueError(
            "--lossy-weights-down reproduces the reference's compressed "
            "weight broadcast: it requires --ps-mode weights, a "
            "compressor, and relay compression (there is no weight "
            "down-link to compress in grads mode)")


def validate_wire_plane(cfg: TrainConfig) -> None:
    """``--wire-plane`` names the TCP server's transport
    (``parallel/ps_net.py``): ``threads`` or ``evloop``."""
    if cfg.wire_plane not in ("threads", "evloop"):
        raise ValueError(f"--wire-plane must be 'threads' or 'evloop', got "
                         f"{cfg.wire_plane!r}")


def validate_server_agg(cfg: TrainConfig) -> None:
    """The ``--server-agg`` matrix (``config.py:777``, copied): fail at
    config altitude, before a server is built."""
    if cfg.server_agg not in ("decode", "homomorphic"):
        raise ValueError(f"--server-agg must be 'decode' or 'homomorphic', "
                         f"got {cfg.server_agg!r}")
    if cfg.server_agg == "decode":
        return
    name = (cfg.compress_grad or "none").lower()
    if name not in ("compress", "qsgd", "topk_qsgd", "topk-qsgd", "method5"):
        raise ValueError(
            "--server-agg homomorphic needs a QSGD-family compressor "
            "(--compress-grad qsgd/topk_qsgd): dense pushes already sum "
            "without a decode, and the plain top-k / terngrad wires have "
            f"no shared-scale contract (got {cfg.compress_grad!r})")
    if cfg.quantum_num > 127:
        raise ValueError(
            "--server-agg homomorphic needs an int8 level wire "
            f"(--quantum-num <= 127, got {cfg.quantum_num}): the widened "
            "int32 accumulator's overflow budget is sized for clipped "
            "int8 levels (the s=128 reference-parity opt-in is an int16 "
            "wire)")
    if cfg.ps_down == "delta":
        raise ValueError(
            "--server-agg homomorphic requires --ps-down weights: the "
            "delta stream compresses SERVER updates with per-push norms "
            "(a different scale domain than the negotiated gradient "
            "contract)")
    if cfg.lossy_weights_down:
        raise ValueError("--server-agg homomorphic is incompatible with "
                         "the --lossy-weights-down negative-result mode")


def federated_max_cohort(cfg: TrainConfig) -> Optional[int]:
    """The largest cohort the homomorphic accumulator admits
    (``config.py:811-842``), or None when decode mode leaves it unbounded.
    Flat: the int32 root budget ``2^31 / s``; under ``--agg-tree`` the
    lesser of that and the mid-tier's int16 hops
    (``ops/homomorphic.tree_max_cohort``)."""
    if cfg.server_agg != "homomorphic":
        return None
    from ewdml_tpu_torch.ops.qsgd import max_world_for

    if cfg.agg_tree:
        from ewdml_tpu_torch.ops.homomorphic import tree_max_cohort

        return tree_max_cohort(cfg.quantum_num,
                               len(parse_agg_tree(cfg.agg_tree)))
    return max_world_for(cfg.quantum_num)


def validate_federated(cfg: TrainConfig) -> None:
    """The ``--federated`` matrix (``config.py:845-912``, copied): fail at
    config altitude, not mid-round. Shared by ``build_endpoint_setup``, the
    in-process ``federated.run_federated`` and the CLI."""
    if not cfg.federated:
        return
    if cfg.pool_size < 1:
        raise ValueError(
            f"--federated needs --pool-size >= 1 (the registered client "
            f"pool), got {cfg.pool_size}")
    if cfg.cohort < 1 or cfg.cohort > cfg.pool_size:
        raise ValueError(
            f"--cohort must be in [1, pool_size={cfg.pool_size}], "
            f"got {cfg.cohort}")
    if cfg.num_aggregate < 0 or cfg.num_aggregate > cfg.cohort:
        raise ValueError(
            f"--num-aggregate (the accept-K-of-cohort bound) must be in "
            f"[0, cohort={cfg.cohort}] in federated mode "
            f"(0 = accept the whole cohort), got {cfg.num_aggregate}")
    if cfg.local_steps < 1:
        raise ValueError(f"--local-steps must be >= 1, got {cfg.local_steps}")
    if cfg.fed_rounds < 1:
        raise ValueError(f"--fed-rounds must be >= 1, got {cfg.fed_rounds}")
    if cfg.partition not in PARTITION_SCHEMES:
        raise ValueError(f"--partition must be one of {PARTITION_SCHEMES}, "
                         f"got {cfg.partition!r}")
    if cfg.partition_alpha <= 0:
        raise ValueError(
            f"--partition-alpha must be > 0, got {cfg.partition_alpha}")
    if cfg.adapt != "off":
        raise ValueError(
            "--federated is incompatible with --adapt: a plan switch "
            "re-registers the push schema mid-run, and sampled clients "
            "bootstrap fresh every round — there is no persistent worker "
            "to follow plan_version (adaptive federated rounds are future "
            "work)")
    if cfg.ps_down != "weights":
        raise ValueError(
            "--federated requires --ps-down weights: sampled clients pull "
            "a fresh full parameter set every round, so there is no "
            "persistent worker-side base for the compressed delta stream "
            "to replay onto")
    if cfg.ps_bootstrap != "f32":
        raise ValueError(
            "--federated requires --ps-bootstrap f32: every cohort pull "
            "is a fresh bootstrap pull, so the bf16 wire's one-time "
            "rounding promise would become an every-round re-rounding of "
            "the weights (exactly the lossy-weights negative result)")
    if cfg.lossy_weights_down:
        raise ValueError("--federated is incompatible with the "
                         "--lossy-weights-down negative-result mode")
    if cfg.overlap != "off":
        raise ValueError(
            "--overlap bucket names the sync SPMD trainer's device "
            "schedule; federated rounds exchange over the host wire")
    bound = federated_max_cohort(cfg)
    if bound is not None and cfg.cohort > bound:
        raise ValueError(
            f"--cohort {cfg.cohort} exceeds the homomorphic accumulator's "
            f"analytic max cohort {bound} at --quantum-num "
            f"{cfg.quantum_num} (a K-way sum of clipped levels can reach "
            f"K*s; int32 admits K <= 2^31/s — ops/qsgd.check_sum_budget)")


def validate_round_pipeline(cfg: TrainConfig) -> None:
    """The ``--round-pipeline`` matrix (``config.py:1026-1103``, copied):
    fail here, not as a wedged barrier or a mixed-round sum mid-run.

    Both pipelined modes change which pushes average into which apply, so
    a subsystem that assumes one round in flight is refused:

    - only the homomorphic sum keeps per-round grids on one shared-scale
      contract; decode mode's pending batch has no round tag;
    - ``--agg-tree`` mid-tier sums hold no round id;
    - a ``--replicas`` pull can lag the apply plane, so a cohort could
      compute against a version from before its round began;
    - a ``--server-state-dir`` snapshot is one grid cut and cannot hold two
      open rounds;
    - ``--adapt`` is refused for every federated run by
      :func:`validate_federated`.

    Async weights a stale delta by pending it fewer times on the int8 grid,
    so the sum budget must admit the tick quota.
    """
    if cfg.round_pipeline not in ("off", "overlap", "async"):
        raise ValueError(f"--round-pipeline must be off|overlap|async, "
                         f"got {cfg.round_pipeline!r}")
    if cfg.round_pipeline == "off":
        return
    if not cfg.federated:
        raise ValueError(
            "--round-pipeline overlap/async needs --federated: the round "
            "pipeline schedules sampled cohorts, not a fixed worker pool")
    if cfg.server_agg != "homomorphic":
        raise ValueError(
            "--round-pipeline overlap/async requires --server-agg "
            "homomorphic: per-round accumulator grids route pushes by "
            "round id in the compressed domain; decode-mode pending "
            "batches carry no round tag")
    if cfg.agg_tree:
        raise ValueError(
            "--round-pipeline is incompatible with --agg-tree: the "
            "mid-tier accumulators hold no round machinery, so a subtree "
            "partial sum spanning two in-flight rounds would mix grids")
    if cfg.replicas:
        raise ValueError(
            "--round-pipeline is incompatible with --replicas: a replica-"
            "served pull can lag the apply plane, so a pipelined cohort "
            "could compute against a version from before its round began "
            "and wedge the overlap window")
    if cfg.server_state_dir:
        raise ValueError(
            "--round-pipeline is incompatible with --server-state-dir: a "
            "snapshot is one point-in-time grid cut and cannot capture "
            "two in-flight rounds; mid-pipeline durability is refused at "
            "config altitude rather than recovered approximately")
    if cfg.round_pipeline == "async":
        if cfg.fed_staleness_decay < 0:
            raise ValueError(f"--fed-staleness-decay must be >= 0, got "
                             f"{cfg.fed_staleness_decay}")
        if cfg.fed_staleness_bound < 1:
            raise ValueError(f"--fed-staleness-bound must be >= 1, got "
                             f"{cfg.fed_staleness_bound}")
        from ewdml_tpu_torch.ops.qsgd import check_sum_budget

        # A fresh delta pends WEIGHT_SCALE (4) ticks, the quota is
        # accept * 4 ticks, and a batch overshoots it by at most one
        # delta's ticks before the quota fires.
        accept = cfg.num_aggregate or cfg.cohort
        check_sum_budget(cfg.quantum_num, accept * 4 + 4)


def validate_replicas(cfg: TrainConfig) -> None:
    """The read replicas' matrix (``--replicas``, ``--pull-delta``,
    ``--keyframe-every``; ``config.py:915-945``, copied): fail at config
    altitude, not mid-run."""
    if cfg.keyframe_every < 1:
        raise ValueError(
            f"--keyframe-every must be >= 1, got {cfg.keyframe_every}")
    if not cfg.replicas:
        return
    if cfg.subscribe_every_s <= 0:
        raise ValueError(
            f"--subscribe-every must be > 0 with --replicas, "
            f"got {cfg.subscribe_every_s}")
    if cfg.adapt != "off":
        raise ValueError(
            "--replicas is incompatible with --adapt: adaptive plan "
            "switches propagate on the apply server's pull replies "
            "(plan_version/plan), and a replica-served pull would leave "
            "workers encoding under a superseded plan forever")
    if cfg.ps_down != "weights":
        raise ValueError(
            "--replicas requires --ps-down weights: a replica serves its "
            "reconstructed dense copy (mode 'weights'), so there is no "
            "worker-side base for the r6 compressed delta down-link to "
            "replay onto")
    if cfg.lossy_weights_down:
        raise ValueError("--replicas is incompatible with the "
                         "--lossy-weights-down negative-result mode")


def parse_agg_tree(spec: str) -> list:
    """An ``--agg-tree`` address list ("host:port,host:port") as
    ``[(host, port), ...]``; a malformed entry raises ``ValueError``."""
    out = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        host, sep, port_s = part.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"bad --agg-tree entry {part!r} (want host:port)")
        try:
            port = int(port_s)
        except ValueError:
            raise ValueError(
                f"bad --agg-tree port in {part!r} (want host:port)"
            ) from None
        out.append((host, port))
    if not out and (spec or "").strip():
        raise ValueError(f"--agg-tree {spec!r} parsed to no addresses")
    return out


def validate_agg_tree(cfg: TrainConfig) -> None:
    """The aggregation tree's matrix (``config.py:975-1023``, copied). The
    mid-tier sums packed payload bytes without decoding them, which is
    sound only for dense shared-scale QSGD: one flat vector of same-grid
    int8 levels per leaf."""
    if not cfg.agg_tree:
        return
    addrs = parse_agg_tree(cfg.agg_tree)
    if len(set(addrs)) != len(addrs):
        raise ValueError(f"--agg-tree {cfg.agg_tree!r} lists a duplicate "
                         f"aggregator address")
    if cfg.server_agg != "homomorphic":
        raise ValueError(
            "--agg-tree requires --server-agg homomorphic: the mid-tier "
            "sums int8 level buffers in the compressed domain, and "
            "decode-mode f32 payloads have no integer sum to forward")
    name = (cfg.compress_grad or "none").lower()
    if name not in ("compress", "qsgd"):
        raise ValueError(
            "--agg-tree needs a DENSE QSGD wire (--compress-grad qsgd): "
            "sparse top-k payloads pack int32 indices next to their "
            "levels, so positionwise buffer addition at the mid-tier "
            f"would be garbage (got {cfg.compress_grad!r})")
    if cfg.adapt != "off":
        raise ValueError(
            "--agg-tree is incompatible with --adapt: a plan switch "
            "re-registers the push schema atomically on the apply server, "
            "and the mid-tier accumulators hold no plan machinery — a "
            "partial sum spanning a plan switch would mix two grids")
    if cfg.federated:
        from ewdml_tpu_torch.ops.homomorphic import check_tier_budget

        # The widest subtree a round can route: ceil(cohort / n_aggs).
        check_tier_budget(cfg.quantum_num, -(-cfg.cohort // len(addrs)))


def apply_method_preset(cfg: TrainConfig, method: int) -> None:
    """Experiment matrix Methods 1-6 (Final Report pp.4-6)."""
    if method == 1:       # vanilla sync PS: dense grads up, weights down
        cfg.compress_grad, cfg.ps_mode, cfg.sync_every = "none", "weights", 1
    elif method == 2:     # QSGD on worker->server push only
        cfg.compress_grad, cfg.ps_mode = "qsgd", "grads"
        cfg.relay_compress = False
    elif method == 3:     # grads both ways, dense
        cfg.compress_grad, cfg.ps_mode, cfg.sync_every = "none", "grads", 1
    elif method == 4:     # QSGD both directions
        cfg.compress_grad, cfg.ps_mode, cfg.relay_compress = "qsgd", "grads", True
    elif method == 5:     # Top-k -> QSGD both directions
        cfg.compress_grad, cfg.ps_mode, cfg.relay_compress = "topk_qsgd", "grads", True
    elif method == 6:     # Method 5 + local SGD, sync every 20th step
        cfg.compress_grad, cfg.ps_mode, cfg.relay_compress = "topk_qsgd", "grads", True
        cfg.sync_every = 20
    else:
        raise ValueError(f"method must be 1-6, got {method}")


def add_fit_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The JAX package's flag surface, flag for flag."""
    d = TrainConfig()
    a = parser.add_argument
    a("--network", type=str, default=d.network)
    a("--dataset", type=str, default=d.dataset)
    a("--batch-size", type=int, default=d.batch_size)
    a("--test-batch-size", type=int, default=d.test_batch_size)
    a("--lr", type=float, default=d.lr)
    a("--momentum", type=float, default=d.momentum)
    a("--epochs", type=int, default=d.epochs)
    a("--max-steps", type=int, default=d.max_steps)
    a("--eval-freq", type=int, default=d.eval_freq)
    a("--train-dir", type=str, default=d.train_dir)
    a("--compress-grad", type=str, default=d.compress_grad)
    a("--gather-type", type=str, default=d.gather_type)
    a("--comm-type", type=str, default=d.comm_type)
    a("--mode", type=str, default=d.mode)
    a("--kill-threshold", type=float, default=d.kill_threshold)
    a("--num-aggregate", type=int, default=d.num_aggregate)
    a("--max-staleness", type=int, default=d.max_staleness)
    a("--fault-spec", type=str, default=d.fault_spec)
    a("--net-timeout", dest="net_timeout_s", type=float,
      default=d.net_timeout_s)
    a("--net-retries", type=int, default=d.net_retries)
    a("--net-backoff", dest="net_backoff_s", type=float,
      default=d.net_backoff_s)
    a("--enable-gpu", action="store_true")
    a("--quantum-num", type=int, default=d.quantum_num)
    a("--topk-ratio", type=float, default=d.topk_ratio)
    a("--topk-approx", dest="topk_exact", action="store_false")
    a("--topk-exact", dest="topk_exact", action="store_true")
    a("--topk-block", dest="topk_exact", action="store_const", const="block")
    parser.set_defaults(topk_exact=None)
    a("--qsgd-block", type=int, default=None)
    a("--sync-every", type=int, default=d.sync_every)
    a("--ps-mode", type=str, default=d.ps_mode)
    a("--lossy-weights-down", action="store_true")
    a("--no-relay-compress", dest="relay_compress", action="store_false")
    a("--error-feedback", action="store_true")
    a("--ps-down", type=str, default=d.ps_down, choices=["weights", "delta"])
    a("--ps-bootstrap", type=str, default=d.ps_bootstrap,
      choices=["f32", "bf16"])
    a("--pull-delta", action="store_true")
    a("--keyframe-every", dest="keyframe_every", type=int,
      default=d.keyframe_every)
    a("--replicas", type=str, default=d.replicas)
    a("--subscribe-every", dest="subscribe_every_s", type=float,
      default=d.subscribe_every_s)
    a("--agg-tree", type=str, default=d.agg_tree)
    a("--fusion", type=str, default=d.fusion,
      choices=["auto", "none", "all", "bucket"])
    a("--fusion-threshold-mb", type=float, default=d.fusion_threshold_mb)
    a("--adapt", type=str, default=d.adapt,
      choices=["off", "variance", "replay"])
    a("--adapt-every", type=int, default=d.adapt_every)
    a("--adapt-ledger", type=str, default=d.adapt_ledger)
    a("--adapt-budget-mb", type=float, default=d.adapt_budget_mb)
    a("--collective", type=str, default=d.collective,
      choices=["gather", "fused_q"])
    a("--server-agg", type=str, default=d.server_agg,
      choices=["decode", "homomorphic"])
    a("--overlap", type=str, default=d.overlap, choices=["off", "bucket"])
    a("--overlap-buckets", type=int, default=d.overlap_buckets)
    a("--federated", action="store_true")
    a("--pool-size", type=int, default=d.pool_size)
    a("--cohort", type=int, default=d.cohort)
    a("--local-steps", type=int, default=d.local_steps)
    a("--partition", type=str, default=d.partition,
      choices=list(PARTITION_SCHEMES))
    a("--partition-alpha", type=float, default=d.partition_alpha)
    a("--fed-rounds", type=int, default=d.fed_rounds)
    a("--round-pipeline", type=str, default=d.round_pipeline,
      choices=["off", "overlap", "async"])
    a("--fed-staleness-decay", dest="fed_staleness_decay", type=float,
      default=d.fed_staleness_decay)
    a("--fed-staleness-bound", dest="fed_staleness_bound", type=int,
      default=d.fed_staleness_bound)
    a("--scan-window", type=int, default=d.scan_window)
    a("--method", type=int, default=None)
    a("--platform", type=str, default=None)
    a("--seed", type=int, default=d.seed)
    a("--num-workers", type=int, default=None)
    a("--num-slices", type=int, default=d.num_slices)
    a("--optimizer", type=str, default=d.optimizer)
    a("--weight-decay", type=float, default=d.weight_decay)
    a("--nesterov", action="store_true")
    a("--data-dir", type=str, default=d.data_dir)
    a("--feed", type=str, default=d.feed, choices=["u8", "f32", "device"])
    a("--synthetic-data", action="store_true")
    a("--synthetic-size", type=int, default=None)
    a("--log-every", type=int, default=d.log_every)
    a("--precision-policy", type=str, default=d.precision_policy,
      choices=list(PRECISION_POLICIES))
    a("--no-bf16", dest="bf16_compute", action="store_false")
    a("--pallas", type=str, default=d.pallas,
      choices=["auto", "on", "interpret", "off"])
    a("--profile-dir", type=str, default=None)
    a("--trace-dir", dest="trace_dir", type=str, default=None)
    a("--metrics-port", dest="metrics_port", type=int, default=None)
    a("--health", type=str, default=d.health,
      choices=["off", "warn", "abort"])
    a("--wire-plane", type=str, default=d.wire_plane,
      choices=["threads", "evloop"])
    a("--server-state-dir", dest="server_state_dir", type=str,
      default=d.server_state_dir)
    a("--snapshot-every", dest="snapshot_every", type=int,
      default=d.snapshot_every)
    a("--debug-nans", action="store_true")
    return parser


def from_args(argv=None) -> TrainConfig:
    parser = argparse.ArgumentParser(
        description="ewdml_tpu_torch distributed trainer (PyTorch/CUDA port)")
    add_fit_args(parser)
    ns = parser.parse_args(argv)
    fields = {f.name: getattr(ns, f.name) for f in dataclasses.fields(TrainConfig)
              if hasattr(ns, f.name)}
    return TrainConfig(**fields)
