"""The paper's published-table cells as declarative specs
(``ewdml_tpu/experiments/registry.py``, copied: the port imports nothing of
the JAX package).

One table is an ordered list of :class:`CellSpec`. ``baseline`` is the
paper's whole contribution (BASELINE.md): Methods 1-6 over {LeNet/MNIST 20
epochs, VGG11/CIFAR-10 50 epochs}, batch 64, SGD momentum 0.9, 2 workers,
12 cells. ``baseline_bf16`` reruns the same 12 under
``--precision-policy bf16_wire_state``; ``baseline_scan`` reruns the M6
cells under ``--feed device`` with the scan window (one CUDA graph a
window on the card).

A cell resolves to the paper's real dataset as soon as its files are on
disk (``data/mnist_data/`` train blobs, ``data/cifar10_data/``); until then
it runs the committed real stand-in (``mnist10k`` for LeNet, the 28->32
zero-padded ``mnist10k32`` for VGG11). Never synthetic data: no real split
is a hard error (:meth:`CellSpec.resolve_dataset`, and
``datasets.load(require_real=True)`` in the cell child).

The resolved config and :meth:`CellSpec.spec_hash` equal the JAX
package's for every cell of the three tables, in smoke and in full mode:
the device is never part of the config (the runner passes it to the
trainer as ``--platform``), so a ledger written by one package names the
same cells as the other's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from ewdml_tpu_torch.core.config import HASH_EXCLUDED, TrainConfig

# ---------------------------------------------------------------------------
# Published numbers: BASELINE.md's rows keyed metric -> method -> value. The
# comm/comp time split was published for VGG11 only (BASELINE.md rows 5-6).
# ---------------------------------------------------------------------------

PUBLISHED = {
    "lenet_mnist": {
        "comm_mb_per_iter": {1: 6.56, 2: 4.1, 3: 6.56, 4: 1.64, 5: 1.312,
                             6: 0.06},
        "top1_pct": {1: 98, 2: 97, 3: 97, 4: 98, 5: 96.5, 6: 97},
        "end_to_end_min": {1: 20, 2: 19, 3: 20, 4: 16, 5: 15, 6: 10},
        "epochs_to_converge": {1: 20, 2: 21, 3: 20, 4: 20, 5: 23, 6: 21},
    },
    "vgg11_cifar10": {
        "comm_mb_per_iter": {1: 148, 2: 92.5, 3: 148, 4: 37, 5: 29.6,
                             6: 1.48},
        "top1_pct": {1: 86, 2: 83, 3: 87, 4: 85, 5: 79, 6: 83},
        "comm_min": {1: 20, 2: 17, 3: 20, 4: 16, 5: 10, 6: 5},
        "comp_min": {1: 380, 2: 382, 3: 380, 4: 383, 5: 385, 6: 381},
        "end_to_end_min": {1: 400, 2: 399, 3: 400, 4: 399, 5: 395, 6: 386},
        "epochs_to_converge": {1: 50, 2: 50, 3: 50, 4: 55, 5: 56, 6: 60},
    },
}

#: The reference's hardware (BASELINE.md header), rendered beside the run's
#: own so every deviation is read against the hardware gap first.
REFERENCE_HARDWARE = ("Google Colab CPU (Intel Xeon @ 2.20 GHz, 12 GB RAM); "
                      "2 workers + 1 parameter server, torch.distributed "
                      "Gloo; batch 64, SGD m=0.9")

#: The six methods, for labels (BASELINE.md "Methods" line).
METHOD_LABELS = {
    1: "vanilla sync PS",
    2: "QSGD push only",
    3: "dense grads both ways",
    4: "QSGD both ways",
    5: "Top-k->QSGD both ways",
    6: "M5 + sync every 20",
}


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One declarative cell of a published table.

    ``ref_dataset`` is the paper's dataset; what the cell trains on is
    resolved against the data on disk at run time
    (:meth:`resolve_dataset`). Everything else resolves to a
    :class:`~ewdml_tpu_torch.core.config.TrainConfig` (:meth:`to_config`).
    """

    cell_id: str            # "lenet_mnist/m1"
    model_key: str          # PUBLISHED key: "lenet_mnist" | "vgg11_cifar10"
    network: str            # LeNet | VGG11
    ref_dataset: str        # the paper's dataset: "mnist" | "cifar10"
    stand_in: str           # committed real stand-in: "mnist10k"/"mnist10k32"
    method: int             # 1-6 preset (core/config.apply_method_preset)
    epochs: int             # the paper's training budget (20 / 50)
    batch_size: int = 64    # per worker (the reference's b64)
    lr: float = 0.01
    momentum: float = 0.9
    num_workers: int = 2    # the reference's 2-worker geometry
    precision_policy: str = "f32"
    feed: str = "u8"        # input feed; "device" enables the scan window
    scan_window: int = 0    # --scan-window (0 = auto; only with feed=device)
    # --adapt: 'variance' arms the per-layer adaptive controller (adapt/)
    # over this cell's method preset; its decision ledger lands in the
    # cell's train_dir (the row's provenance).
    adapt: str = "off"
    adapt_every: int = 0    # decision window (0 = 50 full / 2 smoke)
    # A federated cell runs sampled-cohort rounds of local SGD over
    # non-IID shards instead of the sync trainer (collect.run_cell
    # branches on cfg.federated); fed_dropout is its --fault-spec, in the
    # hash (churn changes the experiment).
    federated: bool = False
    pool_size: int = 0
    cohort: int = 0
    local_steps: int = 1
    partition: str = "iid"
    partition_alpha: float = 0.5
    fed_dropout: str = ""   # --fault-spec clauses for the federated driver
    fed_rounds: int = 0     # rounds (full runs; smoke runs 3)

    @property
    def epoch_cap(self) -> int:
        """Training headroom for the epochs-to-target oracle: the
        reference's own epochs-to-converge exceed its budget for half the
        cells (LeNet M2/M5/M6: 21/23/21 > 20; VGG M4/M5/M6: 55/56/60 >
        50). A cell may train up to 1.5x the published budget; the
        collector stops at the budget once the target is met and uses the
        headroom only while it is not."""
        return -(-self.epochs * 3 // 2)  # ceil(1.5x)

    def resolve_dataset(self, data_dir: str = "data/") -> tuple[str, bool]:
        """``(dataset_name, is_stand_in)`` for the data on disk: the
        paper's dataset when its real files are present, else the
        committed real stand-in, else a ``FileNotFoundError``."""
        from ewdml_tpu_torch.data import datasets

        if datasets.has_real(self.ref_dataset, data_dir):
            return self.ref_dataset, False
        if datasets.has_real(self.stand_in, data_dir):
            return self.stand_in, True
        raise FileNotFoundError(
            f"cell {self.cell_id}: neither {self.ref_dataset!r} nor the "
            f"stand-in {self.stand_in!r} has real files under {data_dir!r} "
            "— refusing the synthetic fallback")

    def to_config(self, data_dir: str = "data/", train_dir: str = "",
                  smoke: bool = False) -> TrainConfig:
        """Resolve to the runnable ``TrainConfig``.

        Smoke mode shrinks the step and batch budgets but keeps the method
        presets, the real data and the checkpoint cadence, so the sweep's
        ledger, resume and watchdog run the full table's path. Smoke cells
        compute in f32, full cells under bf16 autocast."""
        dataset, _ = self.resolve_dataset(data_dir)
        lenet = self.network == "LeNet"
        cfg = TrainConfig(
            network=self.network, dataset=dataset, method=self.method,
            batch_size=(16 if lenet else 4) if smoke else self.batch_size,
            lr=self.lr, momentum=self.momentum, epochs=self.epochs,
            num_workers=self.num_workers, data_dir=data_dir,
            train_dir=train_dir, quantum_num=127,
            precision_policy=self.precision_policy,
            feed=self.feed, scan_window=self.scan_window,
            log_every=10**9, bf16_compute=not smoke,
        )
        if self.adapt != "off":
            cfg.adapt = self.adapt
            # A 2-step window still crosses >= 2 decision boundaries in a
            # smoke cell.
            cfg.adapt_every = self.adapt_every or (2 if smoke else 50)
        if self.federated:
            cfg.federated = True
            cfg.pool_size = self.pool_size
            cfg.cohort = self.cohort
            cfg.local_steps = self.local_steps
            cfg.partition = self.partition
            cfg.partition_alpha = self.partition_alpha
            cfg.fault_spec = self.fed_dropout
            cfg.fed_rounds = 3 if smoke else (self.fed_rounds or 20)
            # Cohort sums on the homomorphic accumulator: one decode a
            # round whatever the cohort.
            cfg.server_agg = "homomorphic"
            # Plain SGD on both sides is FedAvg (server momentum would be
            # FedAvgM, another experiment).
            cfg.momentum = 0.0
        spe = _steps_per_epoch(dataset, cfg.batch_size, self.num_workers)
        if smoke:
            # A few steps a cell, eval_freq 2 so a mid-cell kill always
            # leaves a checkpoint for the resume to pick up.
            cfg.max_steps, cfg.epochs, cfg.eval_freq = (6 if lenet else 4,
                                                        10**6, 2)
            cfg.test_batch_size = 500
        else:
            # Checkpoints at epoch boundaries (the oracle evaluates per
            # epoch; a resume restarts the in-flight epoch), and a budget
            # that reaches epoch_cap (the collector enforces the published
            # budget).
            cfg.epochs = self.epoch_cap
            cfg.max_steps = self.epoch_cap * spe
            cfg.eval_freq = spe
        return cfg

    def spec_hash(self, data_dir: str = "data/", smoke: bool = False) -> str:
        """Content hash of the resolved config and the resolved dataset:
        the ledger's key. Editing the spec, flipping ``--smoke`` or real
        data appearing on disk all invalidate a completed row. Run-local
        fields (``config.HASH_EXCLUDED``) and ``data_dir`` (the resolved
        dataset is hashed instead) never do."""
        cfg = self.to_config(data_dir=data_dir, smoke=smoke)
        blob = json.dumps(
            {"cell": self.cell_id, "config": cfg.canonical_dict(
                exclude=HASH_EXCLUDED + ("data_dir",))},
            sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    @property
    def published(self) -> dict:
        """metric -> the published value for this cell's method; adaptive
        and federated cells have none (the paper's table is the static grid
        they are compared against)."""
        if self.adapt != "off" or self.federated:
            return {}
        fam = PUBLISHED.get(self.model_key, {})
        return {metric: by_method[self.method]
                for metric, by_method in fam.items()
                if self.method in by_method}


def _steps_per_epoch(dataset: str, batch_size: int, world: int) -> int:
    """Epoch geometry without loading pixels (``loop.train``'s
    ``len(ds) // (batch * world)``, from the dataset table)."""
    from ewdml_tpu_torch.data.datasets import _SPECS

    n = _SPECS[dataset.lower()]["n_train"]
    return max(1, n // (batch_size * world))


def _matrix(precision_policy: str = "f32") -> list[CellSpec]:
    """M1-M6 x {LeNet/MNIST 20 epochs, VGG11/CIFAR-10 50 epochs}."""
    cells = []
    for model_key, network, ref_ds, stand_in, epochs in (
            ("lenet_mnist", "LeNet", "mnist", "mnist10k", 20),
            ("vgg11_cifar10", "VGG11", "cifar10", "mnist10k32", 50)):
        for method in range(1, 7):
            cells.append(CellSpec(
                cell_id=f"{model_key}/m{method}", model_key=model_key,
                network=network, ref_dataset=ref_ds, stand_in=stand_in,
                method=method, epochs=epochs,
                precision_policy=precision_policy))
    return cells


def _scan_matrix() -> list[CellSpec]:
    """The M6 cells under the device-resident feed and the scan window
    (auto: K = sync_every = 20), one CUDA graph a window on the card."""
    return [dataclasses.replace(c, cell_id=f"{c.model_key}/m6_scan",
                                feed="device", scan_window=0)
            for c in _matrix() if c.method == 6]


def _adaptive_cells() -> list[CellSpec]:
    """One adaptive config per model family (``registry.py:295-305``): the
    Method-6 preset with the variance controller reallocating the per-layer
    rates under the static method's own byte budget, so the adaptive
    cell's wire bytes are at most the static cell's."""
    return [dataclasses.replace(c, cell_id=f"{c.model_key}/adaptive",
                                adapt="variance")
            for c in _matrix() if c.method == 6]


def _federated_cells() -> list[CellSpec]:
    """The ``federated`` table: cohort size x heterogeneity x dropout over
    LeNet at pool 64, each cell a server-sampled local-SGD round loop on
    the homomorphic accumulator. The dropout cell kills three clients at
    round 1; the coordinator resamples their slots and excludes them from
    later draws."""
    base = dict(model_key="lenet_mnist", network="LeNet",
                ref_dataset="mnist", stand_in="mnist10k", method=4,
                epochs=1, federated=True, pool_size=64, local_steps=5)
    churn = "crash@3=1,crash@11=1,crash@42=1"
    axes = [
        ("fed_c4_iid", dict(cohort=4)),
        ("fed_c8_iid", dict(cohort=8)),
        ("fed_c16_iid", dict(cohort=16)),
        ("fed_c8_dir01", dict(cohort=8, partition="dirichlet",
                              partition_alpha=0.1)),
        ("fed_c8_shard", dict(cohort=8, partition="shard")),
        ("fed_c8_dir01_drop", dict(cohort=8, partition="dirichlet",
                                   partition_alpha=0.1, fed_dropout=churn)),
    ]
    return [CellSpec(cell_id=f"lenet_mnist/{name}", **base, **kw)
            for name, kw in axes]


#: name -> () -> ordered cell list (baseline_adaptive: the static grid and
#: one variance-driven adaptive cell per model family).
TABLES = {
    "baseline": lambda: _matrix(),
    "baseline_bf16": lambda: _matrix(precision_policy="bf16_wire_state"),
    "baseline_scan": lambda: _scan_matrix(),
    "baseline_adaptive": lambda: _matrix() + _adaptive_cells(),
    "federated": lambda: _federated_cells(),
}


def table_cells(name: str) -> list[CellSpec]:
    if name not in TABLES:
        raise ValueError(f"unknown table {name!r}; know {sorted(TABLES)}")
    cells = TABLES[name]()
    ids = [c.cell_id for c in cells]
    if len(ids) != len(set(ids)):
        raise ValueError(f"duplicate cell ids in {name}: {ids}")
    return cells
