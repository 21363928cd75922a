"""The port's published-table reproduction (``ewdml_tpu_torch/experiments``)
against the JAX package's (``ewdml_tpu/experiments``), in process.

Oracles:
- exact: every cell's resolved config and ``spec_hash`` in the
  ``baseline``, ``baseline_bf16`` and ``baseline_scan`` tables, smoke and
  full; ``PUBLISHED``, ``epoch_cap``, ``_steps_per_epoch``; the report
  rendered from one rows dict by both packages (apart from the command
  line and the hardware lines); the wire fields of a cell's row against
  ``ewdml_tpu.train.metrics.wire_plan`` on the same resolved config.
- exact (behaviour): the ledger, the epoch-eval persistence and the
  budget oracle, as ``tests/test_experiments.py`` holds the JAX package's.
- observation only: loss and top-1 of the smoke cells
  (``tests/test_torch_slice*.py`` hold the trainer against the reference).

The subprocess runs (a sweep, its re-invocation, a crash and its resume, a
child with no GPU) are in ``test_torch_experiments_sweep.py``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from ewdml_tpu.experiments import registry as jregistry
from ewdml_tpu.experiments import report as jreport
from ewdml_tpu_torch.experiments import collect, registry, report, runner

torch.set_num_threads(2)

TABLES = ("baseline", "baseline_bf16", "baseline_scan", "baseline_adaptive")
CELLS = [(t, c.cell_id) for t in TABLES for c in registry.table_cells(t)]


def _cell(mod, table, cell_id):
    return {c.cell_id: c for c in mod.table_cells(table)}[cell_id]


# -- the registry: exact against the JAX package --------------------------

@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("table,cell_id", CELLS)
def test_resolved_config_and_spec_hash_equal_jax(table, cell_id, smoke):
    """Exact: the same resolved config and ledger key in both packages."""
    ours, theirs = _cell(registry, table, cell_id), _cell(jregistry, table,
                                                          cell_id)
    assert ours.to_config(smoke=smoke).canonical_dict() == \
        theirs.to_config(smoke=smoke).canonical_dict()
    assert ours.spec_hash(smoke=smoke) == theirs.spec_hash(smoke=smoke)
    assert ours.epoch_cap == theirs.epoch_cap
    assert ours.published == theirs.published
    assert ours.resolve_dataset() == theirs.resolve_dataset()


@pytest.mark.parametrize("dataset,batch,world", [
    ("mnist10k", 64, 2), ("mnist10k32", 4, 2), ("mnist", 16, 2),
    ("cifar10", 64, 2), ("mnist10k", 8, 8)])
def test_steps_per_epoch_equal_jax(dataset, batch, world):
    """Exact: the epoch geometry the cells are planned with."""
    assert registry._steps_per_epoch(dataset, batch, world) == \
        jregistry._steps_per_epoch(dataset, batch, world)


def test_published_numbers_and_labels_equal_jax():
    """Exact: BASELINE.md as data, the labels and the reference hardware."""
    assert registry.PUBLISHED == jregistry.PUBLISHED
    assert registry.METHOD_LABELS == jregistry.METHOD_LABELS
    assert registry.REFERENCE_HARDWARE == jregistry.REFERENCE_HARDWARE
    assert set(registry.TABLES) == set(jregistry.TABLES)


@pytest.mark.parametrize("table,item", [("baseline_adaptive", "item 7")])
def test_unported_tables_raise_by_name(table, item):
    """Exact: the table that waited for ROADMAP Queue 1 ``item`` (adapt/)
    now resolves to the JAX package's cells, its adaptive cells the M6
    presets with ``--adapt variance``; no table raises."""
    del item
    ours, theirs = registry.table_cells(table), jregistry.table_cells(table)
    assert [c.cell_id for c in ours] == [c.cell_id for c in theirs]
    adaptive = [c for c in ours if c.adapt != "off"]
    assert [c.cell_id for c in adaptive] == ["lenet_mnist/adaptive",
                                             "vgg11_cifar10/adaptive"]
    for c in adaptive:
        assert (c.method, c.adapt, c.published) == (6, "variance", {})
        assert c.to_config(smoke=True).adapt_every == 2
        assert c.to_config().adapt_every == 50
    for name in registry.TABLES:
        registry.table_cells(name)


def test_baseline_table_is_the_published_matrix():
    cells = registry.table_cells("baseline")
    assert len(cells) == 12
    assert [c.method for c in cells] == [1, 2, 3, 4, 5, 6] * 2
    for c in cells:
        assert (c.batch_size, c.momentum, c.num_workers) == (64, 0.9, 2)
    assert {c.epochs for c in cells[:6]} == {20}
    assert {c.epochs for c in cells[6:]} == {50}
    scan = registry.table_cells("baseline_scan")
    assert [c.cell_id for c in scan] == ["lenet_mnist/m6_scan",
                                         "vgg11_cifar10/m6_scan"]
    assert all(c.feed == "device" for c in scan)


def test_no_silent_synthetic_fallback(tmp_path):
    from ewdml_tpu_torch.data import datasets

    spec = registry.table_cells("baseline")[0]
    with pytest.raises(FileNotFoundError):
        spec.resolve_dataset(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        datasets.load("mnist10k", str(tmp_path), require_real=True)
    with pytest.raises(ValueError):
        datasets.load("mnist10k", require_real=True, synthetic=True)
    assert datasets.has_real("mnist10k") and not datasets.has_real(
        "cifar10", str(tmp_path))
    assert datasets.load("mnist10k", require_real=True).source == "real"


def test_spec_hash_tracks_content():
    spec = registry.table_cells("baseline")[0]
    h1 = spec.spec_hash(smoke=True)
    assert h1 == spec.spec_hash(smoke=True)
    assert h1 != spec.spec_hash(smoke=False)
    assert h1 != dataclasses.replace(spec, lr=0.02).spec_hash(smoke=True)
    assert h1 != registry.table_cells("baseline_bf16")[0].spec_hash(
        smoke=True)
    # smoke cells compute in f32, full cells under bf16 autocast
    assert spec.to_config(smoke=True).bf16_compute is False
    assert spec.to_config(smoke=False).bf16_compute is True


# -- the ledger, the epoch evals, the budget oracle ------------------------

def test_ledger_round_trip_and_torn_tail(tmp_path):
    led = runner.Ledger(str(tmp_path / "ledger.jsonl"))
    led.append(event="cell_start", cell="a", spec_hash="h1", attempt=1)
    led.append(event="cell_done", cell="a", spec_hash="h1", row={"x": 1},
               attempts=1)
    with open(led.path, "a") as f:
        f.write('{"event": "cell_done", "cell": "b", "ro')
    ev = led.events()
    assert [e["event"] for e in ev] == ["cell_start", "cell_done"]
    done = runner.completed_rows(ev)
    assert done["a"][0] == "h1" and done["a"][1] == {"x": 1}


def test_ledger_latest_done_wins_and_attempt_bookkeeping(tmp_path):
    led = runner.Ledger(str(tmp_path / "ledger.jsonl"))
    led.append(event="cell_done", cell="a", spec_hash="h1", row={"v": 1})
    led.append(event="cell_done", cell="a", spec_hash="h2", row={"v": 2})
    assert runner.completed_rows(led.events())["a"][1] == {"v": 2}
    events = [
        {"event": "cell_start", "cell": "c", "spec_hash": "h", "ts": 10.0},
        {"event": "cell_retry", "cell": "c", "ts": 14.5},
        {"event": "cell_start", "cell": "c", "spec_hash": "old", "ts": 20.0},
        {"event": "cell_retry", "cell": "c", "ts": 29.0},
        {"event": "cell_start", "cell": "c", "spec_hash": "h", "ts": 30.0},
    ]
    # Only the failed attempt of the current spec counts.
    assert runner._journaled_attempt_seconds(events, "c", "h") == 4.5
    assert runner._journaled_attempt_count(events, "c", "h") == 2


def test_epoch_evals_round_trip_filters_to_restored_epoch(tmp_path):
    path = str(tmp_path / "cell" / "epoch_evals.json")
    evals = [{"epoch": e, "top1": 0.5 + e / 100} for e in (1, 2, 3)]
    collect._save_epoch_evals(path, evals)
    assert collect._load_epoch_evals(path, start_epoch=2) == evals[:2]
    assert collect._load_epoch_evals(path, start_epoch=3) == evals


def test_epoch_evals_missing_or_torn_file_is_empty(tmp_path):
    assert collect._load_epoch_evals(None, 5) == []
    assert collect._load_epoch_evals(str(tmp_path / "nope.json"), 5) == []
    torn = tmp_path / "torn.json"
    torn.write_text('[{"epoch": 1, "to')
    assert collect._load_epoch_evals(str(torn), 5) == []


def test_budget_oracle_stops_at_budget_when_target_met():
    """Exact (behaviour): trains to the published budget once the target
    is met, never into the headroom; timing summed over the epoch loop."""
    from ewdml_tpu_torch.core.config import TrainConfig

    cfg = TrainConfig(
        network="LeNet", dataset="MNIST", batch_size=8, synthetic_data=True,
        synthetic_size=128, lr=0.01, epochs=3, max_steps=10**9,
        eval_freq=0, log_every=10**9, bf16_compute=False, num_workers=8,
        test_batch_size=128)  # spe = 128 / (8 * 8) = 2
    row = collect.run_cell(cfg, device="cpu", evaluate=True,
                           target_top1=0.0, max_epochs=3, budget_epochs=2,
                           per_epoch_eval=True, resume=False)
    assert row["steps_per_epoch"] == 2
    assert row["epochs_to_target"] == 1
    assert row["epochs_trained"] == 2
    assert row["steps"] == 2 * row["steps_per_epoch"]
    # Each train() call's first step is compile time: one counted step
    # per 2-step epoch, from both epochs.
    assert row["timing"]["steps"] == 2
    assert row["timing"]["compile_s"] > 0
    assert row["metrics"]["epochs_to_converge"] == 1
    assert row["comm_split_source"] == "bytes_est"
    assert row["hardware"]["platform"] == "cpu"


# -- the report: exact against the JAX reporter ----------------------------

def _fake_row(cell, top1=0.97):
    return {
        "cell": cell, "steps": 6, "resumed_from_step": 0,
        "mean_step_ms": 1.0, "wire_mb_per_step_worker": 3.28,
        "bytes_reduction_vs_dense": 1.0, "dataset": "mnist10k",
        "data_source": "real", "stand_in": True,
        "target_top1": None, "epochs_to_target": None,
        "metrics": {"comm_mb_per_iter": 6.56, "top1_pct": top1 * 100,
                    "end_to_end_min": 0.2, "comm_min_est": 0.01,
                    "comp_min_est": 0.19},
        "hardware": {"platform": "gpu", "device_kind": "NVIDIA H100",
                     "device_count": 1, "mesh_devices": 2, "hostname": "h",
                     "jax": "0", "jaxlib": "0", "torch": "2", "cuda": "12",
                     "name_power_limit": "NVIDIA H100, 700.00 W",
                     "os": "linux"},
    }


def _rows():
    rows = {"lenet_mnist/m1": _fake_row("lenet_mnist/m1"),
            "vgg11_cifar10/m6": _fake_row("vgg11_cifar10/m6", 0.8)}
    full = _fake_row("lenet_mnist/m4")
    full["target_top1"] = 0.98
    full["metrics"]["epochs_to_converge"] = None
    full["metrics"]["comm_min"] = full["metrics"].pop("comm_min_est")
    rows["lenet_mnist/m4"] = full
    done = _fake_row("vgg11_cifar10/m2")
    done["target_top1"] = 0.83
    done["metrics"]["epochs_to_converge"] = 41
    rows["vgg11_cifar10/m2"] = done
    return rows


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_report_renders_as_the_jax_reporter(tmp_path, smoke):
    """Exact: one rows dict through both reporters gives the same REPRO.md
    apart from the command line and the hardware lines, and the same
    REPRO.json apart from the hardware signatures."""
    attempts = {"lenet_mnist/m1": 2}
    summary = {"ran": list(_rows())}
    outs = {}
    for name, mod, reg in (("port", report, registry),
                           ("jax", jreport, jregistry)):
        md, js = mod.write_report(
            "baseline", reg.table_cells("baseline"), _rows(),
            out_dir=str(tmp_path / name), smoke=smoke, attempts=attempts,
            summary=summary)
        outs[name] = (open(md).read().splitlines(), json.load(open(js)))
    (ours, our_js), (theirs, their_js) = outs["port"], outs["jax"]
    assert len(ours) == len(theirs)
    differ = [i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b]
    assert [ours[i].split(":")[0] for i in differ] == [
        "One command", "- **this run**"]
    assert "`python -m ewdml_tpu_torch.experiments --table baseline" in \
        ours[differ[0]]
    assert "NVIDIA H100, 700.00 W" in ours[differ[1]]
    assert "| | published | 6.56 | 4.1 | 6.56 | 1.64 | 1.312 | 0.06 |" \
        in ours
    our_js.pop("hardware_signatures")
    their_js.pop("hardware_signatures")
    assert our_js == their_js


def test_report_mixed_hardware_names_each_card(tmp_path):
    rows = _rows()
    rows["lenet_mnist/m4"]["hardware"] = dict(
        rows["lenet_mnist/m4"]["hardware"],
        name_power_limit="NVIDIA H100, 500.00 W")
    md, js = report.write_report("baseline", registry.table_cells("baseline"),
                                 rows, out_dir=str(tmp_path), smoke=False)
    text = open(md).read()
    assert "**MIXED HARDWARE**" in text and "500.00 W" in text
    assert "| Epochs to converge | measured | — | — | — | >30 |" in text
    assert len(json.load(open(js))["hardware_signatures"]) == 2


# -- one cell in process: the row's wire fields, exact ---------------------

def _jax_wire_plan(cfg_dict):
    import flax

    from ewdml_tpu.core.config import TrainConfig as JConfig
    from ewdml_tpu.models import build_model as jbuild
    from ewdml_tpu.models import init_variables
    from ewdml_tpu.train.metrics import wire_plan

    jcfg = JConfig(**cfg_dict)
    jparams = jax.eval_shape(lambda: init_variables(
        jbuild(jcfg.network, 10), jax.random.key(0),
        jnp.zeros((2, 28, 28, 1))))["params"]
    return wire_plan(jcfg, flax.core.unfreeze(jparams),
                     world=jcfg.num_workers)


@pytest.mark.parametrize("cell_id", ["lenet_mnist/m1", "lenet_mnist/m5"])
def test_cell_row_wire_fields_equal_jax_wire_plan(tmp_path, capsys,
                                                  cell_id):
    """Exact: the wire fields of an in-process smoke cell's row equal the
    JAX package's wire plan of the same resolved config. Loss and top-1
    are observations only."""
    rc = runner.run_cell_child("baseline", cell_id, out_dir=str(tmp_path),
                               data_dir="data/", smoke=True, platform="cpu")
    assert rc == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(runner.RESULT_MARK)][-1]
    row = json.loads(line[len(runner.RESULT_MARK):])
    cfg = _cell(jregistry, "baseline", cell_id).to_config(smoke=True)
    plan = _jax_wire_plan(cfg.canonical_dict(exclude=()))
    w = cfg.num_workers
    m = row["metrics"]
    assert m["comm_mb_per_iter"] == round(plan.per_step_bytes * w / 1e6, 4)
    assert m["exchange_mb_per_rank_iter"] == round(
        plan.per_rank_exchange_bytes / 1e6, 4)
    assert m["transport"] == plan.transport
    assert row["wire_mb_per_step_worker"] == round(
        plan.per_step_bytes / 1e6, 4)
    assert row["bytes_reduction_vs_dense"] == round(
        plan.dense_bytes / max(1.0, plan.per_step_bytes), 1)
    assert row["wire_dtype"] == plan.wire_dtype
    assert row["overlap_buckets"] == len(plan.per_bucket_bytes)
    assert row["world"] == w and row["steps"] == cfg.max_steps
    assert row["data_source"] == "real" and row["stand_in"] is True
    assert row["comm_split_source"] == "bytes_est"
    assert 0 <= row["metrics"]["top1_pct"] <= 100  # observation only


# -- the health watchdog and nan@ clauses in a cell (ported) --------------

@pytest.mark.parametrize("health,fault_spec,what", [
    ("warn", "", "--health warn"), ("abort", "", "--health abort"),
    ("off", "crash@0=2,nan@0=3", "nan@")])
def test_health_and_nan_clauses_rejected_by_name(tmp_path, capsys, health,
                                                 fault_spec, what):
    """Once rejected by name, now ported (the name is kept): ``--health``
    reaches the cell's trainer and ``nan@`` clauses parse beside the
    others. Exact (behaviour): under ``warn`` a nan clause is journaled in
    the cell's ``health.jsonl`` and the cell completes; a healthy cell
    under ``abort`` completes with no event; with the watchdog off a nan
    clause is inert and the crash clause beside it fires."""
    from ewdml_tpu_torch.obs.health import read_events
    from ewdml_tpu_torch.parallel.faults import CRASH_EXIT_CODE

    out = str(tmp_path)
    spec = fault_spec or ("nan@0=2" if health == "warn" else "")
    rc = runner.run_cell_child("baseline", "lenet_mnist/m1", out_dir=out,
                               data_dir="data/", smoke=True, platform="cpu",
                               fault_spec=spec, health=health)
    printed = capsys.readouterr().out
    events = read_events(os.path.join(
        runner.cell_dirs(out, "lenet_mnist/m1"), "health.jsonl"))
    if health == "off":
        assert rc == CRASH_EXIT_CODE and events == []
        assert "CELL_FAULT_CRASH lenet_mnist/m1 at step 2" in printed
        return
    assert rc == 0 and runner.RESULT_MARK in printed
    assert [e["kind"] for e in events] == (["nan"] if health == "warn"
                                           else [])


def test_cli_repro_route_reaches_the_sweep():
    from ewdml_tpu_torch import cli

    # The sweep resolves the table first: an unknown name fails there.
    with pytest.raises(ValueError, match="unknown table 'nope'.*"
                                         "baseline_adaptive"):
        cli.main(["repro", "--table", "nope", "--platform", "cpu"])


# -- the bytes estimate's counter ------------------------------------------

def test_count_bytes_counts_ops_and_kernel_tallies(monkeypatch):
    """Exact: each aten op's operands read once and results written once,
    views and allocations nothing, and a kernel launch the bytes its
    wrapper reports (the kernels bypass the dispatcher)."""
    from ewdml_tpu_torch.ops import kernels
    from ewdml_tpu_torch.train.flops import count_bytes

    a, b = torch.ones(1000), torch.ones(1000)
    # add: 2 x 4000 read + 4000 written; sum: 4000 read + 4 written
    assert count_bytes(lambda: (a + b).sum()) == 16004
    assert count_bytes(lambda: (a.view(10, 100).t(), torch.empty(50))) == 0
    monkeypatch.setitem(kernels.LAUNCHES, "acc_decode", 0)
    acc = torch.zeros(10, dtype=torch.int32)
    scales, out = torch.ones(1), torch.empty(10)
    assert count_bytes(kernels._count, "acc_decode", acc, scales,
                       out) == 40 + 4 + 40
    assert kernels.LAUNCHES["acc_decode"] == 1
    assert kernels._byte_tallies == []


def test_delay_clause_sleeps_its_cell_only():
    """Exact (behaviour): ``delay@I=S`` makes cell I's child sleep S
    seconds before training, and no other cell."""
    import time

    from ewdml_tpu_torch.parallel.faults import FaultSpec

    spec = FaultSpec.parse("delay@1=0.05,crash@0=3")
    t0 = time.perf_counter()
    assert spec.for_worker(1).sleep_if_due() == 0.05
    assert time.perf_counter() - t0 >= 0.05
    assert spec.for_worker(0).sleep_if_due() == 0.0
    assert spec.for_worker(0).crash_at == 3
