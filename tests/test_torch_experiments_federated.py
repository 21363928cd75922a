"""The reproduction driver's ``federated`` table in the port, against the
JAX package, on the CPU.

Oracles, per test:
- every cell's resolved config, ``spec_hash`` (the ledger's key) and
  published row: exact, the JAX package's;
- one smoke cell through ``collect.run_cell``: structure (the row's
  federated keys, one decode a round, real data, the run's registry);
- the report's "Federated rounds" block: bit, the JAX report's lines for
  the same rows.
"""

import numpy as np
import pytest
import torch

from ewdml_tpu.experiments import registry as jregistry
from ewdml_tpu.experiments import report as jreport
from ewdml_tpu_torch.experiments import collect, registry, report

torch.set_num_threads(2)

CELLS = [c.cell_id for c in registry.table_cells("federated")]


def _cell(mod, cell_id):
    return {c.cell_id: c for c in mod.table_cells("federated")}[cell_id]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("cell_id", CELLS)
def test_federated_cell_spec_hash_equals_jax(cell_id, smoke):
    """Exact: the resolved config and the ledger key of every cell."""
    ours, theirs = _cell(registry, cell_id), _cell(jregistry, cell_id)
    assert ours.to_config(smoke=smoke).canonical_dict() == \
        theirs.to_config(smoke=smoke).canonical_dict()
    assert ours.spec_hash(smoke=smoke) == theirs.spec_hash(smoke=smoke)
    assert ours.published == theirs.published == {}
    assert ours.resolve_dataset() == theirs.resolve_dataset()


def test_federated_table_is_the_jax_sweep():
    cells = registry.table_cells("federated")
    assert [c.cell_id for c in cells] == [
        c.cell_id for c in jregistry.table_cells("federated")]
    assert {c.cohort for c in cells} == {4, 8, 16}
    for c in cells:
        cfg = c.to_config(smoke=True)
        assert cfg.federated and cfg.server_agg == "homomorphic"
        assert cfg.fed_rounds == 3 and cfg.momentum == 0.0


def _row(tmp_path):
    cfg = _cell(registry, "lenet_mnist/fed_c4_iid").to_config(
        train_dir=str(tmp_path / "cell"), smoke=True)
    cfg.platform = "cpu"
    return collect.run_cell(cfg, device="cpu")


def test_smoke_cell_through_collect(tmp_path):
    """Structure: the federated row of one smoke cell."""
    row = _row(tmp_path)
    assert row["mode"] == "federated" and row["rounds"] == 3
    assert row["decode_count"] == row["apply_rounds"] == 3
    assert row["planned_server_decodes"] == 1
    assert (row["cohort"], row["accept"], row["pool_size"]) == (4, 4, 64)
    assert row["data_source"] == "real" and 0.0 <= row["top1"] <= 1.0
    assert len(row["round_losses"]) == 3
    assert all(np.isfinite(row["round_losses"]))
    assert row["hardware"]["platform"] == "cpu"
    assert row["obs_metrics"]["gauges"]["federated.rounds_done"] == 3


ROW = {"mode": "federated", "rounds": 3, "cohort": 8,
       "partition": "dirichlet", "partition_alpha": 0.1, "skew": 0.7312,
       "final_loss": 1.2345, "top1": 0.5678, "decode_count": 3,
       "apply_rounds": 3, "dropouts": 3, "resampled": 3,
       "bytes_up_mb": 5.1724, "round_wall_ms_mean": 412.5,
       "data_source": "real", "dataset": "mnist10k", "stand_in": True,
       "cell": "lenet_mnist/fed_c8_dir01_drop"}


def _block(md: str) -> list:
    lines = md.splitlines()
    start = lines.index("## Federated rounds (pool-scale client sampling)")
    end = lines.index("", start + 2)
    return lines[start:end]


def test_report_federated_block_is_the_jax_one(tmp_path):
    """Bit: the block's lines for the same rows."""
    rows = {ROW["cell"]: ROW}
    blocks = []
    for mod, reg, name in ((report, registry, "port"),
                           (jreport, jregistry, "jax")):
        md, _ = mod.write_report("federated", reg.table_cells("federated"),
                                 rows, out_dir=str(tmp_path / name),
                                 smoke=True)
        with open(md) as f:
            blocks.append(_block(f.read()))
    assert blocks[0] == blocks[1]
    assert blocks[0][-1].startswith("| `fed_c8_dir01_drop` | 8 | "
                                    "dirichlet(α=0.1) | 0.7312 | 3 |")
