"""The port's sweep runner with real cell children
(``ewdml_tpu_torch/experiments/runner.py``), on the CPU (``--platform
cpu``): the JAX package's runner tests (``tests/test_experiments.py``),
each here under 20 s with LeNet smoke cells.

Oracles (exact, behaviour): a completed cell is skipped on re-invocation
by its ledger hash and launches no child; an injected crash is journaled
as a retry with the crash exit code, the next attempt resumes from the
checkpoint the cadence wrote and writes the only row, whose end-to-end
time folds in the crashed attempt; a child asked for CUDA with no GPU
raises and never trains on the CPU.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from ewdml_tpu_torch.experiments import runner
from ewdml_tpu_torch.parallel.faults import CRASH_EXIT_CODE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events(out_dir):
    return runner.Ledger(os.path.join(out_dir, "ledger.jsonl")).events()


def _of(events, kind, cell=None):
    return [e for e in events if e.get("event") == kind
            and (cell is None or e.get("cell") == cell)]


def _sweep(out_dir, cells, *extra):
    cmd = [sys.executable, "-m", "ewdml_tpu_torch.experiments", "--table",
           "baseline", "--smoke", "--platform", "cpu", "--out", out_dir,
           "--cells", *cells, *extra]
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_one_cell_sweep_then_reinvocation_skips_it(tmp_path):
    out = str(tmp_path / "repro")
    p = _sweep(out, ["lenet_mnist/m1"])
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    summary = json.loads(p.stdout.splitlines()[-2])
    assert summary["ran"] == ["lenet_mnist/m1"] and summary["failed"] == []
    assert summary["platform"] == "cpu"
    text = open(os.path.join(out, "REPRO.md")).read()
    assert "**Pending cells** (11)" in text
    assert "| Avg comm cost / iter (MB) | measured | 6.897 |" in text
    payload = json.load(open(os.path.join(out, "REPRO.json")))
    row = payload["cells"]["lenet_mnist/m1"]["row"]
    assert row["hardware"]["platform"] == "cpu"
    assert row["data_source"] == "real" and row["steps"] == 6

    p2 = _sweep(out, ["lenet_mnist/m1"])
    assert p2.returncode == 0, p2.stdout[-2000:] + p2.stderr[-2000:]
    ev = _events(out)
    skips = _of(ev, "cell_skipped", "lenet_mnist/m1")
    assert len(skips) == 1 and skips[0]["reason"] == "ledger hash match"
    # The second invocation launched no child: one start, one row.
    assert len(_of(ev, "cell_start", "lenet_mnist/m1")) == 1
    assert len(_of(ev, "cell_done", "lenet_mnist/m1")) == 1
    assert json.loads(p2.stdout.splitlines()[-2])["resumed_skipped"] == [
        "lenet_mnist/m1"]


def test_crash_clause_records_retry_and_resumes(tmp_path):
    out = str(tmp_path / "repro")
    summary = runner.run_sweep(
        "baseline", out_dir=out, smoke=True, platform="cpu",
        cells=["lenet_mnist/m4"], fault_spec="crash@0=3", attempts=2)
    assert summary["ran"] == ["lenet_mnist/m4"], summary
    assert summary["failed"] == []
    ev = _events(out)
    retries = _of(ev, "cell_retry", "lenet_mnist/m4")
    assert len(retries) == 1
    assert f"rc={CRASH_EXIT_CODE}" in retries[0]["reason"]
    # The crash at step 3 leaves only the cadence's step-2 checkpoint
    # (eval_freq 2), and the second attempt resumes there.
    assert retries[0]["resume_step"] == 2
    done = _of(ev, "cell_done", "lenet_mnist/m4")
    assert len(done) == 1 and done[0]["attempts"] == 2
    row = done[0]["row"]
    assert row["resumed_from_step"] == 2 and row["attempt"] == 2
    assert row["steps"] == 6
    assert row["metrics"]["comm_mb_per_iter"] > 0
    assert row["wall_s_all_attempts"] > row["wall_s"]
    assert row["metrics"]["end_to_end_min"] == pytest.approx(
        row["wall_s_all_attempts"] / 60.0, abs=1e-3)
    payload = json.load(open(os.path.join(out, "REPRO.json")))
    assert payload["cells"]["lenet_mnist/m4"]["attempts"] == 2


def test_cuda_child_without_a_gpu_raises(tmp_path):
    """A child given no --platform trains on CUDA; with no GPU it raises
    and prints no result (it never carries on on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: this checks the machine without one")
    cmd = [sys.executable, "-m", "ewdml_tpu_torch.experiments",
           "--run-cell", "lenet_mnist/m1", "--table", "baseline", "--smoke",
           "--out", str(tmp_path / "repro")]
    p = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "no GPU is visible" in p.stderr
    assert runner.RESULT_MARK not in p.stdout
    assert not os.path.exists(runner.cell_dirs(str(tmp_path / "repro"),
                                               "lenet_mnist/m1"))
