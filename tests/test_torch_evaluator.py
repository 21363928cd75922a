"""The port's polling evaluator (``train/evaluator.py``) and single-device
trainer (``train/single.py``) against the JAX package's, and the CLI's
checkpoint, resume and evaluator drive on the CPU.

Oracles:
- tolerance: one poll of the port's evaluator on a JAX-written checkpoint
  (LeNet ``mnist10k``, W = 4, M3, 2 steps) gives the loss of JAX's
  ``DistributedEvaluator.evaluate_once`` within 1e-5 relative (the two sum
  1 000 per-example losses in another order), top-1 and top-5 equal.
- exact: an unchanged mtime means no second evaluation; a new checkpoint
  is evaluated.
- tolerance: the port's ``NNTrainer`` and the JAX one, from the same
  converted LeNet parameters on the same 12 batches of ``mnist10k``,
  end within 1e-5 of each leaf's largest value (float32 rounding: the
  gradients agree to f32 rounding and XLA contracts the update into FMAs),
  train loss within 1e-5 and validation loss within 1e-5 relative,
  top-1 equal.
- exact: the CLI line of the acceptance criteria (6 steps, eval-freq 3)
  writes the checkpoint and a trace shard; a second run with 9 steps
  resumes from step 6; the evaluator evaluates step 9.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ewdml_tpu.core.config import TrainConfig as JConfig
from ewdml_tpu.train.evaluator import DistributedEvaluator as JEvaluator
from ewdml_tpu.train.loop import Trainer as JTrainer
from ewdml_tpu.train.single import NNTrainer as JNNTrainer
from ewdml_tpu_torch import cli
from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.models.convert import torch_to_flax
from ewdml_tpu_torch.obs import trace
from ewdml_tpu_torch.train import checkpoint
from ewdml_tpu_torch.train import evaluator
from ewdml_tpu_torch.train.evaluator import DistributedEvaluator
from ewdml_tpu_torch.train.single import NNTrainer

torch.set_num_threads(2)

CFG = dict(network="LeNet", dataset="mnist10k", batch_size=8, lr=0.01,
           max_steps=2, eval_freq=2, epochs=100, log_every=1000,
           bf16_compute=False, num_workers=4, method=3, seed=42)


@pytest.fixture(autouse=True)
def _no_tracer():
    trace.shutdown(flush=False)
    yield
    trace.shutdown(flush=False)


def test_evaluator_matches_jax_on_a_jax_checkpoint(tmp_path):
    train_dir = str(tmp_path) + "/"
    JTrainer(JConfig(train_dir=train_dir, **CFG)).train()
    path = checkpoint.latest_path(train_dir)
    want = JEvaluator(JConfig(train_dir=train_dir, **CFG)).evaluate_once(path)
    ev = DistributedEvaluator(TrainConfig(platform="cpu", train_dir=train_dir,
                                          **CFG))
    (got,) = list(ev.evaluate(interval_s=0, max_polls=1))
    assert got["step"] == 2 and got["examples"] == want["examples"] == 1000
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert (got["top1"], got["top5"]) == (want["top1"], want["top5"])


def test_an_unchanged_checkpoint_is_evaluated_once(tmp_path):
    cfg = TrainConfig(platform="cpu", train_dir=str(tmp_path) + "/",
                      **dict(CFG, dataset="MNIST", synthetic_data=True,
                             synthetic_size=64))
    from ewdml_tpu_torch.train.loop import Trainer

    t = Trainer(cfg)
    t.train()
    ev = DistributedEvaluator(cfg)
    polls = ev.evaluate(interval_s=0, max_polls=4)
    assert next(polls)["step"] == 2
    # The same file, twice more: no evaluation; then a newer save.
    t.train(max_steps=4)
    assert [r["step"] for r in polls] == [4]
    assert ev.metrics.snapshot()["counters"]["eval.polls"] == 4


def test_evaluator_and_single_trainer_refuse_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal is what a CPU host sees")
    with pytest.raises(RuntimeError, match="no GPU"):
        DistributedEvaluator(TrainConfig(**dict(CFG, platform=None)))
    with pytest.raises(RuntimeError, match="no GPU"):
        NNTrainer("LeNet", "mnist10k")


@pytest.mark.parametrize("kw,flag", [
    (dict(metrics_port=0), "--metrics-port"),
    (dict(health="warn"), "--health warn"),
])
def test_evaluator_rejects_the_serving_flags(tmp_path, kw, flag, capsys):
    """Exact: the evaluator takes every trainer flag. ``--metrics-port``
    is served: ``main`` prints ``EVALUATOR_METRICS <port>`` before its
    polls, the endpoint answers with the evaluator's registry while it
    runs, and the evaluator closes it at the end; ``--health``, which it
    never reads, is accepted and ignored, as in the JAX package."""
    cfg = TrainConfig(platform="cpu", train_dir=str(tmp_path) + "/",
                      **dict(CFG, **kw))
    if flag == "--health warn":
        ev = DistributedEvaluator(cfg)
        # No checkpoint yet: one poll, nothing evaluated, no watchdog.
        assert list(ev.evaluate(interval_s=0, max_polls=1)) == []
        assert not os.path.exists(tmp_path / "health.jsonl")
        return
    import json
    import urllib.request

    ev = DistributedEvaluator(cfg)
    try:
        assert list(ev.evaluate(interval_s=0, max_polls=2)) == []
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{ev.live.port}/metrics.json",
            timeout=10).read())
        assert doc["role"] == "evaluator"
        assert doc["metrics"]["counters"]["eval.polls"] == 2
    finally:
        ev.close()
    from ewdml_tpu_torch.train import evaluator

    argv = ["--platform", "cpu", "--train-dir", str(tmp_path) + "/",
            "--metrics-port", "0", "--max-polls", "1",
            "--eval-interval", "0"] + [
        f"--{k.replace('_', '-')}={v}" for k, v in CFG.items()
        if k in ("network", "dataset", "num_workers", "method", "seed")]
    assert evaluator.main(argv) == 0
    first = capsys.readouterr().out.splitlines()[0].split()
    assert first[0] == "EVALUATOR_METRICS" and int(first[1]) > 0


def test_single_trainer_matches_jax():
    kw = dict(network="LeNet", dataset="mnist10k", batch_size=32, lr=0.01,
              momentum=0.9, seed=7)
    jt = JNNTrainer(**kw)
    tt = NNTrainer(platform="cpu", **kw)
    tt.load_flax_state(jax.tree.map(np.asarray, jt.params))
    (jr,) = jt.train_and_validate(epochs=1, max_steps_per_epoch=12)
    (tr,) = tt.train_and_validate(epochs=1, max_steps_per_epoch=12)
    jp = jax.tree.map(np.asarray, jt.params)
    tp = torch_to_flax(tt.model)[0]
    for name in ("conv1", "conv2", "fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            ref = np.asarray(jp[name][leaf], np.float64)
            np.testing.assert_allclose(tp[name][leaf], ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=f"{name}/{leaf}")
    assert tr.train_loss == pytest.approx(jr.train_loss, rel=1e-5)
    assert tr.val_loss == pytest.approx(jr.val_loss, rel=1e-5)
    assert tr.val_top1 == jr.val_top1


def test_cli_checkpoints_resumes_and_is_evaluated(tmp_path, capsys, caplog):
    d, tdir = str(tmp_path / "D") + "/", str(tmp_path / "T")
    line = ["--platform", "cpu", "--network", "LeNet", "--dataset",
            "mnist10k", "--num-workers", "4", "--method", "4",
            "--eval-freq", "3", "--batch-size", "8", "--no-bf16",
            "--train-dir", d, "--trace-dir", tdir]
    assert cli.main(line + ["--max-steps", "6"]) == 0
    assert checkpoint.peek_step(os.path.join(d, "model_step_")) == 6
    trace.shutdown()
    shards = os.listdir(tdir)
    assert len(shards) == 1 and shards[0].startswith("shard-trainer-")
    assert "done: steps=6" in capsys.readouterr().out
    caplog.set_level("INFO", logger="ewdml_tpu_torch")
    assert cli.main(line + ["--max-steps", "9"]) == 0
    assert "done: steps=9" in capsys.readouterr().out
    assert "model_step_ at step 6 (world=0)" in caplog.text
    assert checkpoint.peek_step(os.path.join(d, "model_step_")) == 9
    assert evaluator.main(line[:-2] + ["--max-polls", "1"]) == 0
    out = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("validation ")]
    assert len(out) == 1
    result = json.loads(out[0][len("validation "):])
    assert result["step"] == 9 and result["examples"] == 1000
