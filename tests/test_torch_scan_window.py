"""The port's scan window (``--scan-window``; ``train/trainer.make_window_step``,
``train/window.py``) and its key table (``utils/keytable.py``).

The contract of ``tests/test_scan_window.py``: one K-step window is
bit-identical to K per-step dispatches, every parameter, BatchNorm statistic,
momentum buffer, residual and metrics row. On the CPU the window is the same
K steps in a loop with their keys, seeds, batch starts and draws read from a
key table; on the GPU one CUDA graph (``tests/test_torch_cuda.py``).

Oracles:
- bit: window against per-step (dense, M4, M6 with adoption inside a
  window, K-of-N with error feedback, M5; windows that start on and off a
  period boundary); the key table against the host chain and against
  ``pallas_kernels.seed_from_key`` of the JAX chain; the table derived again
  for another window against one recorded there.
- exact: ``resolve_scan_window`` against ``ewdml_tpu.core.config``'s on the
  cases of ``tests/test_scan_window.py::TestResolve``; the loop's launch
  count and log cadence.
"""

import jax
import numpy as np
import pytest
import torch

from ewdml_tpu.core.config import TrainConfig as JConfig
from ewdml_tpu.core.config import resolve_scan_window as jresolve
from ewdml_tpu.ops import pallas_kernels
from ewdml_tpu_torch import cli
from ewdml_tpu_torch.core.config import TrainConfig, resolve_scan_window
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.train.loop import Trainer
from ewdml_tpu_torch.train.trainer import RELAY_TAG, make_window_step
from ewdml_tpu_torch.utils import prng
from ewdml_tpu_torch.utils.keytable import KeyTable

torch.set_num_threads(2)

K = 4
W = 4


BASE = dict(network="LeNet", dataset="MNIST", batch_size=4, lr=0.01,
            synthetic_data=True, synthetic_size=64, max_steps=8,
            epochs=1000, log_every=1000, bf16_compute=False, feed="device",
            num_workers=W, platform="cpu")


@pytest.fixture(autouse=True)
def _restore_modes():
    kernels.configure("auto")
    yield
    kernels.configure("auto")


@pytest.fixture(autouse=True)
def _train_dir(tmp_path, monkeypatch):
    """``Trainer.train`` saves a checkpoint at its end: into the test's own
    directory."""
    monkeypatch.setitem(BASE, "train_dir", str(tmp_path) + "/")


def _cfg(after=None, **kw):
    cfg = TrainConfig(**dict(BASE, **kw))
    for k, v in (after or {}).items():   # set after the method preset
        setattr(cfg, k, v)
    return cfg


RESOLVE_CASES = [dict(feed="u8"), dict(feed="f32", scan_window=16),
                 dict(method=6), dict(sync_every=5), dict(),
                 dict(log_every=3), dict(scan_window=12),
                 dict(adapt="auto", scan_window=4)]


@pytest.mark.parametrize("kw", RESOLVE_CASES)
def test_resolve_matches_jax(tmp_path, kw):
    base = dict(network="LeNet", dataset="MNIST", batch_size=4,
                synthetic_data=True, synthetic_size=64, max_steps=8,
                epochs=1000, eval_freq=0, log_every=1000, feed="device")
    base.update(kw)
    got = resolve_scan_window(TrainConfig(**base))
    assert got == jresolve(JConfig(train_dir=str(tmp_path) + "/", **base))
    if kw.get("feed") in ("u8", "f32") or "adapt" in kw:
        assert got == 1


def test_window_step_rejects_streaming_feeds_and_adapt():
    t = Trainer(_cfg(scan_window=K))
    with pytest.raises(ValueError, match="feed device"):
        make_window_step(t.model, t.optimizer, _cfg(feed="u8"), t.world, K)
    with pytest.raises(ValueError, match="adapt"):
        make_window_step(t.model, t.optimizer, _cfg(after=dict(adapt="auto")),
                         t.world, K)
    with pytest.raises(ValueError, match=">= 1"):
        make_window_step(t.model, t.optimizer, t.cfg, t.world, 0)
    assert Trainer(_cfg(feed="u8", scan_window=K)).window_step is None


def _state(t) -> list:
    out = []
    for ws in t.state.workers:
        out += list(ws.model.state_dict().values()) + list(ws.residual)
        st = ws.opt_state
        out += ([st.count] + list(st.mu) + list(st.nu) if hasattr(st, "mu")
                else list(st.momentum_buf))
    return out


CASES = {
    "dense": dict(method=3),
    "m4": dict(method=4),
    "m5": dict(method=5, topk_ratio=0.1),
    "m6_adopt": dict(method=6, topk_ratio=0.1, after=dict(sync_every=4)),
    "kofn_ef": dict(method=4, num_aggregate=2, error_feedback=True),
    # The precision policy's seeded stores and Adam's device count take
    # their keys from the window's key table.
    "bf16_state_adam_ef": dict(method=4, error_feedback=True,
                               optimizer="adam",
                               precision_policy="bf16_wire_state"),
    "bf16_state_overlap_ef": dict(method=4, error_feedback=True,
                                  precision_policy="bf16_wire_state",
                                  overlap="bucket", overlap_buckets=2),
}


@pytest.mark.parametrize("lead", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("case", list(CASES))
def test_window_matches_k_per_step_dispatches(case, lead):
    """``lead`` per-step dispatches, then two windows of K, against
    ``lead + 2K`` per-step dispatches. With ``lead = 1`` the windows start
    off every period: M6 syncs (and adopts) inside them, at steps 3 and 7,
    and the K-of-N rotation starts at rank 1."""
    steps = lead + 2 * K
    ref = Trainer(_cfg(scan_window=1, **CASES[case]))
    t = Trainer(_cfg(scan_window=K, **CASES[case]))
    assert ref.window_step is None and t.scan_window == K
    X, Y = t._device_split(t._train_split())
    rows = [t.train_step(t.state, X, Y, t.base_key) for _ in range(lead)]
    for _ in range(2):
        stacked = t.window_step(t.state, X, Y, t.base_key)
        assert stacked.shape == (K, W, 3)
        rows += list(stacked)
    rx, ry = ref._device_split(ref._train_split())
    ref_rows = [ref.train_step(ref.state, rx, ry, ref.base_key)
                for _ in range(steps)]
    assert t.state.step == ref.state.step == steps
    for j, (a, b) in enumerate(zip(rows, ref_rows)):
        assert torch.equal(a, b), j
    for a, b in zip(_state(t), _state(ref)):
        assert torch.equal(a, b)
    if case == "m6_adopt":
        assert t.window_step.phase(1) == (1, 0)
    if case == "kofn_ef":
        assert t.window_step.phase(1) == (0, 1)


def _jax_seed(seed: int, step: int, *folds) -> int:
    k = jax.random.fold_in(jax.random.key(seed), step)
    for d in folds:
        k = jax.random.fold_in(k, d)
    return int(pallas_kernels.seed_from_key(k))


def test_key_table_is_the_host_chain_and_the_jax_seeds():
    """One M4 step with its keys from a table (``--pallas interpret``: every
    unit takes the murmur stream): per unit, W rank seeds then the relay's,
    each ``seed_from_key`` of the chain; then the table derived again for a
    window in the next epoch equals one recorded there."""
    cfg = _cfg(method=4, pallas="interpret", scan_window=K)
    t = Trainer(cfg)
    X, Y = t._device_split(t._train_split())
    body = t.window_step.body
    table = KeyTable(t.base_key, "cpu", start=2)
    t.state.step = 2
    body(t.state, X, Y, table)
    seeds = table.values()["seeds"]
    units = len(seeds) // (W + 1)
    assert units >= 1 and len(seeds) == units * (W + 1)
    base = prng.key(cfg.seed)
    skey = prng.step_key(base, 2)
    want = []
    for i in range(units):
        want += [prng.seed_from_key(prng.layer_key(prng.rank_key(skey, r), i))
                 for r in range(W)]
        want.append(prng.seed_from_key(
            prng.layer_key(prng.fold_in(skey, RELAY_TAG), i)))
    assert seeds.tolist() == want
    jwant = []
    for i in range(units):
        jwant += [_jax_seed(cfg.seed, 2, r, i) for r in range(W)]
        jwant.append(_jax_seed(cfg.seed, 2, RELAY_TAG, i))
    assert want == jwant
    # 64 examples, global batch 16: step 5 is in epoch 1.
    table.load(5)
    fresh = KeyTable(t.base_key, "cpu", start=5)
    t.state.step = 5
    body(t.state, X, Y, fresh)
    for k, v in fresh.values().items():
        np.testing.assert_array_equal(table.values()[k], v, err_msg=k)


def test_loop_launches_one_window_per_k_steps_and_a_per_step_tail():
    t = Trainer(_cfg(method=3, scan_window=K, max_steps=10))
    calls = {"window": 0, "step": 0}
    w0, s0 = t.window_step, t.train_step

    class Counting:
        def __init__(self, fn, name):
            self.fn, self.name = fn, name
            self.capture_s = 0.0

        def __call__(self, *a):
            calls[self.name] += 1
            return self.fn(*a)

        def stream_context(self):
            return w0.stream_context()

        stream = None

    t.window_step, t.train_step = Counting(w0, "window"), Counting(s0, "step")
    res = t.train()
    assert res.steps == 10 and t.state.step == 10
    assert calls == {"window": 2, "step": 2}, calls
    # Every step's metrics row, and the state, as the per-step loop's.
    ref = Trainer(_cfg(method=3, scan_window=1, max_steps=10))
    rres = ref.train()
    assert res.rows.shape == (10, W, 3)
    np.testing.assert_array_equal(res.rows, rres.rows)
    for a, b in zip(_state(t), _state(ref)):
        assert torch.equal(a, b)


def test_log_cadence_served_from_the_stacked_rows():
    res = Trainer(_cfg(method=4, topk_ratio=0.1, scan_window=K, max_steps=12,
                       log_every=3)).train()
    assert [h[0] for h in res.history] == [0, 3, 6, 9]


def test_cli_trains_with_device_feed_and_window(tmp_path, capsys):
    rc = cli.main(["--platform", "cpu", "--network", "LeNet", "--dataset",
                   "mnist10k", "--feed", "device", "--scan-window", "4",
                   "--method", "4", "--num-workers", "4", "--max-steps", "5",
                   "--batch-size", "8", "--no-bf16",
                   "--train-dir", str(tmp_path) + "/"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "done: steps=5" in out
