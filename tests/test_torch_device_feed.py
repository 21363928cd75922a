"""The port's device-resident feed (``ewdml_tpu_torch/data/device_feed.py``)
and its four new draws (``utils/prng``) against the JAX package's.

Oracles:
- bit: ``split``, ``permutation``, ``randint`` and ``bernoulli`` against
  ``jax.random``; ``batch_indices``, ``apply_crops``, ``augment_batch`` and
  ``fetch`` against ``ewdml_tpu.data.device_feed`` (indices, uint8 pixels
  and labels); a draw fed by a key table's device words against the same
  draw fed by host words.
- tolerance: a 2-step LeNet run on the committed ``mnist10k`` under
  ``--feed device`` (and a window of 2) against the JAX Trainer with the same
  flags, from the same initial state, under the oracles of
  ``test_torch_slice.py`` (dense: |dp| <= 1e-5 max|p|; compressed: bounded
  flips).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.data import device_feed as jfeed
from ewdml_tpu_torch.data import device_feed as tfeed
from ewdml_tpu_torch.utils import prng
from ewdml_tpu_torch.utils.keytable import HostKeys, KeyTable
from test_torch_slice import (check_dense, check_wire, check_with_flips,  # noqa: F401
                              jax_twins, run_pair)

torch.set_num_threads(2)

KEYS = [(0, 0), (42, 5), (7, 123457)]


def _pair(seed: int, step: int):
    """The same key in both packages: ``fold_in(key(seed), step)``."""
    return (jax.random.fold_in(jax.random.key(seed), step),
            prng.fold_in(prng.key(seed), step))


def _words(k) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed,step", KEYS)
def test_split_matches_jax(seed, step):
    jk, tk = _pair(seed, step)
    for num in (2, 3):
        assert tuple(_words(k) for k in jax.random.split(jk, num)) == \
            prng.split(tk, num)


@pytest.mark.parametrize("n", [64, 10_000, 50_000])
@pytest.mark.parametrize("seed,step", KEYS)
def test_permutation_matches_jax(seed, step, n):
    # Ties among the 32-bit sort keys are likely at 50 000 (~0.3 a round),
    # so this also holds the port to a stable sort.
    jk, tk = _pair(seed, step)
    np.testing.assert_array_equal(prng.permutation(tk, n).numpy(),
                                  np.asarray(jax.random.permutation(jk, n)))


@pytest.mark.parametrize("lo,hi", [(0, 9), (-5, 100_003), (0, 1 << 20),
                                   (7, 7), (9, 3)])
@pytest.mark.parametrize("seed,step", KEYS)
def test_randint_matches_jax(seed, step, lo, hi):
    jk, tk = _pair(seed, step)
    a = np.asarray(jax.random.randint(jk, (1000,), lo, hi))
    b = prng.randint(tk, (1000,), lo, hi).numpy()
    assert b.dtype == a.dtype == np.int32
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("p", [0.5, 0.3])
@pytest.mark.parametrize("seed,step", KEYS)
def test_bernoulli_matches_jax(seed, step, p):
    jk, tk = _pair(seed, step)
    np.testing.assert_array_equal(
        prng.bernoulli(tk, p, (1000,)).numpy(),
        np.asarray(jax.random.bernoulli(jk, p, (1000,))))


def test_draws_from_table_words_equal_host_words():
    table = KeyTable(prng.key(3), "cpu", start=10)
    tk = prng.fold_in(table.step_key(12), 7)
    hk = prng.fold_in(prng.step_key(prng.key(3), 12), 7)
    assert tuple(tk) == hk
    assert torch.equal(prng.permutation(tk, 10_000), prng.permutation(hk, 10_000))
    assert torch.equal(prng.randint(tk, (64,), 0, 9), prng.randint(hk, (64,), 0, 9))
    assert torch.equal(prng.uniform(tk, (3, 5)), prng.uniform(hk, (3, 5)))
    assert int(prng.seed_tensor(tk, "cpu")) == prng.seed_from_key(hk)


def _data_keys(seed=42):
    jb = jax.random.key(seed)
    jd = jax.random.fold_in(jax.random.fold_in(jb, jfeed.DATA_TAG),
                            jfeed.DATA_TAG)
    return jd, tfeed.data_key(prng.key(seed))


def test_batch_indices_match_jax_across_an_epoch():
    jd, td = _data_keys()
    n, b, w = 300, 8, 4          # 9 steps an epoch; steps 8 -> 9 cross it
    for step in (0, 1, 8, 9, 10, 23):
        for rank in range(w):
            np.testing.assert_array_equal(
                tfeed.batch_indices(td, step, n, b, w, rank).numpy(),
                np.asarray(jfeed.batch_indices(jd, step, n, b, w, rank)),
                err_msg=f"step {step} rank {rank}")


def test_dataset_smaller_than_global_batch_rejected():
    _, td = _data_keys()
    with pytest.raises(ValueError, match="global batch"):
        tfeed.batch_indices(td, 0, 10, 4, 4, 0)


def _u8(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=shape).astype(np.uint8)


def test_apply_crops_matches_jax():
    rng = np.random.RandomState(1)
    imgs = _u8((16, 32, 32, 3))
    ys, xs = rng.randint(0, 9, 16), rng.randint(0, 9, 16)
    flips = rng.rand(16) < 0.5
    a = jfeed.apply_crops(jnp.array(imgs), jnp.array(ys), jnp.array(xs),
                          jnp.array(flips))
    b = tfeed.apply_crops(torch.from_numpy(imgs), torch.from_numpy(ys),
                          torch.from_numpy(xs), torch.from_numpy(flips))
    assert b.dtype == torch.uint8
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("seed,step", KEYS)
def test_augment_batch_matches_jax(seed, step):
    imgs = _u8((16, 32, 32, 3), seed=2)
    jk, tk = _pair(seed, step)
    np.testing.assert_array_equal(
        tfeed.augment_batch(torch.from_numpy(imgs), tk).numpy(),
        np.asarray(jfeed.augment_batch(jnp.array(imgs), jk)))


@pytest.mark.parametrize("augment", [False, True])
def test_fetch_and_feed_match_jax(augment):
    n, b, w = 300, 8, 4
    data = _u8((n, 32, 32, 3), seed=3)
    labels = np.random.RandomState(4).randint(0, 10, n).astype(np.int32)
    jd, td = _data_keys()
    tdata, tlabels = torch.from_numpy(data), torch.from_numpy(labels)
    feed = tfeed.DeviceFeed(prng.key(42), n, b, w, augment)
    for step in (0, 8, 9):
        host = feed.batches(tdata, tlabels, step, HostKeys(prng.key(42)))
        table = KeyTable(prng.key(42), "cpu", start=step - 1)
        tabled = feed.batches(tdata, tlabels, step, table)
        for rank in range(w):
            ji, jl = jfeed.fetch(jnp.array(data), jnp.array(labels), jd, step,
                                 b, w, rank, augment)
            ti, tl = tfeed.fetch(tdata, tlabels, td, step, b, w, rank, augment)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
            for got in (host[rank], tabled[rank]):
                assert torch.equal(got[0], ti) and torch.equal(got[1], tl)


@pytest.mark.parametrize("method", [1, 4])
def test_lenet_mnist10k_device_feed_matches_jax(tmp_path, jax_twins, method):
    pair = run_pair(tmp_path, method=method, feed="device", max_steps=2,
                    scan_window=2)
    check_wire(pair)
    assert pair.tt.scan_window == pair.jt.scan_window == 2
    if method == 1:
        check_dense(pair)
    else:
        check_with_flips(pair)
