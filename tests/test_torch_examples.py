"""The four example scripts of ``ewdml_tpu_torch/examples/`` (the JAX
package's ``examples/``), each through its ``main`` with ``--platform cpu``
at a tiny size.

Oracle kinds (ROADMAP's north star):
- bit: the round trip's levels and indices against the JAX package's
  compressors on the same vector and key (the draws are threefry's);
- tolerance: its decompressed values (the port sums a QSGD norm in f64,
  the JAX package in f32: one ulp apart);
- statistics: the negative result, as an ordering of two final losses
  at a stated seed (LeNet, real ``mnist10k``, 6 steps, the config's
  default seed of 42): the lossy weight broadcast ends above Method 2.
  At LeNet width the script calls the result inconclusive (its exit 1,
  as the JAX script's); VGG11 width diverges, which the card run shows;
- exact: the verdict on a curve that overflows to NaN.
"""

import math
import re
import types

import jax
import numpy as np
import pytest
import torch

from ewdml_tpu_torch.examples import (compressor_roundtrip, deep_real_pixels,
                                      experiment_matrix,
                                      weight_compression_negative)
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu_torch.ops import kernels

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _restore_modes():
    # Both packages' kernel modes: a test that ran earlier in this process
    # may have left either in 'interpret', whose draws differ.
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


def test_weight_compression_negative_orders_the_losses(capsys):
    rc = weight_compression_negative.main(
        ["--platform", "cpu", "--network", "LeNet", "--dataset", "mnist10k",
         "--real-data", "--max-steps", "6"])
    out = capsys.readouterr().out
    lossy = float(re.search(r"lossy-weights-down: final=(\S+)", out)[1])
    grads = float(re.search(r"method2-grads: final=(\S+)", out)[1])
    assert lossy > grads
    assert f"last_finite={lossy:.3f}" in out
    assert rc == (0 if weight_compression_negative.diverged(lossy, grads)
                  else 1)


@pytest.mark.parametrize("curve,final,want", [
    ([2.3, 90.0, 86994.72], math.nan, True),   # NaN after a blow-up
    ([2.3, 2.4, 2.5], math.nan, False),        # NaN from no blow-up
    ([math.nan, math.nan], math.nan, False),   # no finite loss at all
    ([2.3, 40.0], 742808.4, True),             # the JAX script's reading
], ids=["blowup_then_nan", "nan_without_blowup", "all_nan", "finite"])
def test_negative_verdict_reads_the_last_finite_loss(curve, final, want):
    """Exact: a NaN lossy run is judged by the last finite loss on its
    curve against 5x Method 2's (1.0 here), never by the NaN itself."""
    r = types.SimpleNamespace(final_loss=final,
                              history=[(i, v, 0.0) for i, v in
                                       enumerate(curve)])
    got = weight_compression_negative.last_finite(r)
    assert weight_compression_negative.diverged(got, 1.0) is want


def test_experiment_matrix_runs_the_methods(capsys):
    rc = experiment_matrix.main(
        ["--platform", "cpu", "--network", "LeNet", "--dataset", "mnist10k",
         "--num-workers", "2", "--max-steps", "2", "--batch-size", "8",
         "--methods", "1", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    rows = [line for line in out.splitlines() if line.startswith("| ")]
    assert [r.split("|")[1].strip() for r in rows[1:]] == ["1", "4"]
    # Method 4 ships int8 levels both ways: about 4x fewer bytes than M1.
    assert rows[2].split("|")[3].strip().startswith("4.")


def test_compressor_roundtrip_is_the_jax_one(capsys):
    from ewdml_tpu.ops import make_compressor as jmake

    assert compressor_roundtrip.main(["--platform", "cpu"]) == 0
    assert capsys.readouterr().out.count("wire bytes :") == 3
    g = jax.numpy.asarray(compressor_roundtrip.VECTOR, jax.numpy.float32)
    for name, kw, _, payload, dec in compressor_roundtrip.roundtrips("cpu"):
        jp = jmake(name, **kw).compress(jax.random.key(0), g)
        for field in ("levels", "indices"):
            if hasattr(payload, field):
                assert np.array_equal(getattr(payload, field).numpy(),
                                      np.asarray(getattr(jp, field)))
        np.testing.assert_allclose(
            dec.numpy(), np.asarray(jmake(name, **kw).decompress(jp)),
            rtol=2.4e-7, atol=0)


def test_deep_real_pixels_trains_on_mnist10k32(capsys):
    rc = deep_real_pixels.main(
        ["--platform", "cpu", "--num-workers", "2", "--max-steps", "1",
         "--batch-size", "2", "--only", "VGG11/M1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "VGG11/M1: loss=" in out and "(1000 real)" in out


@pytest.mark.parametrize("module", [compressor_roundtrip, deep_real_pixels,
                                    experiment_matrix,
                                    weight_compression_negative])
def test_examples_name_no_jax(module):
    """Exact: an example's source imports neither ``jax`` nor the JAX
    package (``tests/test_torch_imports.py`` imports every module of the
    port in a fresh interpreter)."""
    with open(module.__file__) as f:
        src = f.read()
    assert not re.search(r"^\s*(from|import)\s+(jax|ewdml_tpu)\b", src,
                         re.MULTILINE)
