"""The slice under QSGD, Methods 2 and 4 (harness and oracles in
``test_torch_slice.py``): LeNet per-layer payloads, fc1's 400k elements
through the quantize and dequant_mean kernel stream, under M4 the relay
requantization too.
"""

import pytest
import torch

from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu_torch.ops import kernels
from test_torch_slice import (check_wire, check_with_flips, jax_twins,  # noqa: F401
                              plain_calls, run_pair)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _restore_modes():
    # The trainers under test set the process-wide kernel modes.
    yield
    kernels.configure("auto")
    pk.configure("auto")


@pytest.mark.parametrize("method", [2, 4])
def test_qsgd_methods_match(tmp_path, jax_twins, plain_calls, method):
    pair = run_pair(tmp_path, method=method)
    check_wire(pair)
    check_with_flips(pair)
    # Per step: 8 leaves x 4 workers pushed (+ 8 relays under M4), and one
    # fused dequant-mean per leaf.
    pushes = 3 * 8 * (4 + (method == 4))
    assert plain_calls["qsgd_quantize"] == pushes
    assert plain_calls["dequant_mean"] == 3 * 8
    assert plain_calls["block_top1"] == 0
    assert abs(pair.tres.final_loss - pair.jres.final_loss) <= \
        1e-3 * abs(pair.jres.final_loss)
