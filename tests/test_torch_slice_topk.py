"""The slice under Top-k -> QSGD, Method 5 at the paper's 1% ratio, with
and without error feedback (harness and oracles in ``test_torch_slice.py``):
fc1's 400k elements take the strided block selection (block_top1), the
other leaves exact top-k, and the winners quantize on the kernel stream.
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
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


@pytest.mark.parametrize("ef", [False, True])
def test_method5_matches(tmp_path, jax_twins, plain_calls, ef):
    pair = run_pair(tmp_path, method=5, topk_ratio=0.01, error_feedback=ef)
    check_wire(pair)
    check_with_flips(pair)
    # fc1 is the only leaf above 2^18: one block selection per worker-step.
    assert plain_calls["block_top1"] == 3 * 4
    assert plain_calls["qsgd_quantize"] > 0
    if ef:
        for ws in pair.tt.state.workers:
            assert len(ws.residual) == 8
            assert any(float(r.abs().max()) > 0 for r in ws.residual)
    assert abs(pair.tres.final_loss - pair.jres.final_loss) <= \
        1e-3 * abs(pair.jres.final_loss)
