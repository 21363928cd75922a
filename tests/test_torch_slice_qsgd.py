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
    kernels.configure("auto")
    pk.configure("auto")
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


@pytest.mark.parametrize("kw", [
    # Threefry for the compressors (--pallas off): the JAX program of this
    # run compiles in 14 s this way, in 20 s through the kernel twins.
    dict(method=4, error_feedback=True, precision_policy="bf16_wire_state",
         pallas="off"),
    dict(method=2, optimizer="adam", lr=1e-3),
    dict(method=4, error_feedback=True, overlap="bucket", overlap_buckets=2),
    dict(compress_grad="qsgd", ps_mode="weights", lossy_weights_down=True),
], ids=["m4_ef_bf16_state", "m2_adam", "m4_ef_overlap", "lossy_weights"])
def test_policy_adam_overlap_and_lossy_runs_match(tmp_path, jax_twins, kw):
    """2 steps; the compressed-method oracle (bounded flips). Under
    ``bf16_wire_state`` the residuals and momentum are bf16 in both
    packages and the W replicas stay bit-identical (rank-shared optimizer
    key); under ``--lossy-weights-down`` every weight leaf is the
    decompressed QSGD payload, one quantization level per element."""
    pair = run_pair(tmp_path, max_steps=2, **kw)
    check_wire(pair)
    check_with_flips(pair)
    tws = pair.tt.state.workers
    if kw.get("precision_policy"):
        assert all(r.dtype == torch.bfloat16 for r in tws[0].residual)
        assert all(b.dtype == torch.bfloat16
                   for b in tws[0].opt_state.momentum_buf)
        for ws in tws[1:]:
            for a, b in zip(tws[0].model.parameters(), ws.model.parameters()):
                assert torch.equal(a, b)
    if kw.get("lossy_weights_down"):
        # Each leaf holds at most 2s + 1 distinct levels times its norm.
        for p in tws[0].model.parameters():
            assert torch.unique(p.detach()).numel() <= 2 * 127 + 1
    assert abs(pair.tres.final_loss - pair.jres.final_loss) <= \
        1e-3 * abs(pair.jres.final_loss)
