"""The slice under Method 6 (harness and oracles in ``test_torch_slice.py``):
Top-k -> QSGD at 1% with local SGD between syncs, ``--sync-every 2``, so the
3 steps are local, sync + best-worker adoption, local. (The Method-6 preset
sets ``sync_every = 20`` over any flag, in both packages, so the period is
set after the preset.)
"""

import numpy as np
import pytest
import torch

from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu_torch.ops import kernels
from test_torch_slice import (check_wire, check_with_flips, jax_twins,  # noqa: F401
                              plain_calls, run_pair, _leaves, W)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _restore_modes():
    # The trainers under test set the process-wide kernel modes.
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


def test_method6_local_sync_adopt(tmp_path, jax_twins, plain_calls):
    pair = run_pair(tmp_path, method=6, topk_ratio=0.01,
                    after_preset=dict(sync_every=2))
    check_wire(pair)
    assert pair.tt.wire.sync_every == 2
    check_with_flips(pair)
    # One exchange (step 1): fc1's block selection once per worker.
    assert plain_calls["block_top1"] == 4
    # The last step was local, so the workers diverge again after adoption.
    t0, t1 = _leaves(pair.tparams[0]), _leaves(pair.tparams[W - 1])
    assert any(not np.array_equal(t0[k], t1[k]) for k in t0)
    assert abs(pair.tres.final_loss - pair.jres.final_loss) <= \
        1e-3 * abs(pair.jres.final_loss)
