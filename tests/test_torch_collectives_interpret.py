"""The collective parity of ``test_torch_collectives.py`` under
``--pallas interpret`` (the kernels' murmur stream on both sides; the JAX
side runs the Pallas interpreter inside ``shard_map``): one case per
kernel call site — the per-layer QSGD mean and relay (``dequant_mean``,
``qsgd_quantize``), blockwise norms with K-of-N, and the block-top-k
selection (``block_top1``). Oracle as in that file.
"""

import pytest
import torch

from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu_torch.ops import kernels
from test_torch_collectives import CASES, check_allreduce

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _restore_modes():
    # The trainers under test set the process-wide kernel modes.
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


@pytest.mark.parametrize("name,ckw,kw", [CASES[0], CASES[2], CASES[5]])
def test_compressed_allreduce_matches_on_the_kernel_stream(name, ckw, kw):
    check_allreduce("interpret", name, ckw, kw)
