"""The port on an NVIDIA GPU: each CUDA kernel against its plain version on
the card, and a short training run that goes through the kernels. Skips
without a GPU. This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Oracles: quantize and block_top1 bit; dequant_mean bit (the kernel keeps
the plain version's order of operations, with no FMA).
"""

import pytest
import torch

from ewdml_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    yield torch.Generator(device="cuda").manual_seed(0)
    kernels.configure("auto")


@pytest.mark.parametrize("n", [2_359_296, 530_442, 4097, 3])
@pytest.mark.parametrize("block", [None, 4096])
def test_quantize_kernel_is_the_plain_version(cuda, n, block):
    x = torch.randn(n, device="cuda", generator=cuda)
    if block is None:
        norm = torch.linalg.vector_norm(x)
    else:
        nb = -(-n // block)
        pad = torch.zeros(nb * block, device="cuda")
        pad[:n] = x
        norm = torch.linalg.vector_norm(pad.reshape(nb, block), dim=1)
    for seed in (0, -77, 2**31 - 1):
        a = kernels.qsgd_quantize(x, norm, seed, 127, block=block)
        b = kernels.qsgd_quantize_ref(x, norm, seed, 127, block=block)
        assert torch.equal(a, b), (n, block, seed)
    z = torch.zeros(n, device="cuda")
    assert not kernels.qsgd_quantize(z, torch.zeros(()), 1, 127).any()


@pytest.mark.parametrize("world,n,block", [(1, 5000, None), (4, 530_442, None),
                                           (4, 2_359_296, 4096)])
def test_dequant_mean_kernel_is_the_plain_version(cuda, world, n, block):
    lv = torch.randint(-127, 128, (world, n), device="cuda",
                       generator=cuda).to(torch.int8)
    shape = (world,) if block is None else (world, -(-n // block))
    nm = torch.rand(shape, device="cuda", generator=cuda)
    assert torch.equal(kernels.dequant_mean(lv, nm, 127, block=block),
                       kernels.dequant_mean_ref(lv, nm, 127, block=block))


@pytest.mark.parametrize("r,c", [(104, 23680), (8, 128), (104, 4224)])
def test_block_top1_kernel_is_the_plain_version(cuda, r, c):
    x2 = torch.round(torch.randn(r, c, device="cuda", generator=cuda) * 2) / 2
    x2[:, 0] = 0.0
    x2[0, 0] = -0.0   # an all-zero column whose first row is -0
    va, la = kernels.block_top1(x2)
    vb, lb = kernels.block_top1_ref(x2)
    assert torch.equal(la, lb)
    assert torch.equal(va.view(torch.int32), vb.view(torch.int32))


def test_wrappers_count_launches(cuda):
    kernels.reset_launches()
    x = torch.randn(4096, device="cuda", generator=cuda)
    kernels.qsgd_quantize(x, torch.linalg.vector_norm(x), 1, 127)
    kernels.block_top1(x.reshape(32, 128))
    kernels.dequant_mean(torch.zeros(2, 8, dtype=torch.int8, device="cuda"),
                         torch.ones(2, device="cuda"), 127)
    assert kernels.LAUNCHES == {"qsgd_quantize": 1, "dequant_mean": 1,
                                "block_top1": 1}


@pytest.mark.parametrize("method", [4, 5])
def test_lenet_trains_through_the_kernels(cuda, tmp_path, method):
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.train.loop import Trainer

    cfg = TrainConfig(network="LeNet", dataset="mnist10k", batch_size=32,
                      max_steps=3, epochs=100, num_workers=4, method=method,
                      topk_ratio=0.01, bf16_compute=False, log_every=1000,
                      pallas="on")
    kernels.reset_launches()
    res = Trainer(cfg).train()
    torch.cuda.synchronize()
    assert res.steps == 3 and torch.isfinite(torch.tensor(res.final_loss))
    if method == 4:
        assert kernels.LAUNCHES["qsgd_quantize"] == 3 * 8 * 5
        assert kernels.LAUNCHES["dequant_mean"] == 3 * 8
    else:
        assert kernels.LAUNCHES["block_top1"] == 3 * 4
