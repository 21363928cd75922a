"""The port on an NVIDIA GPU: each CUDA kernel against its plain version on
the card, and a short training run that goes through the kernels. Skips
without a GPU. This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Oracles: quantize and block_top1 bit; dequant_mean bit (the kernel keeps
the plain version's order of operations, with no FMA), at every row count
its templates split on and on unaligned rows; chunk_encode and
dequant_acc_requant bit, levels and norms (the plain versions repeat the
kernels' summation order); int_accumulate and acc_decode bit (exact
integer sums, one f32 product per element in the same order).
"""

import numpy as np
import pytest
import torch

from chip_smoke import top1_edge_matrix
from ewdml_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    kernels.configure("auto")
    yield torch.Generator(device="cuda").manual_seed(0)
    kernels.configure("auto")


def _norms(x, block):
    if block is None:
        return torch.linalg.vector_norm(x)
    n = x.numel()
    nb = -(-n // block)
    pad = torch.zeros(nb * block, device="cuda")
    pad[:n] = x
    return torch.linalg.vector_norm(pad.reshape(nb, block), dim=1)


@pytest.mark.parametrize("n", [2_359_296, 1_180_160, 1_069_066, 959_616,
                               530_442, 4097, 3])
@pytest.mark.parametrize("block", [None, 4096, 8192, 16384])
def test_quantize_kernel_is_the_plain_version(cuda, n, block):
    x = torch.randn(n, device="cuda", generator=cuda)
    norm = _norms(x, block)
    for seed in (0, -77, 2**31 - 1):
        a = kernels.qsgd_quantize(x, norm, seed, 127, block=block)
        b = kernels.qsgd_quantize_ref(x, norm, seed, 127, block=block)
        assert torch.equal(a, b), (n, block, seed)
    z = torch.zeros(n, device="cuda")
    assert not kernels.qsgd_quantize(z, torch.zeros(()), 1, 127).any()


@pytest.mark.parametrize("block", [None, 4096])
def test_quantize_kernel_on_an_unaligned_view(cuda, block):
    """A view 4 bytes into its storage (the wrapper copies it for the
    kernel's 16-byte loads)."""
    x = torch.randn(530_443, device="cuda", generator=cuda)[1:]
    assert x.data_ptr() % 16 == 4
    norm = _norms(x, block)
    a = kernels.qsgd_quantize(x, norm, 9, 127, block=block)
    assert torch.equal(a, kernels.qsgd_quantize_ref(x, norm, 9, 127,
                                                    block=block))


@pytest.mark.parametrize("world,n,block", [(1, 5000, None), (4, 530_442, None),
                                           (4, 2_359_296, 4096),
                                           (4, 1_069_066, None),
                                           (4, 1_069_066, 4096)])
def test_dequant_mean_kernel_is_the_plain_version(cuda, world, n, block):
    """Among the shapes, ResNet50's unit of 1 069 066 (2 mod 4: rows 1 and
    3 start on 2-byte boundaries)."""
    lv = torch.randint(-127, 128, (world, n), device="cuda",
                       generator=cuda).to(torch.int8)
    shape = (world,) if block is None else (world, -(-n // block))
    nm = torch.rand(shape, device="cuda", generator=cuda)
    assert torch.equal(kernels.dequant_mean(lv, nm, 127, block=block),
                       kernels.dequant_mean_ref(lv, nm, 127, block=block))


def _levels(cuda, rows, n, offset=0):
    """Random int8 levels [rows, n], ``offset`` bytes into their storage."""
    flat = torch.randint(-127, 128, (rows * n + offset,), device="cuda",
                         generator=cuda).to(torch.int8)
    return flat[offset:].reshape(rows, n)


@pytest.mark.parametrize("world", [1, 3, 4, 8, 9])
@pytest.mark.parametrize("n", [2_359_296, 530_442, 12_290, 9])
@pytest.mark.parametrize("block", [None, 4096])
def test_dequant_mean_kernel_at_every_row_count(cuda, world, n, block):
    """The kernel's bodies for W <= 8 and the runtime one, on rows that
    start 16-, 4- and 2-byte aligned, and on a base 1 and 3 bytes into its
    storage (the kernel realigns; it never reads outside the levels)."""
    shape = (world,) if block is None else (world, -(-n // block))
    nm = torch.rand(shape, device="cuda", generator=cuda) * 3
    for offset in (0, 1, 3):
        lv = _levels(cuda, world, n, offset)
        a = kernels.dequant_mean(lv, nm, 127, block=block)
        b = kernels.dequant_mean_ref(lv, nm, 127, block=block)
        assert _bits_equal(a, b), (world, n, block, offset)


@pytest.mark.parametrize("world", [1, 2, 4, 8, 9, 16])
@pytest.mark.parametrize("n", [262_144, 294_912, 530_442, 17, 5])
def test_int_accumulate_kernel_at_every_row_count(cuda, world, n):
    for offset in (0, 1, 2):
        lv = _levels(cuda, world, n, offset)
        lv[:, :3] = 127
        lv[:, -1] = -128
        assert torch.equal(kernels.int_accumulate(lv),
                           kernels.int_accumulate_ref(lv)), (world, n, offset)


@pytest.mark.parametrize("r,c", [(104, 23680), (104, 11904), (104, 9600),
                                 (104, 5376), (8, 128), (1000, 256),
                                 (104, 4224), (104, 10496), (104, 10752)])
def test_block_top1_kernel_is_the_plain_version(cuda, r, c):
    x2 = torch.round(torch.randn(r, c, device="cuda", generator=cuda) * 2) / 2
    x2[:, 0] = 0.0
    x2[0, 0] = -0.0   # an all-zero column whose first row is -0
    for x in (x2, top1_edge_matrix(torch, r, c, cuda)):
        va, la = kernels.block_top1(x)
        vb, lb = kernels.block_top1_ref(x)
        assert torch.equal(la, lb)
        assert torch.equal(va.view(torch.int32), vb.view(torch.int32))
    tie = min(3, r - 7)  # the first of the planted rows (3, r - 7)
    assert la[:8].tolist() == [0, 0, 0, tie, tie, tie, r - 1, 0]


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n", [2_441_216, 530_442, 4097, 3])
@pytest.mark.parametrize("block", [4096, 8192, 12288, 16384])
def test_chunk_encode_kernel_is_the_plain_version(cuda, n, block):
    _check_encode(cuda, n, block)


@pytest.mark.parametrize("blocks", [1, 33, 64, 66, 144, 264, 265, 596, 1436])
@pytest.mark.parametrize("block", [4096, 16384])
def test_chunk_encode_kernel_at_the_ring_chunk_sizes(cuda, blocks, block):
    """The ring_rs and fused_q chunks of VGG11-BN and ResNet50 (64 to 144
    blocks, and 1 436) and both sides of 264 blocks, where the hop (not the
    encode) changes kernel."""
    _check_encode(cuda, blocks * block, block)


def _check_encode(cuda, n, block):
    x = torch.randn(n, device="cuda", generator=cuda) * 1e-2
    x[: min(n, 50)] *= 1e4   # a few large entries: levels up to s
    for seed in (0, -77, 2**31 - 1):
        la, na = kernels.chunk_encode(x, seed, 127, block=block)
        lb, nb = kernels.chunk_encode_ref(x, seed, 127, block=block)
        assert _bits_equal(na, nb), (n, block, seed)
        assert torch.equal(la, lb), (n, block, seed)
    z = torch.zeros(n, device="cuda")
    lz, nz = kernels.chunk_encode(z, 1, 127, block=block)
    assert not lz.any() and not nz.any()


@pytest.mark.parametrize("n", [1436 * 4096, 2_441_216, 144 * 4096, 530_442,
                               64 * 4096, 33 * 4096, 4096, 4097, 3])
@pytest.mark.parametrize("block", [4096, 8192, 12288, 16384])
@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_dequant_acc_requant_kernel_is_the_plain_version(cuda, n, block,
                                                         scale):
    local = torch.randn(n, device="cuda", generator=cuda) * 1e-2
    lv = torch.randint(-127, 128, (n,), device="cuda",
                       generator=cuda).to(torch.int8)
    nm = torch.rand(-(-n // block), device="cuda", generator=cuda)
    for seed in (0, -77, 2**31 - 1):
        la, na = kernels.dequant_acc_requant(lv, nm, local, seed, 127,
                                             block=block, scale=scale)
        lb, nb = kernels.dequant_acc_requant_ref(lv, nm, local, seed, 127,
                                                 block=block, scale=scale)
        assert _bits_equal(na, nb), (n, block, scale, seed)
        assert torch.equal(la, lb), (n, block, scale, seed)


def test_wrappers_count_launches(cuda):
    kernels.reset_launches()
    x = torch.randn(4096, device="cuda", generator=cuda)
    kernels.qsgd_quantize(x, torch.linalg.vector_norm(x), 1, 127)
    kernels.block_top1(x.reshape(32, 128))
    kernels.dequant_mean(torch.zeros(2, 8, dtype=torch.int8, device="cuda"),
                         torch.ones(2, device="cuda"), 127)
    lv, nm = kernels.chunk_encode(x, 2)
    kernels.dequant_acc_requant(lv, nm, x, 3)
    acc = kernels.int_accumulate(torch.stack([lv, lv]))
    kernels.acc_decode(acc, torch.ones(1, device="cuda"), 2)
    kernels.stochastic_round_bf16(x, (1, 2))
    kernels.random_bits((1, 2), 100, "cuda")
    assert kernels.LAUNCHES == {"qsgd_quantize": 1, "dequant_mean": 1,
                                "block_top1": 1, "chunk_encode": 1,
                                "dequant_acc_requant": 1, "int_accumulate": 1,
                                "acc_decode": 1, "stochastic_round": 1,
                                "random_bits": 1}


@pytest.mark.parametrize("world,n", [(4, 2_359_296), (5, 9000), (8, 130),
                                     (3, 4096)])
def test_int_accumulate_kernel_is_the_plain_version(cuda, world, n):
    lv = torch.randint(-127, 128, (world, n), device="cuda",
                       generator=cuda).to(torch.int8)
    lv[:, :3] = 127
    assert torch.equal(kernels.int_accumulate(lv),
                       kernels.int_accumulate_ref(lv))
    # A base address that is not 4-byte aligned: every row realigned.
    big = torch.randint(-127, 128, (world * n + 1,), device="cuda",
                        generator=cuda).to(torch.int8)
    off = big[1:].reshape(world, n)
    assert torch.equal(kernels.int_accumulate(off),
                       kernels.int_accumulate_ref(off))


@pytest.mark.parametrize("k", [4, 3])
@pytest.mark.parametrize("n,block", [(2_359_296, None), (2_359_296, 4096),
                                     (2_359_296, 8192), (3 * 8192 + 17, 4096),
                                     (3 * 8192 + 17, 8192), (5, None)])
def test_acc_decode_kernel_is_the_plain_version(cuda, k, n, block):
    acc = torch.randint(-127 * k, 127 * k + 1, (n,), device="cuda",
                        generator=cuda).to(torch.int32)
    nb = 1 if block is None else -(-n // block)
    sc = torch.rand(nb, device="cuda", generator=cuda) * 1e-3
    a = kernels.acc_decode(acc, sc, k, block=block)
    b = kernels.acc_decode_ref(acc, sc, k, block=block)
    assert _bits_equal(a, b)


def test_acc_decode_kernel_refuses_an_odd_block(cuda):
    acc = torch.zeros(5000, dtype=torch.int32, device="cuda")
    sc = torch.ones(5, device="cuda")
    with pytest.raises(ValueError, match="4096"):
        kernels.acc_decode(acc, sc, 2, block=1000)
    # The dispatcher takes the plain version there, as the JAX twin serves.
    kernels.reset_launches()
    kernels.decode_sum(acc, sc, 2, block=1000)
    assert kernels.LAUNCHES["acc_decode"] == 0


def _decode_set(gen, sizes, ks, block):
    items = []
    for i, n in enumerate(sizes):
        k = ks[i % len(ks)]
        # Every other leaf a view 4 bytes into its storage: the wrapper
        # realigns it.
        off = i % 2
        acc = torch.randint(-127 * k, 127 * k + 1, (n + off,), device="cuda",
                            generator=gen).to(torch.int32)[off:]
        nb = 1 if block is None else -(-n // block)
        sc = torch.rand(nb, device="cuda", generator=gen) * 1e-3
        items.append((acc, sc, k, block))
    return items


@pytest.mark.parametrize("block", [None, 4096, 8192])
def test_decode_set_kernel_is_the_plain_version(cuda, block):
    items = _decode_set(cuda, [1, 3, 4095, 4097, 530_442, 0, 2_359_296],
                        [3, 4, 6], block)
    kernels.reset_launches()
    got = kernels.acc_decode_set(items)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["acc_decode"] == 1
    for a, b in zip(got, kernels.decode_sum_set_ref(items)):
        assert a.data_ptr() % 16 == 0 and _bits_equal(a, b)
    # The apply's packed set takes the kernel at every size too.
    dset = kernels.DecodeSet([(a.numel(), sc, k, b) for a, sc, k, b in items],
                             "cuda")
    acc = dset.acc_arena()
    for view, (a, _, _, _) in zip(dset.views(acc), items):
        view.copy_(a)
    kernels.reset_launches()
    got = dset.decode(acc)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["acc_decode"] == 1
    for a, b in zip(got, kernels.decode_sum_set_ref(items)):
        assert a.data_ptr() % 16 == 0 and _bits_equal(a, b)


def test_decode_set_of_449_leaves_takes_two_launches(cuda):
    sizes = [1 + (i * 977) % 9000 for i in range(449)]
    items = _decode_set(cuda, sizes, [1, 3, 26], 4096)
    kernels.reset_launches()
    got = kernels.acc_decode_set(items)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["acc_decode"] == kernels.decode_set_launches(
        449) == 2
    for a, b in zip(got, kernels.decode_sum_set_ref(items)):
        assert _bits_equal(a, b)


def test_decode_set_refuses_an_odd_block(cuda):
    acc = torch.zeros(5000, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="4096"):
        kernels.acc_decode_set([(acc, torch.ones(5, device="cuda"), 2, 1000)])
    with pytest.raises(ValueError, match="4096"):
        kernels.DecodeSet([(5000, torch.ones(5, device="cuda"), 2, 1000)],
                          "cuda")


@pytest.mark.parametrize("compress", ["qsgd", "topk_qsgd"])
def test_lenet_async_runs_through_the_kernels(cuda, compress):
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.ops import make_compressor
    from ewdml_tpu_torch.optim import SGD
    from ewdml_tpu_torch.data import datasets, loader
    from ewdml_tpu_torch.parallel.ps import run_async_ps

    ds = datasets.load("mnist10k", train=True)
    kernels.reset_launches()
    _, stats = run_async_ps(
        build_model("LeNet", 10, dataset="mnist10k"), SGD(0.01),
        lambda i: loader.global_batches(ds, 32, 1, seed=i, feed="f32"),
        num_workers=4, steps_per_worker=3,
        compressor=make_compressor(compress, 127, topk_ratio=0.05),
        num_aggregate=2, server_agg="homomorphic", device="cuda")
    torch.cuda.synchronize()
    assert stats.pushes == 12 and stats.updates == 6
    assert stats.decode_count == stats.apply_rounds == 6
    # One decode set of LeNet's eight leaves, and an accumulate of its one
    # leaf of at least 2^17 elements (fc1), per round and once for the
    # warm apply.
    assert kernels.LAUNCHES["acc_decode"] == 6 + 1
    assert kernels.LAUNCHES["int_accumulate"] == (
        6 + 1 if compress == "qsgd" else 0)


@pytest.mark.parametrize("method", [4, 5])
def test_lenet_trains_through_the_kernels(cuda, tmp_path, method):
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.train.loop import Trainer

    cfg = TrainConfig(network="LeNet", dataset="mnist10k", batch_size=32,
                      max_steps=3, epochs=100, num_workers=4, method=method,
                      topk_ratio=0.01, bf16_compute=False, log_every=1000,
                      pallas="on", train_dir=str(tmp_path) + "/")
    kernels.reset_launches()
    res = Trainer(cfg).train()
    torch.cuda.synchronize()
    assert res.steps == 3 and torch.isfinite(torch.tensor(res.final_loss))
    if method == 4:
        assert kernels.LAUNCHES["qsgd_quantize"] == 3 * 8 * 5
        assert kernels.LAUNCHES["dequant_mean"] == 3 * 8
    else:
        assert kernels.LAUNCHES["block_top1"] == 3 * 4


@pytest.mark.parametrize("kw,units", [
    (dict(method=3, collective="fused_q"), 1),
    (dict(method=4, gather_type="ring_rs", qsgd_block=4096), 8),
])
def test_lenet_rings_run_through_the_kernels(cuda, tmp_path, kw, units):
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.train.loop import Trainer

    cfg = TrainConfig(network="LeNet", dataset="mnist10k", batch_size=32,
                      max_steps=3, epochs=100, num_workers=4,
                      bf16_compute=False, log_every=1000,
                      train_dir=str(tmp_path) + "/", **kw)
    trainer = Trainer(cfg)
    kernels.reset_launches()
    res = trainer.train()
    torch.cuda.synchronize()
    assert res.steps == 3 and torch.isfinite(torch.tensor(res.final_loss))
    # Per step and ring unit: one encode per rank, W - 1 hops per rank.
    assert kernels.LAUNCHES["chunk_encode"] == 3 * units * 4
    assert kernels.LAUNCHES["dequant_acc_requant"] == 3 * units * 4 * 3
    if "collective" in kw:
        assert trainer.world.ppermute_bytes == \
            3 * res.wire.per_rank_exchange_bytes


# -- the seed from device memory, and the captured window ------------------------

def _table_seed(seed: int, slot: int = 3) -> torch.Tensor:
    """``seed`` as a key table holds it: one int32 slot of a device buffer."""
    buf = torch.zeros(8, dtype=torch.int32, device="cuda")
    buf[slot] = seed
    return buf[slot:slot + 1]


@pytest.mark.parametrize("case", ["quantize", "quantize_4096", "encode_596",
                                  "encode_144", "hop_144", "hop_1436"])
def test_table_seed_kernels_are_the_plain_versions(cuda, case):
    """The three drawing kernels with their seed read from a table slot, at
    the shapes the paths give them, against their plain versions given the
    same slot and given the seed as an int."""
    n, block = {"quantize": (2_359_296, None), "quantize_4096": (2_359_296, 4096),
                "encode_596": (2_441_216, 4096), "encode_144": (144 * 4096, 4096),
                "hop_144": (144 * 4096, 4096),
                "hop_1436": (1436 * 4096, 4096)}[case]
    x = torch.randn(n, device="cuda", generator=cuda) * 1e-2
    lv = torch.randint(-127, 128, (n,), device="cuda",
                       generator=cuda).to(torch.int8)
    nm = torch.rand(-(-n // 4096), device="cuda", generator=cuda)
    for seed in (0, -77, 2**31 - 1):
        st = _table_seed(seed)
        if case.startswith("quantize"):
            norm = _norms(x, block)
            got = kernels.qsgd_quantize(x, norm, st, 127, block=block)
            want = [kernels.qsgd_quantize_ref(x, norm, s, 127, block=block)
                    for s in (st, seed)]
        elif case.startswith("encode"):
            got = kernels.chunk_encode(x, st, 127)
            want = [kernels.chunk_encode_ref(x, s, 127) for s in (st, seed)]
        else:
            got = kernels.dequant_acc_requant(lv, nm, x, st, 127, scale=0.25)
            want = [kernels.dequant_acc_requant_ref(lv, nm, x, s, 127,
                                                    scale=0.25)
                    for s in (st, seed)]
        for w in want:
            if isinstance(got, tuple):
                assert torch.equal(got[0], w[0]) and _bits_equal(got[1], w[1])
            else:
                assert torch.equal(got, w), (case, seed)


def test_captured_kernels_draw_each_replays_seed(cuda):
    """A graph that captured the three launches draws from whatever seeds
    the table holds at each replay."""
    n = 144 * 4096
    x = torch.randn(n, device="cuda", generator=cuda) * 1e-2
    lv = torch.randint(-127, 128, (n,), device="cuda",
                       generator=cuda).to(torch.int8)
    nm = torch.rand(n // 4096, device="cuda", generator=cuda)
    norm = torch.linalg.vector_norm(x)
    table = torch.zeros(3, dtype=torch.int32, device="cuda")

    def launch():
        return (kernels.qsgd_quantize(x, norm, table[0:1], 127),
                kernels.chunk_encode(x, table[1:2], 127),
                kernels.dequant_acc_requant(lv, nm, x, table[2:3], 127))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q, (el, en), (hl, hn) = launch()
    for seeds in ((1, 2, 3), (-5, 7, 2**31 - 1)):
        table.copy_(torch.tensor(seeds, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(q, kernels.qsgd_quantize_ref(x, norm, seeds[0], 127))
        rl, rn = kernels.chunk_encode_ref(x, seeds[1], 127)
        assert torch.equal(el, rl) and _bits_equal(en, rn)
        rl, rn = kernels.dequant_acc_requant_ref(lv, nm, x, seeds[2], 127)
        assert torch.equal(hl, rl) and _bits_equal(hn, rn)


@pytest.fixture
def deterministic(cuda):
    """Bit-equal runs on the card need deterministic kernels (cuDNN's
    weight gradients and ``index_add_`` sum with atomics otherwise)."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cudnn.deterministic = True
    yield
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False


@pytest.mark.parametrize("kw", [
    dict(network="LeNet", dataset="MNIST", method=4),
    dict(network="LeNet", dataset="MNIST", method=6, topk_ratio=0.1,
         sync_every=4),
    dict(network="LeNet", dataset="MNIST", method=4, num_aggregate=2),
    dict(network="VGG11", dataset="Cifar10", method=5, topk_ratio=0.01),
    dict(network="LeNet", dataset="MNIST", method=4, bf16_compute=True),
], ids=["lenet_m4", "lenet_m6", "lenet_kofn", "vgg_m5_dropout",
        "lenet_m4_bf16"])
def test_captured_window_replays_match_per_step(deterministic, tmp_path, kw):
    """12 steps at K = 4 (a warm-up window, a capture replayed, a replay)
    against 12 per-step dispatches: every metrics row, parameter, BatchNorm
    statistic and momentum buffer bit-equal, and as many kernel launches."""
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.train.loop import Trainer

    kw = dict(kw)
    sync_every = kw.pop("sync_every", None)
    kw.setdefault("bf16_compute", False)
    runs = []
    for k in (1, 4):
        cfg = TrainConfig(batch_size=32, max_steps=12, epochs=100,
                          num_workers=4, log_every=1000, synthetic_data=True,
                          feed="device", scan_window=k,
                          train_dir=str(tmp_path / f"k{k}") + "/", **kw)
        if sync_every:
            cfg.sync_every = sync_every   # after the Method 6 preset
        t = Trainer(cfg)
        kernels.reset_launches()
        res = t.train()
        torch.cuda.synchronize()
        runs.append((t, res, dict(kernels.LAUNCHES)))
    (ref, rres, rl), (win, wres, wl) = runs
    ws = win.window_step
    assert (ws.eager_windows, ws.captures, ws.replays) == (1, 1, 2)
    assert torch.equal(torch.from_numpy(wres.rows), torch.from_numpy(rres.rows))
    assert wl == rl and sum(rl.values()) > 0
    for a, b in zip(ref.state.workers, win.state.workers):
        for (name, x), (_, y) in zip(a.model.state_dict().items(),
                                     b.model.state_dict().items()):
            assert torch.equal(x, y), name
        for x, y in zip(a.opt_state.momentum_buf, b.opt_state.momentum_buf):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(method=6, topk_ratio=0.1, sync_every=4),
    dict(method=4, num_aggregate=2),
], ids=["m6", "kofn"])
def test_captured_window_off_a_period_boundary(deterministic, kw):
    """One per-step dispatch, then three windows of K = 4 starting at steps
    1, 5 and 9: off the sync period and the K-of-N rotation, so the graph
    is captured for phase 1 and syncs (M6) inside the window. Against 13
    per-step dispatches, bit for bit."""
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.train.loop import Trainer

    kw = dict(kw)
    sync_every = kw.pop("sync_every", None)
    trainers = []
    for k in (1, 4):
        cfg = TrainConfig(network="LeNet", dataset="MNIST", batch_size=32,
                          epochs=100, num_workers=4, bf16_compute=False,
                          synthetic_data=True, feed="device", scan_window=k,
                          **kw)
        if sync_every:
            cfg.sync_every = sync_every
        trainers.append(Trainer(cfg))
    ref, win = trainers
    rx, ry = ref._device_split(ref._train_split())
    ref_rows = torch.stack([ref.train_step(ref.state, rx, ry, ref.base_key)
                            for _ in range(13)])
    x, y = win._device_split(win._train_split())
    rows = [win.train_step(win.state, x, y, win.base_key)[None]]
    ws = win.window_step
    ws.stream.wait_stream(torch.cuda.current_stream())
    with ws.stream_context():
        rows += [ws(win.state, x, y, win.base_key) for _ in range(3)]
    torch.cuda.current_stream().wait_stream(ws.stream)
    assert (ws.eager_windows, ws.captures, ws.replays) == (1, 1, 2)
    assert ws.phase(5) == ((1, 0) if sync_every else (0, 1))
    assert torch.equal(torch.cat(rows), ref_rows)
    for a, b in zip(ref.state.workers, win.state.workers):
        for (name, p), (_, q) in zip(a.model.state_dict().items(),
                                     b.model.state_dict().items()):
            assert torch.equal(p, q), name


def _resume_cfg(train_dir, **kw):
    from ewdml_tpu_torch.core.config import TrainConfig

    kw = dict(kw)
    sync_every = kw.pop("sync_every", None)
    cfg = TrainConfig(network="LeNet", dataset="MNIST", batch_size=32,
                      epochs=100, num_workers=4, log_every=1000,
                      bf16_compute=False, synthetic_data=True, feed="device",
                      train_dir=str(train_dir) + "/", **kw)
    if sync_every:
        cfg.sync_every = sync_every   # after the Method 6 preset
    return cfg


def _worker_tensors(t) -> list:
    out = []
    for ws in t.state.workers:
        out += list(ws.model.state_dict().values())
        out += list(ws.opt_state.momentum_buf) + list(ws.residual)
    return out


@pytest.mark.parametrize("case", ["m4_per_step", "m6_local_phase",
                                  "m4_window_captured_before_restore"])
def test_resume_equals_the_uninterrupted_run(deterministic, tmp_path, case):
    """Stopped at a save, restored in a fresh Trainer (in place) and
    carried on: bit-equal to the uninterrupted run, and the restored
    tensors equal the saved ones. M6 is saved inside its local phase (the
    workers differ); the windowed Trainer has captured its graph before
    the restore and replays it on the restored state."""
    import shutil

    from ewdml_tpu_torch.train import checkpoint
    from ewdml_tpu_torch.train.loop import Trainer
    from ewdml_tpu_torch.train.state import state_tree

    kw, stop, total = {
        "m4_per_step": (dict(method=4, scan_window=1, eval_freq=4), 4, 8),
        "m6_local_phase": (dict(method=6, topk_ratio=0.1, sync_every=4,
                                scan_window=1, eval_freq=5), 5, 8),
        "m4_window_captured_before_restore": (
            dict(method=4, scan_window=4, eval_freq=4), 4, 8),
    }[case]
    full = Trainer(_resume_cfg(tmp_path / "full", max_steps=total, **kw))
    fres = full.train()
    stopped = Trainer(_resume_cfg(tmp_path / "stop", max_steps=stop, **kw))
    sres = stopped.train()
    saved = [t.cpu().clone() for t in _worker_tensors(stopped)]
    path = checkpoint.latest_path(str(tmp_path / "stop"))
    if case.startswith("m4_window"):
        t = Trainer(_resume_cfg(tmp_path / "pre", max_steps=total, **kw))
        t.train()
        assert t.window_step.captures == 1
        shutil.copyfile(path, str(tmp_path / "pre" / "model_step_"))
        replays = t.window_step.replays
    else:
        t = Trainer(_resume_cfg(tmp_path / "stop", max_steps=total, **kw))
    assert t.maybe_restore() and t.state.step == stop
    for a, b in zip(_worker_tensors(t), saved):
        assert torch.equal(a.cpu(), b)
    if case == "m6_local_phase":
        leaf = state_tree(t.state.workers, t.specs, stacked=True)["params"]
        leaf = leaf["conv1"]["kernel"]
        assert not all(torch.equal(leaf[0], leaf[r]) for r in range(1, 4))
    rres = t.train()
    torch.cuda.synchronize()
    if case.startswith("m4_window"):
        assert t.window_step.captures == 1
        assert t.window_step.replays == replays + 1
    for a, b in zip(_worker_tensors(full), _worker_tensors(t)):
        assert torch.equal(a, b)
    assert torch.equal(torch.from_numpy(fres.rows[stop:]),
                       torch.from_numpy(rres.rows))
    assert sres.steps == stop


# -- the precision policy's store, Adam and --overlap bucket ---------------------

# ±0, subnormals, the largest finite in both signs, ±inf, NaN, values on
# the bf16 grid.
SPECIALS = [0.0, -0.0, 1e-40, -1e-40, 3.4028235e38, -3.4028235e38,
            float("inf"), float("-inf"), float("nan"), 1.0, -2.5, 0.15625]


def _same_bf16(a, b, what=""):
    """Bit-equal bf16 tensors, NaN lanes compared by ``isnan``."""
    assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    assert torch.equal(na, nb), what
    assert torch.equal(a.view(torch.int16)[~na], b.view(torch.int16)[~nb]), \
        what


@pytest.mark.parametrize("kind,shape", [
    ("conv", (256, 128, 3, 3)), ("conv", (64, 3, 3, 3)),
    ("dense", (10, 512)), ("vector", (4097,)), ("vector", (2_359_296,))])
def test_stochastic_round_kernel_is_the_plain_version(cuda, kind, shape):
    x = torch.randn(shape, device="cuda", generator=cuda)
    x.view(-1)[:len(SPECIALS)] = torch.tensor(SPECIALS, device="cuda")
    for key in ((0, 42), (0x9E3779B9, 0x7F4A7C15)):
        a = kernels.stochastic_round_bf16(x, key, kind)
        b = kernels.stochastic_round_ref(x, key, kind)
        _same_bf16(a, b, (kind, shape, key))
        out = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        assert kernels.stochastic_round_bf16(x, key, kind, out=out) is out
        _same_bf16(out, b)


def test_captured_stochastic_round_reads_each_replays_key(cuda):
    """A graph that captured the launch with a key-table key rounds under
    the key the table holds at each replay."""
    from ewdml_tpu_torch.utils import prng
    from ewdml_tpu_torch.utils.keytable import KeyTable

    x = torch.randn(64, 3, 3, 3, device="cuda", generator=cuda)
    table = KeyTable(prng.key(7), "cuda", 0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.stochastic_round_bf16(x, (1, 2), "conv")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernels.stochastic_round_bf16(
            x, prng.layer_key(table.step_key(0), 3), "conv")
    for start in (0, 5):
        table.load(start)
        graph.replay()
        torch.cuda.synchronize()
        want = prng.layer_key(prng.step_key(prng.key(7), start), 3)
        _same_bf16(out, kernels.stochastic_round_ref(x, want, "conv"))


def _network_leaves(network: str) -> list:
    """``(kind, torch shape)`` of the network's leaves, in JAX order."""
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs

    model = build_model(network, 10, dataset="Cifar10")
    named = dict(model.named_parameters())
    return [(s.kind, tuple(named[s.torch_name].shape))
            for s in leaf_specs(model)]


@pytest.mark.parametrize("network", ["VGG11", "ResNet50"])
def test_round_set_kernel_is_the_plain_version(cuda, network):
    """Every leaf shape singly, then the network's optimizer set (paths
    (i,)), its Adam set ((i, 0), (i, 1)) and a residual set of two
    workers ((tag, r, i)), with specials in each leaf, one launch per
    ``ROUND_MAX_LEAVES`` leaves."""
    leaves = _network_leaves(network)
    xs = []
    for kind, shape in leaves:
        x = torch.randn(shape, device="cuda", generator=cuda) * 1e-2
        n = min(len(SPECIALS), x.numel())
        x.view(-1)[:n] = torch.tensor(SPECIALS[:n], device="cuda")
        xs.append(x)
    kinds = [k for k, _ in leaves]
    for x, kind in sorted({(tuple(x.shape), k): (x, k)
                           for x, k in zip(xs, kinds)}.values(),
                          key=lambda v: tuple(v[0].shape)):
        _same_bf16(kernels.stochastic_round_bf16(x, (3, 4), kind),
                   kernels.stochastic_round_ref(x, (3, 4), kind),
                   (network, kind, tuple(x.shape)))
    n = len(xs)
    flat = [x.reshape(-1) for x in xs]  # residuals: the JAX layout's
    sets = [(xs, kinds, [(i,) for i in range(n)]),
            (xs + xs, kinds * 2,
             [(i, 0) for i in range(n)] + [(i, 1) for i in range(n)]),
            (flat + flat, ["vector"] * 2 * n,
             [(0x0E5F, r, i) for r in range(2) for i in range(n)])]
    for key in ((0, 42), (0x9E3779B9, 0x7F4A7C15)):
        for sx, sk, paths in sets:
            kernels.reset_launches()
            got = kernels.stochastic_round_set(key, sx, paths, sk)
            assert kernels.LAUNCHES["stochastic_round"] == \
                kernels.round_launches(len(sx))
            want = kernels.stochastic_round_set_ref(key, sx, paths, sk)
            for a, b, p in zip(got, want, paths):
                _same_bf16(a, b, (network, key, p))


@pytest.mark.parametrize("kind,shape", [
    ("dense", (10, 5)), ("dense", (7, 3)), ("conv", (6, 2, 2, 2)),
    ("conv", (3, 5, 3, 1)), ("dense", (9, 4097)), ("conv", (1, 5, 3, 3))])
def test_round_kernel_on_narrow_and_odd_leaves(cuda, kind, shape):
    """An innermost dim shorter than a vector (the carry chain), and odd
    sizes with a scalar tail."""
    x = torch.randn(shape, device="cuda", generator=cuda)
    for key in ((0, 42), (0x9E3779B9, 0x7F4A7C15)):
        _same_bf16(kernels.stochastic_round_bf16(x, key, kind),
                   kernels.stochastic_round_ref(x, key, kind), (kind, shape))


def test_round_set_kernel_on_unaligned_leaves(cuda):
    """Leaves off a 16-byte boundary take the kernel's scalar path."""
    base = torch.randn(4 * 4099 + 3, device="cuda", generator=cuda)
    xs = [base[1:4100], base[4100:4100 + 7], base[8200:8200 + 4096]]
    outs = [torch.empty(x.shape, dtype=torch.bfloat16,
                        device="cuda") for x in xs]
    ragged = torch.empty(4100, dtype=torch.bfloat16, device="cuda")[1:]
    outs[0] = ragged
    paths = [(1,), (2, 3), (4, 5, 6)]
    got = kernels.stochastic_round_set((7, 8), xs, paths, outs=outs)
    want = kernels.stochastic_round_set_ref((7, 8), xs, paths)
    for a, b in zip(got, want):
        _same_bf16(a, b)


def test_captured_round_set_reads_each_replays_key(cuda):
    """A graph that captured a set's launch under a key-table parent key
    rounds each leaf under the key its path folds from the key the table
    holds at each replay."""
    from ewdml_tpu_torch.utils import prng
    from ewdml_tpu_torch.utils.keytable import KeyTable

    leaves = _network_leaves("VGG11")
    xs = [torch.randn(s, device="cuda", generator=cuda) for _, s in leaves]
    kinds = [k for k, _ in leaves]
    paths = [(i,) for i in range(len(xs))]
    table = KeyTable(prng.key(7), "cuda", 0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.stochastic_round_set((1, 2), xs, paths, kinds)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = kernels.stochastic_round_set(
            prng.fold_in(table.step_key(0), 0x0917), xs, paths, kinds)
    for start in (0, 5):
        table.load(start)
        graph.replay()
        torch.cuda.synchronize()
        want = prng.fold_in(prng.step_key(prng.key(7), start), 0x0917)
        for a, b in zip(outs, kernels.stochastic_round_set_ref(
                want, xs, paths, kinds)):
            _same_bf16(a, b)


# 2 359 296 (VGG11-BN's and ResNet50's largest leaf, the shared-scale
# encode's draw) and 2 359 299 pass the 132 x 8 blocks of 1 024 elements
# where the grid stops growing, so the threads loop, the second with a tail.
@pytest.mark.parametrize("n", [1, 7, 4099, 2**17 - 1, 2_359_296, 2_359_299])
def test_draw_kernel_is_the_plain_version(cuda, n):
    """The bits (int64) and uniform (f32) against the plain versions (a
    key-table key: the captured test below); one launch a draw, also in
    permutation (a draw a round), randint (two) and uniform."""
    from ewdml_tpu_torch.utils import prng
    from ewdml_tpu_torch.utils.keytable import KeyTable

    for key in ((0, 42), (0x9E3779B9, 0x7F4A7C15)):
        for uniform in (False, True):
            kernels.reset_launches()
            a = kernels.random_bits(key, n, "cuda", uniform=uniform)
            assert kernels.LAUNCHES["random_bits"] == 1
            b = kernels.random_bits_ref(key, n, "cuda", uniform=uniform)
            assert a.dtype == b.dtype and a.shape == b.shape == (n,)
            assert torch.equal(a.view(torch.int32) if uniform else a,
                               b.view(torch.int32) if uniform else b), \
                (n, key, uniform)
    tkey = KeyTable(prng.key(9), "cuda", 3).step_key(4)
    kernels.reset_launches()
    prng.permutation(tkey, n, "cuda")
    prng.randint(tkey, (n,), 0, 9, "cuda")
    prng.uniform(tkey, (n,), "cuda")
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2**32 - 1)))
    assert kernels.LAUNCHES["random_bits"] == rounds + 2 + 1


def test_captured_draw_reads_each_replays_key(cuda):
    from ewdml_tpu_torch.utils import prng
    from ewdml_tpu_torch.utils.keytable import KeyTable

    table = KeyTable(prng.key(5), "cuda", 0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.random_bits((1, 2), 4099, "cuda")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bits = prng.random_bits(prng.fold_in(table.step_key(0), 3), 4099,
                                "cuda")
        u = prng.uniform(prng.fold_in(table.step_key(0), 4), (4099,), "cuda")
    for start in (0, 5):
        table.load(start)
        graph.replay()
        torch.cuda.synchronize()
        skey = prng.step_key(prng.key(5), start)
        assert torch.equal(bits, kernels.random_bits_ref(
            prng.fold_in(skey, 3), 4099, "cuda"))
        assert torch.equal(u.view(torch.int32), kernels.random_bits_ref(
            prng.fold_in(skey, 4), 4099, "cuda", uniform=True).view(
                torch.int32))


def _state_tensors(trainer) -> list:
    out = []
    for ws in trainer.state.workers:
        out += list(ws.model.state_dict().values()) + list(ws.residual)
        st = ws.opt_state
        out += ([st.count] + list(st.mu) + list(st.nu)
                if hasattr(st, "mu") else list(st.momentum_buf))
    return out


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_lenet_bf16_state_runs_through_the_kernel(cuda, tmp_path, optimizer):
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.train.loop import Trainer

    cfg = TrainConfig(network="LeNet", dataset="mnist10k", batch_size=32,
                      max_steps=3, epochs=100, num_workers=4, method=4,
                      error_feedback=True, optimizer=optimizer,
                      precision_policy="bf16_wire_state", bf16_compute=False,
                      log_every=1000, train_dir=str(tmp_path) + "/")
    t = Trainer(cfg)
    kernels.reset_launches()
    res = t.train()
    torch.cuda.synchronize()
    assert res.steps == 3 and torch.isfinite(torch.tensor(res.final_loss))
    stores = 2 if optimizer == "adam" else 1
    # Per step: one store set a worker's optimizer update (its 8 leaves,
    # both moments under Adam) and one set of every worker's residuals.
    assert kernels.LAUNCHES["stochastic_round"] == 3 * (
        4 * kernels.round_launches(8 * stores) + kernels.round_launches(8 * 4))
    ws = t.state.workers
    assert all(r.dtype == torch.bfloat16 for r in ws[0].residual)
    # The optimizer key is rank-shared: the replicas stay bit-identical.
    for w in ws[1:]:
        for a, b in zip(ws[0].model.parameters(), w.model.parameters()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(method=1, precision_policy="bf16_wire"),
    dict(method=3, collective="fused_q"),
    dict(method=4, error_feedback=True, precision_policy="bf16_wire_state"),
], ids=["m1_bf16", "m3_fused_q", "m4_ef_bf16_state"])
def test_overlap_stream_schedule_is_the_inline_one(deterministic, tmp_path,
                                                   kw):
    """``--overlap bucket``: the side-stream schedule (each bucket issued
    from the last worker's backward hooks) against every bucket inline
    after the backward, bit for bit."""
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.parallel import overlap
    from ewdml_tpu_torch.train.loop import Trainer

    runs = []
    try:
        for schedule in ("stream", "inline"):
            overlap.configure(schedule)
            cfg = TrainConfig(network="LeNet", dataset="mnist10k",
                              batch_size=32, max_steps=3, epochs=100,
                              num_workers=4, overlap="bucket",
                              overlap_buckets=3, bf16_compute=False,
                              log_every=1000,
                              train_dir=str(tmp_path / schedule) + "/", **kw)
            t = Trainer(cfg)
            res = t.train()
            torch.cuda.synchronize()
            runs.append((t, res))
    finally:
        overlap.configure("stream")
    (a, ares), (b, bres) = runs
    assert torch.equal(torch.from_numpy(ares.rows), torch.from_numpy(bres.rows))
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        assert torch.equal(x, y)


def test_overlap_bf16_adam_window_replays_match_per_step(deterministic,
                                                         tmp_path):
    """M4 with error feedback, ``bf16_wire_state``, Adam and ``--overlap
    bucket``: 12 steps at K = 4 against 12 per-step dispatches, bit for
    bit (the side stream forked and joined inside the capture)."""
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.train.loop import Trainer

    runs = []
    for k in (1, 4):
        cfg = TrainConfig(network="LeNet", dataset="MNIST", batch_size=32,
                          max_steps=12, epochs=100, num_workers=4, method=4,
                          error_feedback=True, optimizer="adam",
                          precision_policy="bf16_wire_state",
                          overlap="bucket", overlap_buckets=2,
                          bf16_compute=False, log_every=1000,
                          synthetic_data=True, feed="device", scan_window=k,
                          train_dir=str(tmp_path / f"k{k}") + "/")
        t = Trainer(cfg)
        kernels.reset_launches()
        res = t.train()
        torch.cuda.synchronize()
        runs.append((t, res, dict(kernels.LAUNCHES)))
    (ref, rres, rl), (win, wres, wl) = runs
    assert (win.window_step.captures, win.window_step.replays) == (1, 2)
    assert torch.equal(torch.from_numpy(wres.rows), torch.from_numpy(rres.rows))
    # Per step: a store set a worker's Adam update (16 leaves), one set of
    # residuals a bucket (at most 8 leaves x 4 workers, one launch each).
    assert wl == rl and rl["stochastic_round"] == 12 * (
        4 * kernels.round_launches(16) + 2)
    for x, y in zip(_state_tensors(ref), _state_tensors(win)):
        assert torch.equal(x, y)
