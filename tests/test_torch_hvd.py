"""The horovod-style API of the port (``ewdml_tpu_torch/hvd``) against the
JAX package's (``ewdml_tpu/hvd``) on the conftest's 8-device mesh: W = 8
on both sides, the same gradients (numpy, from a seed), the same keys.

Oracles, per test:
- exact: the dense Average and Sum (gradients on a 1/8 grid, so every sum
  is exact in any order), the API basics, weight files crossing between
  the packages, the example's run;
- tolerance: predivide, the quirk, Adasum and QSGD/Top-k QSGD through the
  API, each within a few ulps of the update's scale (measured: at most 2
  ulps of the largest update, no quantization level or Top-k winner
  flipped at these sizes); the keras fit's loss history and parameters.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ewdml_tpu import hvd as jhvd
from ewdml_tpu.data import datasets as jdatasets
from ewdml_tpu.hvd import keras as JK
from ewdml_tpu.models import build_model as jbuild_model
from ewdml_tpu.ops import make_compressor as jmake_compressor
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu.optim import SGD as JSGD
from ewdml_tpu_torch import hvd
from ewdml_tpu_torch.hvd import keras as K
from ewdml_tpu_torch.models import build_model
from ewdml_tpu_torch.ops import kernels, make_compressor
from ewdml_tpu_torch.optim import SGD
from ewdml_tpu_torch.utils import prng

torch.set_num_threads(2)

W = 8


@pytest.fixture(autouse=True)
def world():
    # Both packages' kernel modes are process-wide; a test that left the
    # JAX package's at 'interpret' would run these exchanges through the
    # Pallas interpreter inside shard_map (minutes, where 'auto' takes a
    # second), so they are set before each test and restored after.
    kernels.configure("auto")
    pk.configure("auto")
    yield hvd.init(W, platform="cpu")
    kernels.configure("auto")
    pk.configure("auto")


def jax_updates(mesh, dopt, grads8, key=None):
    """The JAX optimizer's per-rank update ``u`` from zero parameters."""
    params = {"w": jnp.zeros(grads8.shape[1:])}
    state = dopt.init(params)

    def body(g):
        u, _ = dopt.update({"w": g[0]}, state, params, key=key)
        return u["w"][None]

    return np.asarray(jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
        check_vma=False))(jnp.asarray(grads8)))


def port_updates(dopt, grads8, key=None, per_rank=False):
    """The port optimizer's per-rank parameters after one step from zero
    (with SGD(1.0), the update ``u``): one shared replica, or W."""
    g = torch.from_numpy(np.array(grads8))
    if per_rank:
        params = [[torch.zeros(g.shape[1:])] for _ in range(W)]
        state = [dopt.init(p) for p in params]
    else:
        params = [[torch.zeros(g.shape[1:])]] * W
        state = [dopt.init(params[0])] * W
    dopt.update([[g[r]] for r in range(W)], state, params, key=key)
    return np.stack([params[r][0].numpy() for r in range(W)])


def grid_grads(seed: int, n: int) -> np.ndarray:
    """Gradients on a 1/8 grid: every partial sum is exact."""
    rs = np.random.RandomState(seed)
    return (rs.randint(-64, 64, size=(W, n)) / 8.0).astype(np.float32)


def scaled_grads(seed: int, n: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    return (rs.randn(W, n) * np.linspace(1.0, 4.0, W)[:, None]).astype(
        np.float32)


def close(a, b, ulps: float = 4.0):
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=ulps * 1.2e-7 * np.abs(b).max())


class TestBasics:
    def test_size_rank_and_identities(self):
        """Exact: W, the controller's rank, the broadcast identity, the
        metric allreduce of per-rank values."""
        assert hvd.size() == W == jax.device_count()
        assert hvd.rank() == jhvd.rank() == 0
        assert hvd.local_rank() == jhvd.local_rank() == 0
        p = [torch.ones(3)]
        assert hvd.broadcast_parameters(p, root_rank=0) is p
        assert hvd.broadcast_optimizer_state is hvd.broadcast_parameters
        vals = [torch.tensor(float(r)) for r in range(W)]
        assert float(hvd.allreduce(vals)) == 3.5
        assert float(hvd.allreduce(vals, average=False)) == 28.0
        t = torch.tensor(2.0)
        assert hvd.allreduce(t) is t

    def test_bad_op(self):
        with pytest.raises(ValueError):
            hvd.DistributedOptimizer(SGD(0.1), op="Max")


class TestDistributedOptimizer:
    @pytest.mark.parametrize("op", ["Average", "Sum"])
    def test_dense_average_and_sum_exact(self, mesh, op):
        """Exact: the dense mean (and its W-fold Sum) equal JAX's."""
        g = grid_grads(0, 48)
        want = jax_updates(mesh, jhvd.DistributedOptimizer(JSGD(1.0), op=op),
                           g)
        got = port_updates(hvd.DistributedOptimizer(SGD(1.0), op=op), g)
        np.testing.assert_array_equal(got, want)
        mean = g.mean(axis=0) * (W if op == "Sum" else 1)
        np.testing.assert_array_equal(got[0], -mean)

    def test_predivide(self, mesh):
        """Tolerance (4 ulps of the largest update): the predivided mean."""
        g = scaled_grads(1, 64)
        want = jax_updates(mesh, jhvd.DistributedOptimizer(
            JSGD(1.0), gradient_predivide_factor=3.0), g)
        got = port_updates(hvd.DistributedOptimizer(
            SGD(1.0), gradient_predivide_factor=3.0), g)
        close(got, want)

    def test_quirk_ranks_differ_and_match_jax(self, mesh):
        """Tolerance (4 ulps): under the quirk each rank rescales the mean
        levels by its own norm, so ranks differ, and each rank's result is
        JAX's; without it every rank holds one result."""
        g = scaled_grads(2, 64)
        for quirk in (True, False):
            want = jax_updates(mesh, jhvd.DistributedOptimizer(
                JSGD(1.0), compressor=jmake_compressor("qsgd"),
                quirk_average_levels=quirk), g, key=jax.random.key(1))
            dopt = hvd.DistributedOptimizer(
                SGD(1.0), compressor=make_compressor("qsgd"),
                quirk_average_levels=quirk)
            got = port_updates(dopt, g, key=prng.key(1), per_rank=True)
            close(got, want)
            if quirk:
                assert not np.allclose(got[0], got[7])
            else:
                np.testing.assert_array_equal(got[0], got[7])

    def test_quirk_returns_one_result_per_rank(self):
        """Exact: the reduced gradients of the quirk are W lists, of the
        default one list W times."""
        g = torch.from_numpy(scaled_grads(3, 32))
        grads = [[g[r]] for r in range(W)]
        quirk = hvd.DistributedOptimizer(
            SGD(1.0), compressor=make_compressor("qsgd"),
            quirk_average_levels=True).exchange(grads, prng.key(4))
        assert len({id(x) for x in quirk}) == W
        plain = hvd.DistributedOptimizer(
            SGD(1.0), compressor=make_compressor("qsgd")).exchange(
                grads, prng.key(4))
        assert len({id(x) for x in plain}) == 1

    def test_adasum(self, mesh):
        """Tolerance (16 ulps of the largest update: eight dot products
        summed in different orders): Adasum over QSGD payloads; and the
        identity a ⊕ a = a on identical dense gradients."""
        g = scaled_grads(5, 64)
        want = jax_updates(mesh, jhvd.DistributedOptimizer(
            JSGD(1.0), compressor=jmake_compressor("qsgd"), op="Adasum"),
            g, key=jax.random.key(3))
        got = port_updates(hvd.DistributedOptimizer(
            SGD(1.0), compressor=make_compressor("qsgd"), op="Adasum"),
            g, key=prng.key(3))
        close(got, want, ulps=16)
        same = np.broadcast_to(scaled_grads(6, 16)[:1], (W, 16)).copy()
        got = port_updates(hvd.DistributedOptimizer(
            SGD(1.0), compressor=make_compressor("none"), op="Adasum"),
            same, key=prng.key(3))
        np.testing.assert_allclose(got[0], -same[0], rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("name", ["qsgd", "topk_qsgd"])
    def test_compression_through_the_api(self, mesh, name):
        """Tolerance with bounded flips: ``Compression.qsgd()`` and
        ``Compression.topk_qsgd(0.02, exact='block')`` (the Method-5 block
        wire) on (8, 20 000); at most 0.1% of the elements may move by a
        flipped level or winner (measured: none), the rest within 4 ulps;
        the Top-k update touches at most 8 x nb elements."""
        g = np.asarray(jax.random.normal(jax.random.key(3), (W, 20_000)))
        if name == "qsgd":
            jc, tc = jhvd.Compression.qsgd(), hvd.Compression.qsgd()
        else:
            jc = jhvd.Compression.topk_qsgd(ratio=0.02, exact="block")
            tc = hvd.Compression.topk_qsgd(ratio=0.02, exact="block")
        want = jax_updates(mesh, jhvd.DistributedOptimizer(
            JSGD(1.0), compressor=jc), g, key=jax.random.key(5))
        got = port_updates(hvd.DistributedOptimizer(SGD(1.0), compressor=tc),
                           g, key=prng.key(5))
        off = np.abs(got - want) > 4 * 1.2e-7 * np.abs(want).max()
        assert off.sum() <= 0.001 * off.size, int(off.sum())
        if name == "topk_qsgd":
            from ewdml_tpu.ops import blocktopk
            nb, _, _ = blocktopk.geometry(20_000, 0.02)
            assert 0 < np.count_nonzero(got[0]) <= W * nb

    def test_inner_key_and_foreign_optimizer(self):
        """Exact: the inner optimizer's stores draw from
        ``fold_in(key, 0x0917)`` (passed through), and a foreign optimizer
        of the ``update(grads, state, params, lr=None)`` protocol (the JAX
        package's) works unchanged and is given the caller's lr."""
        seen = {}

        class Keyed(SGD):
            def update(self, grads, state, params, key=None, kinds=None,
                       lr=None):
                seen["key"], seen["lr"] = key, lr
                return super().update(grads, state, params, key=key,
                                      kinds=kinds, lr=lr)

        class Plain:
            def init(self, params):
                return None

            def update(self, grads, state, params, lr=None):
                seen["plain_lr"] = lr
                for p, g in zip(params, grads):
                    p.add_(-0.5 * g)

        g = grid_grads(7, 8)
        port_updates(hvd.DistributedOptimizer(Keyed(1.0)), g)
        assert seen["key"] is None
        dopt = hvd.DistributedOptimizer(Keyed(1.0))
        p = [torch.zeros(8)]
        dopt.update([[torch.from_numpy(g[r])] for r in range(W)],
                    [dopt.init(p)] * W, [p] * W, key=prng.key(9), lr=0.25)
        assert seen["key"] == prng.fold_in(prng.key(9), 0x0917)
        assert seen["lr"] == 0.25
        got = port_updates(hvd.DistributedOptimizer(Plain()), g)
        np.testing.assert_array_equal(got[0], -0.5 * g.mean(axis=0))
        assert seen["plain_lr"] is None
        dopt = hvd.DistributedOptimizer(Plain())
        dopt.update([[torch.from_numpy(g[r])] for r in range(W)],
                    [None] * W, [[torch.zeros(8)]] * W, lr=0.25)
        assert seen["plain_lr"] == 0.25


@pytest.fixture(scope="module")
def mnist_synth():
    return (jdatasets.load("MNIST", train=True, synthetic=True,
                           synthetic_size=512),
            jdatasets.load("MNIST", train=False, synthetic=True,
                           synthetic_size=128))


class TestKeras:
    def test_fit_matches_jax_and_callbacks_fire(self, mnist_synth, tmp_path):
        """Tolerance with bounded flips: a 2-epoch ``fit`` (W = 8, batch 8,
        LeNet from the JAX model's initial weights, warmup) against JAX's.
        Gradients agree to f32 rounding (about 1e-6 of a leaf), but where
        two values of a max-pool window lie within that rounding the two
        frameworks can route the gradient to different elements, a jump
        of ~1e-4 of a leaf that later steps carry (measured on this data:
        3.5e-7 for four steps, then 1.2e-4). So: the loss history and the
        evaluation within 1e-3 relative, the accuracies equal, and per
        leaf ||d||_2 <= 2e-2 ||m||_2, d the difference of the final
        parameters and m JAX's own move from the initial ones (the slice
        tests' bound); every callback fires; rank 0's weight file is
        written each epoch."""
        train, test = mnist_synth
        jm = JK.Model(jbuild_model("LeNet", 10), input_shape=(28, 28, 1))
        jm.save_weights(str(tmp_path / "init.npz"))
        jm.compile(JSGD(0.01, momentum=0.9), scale_lr=False)
        jcb = [JK.LearningRateWarmupCallback(warmup_epochs=2)]
        jh = jm.fit(train.images, train.labels, batch_size=8, epochs=2,
                    callbacks=jcb, verbose=0)
        jev = jm.evaluate(test.images, test.labels)

        tm = K.Model(build_model("LeNet", 10), input_shape=(28, 28, 1))
        tm.load_weights(str(tmp_path / "init.npz"))
        tm.compile(SGD(0.01, momentum=0.9), scale_lr=False)
        fired = []

        class Probe(K.Callback):
            def on_train_begin(self, logs=None):
                fired.append("begin")

            def on_epoch_begin(self, epoch, logs=None):
                fired.append(("epoch", epoch, self.model.lr_multiplier))

            def on_epoch_end(self, epoch, logs=None):
                fired.append(("end", epoch, logs["loss"]))

        th = tm.fit(train.images, train.labels, batch_size=8, epochs=2,
                    callbacks=[K.BroadcastGlobalVariablesCallback(0),
                               K.MetricAverageCallback(),
                               K.LearningRateWarmupCallback(warmup_epochs=2),
                               K.ModelCheckpoint(str(tmp_path /
                                                     "ckpt-{epoch}.npz")),
                               Probe()],
                    verbose=0)
        np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                                   rtol=1e-3)
        assert th.history["accuracy"] == jh.history["accuracy"]
        tev = tm.evaluate(test.images, test.labels)
        assert abs(tev["loss"] - jev["loss"]) <= 1e-3 * abs(jev["loss"])
        assert tev["accuracy"] == jev["accuracy"]
        jp, tp = jm.params, tm.params
        with np.load(str(tmp_path / "init.npz")) as init:
            for layer in jp:
                for leaf in jp[layer]:
                    a = np.asarray(jp[layer][leaf])
                    move = a - init[f"['{layer}']['{leaf}']"]
                    d = tp[layer][leaf] - a
                    assert (np.linalg.norm(d)
                            <= 2e-2 * np.linalg.norm(move)), (layer, leaf)
        assert fired[0] == "begin"
        assert [f[:2] for f in fired[1:]] == [("epoch", 0), ("end", 0),
                                              ("epoch", 1), ("end", 1)]
        # Warmup over 2 epochs at W = 8: 1/8 + 7/8 * (epoch + 1) / 2.
        assert fired[1][2] == pytest.approx(1 / 8 + 7 / 16)
        assert fired[3][2] == 1.0
        assert (tmp_path / "ckpt-0.npz").exists()
        assert (tmp_path / "ckpt-1.npz").exists()

    def test_compile_scales_lr_without_mutating(self):
        """Exact: lr x W, the caller's optimizer untouched, twice."""
        opt = SGD(0.01, momentum=0.9)
        m = K.Model(build_model("LeNet", 10), input_shape=(28, 28, 1))
        m.compile(opt)
        m.compile(opt)
        assert opt.lr == 0.01 and m._base_lr == 0.01 * W
        assert m.optimizer.optimizer is not opt
        m.compile(opt, scale_lr=False)
        assert m._base_lr == 0.01

    def test_batch_stats_are_rank_zeros(self, tmp_path):
        """Exact: after a step the BatchNorm statistics are rank 0's own
        batch update (the JAX step's ``out_specs=P()`` keeps rank 0's
        shard; it does not average them over the ranks)."""
        from ewdml_tpu_torch.models.layers import BatchNorm

        class Tiny(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.conv0 = torch.nn.Conv2d(1, 4, 3)
                self.bn0 = BatchNorm(4)
                self.fc = torch.nn.Linear(4, 10)

            def forward(self, x, train=False, generator=None):
                x = self.bn0(self.conv0(x.permute(0, 3, 1, 2)), train=train)
                return self.fc(x.mean(dim=(2, 3)))

        torch.manual_seed(0)
        m = K.Model(Tiny(), input_shape=(8, 8, 1))
        m.compile(SGD(0.0))
        rs = np.random.RandomState(0)
        x = rs.randn(2 * W, 8, 8, 1).astype(np.float32) * np.repeat(
            np.arange(1, W + 1), 2)[:, None, None, None].astype(np.float32)
        y = rs.randint(0, 10, 2 * W)
        m.fit(x, y, batch_size=2, epochs=1, verbose=0)
        # Rank 0's rows: the first two of the fit's shuffle (seed 0).
        order = np.random.RandomState(0).permutation(2 * W)[:2]
        with torch.no_grad():
            feats = m.module.conv0(torch.from_numpy(x[order]).permute(
                0, 3, 1, 2))
            mean = feats.float().mean(dim=(0, 2, 3))
        np.testing.assert_allclose(m.module.bn0.running_mean.numpy(),
                                   (0.1 * mean).numpy(), rtol=1e-6,
                                   atol=1e-7)

    def test_foreign_optimizer_gets_the_scaled_warmed_lr(self, mnist_synth):
        """Exact: under ``fit`` a foreign optimizer (no key) is given
        lr x W times the warmup's multiplier at every step: W = 8, two
        epochs of two steps, ``LearningRateWarmupCallback(2)``."""
        lrs = []

        class Foreign:
            lr = 0.01

            def init(self, params):
                return None

            def update(self, grads, state, params, lr=None):
                lrs.append(lr)
                for p, g in zip(params, grads):
                    p.add_(-lr * g)

        train, _ = mnist_synth
        m = K.Model(build_model("LeNet", 10), input_shape=(28, 28, 1))
        m.compile(Foreign())
        m.fit(train.images[:32], train.labels[:32], batch_size=2, epochs=2,
              callbacks=[K.LearningRateWarmupCallback(warmup_epochs=2)],
              verbose=0)
        base = 0.01 * W
        assert lrs == [base * (1 / W + (1 - 1 / W) / 2)] * 2 + [base] * 2

    def test_batch_stats_match_jax(self, tmp_path, monkeypatch):
        """Tolerance: the BatchNorm statistics ``fit`` returns against the
        JAX ``Model.batch_stats`` after the same fit: a narrow VGG with
        BatchNorm (8-M-16-M-16-16-M), W = 8, batch 2 a worker, two steps of
        SGD(0.05, momentum 0.9) from one weight file, dropout off on both
        sides. Every sample has its own scale, so the ranks' batches
        differ and an average over the ranks would not match rank 0's.
        Each leaf within 1e-5 relative plus 1e-5 of its largest value (the
        model tests' bound for a BatchNorm update)."""
        import flax.linen as nn

        from ewdml_tpu.models import VGG as JVGG
        from ewdml_tpu_torch.models import VGG
        from ewdml_tpu_torch.models.layers import Dropout

        monkeypatch.setattr(nn.Dropout, "__call__",
                            lambda self, x, deterministic=None, rng=None: x)
        monkeypatch.setattr(Dropout, "forward",
                            lambda self, x, train=False, generator=None: x)
        cfg = (8, "M", 16, "M", 16, 16, "M")
        rs = np.random.RandomState(0)
        n = 2 * W * 2
        x = (rs.randn(n, 32, 32, 3) * (1 + np.arange(n) / 4)[
            :, None, None, None]).astype(np.float32)
        y = rs.randint(0, 10, n)
        jm = JK.Model(JVGG(cfg=cfg, batch_norm=True, num_classes=10),
                      input_shape=(32, 32, 3))
        jm.save_weights(str(tmp_path / "init.npz"))
        jm.compile(JSGD(0.05, momentum=0.9), scale_lr=False)
        jm.fit(x, y, batch_size=2, epochs=1, verbose=0)
        tm = K.Model(VGG(cfg=cfg, batch_norm=True, num_classes=10),
                     input_shape=(32, 32, 3))
        tm.load_weights(str(tmp_path / "init.npz"))
        tm.compile(SGD(0.05, momentum=0.9), scale_lr=False)
        tm.fit(x, y, batch_size=2, epochs=1, verbose=0)
        flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(jm.batch_stats)[0]}
        got = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
               jax.tree_util.tree_flatten_with_path(tm.batch_stats)[0]}
        assert sorted(got) == sorted(flat) and len(flat) == 8
        for k, want in flat.items():
            np.testing.assert_allclose(
                got[k], want, rtol=1e-5,
                atol=1e-5 * np.abs(want).max(), err_msg=k)

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_weights_cross_between_packages(self, tmp_path, direction):
        """Exact: a ``save_weights`` file of either package loads in the
        other, every leaf bit-equal in Flax layout."""
        jm = JK.Model(jbuild_model("LeNet", 10), input_shape=(28, 28, 1),
                      seed=3)
        tm = K.Model(build_model("LeNet", 10, seed=5),
                     input_shape=(28, 28, 1))
        path = str(tmp_path / "w.npz")
        if direction == "jax_to_port":
            jm.save_weights(path)
            tm.load_weights(path)
        else:
            tm.save_weights(path)
            jm.load_weights(path)
        jp, tp = jm.params, tm.params
        assert sorted(jp) == sorted(tp)
        for layer in jp:
            for leaf in jp[layer]:
                np.testing.assert_array_equal(np.asarray(jp[layer][leaf]),
                                              tp[layer][leaf])
        with np.load(path) as data:
            assert "['conv1']['kernel']" in data.files

    def test_example_runs(self, tmp_path, capsys):
        """Exact: ``python -m ewdml_tpu_torch.examples.horovod_style`` runs
        on the CPU: W = 2, one epoch, its lines and its weight file."""
        from ewdml_tpu_torch.examples import horovod_style

        with contextlib.chdir(tmp_path):
            assert horovod_style.main(["--platform", "cpu", "--num-workers",
                                       "2", "--epochs", "1"]) == 0
        out = capsys.readouterr().out
        assert "world size: 2, rank: 0" in out
        assert "loss history:" in out and "eval:" in out
        assert os.path.exists(tmp_path / "checkpoint-0.npz")
