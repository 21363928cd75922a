"""The port's ResNet family (and the s2d VGG) against the JAX package's.

Oracles:
- leaf order and shapes, BatchNorm statistic paths, the Flax round trip:
  bit (names, shapes and values equal). The JAX trees come from
  ``jax.eval_shape``, so no init runs.
- forward and backward of small ResNets in train mode from one Flax init:
  tolerance, the VGG test's (``tests/test_torch_models.py``): logits and
  BN statistics within rtol 1e-5 (atol 1e-5 of the tensor's largest value),
  every gradient within rtol 1e-4 and atol 1e-5 of the model's largest.
  Both sides run in float64 (the port's model ``.double()``, Flax's with
  ``dtype=float64`` under ``jax.enable_x64``; the logits are cast to float32
  on both sides, as the models do), which holds the two functions equal to
  ~1e-7 whatever the conditioning of the network. In float32 it is poor
  here: at batch 4 every BatchNorm of a block divides by the spread of a
  few values, and pre-ReLU values lie within 2e-6 of zero, so float32
  gradients of the small ResNets differ from float64 ones by up to 3e-4 of
  the largest gradient in the port and 1.1e-2 (BasicBlock) in Flax on
  XLA:CPU; no tolerance of the VGG test holds between them.
- the Kaiming fan-out init: statistics, the std of ResNet50's largest conv
  kernel (2 359 296 draws) within 5% of sqrt(2 / fan_out).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.models import BasicBlock as JBasic
from ewdml_tpu.models import Bottleneck as JBottleneck
from ewdml_tpu.models import ResNet as JResNet
from ewdml_tpu.models import build_model as jbuild
from ewdml_tpu.train.trainer import cross_entropy as jce
from ewdml_tpu_torch.models import (BasicBlock, Bottleneck, ResNet,
                                    build_model)
from ewdml_tpu_torch.models.convert import (flax_to_torch, leaf_specs,
                                            torch_to_flax)
from ewdml_tpu_torch.models.layers import BatchNorm
from ewdml_tpu_torch.train.trainer import cross_entropy
from test_torch_models import _compare

torch.set_num_threads(2)

NETWORKS = ["resnet18", "resnet34", "resnet50", "resnet50s2d", "resnet101",
            "resnet152", "vgg11s2d"]


def _flax_shapes(network: str):
    jm = jbuild(network, 10)
    v = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((2, 32, 32, 3)), train=False),
        jax.random.key(0))
    return tuple(
        [("/".join(p.key for p in path), tuple(x.shape)) for path, x in
         jax.tree_util.tree_flatten_with_path(v[col])[0]]
        for col in ("params", "batch_stats"))


@pytest.mark.parametrize("network", NETWORKS)
def test_leaf_order_and_shapes_match_flax(network):
    """Bit: the leaves in ``jax.tree.flatten`` order (nested keys sorted at
    every level, ``layer3_1 < layer3_10 < layer3_2`` in ResNet152) with
    their Flax shapes, and the BatchNorm statistics at their Flax paths."""
    params, stats = _flax_shapes(network)
    model = build_model(network, 10, dataset="cifar10")
    assert [(s.name, s.jax_shape) for s in leaf_specs(model)] == params
    _, tstats = torch_to_flax(model)
    tflat = [("/".join(p.key for p in path), tuple(x.shape)) for path, x in
             jax.tree_util.tree_flatten_with_path(tstats)[0]]
    assert tflat == stats


def test_resnet50_has_the_reference_leaves():
    """Bit: ResNet50's leaf, parameter and statistic counts."""
    model = build_model("ResNet50", 10, dataset="cifar10")
    specs = leaf_specs(model)
    assert len(specs) == 161
    assert sum(p.numel() for p in model.parameters()) == 23_520_842
    assert len(list(model.buffers())) == 106
    assert specs[0].name == "bn1/bias"
    assert specs[-1].name == "linear/kernel"


@pytest.mark.parametrize("network", ["resnet18", "resnet50s2d", "vgg11s2d"])
def test_flax_round_trip_is_exact(network):
    """Bit: Flax params and statistics -> the model -> Flax again."""
    params, stats = _flax_shapes(network)
    rng = np.random.RandomState(7)

    def nest(flat):
        tree = {}
        for path, shape in flat:
            *parents, leaf = path.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = rng.randn(*shape).astype(np.float32)
        return tree

    fp, fs = nest(params), nest(stats)
    model = build_model(network, 10, dataset="cifar10")
    model.load_state_dict(flax_to_torch(model, fp, fs))
    bp, bs = torch_to_flax(model)
    for a, b in ((fp, bp), (fs, bs)):
        la = jax.tree_util.tree_flatten_with_path(a)[0]
        lb = jax.tree_util.tree_flatten_with_path(b)[0]
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (path, x), (_, y) in zip(la, lb):
            assert x.shape == y.shape and np.array_equal(
                x.view(np.uint32), y.view(np.uint32)), path


SMALL = {
    "bottleneck": (JBottleneck, Bottleneck, False),
    "basic": (JBasic, BasicBlock, False),
    "bottleneck_s2d": (JBottleneck, Bottleneck, True),
}


@pytest.mark.parametrize("hw,c", [(32, 3), (28, 1)])
@pytest.mark.parametrize("kind", list(SMALL))
def test_small_resnet_train_mode_matches_flax(kind, hw, c):
    """Tolerance (module docstring): logits, loss, every gradient and the
    updated BN statistics at batch 4. At 28x28 stage 4 sees 7x7, where the
    stride-2 shortcut's SAME padding and the 3x3 conv's padding=1 must give
    the same 4x4 output."""
    jblock, tblock, s2d = SMALL[kind]
    rng = np.random.RandomState(hw + c)
    x = rng.randn(4, hw, hw, c).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.int32)
    jkw = dict(block=jblock, num_blocks=(1, 1, 1, 1), num_classes=10,
               space_to_depth=s2d)
    variables = JResNet(**jkw).init(jax.random.key(0), jnp.asarray(x[:2]),
                                    train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    with jax.enable_x64():
        jmodel = JResNet(dtype=jnp.float64, **jkw)
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)

        def loss_fn(p):
            logits, upd = jmodel.apply(
                {"params": p, "batch_stats": f64(stats)},
                jnp.asarray(x, jnp.float64), train=True,
                mutable=["batch_stats"])
            return jce(logits, jnp.asarray(y)), (logits, upd)

        (jloss, (jlogits, jupd)), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(f64(params))
        ref = jax.tree.map(np.asarray, (jloss, jlogits, jupd, jgrads))
    tmodel = ResNet(tblock, (1, 1, 1, 1), 10, in_channels=c, input_hw=hw,
                    space_to_depth=s2d)
    tmodel.load_state_dict(flax_to_torch(tmodel, params, stats))
    tmodel.double()
    tlogits = tmodel(torch.from_numpy(x).double(), train=True)
    assert tlogits.dtype == torch.float32
    tloss = cross_entropy(tlogits, torch.from_numpy(y).long())
    tloss.backward()
    _compare(ref, (tloss, tlogits), tmodel, bn=True)


def test_kaiming_fan_out_init():
    """Statistics: ResNet50's largest conv kernel, layer4_0/conv2 (HWIO
    3x3x512x512), has std sqrt(2 / (9 * 512)) within 5%; the head's bias
    and every BatchNorm start at 0 and 1."""
    model = build_model("ResNet50", 10, dataset="cifar10", seed=3)
    specs = {s.name: s for s in leaf_specs(model)}
    named = dict(model.named_parameters())
    conv = max((s for s in specs.values() if s.kind == "conv"),
               key=lambda s: np.prod(s.jax_shape))
    assert conv.name == "layer4_0/conv2/kernel"
    std = float(named[conv.torch_name].detach().std())
    want = np.sqrt(2.0 / (9 * 512))
    assert abs(std / want - 1) < 0.05, (std, want)
    assert not named["linear.bias"].detach().any()
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 53
    for bn in bns:
        assert torch.equal(bn.weight.detach(), torch.ones_like(bn.weight))
        assert not bn.bias.detach().any()
