"""The port's models on weights converted from a Flax init: logits, loss
gradients and BatchNorm statistic updates in train mode, against the JAX
package's Flax models (dropout made an identity on both sides).

Oracle: tolerance. Convolutions and reductions sum in another order on
each side, so values agree to f32 rounding: logits and BN statistics
within rtol 1e-5 (atol 1e-5 of the tensor's largest value), gradients within rtol
1e-4 and atol 1e-5 of the model's largest gradient (a gradient is a sum
over the batch, where rounding of the large terms dominates the small
ones; a conv bias in front of BatchNorm has a true gradient of zero, so
its computed one is rounding noise on both sides). BatchNorm divides by
the batch spread, so absolute errors are taken relative to each tensor's
largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.models import LeNet as JLeNet
from ewdml_tpu.models import VGG as JVGG
from ewdml_tpu.train.trainer import cross_entropy as jce
from ewdml_tpu_torch.models import LeNet, VGG
from ewdml_tpu_torch.models.convert import flax_to_torch, leaf_specs, to_jax
from ewdml_tpu_torch.models.layers import Dropout
from ewdml_tpu_torch.train.trainer import cross_entropy

torch.set_num_threads(2)

NARROW_CFG = (8, "M", 16, "M", 16, 16, "M")


def _close(a, b, rtol, atol_frac):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    atol = atol_frac * max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.fixture
def no_dropout(monkeypatch):
    import flax.linen as nn

    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(Dropout, "forward",
                        lambda self, x, train=False, generator=None: x)


def _run_both(jmodel, tmodel, x, y, bn: bool):
    variables = jmodel.init(jax.random.key(0), jnp.asarray(x[:2]), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))
    tmodel.load_state_dict(flax_to_torch(tmodel, params, stats))

    def loss_fn(p):
        v = {"params": p}
        if bn:
            v["batch_stats"] = stats
            logits, upd = jmodel.apply(v, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
        else:
            logits, upd = jmodel.apply(v, jnp.asarray(x), train=True), {}
        return jce(logits, jnp.asarray(y)), (logits, upd)

    (jloss, (jlogits, jupd)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tlogits = tmodel(torch.from_numpy(x), train=True)
    tloss = cross_entropy(tlogits, torch.from_numpy(y).long())
    tloss.backward()
    return (jloss, jlogits, jupd, jgrads), (tloss, tlogits)


def _check(jmodel, tmodel, x, y, bn):
    _compare(*_run_both(jmodel, tmodel, x, y, bn), tmodel, bn)


def _compare(ref, port, tmodel, bn):
    """The tolerances of the module docstring: ``ref`` is the Flax side's
    ``(loss, logits, updates, grads)``, ``port`` the port's
    ``(loss, logits)`` with the gradients in ``tmodel``."""
    (jloss, jlogits, jupd, jgrads), (tloss, tlogits) = ref, port
    _close(tlogits.detach().numpy(), jlogits, 1e-5, 1e-5)
    _close(float(tloss.detach()), float(jloss), 1e-5, 0)
    flat = {"/".join(p.key for p in path): np.asarray(g) for path, g in
            jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    named = dict(tmodel.named_parameters())
    specs = leaf_specs(tmodel)
    assert [s.name for s in specs] == list(flat)
    gmax = max(np.abs(g).max() for g in flat.values())
    for s in specs:
        tg = to_jax(named[s.torch_name].grad, s.kind).numpy()
        assert tg.shape == flat[s.name].shape, s.name
        np.testing.assert_allclose(tg, flat[s.name], rtol=1e-4,
                                   atol=1e-5 * gmax, err_msg=s.name)
    if bn:
        for name, buf in tmodel.named_buffers():
            *modules, attr = name.split(".")
            stat = jupd["batch_stats"]
            for m in modules:
                stat = stat[m]
            stat = stat[{"running_mean": "mean", "running_var": "var"}[attr]]
            _close(buf.numpy(), stat, 1e-5, 1e-5)


def test_lenet_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.int32)
    _check(JLeNet(num_classes=10), LeNet(), x, y, bn=False)


def test_narrow_vgg_bn_train_mode_matches_flax(no_dropout):
    rng = np.random.RandomState(1)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int32)
    _check(JVGG(cfg=NARROW_CFG, batch_norm=True, num_classes=10),
           VGG(cfg=NARROW_CFG, batch_norm=True, num_classes=10), x, y, bn=True)


def test_vgg11_bn_has_the_reference_leaves():
    from ewdml_tpu_torch.models import build_model

    m = build_model("VGG11", 10, dataset="cifar10")
    specs = leaf_specs(m)
    assert len(specs) == 38
    assert sum(p.numel() for p in m.parameters()) == 9_756_426


def test_dropout_draws_from_the_given_generator():
    d = Dropout(0.5)
    x = torch.ones(1000)
    a = d(x, True, torch.Generator().manual_seed(3))
    b = d(x, True, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) <= {0.0, 2.0}
    assert torch.equal(d(x, False), x)
    with pytest.raises(ValueError):
        d(x, True, None)
