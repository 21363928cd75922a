"""The precision policy (``core/precision.py``) against the JAX package's.

The same inputs, made from a numpy seed, go through
``ewdml_tpu.core.precision`` and the port's ``core/precision`` with the same
key words. Oracles:

- ``stochastic_round`` (the plain version of the ``stochastic_round_bf16``
  kernel): bit-equal, on a 1-D leaf, on a conv and a dense leaf held in
  PyTorch's layout (the draw follows the JAX layout's index) and on
  specials; NaN lanes by ``isnan``.
- ``store_round``'s round-to-nearest-even fallback (no key), ``wire_cast``
  and ``tree_store_round``: bit-equal.
- The bf16 dense all-reduce at W = 4: bit-equal (f32 sums of the same
  upcast bf16 rows in the same order).
- SGD with bf16 momentum over 3 updates: the *store* is bit-equal given the
  same f32 input; across whole updates the momentum stays within one bf16
  ulp of the JAX state (an element flips to its other bf16 neighbour where
  XLA contracts ``mu * buf + d_p`` into an FMA and the f32 sum differs in
  its last bit; measured: no flips at these inputs), the parameters within
  1e-6 of their largest value.
- The wire plan under each policy: byte-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ewdml_tpu.core import config as jconfig
from ewdml_tpu.core import precision as jprec
from ewdml_tpu.optim.sgd import SGD as JSGD
from ewdml_tpu.parallel import collectives as jcoll
from ewdml_tpu_torch.core import config as tconfig
from ewdml_tpu_torch.core import precision as tprec
from ewdml_tpu_torch.core.world import LocalWorld
from ewdml_tpu_torch.models.convert import from_jax, to_jax
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.optim import SGD, make_optimizer, update_accepts_key
from ewdml_tpu_torch.parallel import collectives as tcoll
from ewdml_tpu_torch.utils import prng
from ewdml_tpu_torch.utils.keytable import KeyTable

torch.set_num_threads(2)

SPECIALS = [0.0, -0.0, 1e-40, -1e-40, 3.4028235e38, -3.4028235e38,
            np.inf, -np.inf, np.nan, 1.0, -2.5, 0.15625]
# (kind, JAX shape): a conv kernel (HWIO), a dense kernel ([in, out]) and
# a vector, as LeNet and VGG11-BN hold them.
LEAVES = [("conv", (3, 3, 16, 32)), ("dense", (120, 84)), ("vector", (4097,))]


def _key_words(key) -> tuple:
    return tuple(int(v) for v in jax.random.key_data(key))


def _torch_leaf(x_jax: np.ndarray, kind: str) -> torch.Tensor:
    return from_jax(torch.from_numpy(x_jax.copy()), kind).contiguous()


def _same_bf16(t: torch.Tensor, j) -> None:
    """Bit-equal bf16 values, NaN lanes compared by ``isnan``."""
    j = np.asarray(j, np.float32)
    t = t.float().numpy()
    nt, nj = np.isnan(t), np.isnan(j)
    assert np.array_equal(nt, nj)
    assert np.array_equal(t[~nt].view(np.uint32), j[~nj].view(np.uint32))


def _input(shape, seed=0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.choice([1e-3, 1.0, 50.0])).astype(np.float32)
    flat = x.reshape(-1)
    flat[:len(SPECIALS)] = SPECIALS
    return x


@pytest.mark.parametrize("kind,shape", LEAVES)
@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
def test_stochastic_round_is_the_jax_one(kind, shape, seed):
    x = _input(shape, seed % 7)
    key = jax.random.key(seed % (1 << 32))
    want = jprec.stochastic_round(key, jnp.array(x))
    got = tprec.stochastic_round(_key_words(key), _torch_leaf(x, kind), kind)
    assert got.dtype == torch.bfloat16
    _same_bf16(to_jax(got, kind).contiguous(), want)


def test_stochastic_round_writes_into_storage_and_is_unbiased():
    x = torch.full((1 << 16,), 1.0 + 2.0 ** -10)  # a quarter ulp above 1
    out = torch.empty(x.shape, dtype=torch.bfloat16)
    assert tprec.stochastic_round((0, 3), x, out=out) is out
    up = (out.float() > 1.0).float().mean().item()
    assert abs(up - 0.125) < 0.01   # 2^-10 over bf16's ulp of 2^-7


def test_stochastic_round_reads_a_key_table_key():
    """A key of the window's key table draws what its host words draw."""
    base = prng.key(11)
    table = KeyTable(base, "cpu", start=4)
    tkey = prng.layer_key(prng.fold_in(table.step_key(6), 0x0917), 2)
    hkey = prng.layer_key(prng.fold_in(prng.step_key(base, 6), 0x0917), 2)
    x = _torch_leaf(_input((3, 3, 8, 4)), "conv")
    a = tprec.stochastic_round(tkey, x, "conv")
    b = tprec.stochastic_round(hkey, x, "conv")
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    packed = prng.key_tensor(tkey, "cpu")
    assert int(packed) == prng.packed_key(hkey)
    table.load(9)
    assert int(packed) == prng.packed_key(prng.layer_key(
        prng.fold_in(prng.step_key(base, 11), 0x0917), 2))


def test_store_round_falls_back_to_nearest_even():
    x = _input((5000,), 3)
    want = jprec.store_round(None, jnp.array(x), jnp.bfloat16)
    got = tprec.store_round(None, torch.from_numpy(x.copy()), torch.bfloat16)
    _same_bf16(got, want)
    f = torch.from_numpy(x.copy())
    assert tprec.store_round((0, 1), f, torch.float32) is f


def test_tree_store_round_keys_leaf_i_under_layer_key():
    xs = [_input(s, i) for i, (_, s) in enumerate(LEAVES)]
    key = jax.random.key(5)
    like_j = [jnp.zeros(x.shape, jnp.bfloat16) for x in xs]
    like_j[1] = jnp.zeros(xs[1].shape, jnp.float32)   # an f32 leaf passes
    want = jprec.tree_store_round(key, [jnp.array(x) for x in xs], like_j)
    like_t = [torch.zeros(x.shape, dtype=torch.bfloat16) for x in xs]
    like_t[1] = torch.zeros(xs[1].shape)
    got = tprec.tree_store_round(_key_words(key),
                                 [torch.from_numpy(x.copy()) for x in xs],
                                 like_t)
    _same_bf16(got[0], want[0])
    assert np.array_equal(got[1].numpy().view(np.uint32),
                          np.asarray(want[1]).view(np.uint32))
    _same_bf16(got[2], want[2])


def test_wire_cast_narrows_f32_leaves_only():
    xs = [np.linspace(-3, 3, 101).astype(np.float32),
          np.arange(7, dtype=np.int32)]
    want = jprec.wire_cast([jnp.array(x) for x in xs])
    got = tprec.wire_cast([torch.from_numpy(x.copy()) for x in xs])
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.int32
    _same_bf16(got[0], want[0])
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert tprec.wire_cast(got, torch.float32) == got


@pytest.mark.parametrize("name", ["f32", "bf16_wire", "bf16_wire_state",
                                  None, "BF16_WIRE"])
def test_policies_are_the_jax_ones(name):
    j, t = jprec.resolve_policy(name), tprec.resolve_policy(name)
    assert (t.name, t.bf16_wire, t.bf16_state, t.wire_itemsize) == \
        (j.name, j.bf16_wire, j.bf16_state, j.wire_itemsize)
    assert str(t.wire_dtype).replace("torch.", "") == np.dtype(j.wire_dtype).name
    assert str(t.state_dtype).replace("torch.", "") == \
        np.dtype(j.state_dtype).name
    assert tconfig.TrainConfig(precision_policy=name or "f32").precision == t
    with pytest.raises(ValueError):
        tprec.resolve_policy("fp8")


def _jax_dense_mean(grads, wire_dtype):
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    stacked = [jnp.array(np.stack([g[i] for g in grads]))
               for i in range(len(grads[0]))]
    specs = tuple(P("data") for _ in stacked)
    f = jax.jit(jax.shard_map(
        lambda *ls: tuple(a[None] for a in jcoll.dense_allreduce_mean(
            [l[0] for l in ls], "data", wire_dtype=wire_dtype)),
        mesh=mesh, in_specs=specs, out_specs=specs, check_vma=False))
    return [np.asarray(a)[0] for a in f(*stacked)]


def test_bf16_dense_allreduce_is_the_jax_one():
    rng = np.random.RandomState(4)
    shapes = [(20,), (5, 5, 3, 8), (3000,), (70, 90)]
    grads = [[(rng.randn(*s) * 0.1).astype(np.float32) for s in shapes]
             for _ in range(4)]
    want = _jax_dense_mean(grads, jnp.bfloat16)
    got = tcoll.dense_allreduce_mean(
        LocalWorld(4, "cpu"), [[torch.from_numpy(x) for x in g] for g in grads],
        wire_dtype=torch.bfloat16)
    for t, j in zip(got, want):
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy().view(np.uint32), j.view(np.uint32))


def test_bf16_dense_allreduce_passes_a_non_f32_leaf():
    world = LocalWorld(4, "cpu")
    ints = [[torch.full((3,), r, dtype=torch.int32)] for r in range(4)]
    out = tcoll.dense_allreduce_mean(world, ints, wire_dtype=torch.bfloat16)
    assert out[0].dtype == torch.int32 and out[0].tolist() == [1, 1, 1]
    f32 = [[torch.full((3,), float(r))] for r in range(4)]
    a = tcoll.dense_allreduce_mean(world, f32)
    b = tcoll.dense_allreduce_mean(world, f32, wire_dtype=torch.float32)
    assert torch.equal(a[0], b[0])


def _sgd_pair(kinds_layout: bool, nesterov: bool):
    rng = np.random.RandomState(9)
    params = [(rng.randn(*s) * 0.1).astype(np.float32) for _, s in LEAVES]
    grads = [[(rng.randn(*s) * 0.05).astype(np.float32) for _, s in LEAVES]
             for _ in range(3)]
    kinds = [k for k, _ in LEAVES]
    jopt = JSGD(0.1, momentum=0.9, weight_decay=1e-4, nesterov=nesterov,
                state_dtype=jnp.bfloat16)
    jp = [jnp.array(p) for p in params]
    jst = jopt.init(jp)
    topt = SGD(0.1, momentum=0.9, weight_decay=1e-4, nesterov=nesterov,
               state_dtype=torch.bfloat16)
    conv = _torch_leaf if kinds_layout else (
        lambda x, k: torch.from_numpy(x.copy()))
    tp = [conv(p, k) for p, k in zip(params, kinds)]
    tst = topt.init(tp)
    for step, g in enumerate(grads):
        key = jax.random.fold_in(jax.random.key(3), step)
        upd, jst = jopt.update([jnp.array(x) for x in g], jst, jp, key=key)
        jp = [p + u for p, u in zip(jp, upd)]
        topt.update([conv(x, k) for x, k in zip(g, kinds)], tst, tp,
                    key=_key_words(key),
                    kinds=kinds if kinds_layout else None)
    back = ((lambda t, k: to_jax(t, k).contiguous()) if kinds_layout
            else (lambda t, k: t))
    return ([np.asarray(p) for p in jp], [back(p, k) for p, k in zip(tp, kinds)],
            [np.asarray(b, np.float32) for b in jst.momentum_buf],
            [back(b, k) for b, k in zip(tst.momentum_buf, kinds)])


@pytest.mark.parametrize("kinds_layout", [True, False],
                         ids=["torch_layout", "jax_layout"])
@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_bf16_momentum_follows_the_jax_one(kinds_layout, nesterov):
    jp, tp, jb, tb = _sgd_pair(kinds_layout, nesterov)
    for j, t in zip(jb, tb):
        assert t.dtype == torch.bfloat16
        t = t.float().numpy()
        ulp = np.abs(j).view(np.int32).astype(np.int64)
        steps = np.abs(t.view(np.int32).astype(np.int64) - j.view(np.int32)
                       .astype(np.int64)) >> 16
        assert steps.max() <= 1 and ulp.size
        assert (steps > 0).mean() <= 0.01   # the share of flipped elements
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-6 * np.abs(j).max())


def test_sgd_bf16_store_is_bit_equal_given_the_same_f32_input():
    """One update from a zero buffer: the buffer is the store of ``d_p``
    itself, so the two packages round the same f32 values."""
    kind, shape = LEAVES[0]
    g = _input(shape, 5)
    g[~np.isfinite(g)] = 0.0
    key = jax.random.key(8)
    jopt = JSGD(0.1, momentum=0.9, state_dtype=jnp.bfloat16)
    p = np.zeros(shape, np.float32)
    _, st = jopt.update([jnp.array(g)], jopt.init([jnp.array(p)]),
                        [jnp.array(p)], key=key)
    topt = SGD(0.1, momentum=0.9, state_dtype=torch.bfloat16)
    tp = [_torch_leaf(p, kind)]
    tst = topt.init(tp)
    topt.update([_torch_leaf(g, kind)], tst, tp, key=_key_words(key),
                kinds=[kind])
    _same_bf16(to_jax(tst.momentum_buf[0], kind).contiguous(),
               st.momentum_buf[0])


def test_make_optimizer_takes_the_state_dtype():
    opt = make_optimizer("sgd", 0.1, state_dtype=torch.bfloat16)
    assert opt.init([torch.zeros(3)]).momentum_buf[0].dtype == torch.bfloat16
    assert make_optimizer("sgd", 0.1, state_dtype=torch.float32).init(
        [torch.zeros(3)]).momentum_buf[0].dtype == torch.float32
    assert update_accepts_key(opt)

    class Foreign:
        def update(self, grads, state, params):
            pass
    assert not update_accepts_key(Foreign())
    with pytest.raises(ValueError):
        make_optimizer("lamb", 0.1)


@pytest.mark.parametrize("kw", [
    dict(lossy_weights_down=True, compress_grad="qsgd", ps_mode="weights"),
    dict(lossy_weights_down=True, compress_grad="qsgd", ps_mode="grads"),
    dict(lossy_weights_down=True, compress_grad="none", ps_mode="weights"),
    dict(lossy_weights_down=True, compress_grad="qsgd", ps_mode="weights",
         relay_compress=False),
    dict(lossy_weights_down=False, compress_grad="qsgd", ps_mode="weights"),
])
def test_lossy_weights_validation_is_the_jax_one(kw):
    """The trainer's ``--lossy-weights-down`` rule (``trainer.py:100``)."""
    from ewdml_tpu.models import build_model as jbuild
    from ewdml_tpu.optim import make_optimizer as jmake_opt
    from ewdml_tpu.train.trainer import _make_step_body
    from ewdml_tpu_torch.train.trainer import check_supported

    jcfg = jconfig.TrainConfig(**kw)
    try:
        _make_step_body(jbuild("LeNet", 10, jnp.float32),
                        jmake_opt("sgd", 0.1), jcfg,
                        Mesh(np.array(jax.devices()[:1]), ("data",)))
        jax_ok = True
    except ValueError:
        jax_ok = False
    try:
        check_supported(tconfig.TrainConfig(**kw))
        port_ok = True
    except ValueError:
        port_ok = False
    assert port_ok == jax_ok


@pytest.mark.parametrize("policy", ["bf16_wire", "bf16_wire_state"])
def test_the_trainer_takes_the_policies(policy):
    from ewdml_tpu_torch.train.trainer import check_supported

    check_supported(tconfig.TrainConfig(precision_policy=policy, method=4))
    with pytest.raises(ValueError, match="fused_q"):
        check_supported(tconfig.TrainConfig(precision_policy=policy,
                                            method=3, collective="fused_q"))
    # The bf16 bootstrap is ported (tests/test_torch_ps_downlink.py).
    check_supported(tconfig.TrainConfig(precision_policy=policy,
                                        mode="async", ps_down="delta",
                                        ps_bootstrap="bf16"),
                    async_path=True)
    with pytest.raises(NotImplementedError, match="lossy"):
        check_supported(tconfig.TrainConfig(
            mode="async", compress_grad="qsgd", ps_mode="weights",
            lossy_weights_down=True), async_path=True)


def test_kernel_dispatch_counts_nothing_on_the_cpu():
    kernels.reset_launches()
    tprec.stochastic_round((1, 2), torch.randn(300))
    assert kernels.LAUNCHES["stochastic_round"] == 0


def _plans(kw, net="LeNet"):
    from ewdml_tpu.models import build_model as jbuild, init_variables
    from ewdml_tpu.train.metrics import wire_plan as jplan
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs
    from ewdml_tpu_torch.train.metrics import wire_plan as tplan

    dataset, shape = (("mnist10k", (2, 28, 28, 1)) if net == "LeNet"
                      else ("Cifar10", (2, 32, 32, 3)))
    jm = jbuild(net, 10, jnp.float32)
    params = jax.eval_shape(lambda: init_variables(
        jm, jax.random.key(0), jnp.zeros(shape)))["params"]
    tm = build_model(net, 10, dataset=dataset, seed=0)
    leaves = [(s.name, s.jax_shape) for s in leaf_specs(tm)]
    return (jplan(jconfig.TrainConfig(**kw), params, world=4),
            tplan(tconfig.TrainConfig(**kw), leaves, world=4))


PLAN_FIELDS = ("per_layer_up", "per_layer_down", "per_step_bytes",
               "per_step_bytes_total", "dense_bytes", "wire_dtype",
               "transport", "per_rank_exchange_bytes", "per_layer_bytes",
               "per_bucket_bytes")


@pytest.mark.parametrize("net", ["LeNet", "VGG11"])
@pytest.mark.parametrize("policy", ["f32", "bf16_wire", "bf16_wire_state"])
@pytest.mark.parametrize("method", [1, 2, 3, 4, 5, 6])
def test_wire_plan_under_each_policy_is_the_jax_one(net, policy, method):
    j, t = _plans(dict(method=method, precision_policy=policy), net)
    for f in PLAN_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    if policy != "f32" and method in (1, 3):
        f32 = _plans(dict(method=method), net)[1]
        assert t.up_bytes * 2 == f32.up_bytes
        # The weight down-link of Method 1 stays f32.
        assert t.down_bytes * (1 if method == 1 else 2) == f32.down_bytes
