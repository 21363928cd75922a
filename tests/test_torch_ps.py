"""The parameter server's pieces against the JAX package's: the one-buffer
packer, the native wire frame, and both ``ParameterServer``s driven in lock
step from one thread with the same wire messages (in the manner of
``tests/test_homomorphic.py``'s server tests).

Oracles, per test:
- packed buffers and frames: bit (byte-identical).
- lock-step server params after two K = 3 rounds: tolerance,
  |d| <= 1e-6 * max|p| per leaf under both ``--server-agg`` modes. The
  homomorphic apply is an exact integer sum and one f32 product in the same
  order, so only the SGD update's rounding can differ (XLA may contract it
  into an FMA); the decode mean sums K f32 decodes, whose order may differ
  too, by an ulp of the gradient.
- the server's counters (pushes, updates, decode_count, apply_rounds,
  bytes_up, dropped_stale): equal.
- the constructor's validation: the same ``ValueError``s; the down-link
  modes, the relay and a watchdog are accepted, ``--adapt`` raises by
  name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu import native as jnative
from ewdml_tpu.core.config import TrainConfig as JConfig
from ewdml_tpu.ops import chain as jchain
from ewdml_tpu.ops import homomorphic as jhom
from ewdml_tpu.ops.chain import TopKQSGDCompressor as JTopKQSGD
from ewdml_tpu.ops.qsgd import QSGDCompressor as JQSGD
from ewdml_tpu.optim import SGD as JSGD
from ewdml_tpu.parallel import ps as jps
from ewdml_tpu.train.metrics import wire_plan as j_wire_plan
from ewdml_tpu.utils import transfer as jtransfer
from ewdml_tpu_torch import native
from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.models import build_model
from ewdml_tpu_torch.models.convert import leaf_specs
from ewdml_tpu_torch.ops import chain, homomorphic, qsgd
from ewdml_tpu_torch.ops.qsgd import QSGDCompressor
from ewdml_tpu_torch.optim import SGD
from ewdml_tpu_torch.parallel import ps
from ewdml_tpu_torch.train.metrics import wire_plan
from ewdml_tpu_torch.utils import prng, transfer

torch.set_num_threads(2)

SHAPES = {"a": (5000,), "b": (64, 150), "c": (3, 3, 4, 8)}


def _tree(seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _leaves(tree):
    return [torch.from_numpy(np.array(tree[k])) for k in sorted(tree)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_payload(p):
    """The port's payload of the same kind and fields as a JAX payload."""
    if isinstance(p, jps.qsgd.QSGDPayload):
        return qsgd.QSGDPayload(_t(p.levels), _t(p.norm), p.shape, p.s,
                                p.packed, p.block)
    if isinstance(p, jps.qsgd.SharedScaleQSGDPayload):
        return qsgd.SharedScaleQSGDPayload(_t(p.levels), p.shape, p.s,
                                           p.block)
    if isinstance(p, jchain.SharedScaleTopKQSGDPayload):
        return chain.SharedScaleTopKQSGDPayload(_t(p.indices), _t(p.levels),
                                                p.shape, p.s, p.block)
    if isinstance(p, jchain.TopKQSGDPayload):
        return chain.TopKQSGDPayload(_t(p.indices), _t(p.levels), _t(p.norm),
                                     p.shape, p.s, p.packed, p.block)
    raise TypeError(type(p).__name__)


@pytest.mark.parametrize("kind", ["params", "qsgd", "qsgd_block", "topk",
                                  "shared", "shared_topk"])
def test_packer_bytes_equal(kind):
    grads = _tree(1)
    jtree = {k: jnp.asarray(v) for k, v in grads.items()}
    if kind == "params":
        jt, tt = jtree, _leaves(grads)
    else:
        jcomp = {"qsgd": JQSGD(127), "qsgd_block": JQSGD(127, block=4096),
                 "topk": JTopKQSGD(0.1, 127), "shared": JQSGD(127),
                 "shared_topk": JTopKQSGD(0.1, 127)}[kind]
        if kind.startswith("shared"):
            jcomp = jhom.make_homomorphic(jcomp, jtree)
        jt = jps.compress_tree_fn(jcomp, jtree, jax.random.key(3))
        flat = jax.tree.flatten(jt, is_leaf=lambda x: hasattr(x, "wire_bytes"))[0]
        tt = [_port_payload(p) for p in flat]
    a = np.asarray(jtransfer.make_device_packer()(jt))
    b = transfer.make_device_packer()(tt).numpy()
    assert a.dtype == b.dtype == np.uint8
    assert np.array_equal(a, b)
    assert [tuple(s) for s in transfer.specs_of(tt)] == \
        [tuple(s) for s in jtransfer.specs_of(jt)]
    # The port unpacks the JAX bytes into the same arrays.
    back = transfer.make_device_unpacker(tt)(torch.from_numpy(a.copy()))
    for x, y in zip(transfer.tree_leaves(back), transfer.tree_leaves(tt)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("fallback", [False, True])
def test_native_frames_equal(fallback, monkeypatch):
    rng = np.random.RandomState(2)
    arrays = [rng.randint(0, 256, size=n).astype(np.uint8)
              for n in (1, 7, 4096, 10_001)]
    if fallback:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    for arrs in ([arrays[0]], [arrays[2]], arrays):
        msg = native.encode_arrays(arrs)
        assert msg == jnative.encode_arrays(arrs)
        assert len(msg) == native.encoded_arrays_size(arrs)
        for x, y in zip(native.decode_arrays(msg), arrs):
            assert np.array_equal(x, y)
    sections = [b"", b"abc", bytes(range(256))]
    assert native.wire_encode(sections) == jnative.wire_encode(sections)
    assert native.wire_decode(jnative.wire_encode(sections)) == sections
    bad = bytearray(native.wire_encode(sections))
    bad[-1] ^= 1
    with pytest.raises(ValueError, match="corrupt"):
        native.wire_decode(bytes(bad))


def _servers(agg, k, **kw):
    """The JAX and the port server over the same params, compressor and
    (under homomorphic) scale contract."""
    tmpl = _tree(10)
    jtmpl = {n: jnp.asarray(v) for n, v in tmpl.items()}
    params = {n: jnp.ones(s, jnp.float32) for n, s in SHAPES.items()}
    jcomp, tcomp = JQSGD(127), QSGDCompressor(127)
    if agg == "homomorphic":
        jcomp = jhom.make_homomorphic(jcomp, jtmpl)
        tcomp = homomorphic.make_homomorphic(tcomp, _leaves(tmpl))
        for i in range(len(SHAPES)):  # the JAX grid, bit for bit
            tcomp.for_leaf(i).scales = _t(jcomp.for_leaf(i).scales)
    js = jps.ParameterServer(params, JSGD(0.1, momentum=0.9), jcomp,
                             num_aggregate=k, server_agg=agg, **kw)
    ts = ps.ParameterServer([torch.ones(s) for _, s in sorted(SHAPES.items())],
                            SGD(0.1, momentum=0.9), tcomp, num_aggregate=k,
                            server_agg=agg, device="cpu", **kw)
    jct = jps.make_compress_tree(js.compressor)
    js.register_payload_schema(jct({n: jnp.zeros(s) for n, s in SHAPES.items()},
                                   jax.random.key(0)))
    tct = ps.make_compress_tree(ts.compressor)
    ts.register_payload_schema(tct([torch.zeros(s) for _, s in
                                    sorted(SHAPES.items())], prng.key(0)))
    return js, ts, jct


def _message(jct, grads, seed):
    tree = jct({n: jnp.asarray(v) for n, v in grads.items()},
               jax.random.key(seed))
    return jnative.encode_arrays(
        [np.asarray(jtransfer.make_device_packer()(tree))])


@pytest.mark.parametrize("agg", ["homomorphic", "decode"])
def test_lock_step_servers_agree(agg):
    k = 3
    js, ts, jct = _servers(agg, k)
    for r in range(2):
        for w in range(k):
            msg = _message(jct, _tree(20 + 3 * r + w, 0.05 * (1 + w)), 50 + w)
            for server, rec in ((js, jps.PushRecord), (ts, ps.PushRecord)):
                ok = server.push(rec(worker=w, version=server.version,
                                     message=msg, loss=0.5))
                assert ok is True
    for name, (jl, tl) in enumerate(zip(
            [np.asarray(js.params[n]) for n in sorted(SHAPES)], ts.params)):
        tl = tl.numpy()
        assert tl.shape == jl.shape
        assert np.abs(jl - 1.0).max() > 1e-3  # the params did move
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=1e-6 * np.abs(jl).max(),
                                   err_msg=f"leaf {name}")
    for field in ("pushes", "updates", "decode_count", "apply_rounds",
                  "bytes_up", "dropped_stale", "staleness_sum"):
        assert getattr(ts.stats, field) == getattr(js.stats, field), field
    assert ts.stats.decode_count == (2 if agg == "homomorphic" else 2 * k)
    assert ts.stats.apply_s_sum > 0
    # The pull serves the packed params with the JAX byte count.
    jm, jbuf, jv, jn = js.pull(worker=0)
    tm, tbuf, tv, tn = ts.pull(worker=0)
    assert (tm, tv, tn, tbuf.size) == (jm, jv, jn, jbuf.size)


def test_stale_push_dropped_by_both():
    js, ts, jct = _servers("homomorphic", 1, max_staleness=0)
    msg = _message(jct, _tree(30), 60)
    for server, rec in ((js, jps.PushRecord), (ts, ps.PushRecord)):
        assert server.push(rec(worker=0, version=0, message=msg,
                               loss=0.1)) is True
        assert server.push(rec(worker=1, version=0, message=msg,
                               loss=0.1)) is False
    for field in ("pushes", "updates", "dropped_stale", "decode_count",
                  "apply_rounds", "bytes_up"):
        assert getattr(ts.stats, field) == getattr(js.stats, field), field
    assert ts.stats.dropped_stale == 1 and ts.stats.updates == 1


def test_constructor_validation_matches(tmp_path):
    params = {"w": jnp.ones((64,), jnp.float32)}
    tparams = [torch.ones(64)]
    comp = jhom.make_homomorphic(JQSGD(127), {"w": jnp.ones((64,))})
    tcomp = homomorphic.make_homomorphic(QSGDCompressor(127), [torch.ones(64)])
    cases = [
        (dict(compressor=JQSGD(127), server_agg="sum"),
         dict(compressor=QSGDCompressor(127), server_agg="sum")),
        (dict(compressor=JQSGD(127), server_agg="homomorphic"),
         dict(compressor=QSGDCompressor(127), server_agg="homomorphic")),
        (dict(compressor=comp, server_agg="homomorphic", down_mode="delta"),
         dict(compressor=tcomp, server_agg="homomorphic", down_mode="delta")),
        (dict(compressor=comp, server_agg="homomorphic", relay_compress=True),
         dict(compressor=tcomp, server_agg="homomorphic",
              relay_compress=True)),
    ]
    for jkw, tkw in cases:
        with pytest.raises(ValueError) as je:
            jps.ParameterServer(params, JSGD(0.1), **jkw)
        with pytest.raises(ValueError) as te:
            ps.ParameterServer(tparams, SGD(0.1), device="cpu", **tkw)
        # The same error; the port's message ends naming its own callers.
        assert str(te.value)[:120] == str(je.value)[:120]
    # The down-link modes, the relay and the watchdog are ported (their
    # behaviour: tests/test_torch_ps_downlink.py, test_torch_health.py);
    # so is --adapt (tests/test_torch_adapt_ps.py), refused with the delta
    # down-link and the relay as in JAX.
    for kw, attr, want in (
            (dict(down_mode="delta"), "down_mode", "delta"),
            (dict(down_mode="delta", bootstrap="bf16"), "bootstrap", "bf16"),
            (dict(relay_compress=True), "relay_compress", True),
            (dict(health="watchdog"), "health", "watchdog")):
        server = ps.ParameterServer(tparams, SGD(0.1), QSGDCompressor(127),
                                    device="cpu", **kw)
        assert getattr(server, attr) == want
    from ewdml_tpu.adapt import AdaptRuntime as JAdapt
    from ewdml_tpu_torch.adapt import AdaptRuntime

    akw = dict(compress_grad="qsgd", adapt="variance", adapt_every=2)
    jrt = JAdapt(JConfig(train_dir=str(tmp_path / "j") + "/", **akw),
                 ["w"], [64], surface="ps")
    trt = AdaptRuntime(TrainConfig(train_dir=str(tmp_path / "t") + "/",
                                   **akw), ["w"], [64], surface="ps")
    for kw in (dict(down_mode="delta"), dict(relay_compress=True)):
        with pytest.raises(ValueError) as je:
            jps.ParameterServer(params, JSGD(0.1), adapt=jrt, **kw)
        with pytest.raises(ValueError) as te:
            ps.ParameterServer(tparams, SGD(0.1), device="cpu", adapt=trt,
                               **kw)
        assert str(te.value) == str(je.value)
    assert ps.ParameterServer(tparams, SGD(0.1), device="cpu",
                              adapt=trt).compressor is trt.compressor()
    # The precision policies are ported; an unknown one fails as in JAX.
    for name in ("bf16_wire", "bf16_wire_state"):
        assert ps.ParameterServer(tparams, SGD(0.1), QSGDCompressor(127),
                                  device="cpu", precision=name) \
            .precision.name == name
    with pytest.raises(ValueError):
        ps.ParameterServer(tparams, SGD(0.1), device="cpu", precision="fp8")


@pytest.mark.parametrize("network,dataset", [("LeNet", "mnist10k"),
                                             ("VGG11", "Cifar10")])
@pytest.mark.parametrize("kw", [
    dict(compress_grad="qsgd", server_agg="homomorphic"),
    dict(compress_grad="qsgd", server_agg="homomorphic", qsgd_block=4096),
    dict(compress_grad="topk_qsgd", topk_ratio=0.01, server_agg="homomorphic"),
    dict(compress_grad="qsgd", quantum_num=7, server_agg="homomorphic",
         fusion="none"),
    dict(compress_grad="qsgd", server_agg="decode"),
    dict(compress_grad="topk_qsgd", topk_ratio=0.01, fusion="none"),
    dict(compress_grad="none"),
])
def test_async_wire_plan_rows_equal(network, dataset, kw):
    """The async rows of the wire plan, homomorphic up-link included, equal
    the JAX plan's byte for byte."""
    import flax

    from ewdml_tpu.models import build_model as jbuild
    from ewdml_tpu.models import init_variables

    model = build_model(network, 10, dataset=dataset)
    leaves = [(s.name, s.jax_shape) for s in leaf_specs(model)]
    h = 28 if dataset == "mnist10k" else 32
    c = 1 if dataset == "mnist10k" else 3
    jparams = jax.eval_shape(lambda: init_variables(
        jbuild(network, 10), jax.random.key(0),
        jnp.zeros((2, h, h, c))))["params"]
    jparams = flax.core.unfreeze(jparams)
    cfg = dict(mode="async", **kw)
    jp = j_wire_plan(JConfig(**cfg), jparams, world=4)
    tp = wire_plan(TrainConfig(**cfg), leaves, world=4)
    assert tp.per_layer_up == jp.per_layer_up
    assert tp.per_layer_down == jp.per_layer_down
    assert tp.up_bytes == jp.up_bytes
