"""The async server's down-link against the JAX package's: the compressed
delta stream (``--ps-down delta``), the bf16 bootstrap (``--ps-bootstrap
bf16``) and the lossy weights-down relay (``relay_compress``).

Inputs are made with numpy from a seed; JAX gets copies. Leaves lie on
both sides of ``MIN_ELEMS`` (5 000 and 140 000 elements); ``interpret``
runs the quantize kernel's murmur stream in both packages (its plain
version in the port), ``off`` jax.random's threefry stream.

Oracles:
- the delta step on the same parameters, shadow and key: tolerance, the
  QSGD oracle of ``tests/test_torch_compressors.py`` (norms within 2e-6
  relative; levels bit-equal where the two norms are, else at most 0.1%
  of them one level apart) and the new shadow within one level of the
  largest norm.
- lock-step servers in delta mode: parameters within 1e-6 of their scale
  (``tests/test_torch_ps.py``); pull modes, delta buffer sizes, bytes and
  counters exact.
- the port alone, exact: a worker's replay of the deltas lands on the
  server's shadow bit for bit (the same ops on the same device), in a
  lock-step server and after a ``run_async_ps`` run; behind the window the
  fallback serves the shadow as ``weights``, bit for bit.
- the bf16 bootstrap: the ``weights_bf16`` buffer byte-equal to the JAX
  one; half the dense bytes; a fallback stays f32; the round trip within
  2^-8 relative; the ``ValueError`` without the delta mode is the JAX one.
- the relay: the pulled buffer equals the JAX one at the same version, bit
  for bit on every leaf whose norm the two packages compute bit-equal (else
  within one level); its bytes are the compressor's wire bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu import native as jnative
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu.ops.qsgd import QSGDCompressor as JQSGD
from ewdml_tpu.optim import SGD as JSGD
from ewdml_tpu.parallel import ps as jps
from ewdml_tpu.utils import transfer as jtransfer
from ewdml_tpu_torch.models import build_model
from ewdml_tpu_torch.ops import kernels, make_compressor
from ewdml_tpu_torch.ops.qsgd import QSGDCompressor
from ewdml_tpu_torch.optim import SGD
from ewdml_tpu_torch.parallel import ps
from ewdml_tpu_torch.utils import prng, transfer

torch.set_num_threads(2)

SMALL = {"a": (5000,), "b": (64, 150), "c": (3, 3, 4, 8)}
BIG = {"a": (5000,), "z": (140000,)}   # 140 000 >= MIN_ELEMS = 2^17


@pytest.fixture(autouse=True)
def _restore_modes():
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


def _tree(shapes, seed, scale=0.05, offset=0.0):
    rng = np.random.RandomState(seed)
    return {k: (offset + rng.randn(*s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _j(tree):
    return {k: jnp.asarray(np.array(v)) for k, v in tree.items()}


def _t(tree):
    return [torch.from_numpy(np.array(tree[k])) for k in sorted(tree)]


def _servers(shapes, block=None, seed=0, **kw):
    """JAX and port servers over the same parameters, schema registered."""
    params = _tree(shapes, seed, scale=0.5, offset=1.0)
    js = jps.ParameterServer(_j(params), JSGD(0.1, momentum=0.9),
                             JQSGD(127, block=block), **kw)
    ts = ps.ParameterServer(_t(params), SGD(0.1, momentum=0.9),
                            QSGDCompressor(127, block=block), device="cpu",
                            **kw)
    zeros = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    jct = jps.make_compress_tree(js.compressor)
    js.register_payload_schema(jct(_j(zeros), jax.random.key(0)))
    ts.register_payload_schema(
        ps.make_compress_tree(ts.compressor)(_t(zeros), prng.key(0)))
    return js, ts, jct, params


def _message(jct, grads, seed):
    tree = jct(_j(grads), jax.random.key(seed))
    return jnative.encode_arrays(
        [np.asarray(jtransfer.make_device_packer()(tree))])


def _push_round(js, ts, jct, shapes, k, r):
    for w in range(k):
        msg = _message(jct, _tree(shapes, 20 + 3 * r + w, 0.05 * (1 + w)),
                       50 + w)
        for server, rec in ((js, jps.PushRecord), (ts, ps.PushRecord)):
            assert server.push(rec(worker=w, version=server.version,
                                   message=msg, loss=0.5)) is True


def _check_norms_and_levels(jn, tn, jl, tl):
    jn, tn = np.asarray(jn, np.float64), tn.numpy().astype(np.float64)
    np.testing.assert_allclose(tn, jn, rtol=2e-6, atol=0)
    jl, tl = np.asarray(jl).astype(np.int64), tl.numpy().astype(np.int64)
    if np.array_equal(jn, tn):
        assert np.array_equal(tl, jl)
    else:
        diff = np.abs(tl - jl)
        assert diff.max(initial=0) <= 1
        assert (diff != 0).sum() <= 1e-3 * jl.size + 1


@pytest.mark.parametrize("block", [None, 4096], ids=["per_tensor", "b4096"])
@pytest.mark.parametrize("mode", ["interpret", "off"])
def test_delta_step_matches_reference(mode, block):
    pk.configure(mode)
    kernels.configure(mode)
    js, ts, _, params = _servers(BIG, block, down_mode="delta")
    shadow = _tree(BIG, 7, scale=0.5, offset=1.0)
    moved = {k: v + _tree(BIG, 8, scale=0.01)[k] for k, v in params.items()}
    jpacked, jshadow = js._delta_fn(_j(moved), _j(shadow),
                                    jax.random.fold_in(jax.random.key(5), 3))
    tpacked, tshadow = ts._delta_fn(_t(moved), _t(shadow),
                                    prng.fold_in(prng.key(5), 3))
    jpacked = np.asarray(jpacked)
    assert tpacked.numpy().shape == jpacked.shape
    jpl = ts.payload_unpack(torch.from_numpy(jpacked.copy()))
    tpl = ts.payload_unpack(tpacked)
    for i, k in enumerate(sorted(BIG)):
        _check_norms_and_levels(jpl[i].norm, tpl[i].norm, jpl[i].levels,
                                tpl[i].levels)
        want = np.asarray(jshadow[k])
        got = tshadow[i].numpy()
        if np.array_equal(jpl[i].norm.numpy(), tpl[i].norm.numpy()):
            tol = 4 * np.spacing(np.abs(want).max())   # the add's rounding
        else:
            tol = float(tpl[i].norm.max()) / 127 * 1.0001
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("bootstrap", ["f32", "bf16"])
def test_lock_step_delta_servers_agree(bootstrap):
    k = 3
    js, ts, jct, params = _servers(SMALL, 4096, down_mode="delta",
                                   num_aggregate=k, bootstrap=bootstrap)
    pulls = []
    for server in (js, ts):
        m, buf, v, n = server.pull(-1, worker=0)
        pulls.append((m, v, n, np.asarray(buf).nbytes))
    assert pulls[0] == pulls[1]
    assert pulls[1][0] == ("weights_bf16" if bootstrap == "bf16"
                           else "weights")
    for r in range(2):
        _push_round(js, ts, jct, SMALL, k, r)
    assert sorted(ts._deltas) == sorted(js._deltas) == [1, 2]
    assert [b.nbytes for b in ts._deltas.values()] == [
        np.asarray(b).nbytes for b in js._deltas.values()]
    for wv in (0, 1, 2, -1):
        jm, jb, jv, jn = js.pull(wv, worker=1)
        tm, tb, tv, tn = ts.pull(wv, worker=1)
        assert (tm, tv, tn) == (jm, jv, jn), wv
        if tm == "delta":
            assert [b.nbytes for b in tb] == [np.asarray(b).nbytes
                                              for b in jb]
    for field in ("pushes", "updates", "decode_count", "bytes_up",
                  "bytes_down", "staleness_sum"):
        assert getattr(ts.stats, field) == getattr(js.stats, field), field
    # The shadows may differ by one level of each delta where a norm one
    # ulp apart moved a stochastic threshold.
    deltas = [ts.payload_unpack(torch.from_numpy(b.copy()))
              for b in ts._deltas.values()]
    for i, name in enumerate(sorted(SMALL)):
        jl = np.asarray(js.params[name])
        np.testing.assert_allclose(ts.params[i].numpy(), jl, rtol=0,
                                   atol=1e-6 * np.abs(jl).max(), err_msg=name)
        level = sum(float(d[i].norm.max()) / 127 * 1.0001 for d in deltas)
        np.testing.assert_allclose(ts._shadow[i].numpy(),
                                   np.asarray(js._shadow[name]), rtol=0,
                                   atol=level, err_msg=name)


def test_replay_and_fallback_land_on_the_shadow():
    k = 1
    js, ts, jct, params = _servers(SMALL, 4096, down_mode="delta",
                                   num_aggregate=k, down_window=2)
    unpack = transfer.make_device_unpacker(ts.params)
    apply_delta = ps.make_apply_delta(ts.compressor, ts.payload_unpack)
    m, buf, v0, _ = ts.pull(-1)
    local = unpack(torch.from_numpy(buf.copy()))
    for r in range(2):
        _push_round(js, ts, jct, SMALL, k, r)
    m, bufs, v, n = ts.pull(v0)
    assert (m, v, len(bufs)) == ("delta", 2, 2)
    for b in bufs:
        local = apply_delta(local, torch.from_numpy(b.copy()))
    for x, sh in zip(local, ts._shadow):
        assert torch.equal(x, sh)
    # The shadow is not the parameters: it lags by the residual.
    assert any(not torch.equal(p, sh)
               for p, sh in zip(ts.params, ts._shadow))
    assert ts.pull(v) == ("delta", [], v, 0)
    for r in range(2, 5):
        _push_round(js, ts, jct, SMALL, k, r)
    # Version 0 is 5 behind a window of 2: the shadow, dense, in f32.
    jm, _, jv, jn = js.pull(0)
    tm, tb, tv, tn = ts.pull(0)
    assert (tm, tv, tn) == (jm, jv, jn) == ("weights", 5,
                                            ts._down_bytes)
    for x, sh in zip(unpack(torch.from_numpy(tb.copy())), ts._shadow):
        assert torch.equal(x, sh)
    assert sorted(ts._deltas) == sorted(js._deltas) == [4, 5]


@pytest.mark.parametrize("bootstrap", ["f32", "bf16"])
def test_workers_replay_onto_the_shadow_after_a_run(bootstrap):
    """After a run, each worker's final pull replays onto the shadow bit
    for bit from an f32 bootstrap; from a bf16 one, onto its rounded base
    plus the same deltas (a replay from the f32 start lands on the
    shadow)."""
    from ewdml_tpu_torch.data import datasets, loader

    ds = datasets.load("MNIST", synthetic=True, synthetic_size=64, seed=0)
    model = build_model("LeNet", 10, dataset="MNIST", seed=1)
    run = ps.build_async_ps(
        model, SGD(0.01), lambda i: loader.global_batches(
            ds, 4, 1, seed=i, feed="f32"),
        num_workers=2, steps_per_worker=3,
        compressor=make_compressor("qsgd", 127, qsgd_block=4096),
        num_aggregate=2, down_mode="delta", bootstrap=bootstrap,
        device="cpu")
    _, stats = run.run()
    server, workers = run.server, run.workers
    assert stats.updates == 3 and sorted(server._deltas) == [1, 2, 3]
    assert stats.delta_s_sum > 0
    apply_delta = ps.make_apply_delta(server.compressor,
                                      server.payload_unpack)
    deltas = [torch.from_numpy(server._deltas[v].copy()) for v in (1, 2, 3)]
    # The shadow at every version: a replay from the f32 start.
    init = [torch.from_numpy(x) for x in _initial_params(model)]
    shadows = [init]
    for d in deltas:
        shadows.append(apply_delta(shadows[-1], d))
    for x, sh in zip(shadows[-1], server._shadow):
        assert torch.equal(x, sh)
    # The down-link's bytes, reckoned: two first pulls, then deltas only
    # (the window of 16 holds every version).
    boot_bytes = sum(x.numel() * (2 if bootstrap == "bf16" else 4)
                     for x in init)
    boot = "weights_bf16" if bootstrap == "bf16" else "weights"
    assert stats.pulls_by_mode[boot] == 2
    assert sum(stats.pulls_by_mode.values()) == 6
    assert stats.bytes_down == (2 * boot_bytes
                                + stats.deltas_down * deltas[0].numel())
    for w in workers:
        w.pull_params()
        assert w.version == 3 and w.base_version >= 0
        # Its base: the shadow at its first pull, rounded to bf16 there.
        replayed = shadows[w.base_version]
        if bootstrap == "bf16":
            replayed = [x.to(torch.bfloat16).to(torch.float32)
                        for x in replayed]
        for d in deltas[w.base_version:]:
            replayed = apply_delta(replayed, d)
        for x, y in zip(w.params, replayed):
            assert torch.equal(x, y)


def _initial_params(model):
    """The run's initial parameters (``run_async_ps`` reads them from the
    model), as numpy leaves in the JAX order and layout."""
    from ewdml_tpu_torch.models.convert import leaf_specs, to_jax
    from ewdml_tpu_torch.train.state import leaf_params

    specs = leaf_specs(model)
    return [to_jax(p.detach(), s.kind).contiguous().numpy().copy()
            for p, s in zip(leaf_params(model, specs), specs)]


def test_bf16_bootstrap_bytes_and_rules():
    js, ts, _, params = _servers(SMALL, 4096, down_mode="delta",
                                 bootstrap="bf16", down_window=2)
    dense = sum(int(np.prod(s)) * 4 for s in SMALL.values())
    jm, jbuf, _, jn = js.pull(-1)
    tm, tbuf, _, tn = ts.pull(-1)
    assert tm == jm == "weights_bf16" and tn == jn == dense // 2
    assert np.array_equal(tbuf, np.asarray(jbuf))     # byte for byte
    back = ps.make_bf16_unpacker(ts.params)(torch.from_numpy(tbuf.copy()))
    for x, p in zip(back, ts.params):
        assert x.dtype == torch.float32
        rel = (x - p).abs() / p.abs().clamp_min(1e-12)
        assert float(rel.max()) <= 2.0 ** -8
    # A worker behind the window falls back to f32, never bf16 again.
    js.version = ts.version = 5
    for server in (js, ts):
        m, buf, v, n = server.pull(0)
        assert (m, v, n, np.asarray(buf).nbytes) == ("weights", 5, dense,
                                                     dense)
    assert ts.stats.bytes_down == js.stats.bytes_down == dense // 2 + dense


@pytest.mark.parametrize("kw", [dict(down_mode="weights", comp=True),
                                dict(down_mode="delta", comp=False)],
                         ids=["weights", "no_compressor"])
def test_bf16_without_the_delta_mode_raises_as_the_reference(kw):
    params = _tree(SMALL, 0)
    comp = kw.pop("comp")
    with pytest.raises(ValueError) as je:
        jps.ParameterServer(_j(params), JSGD(0.1), JQSGD(127) if comp
                            else None, bootstrap="bf16", **kw)
    with pytest.raises(ValueError) as te:
        ps.ParameterServer(_t(params), SGD(0.1), QSGDCompressor(127) if comp
                           else None, bootstrap="bf16", device="cpu", **kw)
    assert str(te.value)[:120] == str(je.value)[:120]


@pytest.mark.parametrize("block", [None, 4096], ids=["per_tensor", "b4096"])
@pytest.mark.parametrize("mode", ["interpret", "off"])
def test_relay_pull_matches_reference(mode, block):
    pk.configure(mode)
    kernels.configure(mode)
    params = _tree(BIG, 3, scale=0.5, offset=1.0)
    jcomp, tcomp = JQSGD(127, block=block), QSGDCompressor(127, block=block)
    js = jps.ParameterServer(_j(params), JSGD(0.1), jcomp,
                             relay_compress=True, seed=11)
    ts = ps.ParameterServer(_t(params), SGD(0.1), tcomp, device="cpu",
                            relay_compress=True, seed=11)
    jm, jbuf, jv, jn = js.pull(-1, worker=0)
    tm, tbuf, tv, tn = ts.pull(-1, worker=0)
    wire = sum(tcomp.wire_bytes(s) for s in BIG.values())
    assert (tm, tv, tn) == (jm, jv, jn) == ("weights", 0, wire)
    assert ts.stats.bytes_down == js.stats.bytes_down == wire
    unpack = transfer.make_device_unpacker(ts.params)
    jl = unpack(torch.from_numpy(np.asarray(jbuf).copy()))
    tl = unpack(torch.from_numpy(tbuf.copy()))
    jkey = jax.random.fold_in(jax.random.key(11 ^ 0x5EED), 0)
    tkey = prng.fold_in(prng.key(11 ^ 0x5EED), 0)
    bit = 0
    for i, k in enumerate(sorted(BIG)):
        # The norms each package relays this leaf with.
        jn_ = np.asarray(jcomp.compress(jax.random.fold_in(jkey, i),
                                        jnp.asarray(params[k])).norm)
        tn_ = tcomp.compress(prng.layer_key(tkey, i),
                             torch.from_numpy(params[k])).norm.numpy()
        assert not np.array_equal(tl[i].numpy(), params[k])  # lossy
        if np.array_equal(jn_, tn_):
            assert torch.equal(tl[i], jl[i]), k
            bit += 1
        else:
            np.testing.assert_allclose(tl[i].numpy(), jl[i].numpy(), rtol=0,
                                       atol=float(tn_.max()) / 127 * 1.0001)
    assert bit >= 1
