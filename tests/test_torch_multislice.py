"""The multi-slice world (``--num-slices > 1``) against the JAX package.

The port's two-level ``LocalWorld`` and ``hierarchical_compressed_allreduce``
against ``build_multislice_mesh(2)`` (2 x 4 over the 8 CPU devices) and the
JAX collective inside ``shard_map``, with the same per-worker gradients
(numpy, from a seed) and the same key words; ``wire_plan``'s ``dcn/`` rows;
LeNet trainer steps at 2 x 2 through the slice harness of
``test_torch_slice.py``; the refusals; a checkpoint at W = 8, S = 2; the
device feed and the scan window at 2 x 4 and 2 x 2.

Oracle kinds (ROADMAP's north star), named per test:
- bit: the world's linearization, the ICI stage's own payloads on the
  kernel stream, the device feed's batches, ``wire_plan``'s rows, the
  refusal messages, a windowed run against a per-step one;
- tolerance: the dense hierarchical mean (against the global mean and
  the JAX collective), the dense trainer (``check_dense``), the
  error-feedback identity (f32 association);
- tolerance plus bounded flips (``test_torch_collectives.py``): the
  compressed hierarchical means and own views; a stochastic level can
  flip where a norm is one ulp apart, and a flip at the ICI stage moves
  the DCN stage's input;
- statistics: none (every draw here is the JAX package's bit for bit).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ewdml_tpu.core.mesh import build_multislice_mesh
from ewdml_tpu.ops import make_compressor as jmake
from ewdml_tpu.ops import pallas_kernels as pk
from ewdml_tpu.parallel import collectives as jcoll
from ewdml_tpu_torch.core.world import LocalWorld, build_world
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.ops import make_compressor as tmake
from ewdml_tpu_torch.parallel import collectives as tcoll
from ewdml_tpu_torch.utils import prng
from test_torch_collectives import _close_with_flips
from test_torch_slice import (check_dense, check_wire, check_with_flips,  # noqa: F401
                              jax_twins, plain_calls, run_pair)

torch.set_num_threads(2)
S, W = 2, 8
SHAPES = [(20,), (5, 5, 3, 8), (3000,), (70, 90)]


@pytest.fixture(autouse=True)
def _restore_modes():
    # The trainers and cases under test set the process-wide kernel modes.
    kernels.configure("auto")
    pk.configure("auto")
    yield
    kernels.configure("auto")
    pk.configure("auto")


def _grads(seed, shapes):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(*s) * rng.choice([0.01, 1.0])).astype(np.float32)
             for s in shapes] for _ in range(W)]


def _stacked(grads, shapes):
    return [jnp.asarray(np.stack([g[i] for g in grads]).reshape(
        (S, W // S) + tuple(shape))) for i, shape in enumerate(shapes)]


def _shard(body, n_in, n_out):
    specs_in = tuple(P("dcn", "data") for _ in range(n_in))
    # n_out: an output count (a flat tuple) or a tuple of counts.
    specs_out = (tuple(P("dcn", "data") for _ in range(n_out))
                 if isinstance(n_out, int) else
                 tuple(tuple(P("dcn", "data") for _ in range(k))
                       for k in n_out))
    return jax.jit(jax.shard_map(body, mesh=build_multislice_mesh(2),
                                 in_specs=specs_in, out_specs=specs_out,
                                 check_vma=False))


def _rows(arrs):
    """``[S, W/S, ...]`` outputs as ``[W, ...]`` numpy, linear rank order."""
    return [np.asarray(a).reshape((W,) + a.shape[2:]) for a in arrs]


def _close_own(t, j, scale, s=127):
    """The flips oracle for an own view ``own_ici + own_dcn - within``: its
    terms are up to ``scale`` (the leaf's largest gradient), so the f32
    tolerance is relative to that, not to the (cancelled) result."""
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    tol = 2e-6 * scale
    diff = np.abs(t - j)
    assert diff.max() <= 8 * scale / s + tol
    assert (diff > tol).sum() <= 0.01 * diff.size + 1


def _jax_hier(grads, comp, kw):
    shapes = [g.shape for g in grads[0]]

    def body(*leaves):
        key = jax.random.key(7)
        avg, own = jcoll.hierarchical_compressed_allreduce(
            [l[0, 0] for l in leaves], comp, key, ici_axis="data",
            dcn_axis="dcn", relay_key=jax.random.fold_in(key, 0x5EED),
            return_own_decompressed=True, **kw)
        return (tuple(a[None, None] for a in avg),
                tuple(o[None, None] for o in own))

    avg, own = _shard(body, len(shapes), (len(shapes),) * 2)(
        *_stacked(grads, shapes))
    return _rows(avg), _rows(own)


def _torch(grads):
    return [[torch.from_numpy(x) for x in g] for g in grads]


def _port_hier(grads, comp, kw):
    key = prng.key(7)
    return tcoll.hierarchical_compressed_allreduce(
        LocalWorld(W, "cpu", num_slices=S), _torch(grads), comp, key,
        relay_key=prng.fold_in(key, 0x5EED), return_own_decompressed=True,
        **kw)


def test_world_linearizes_major_to_minor():
    """bit: worker r is slice r // (W/S) at ICI rank r % (W/S), as
    ``devs.reshape(num_slices, -1)``; the sub-worlds' ranks are the
    level's axis index."""
    world = LocalWorld(W, "cpu", num_slices=S)
    mesh = build_multislice_mesh(2)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    assert (world.num_slices, world.slice_size) == mesh.devices.shape
    for r in world.ranks:
        s, d = world.coords(r)
        assert ids[s, d] == jax.devices()[r].id
        assert world.ici(s).members[d] == r
        assert world.dcn(d).members[s] == r
    assert list(world.ici(1).ranks) == list(range(W // S))
    assert list(world.dcn(3).ranks) == list(range(S))


def test_world_refuses_a_slice_count_that_does_not_divide():
    """bit: the JAX package's message (``mesh.py:48-52``); with no
    --num-workers one card is one worker, and the message says so."""
    with pytest.raises(ValueError) as jerr:
        build_multislice_mesh(3, num_devices=8)
    with pytest.raises(ValueError) as terr:
        LocalWorld(8, "cpu", num_slices=3)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="num-slices 2 does not divide the "
                                         "1 available.*--num-workers W "
                                         "emulates"):
        build_world(None, 2, "cpu")
    assert build_world(4, 2, "cpu").slice_size == 2


CASES = [
    ("none", {}, {}),
    ("qsgd", {}, dict(relay=True)),
    ("qsgd", dict(qsgd_block=4096), dict(relay=False)),
    ("topk_qsgd", dict(topk_ratio=0.05), dict(relay=True)),
    ("topk_qsgd", dict(topk_ratio=0.05, topk_exact="block"),
     dict(relay=True)),
    ("topk_qsgd", dict(topk_ratio=0.05), dict(relay=True,
                                               bucket_bytes=16384)),
]


def _case_grads(name, kw):
    return _grads(len(str(kw)) + len(name), SHAPES)


@functools.lru_cache(maxsize=None)
def _jax_cases():
    """The JAX collective's ``(avg, own)`` rows of every case in CASES,
    from one trace and one compile: a case's outputs depend only on its own
    inputs, compressor and key words."""
    n = len(SHAPES)
    comps = [jmake(name, **ckw) for name, ckw, _ in CASES]

    def body(*leaves):
        key = jax.random.key(7)
        out = []
        for c, (_, _, kw) in enumerate(CASES):
            avg, own = jcoll.hierarchical_compressed_allreduce(
                [l[0, 0] for l in leaves[c * n:(c + 1) * n]], comps[c], key,
                ici_axis="data", dcn_axis="dcn",
                relay_key=jax.random.fold_in(key, 0x5EED),
                return_own_decompressed=True, **kw)
            out += [a[None, None] for a in avg] + [o[None, None] for o in own]
        return tuple(out)

    ins = [x for name, _, kw in CASES
           for x in _stacked(_case_grads(name, kw), SHAPES)]
    rows = _rows(_shard(body, len(ins), 2 * len(ins))(*ins))
    return [(rows[2 * c * n:(2 * c + 1) * n],
             rows[(2 * c + 1) * n:(2 * c + 2) * n])
            for c in range(len(CASES))]


@pytest.mark.parametrize("name,ckw,kw", CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_hierarchical_allreduce_matches(name, ckw, kw):
    """tolerance (NoneCompressor, also against the global mean) or
    tolerance plus bounded flips (the compressors, threefry draws): the
    average every worker holds and each worker's own view across both
    stages, per leaf."""
    grads = _case_grads(name, kw)
    javg, jown = _jax_cases()[CASES.index((name, ckw, kw))]
    tavg, town = _port_hier(grads, tmake(name, **ckw), kw)
    for i, shape in enumerate(SHAPES):
        scale = max(np.abs(g[i]).max() for g in grads)
        assert tuple(tavg[i].shape) == shape
        # every worker of the JAX collective holds the same average
        assert all(np.array_equal(javg[i][0], javg[i][r]) for r in range(W))
        if name == "none":
            mean = np.mean([g[i] for g in grads], axis=0, dtype=np.float64)
            np.testing.assert_allclose(tavg[i].numpy(), mean, rtol=1e-5,
                                       atol=1e-6 * scale)
            np.testing.assert_allclose(tavg[i].numpy(), javg[i][0],
                                       rtol=1e-6, atol=1e-7 * scale)
            continue
        # Two quantizations deep, so twice the single-stage flip bound.
        _close_with_flips(tavg[i].numpy(), javg[i][0], 2 * scale)
        for r in range(W):
            _close_own(town[r][i].numpy(), jown[i][r], scale)


def test_hierarchical_qsgd_on_the_kernel_stream(jax_twins, plain_calls,
                                                monkeypatch):
    """bit (the ICI stage's quantized levels: the quantize kernel's murmur
    stream with the level's rank keys; each own view is its levels times
    the norm, which may round an ulp apart) and tolerance plus bounded flips
    (the means; ``dequant_mean`` holds to ROADMAP Queue 3 item 1's
    bound): a leaf above MIN_ELEMS under ``interpret`` on both sides, with
    the relay. dequant_mean runs at K = W/S rows per slice, then K = S."""
    pk.configure("interpret")
    kernels.configure("interpret")
    shapes = [(kernels.MIN_ELEMS + 8_859,)]
    grads = _grads(11, shapes)
    rows = []
    ref = kernels.dequant_mean_ref

    def spy(levels, *a, **k):
        rows.append(levels.shape[0])
        return ref(levels, *a, **k)
    monkeypatch.setattr(kernels, "dequant_mean_ref", spy)
    kw = dict(relay=True)
    javg, jown = _jax_hier(grads, jmake("qsgd"), kw)
    calls = dict(plain_calls)
    tavg, town = _port_hier(grads, tmake("qsgd"), kw)
    # W quantizes in the slices, S over DCN, one relay; dequant_mean
    # once per slice (K = 4) and once over DCN (K = 2).
    assert plain_calls["qsgd_quantize"] - calls["qsgd_quantize"] == W + S + 1
    assert rows == [W // S] * S + [S]
    scale = max(np.abs(g[0]).max() for g in grads)
    _close_with_flips(tavg[0].numpy(), javg[0][0], 2 * scale)
    for r in range(W):
        _close_own(town[r][0].numpy(), jown[0][r], scale)

    # The ICI stage alone, rank r folded as its ICI rank r % (W/S): every
    # own view within 1e-6 relative, far inside one level's step (at
    # least 1/127 relative), so every level is the same.
    def ici_body(leaf):
        _, own = jcoll.compressed_allreduce(
            [leaf[0, 0]], jmake("qsgd"), jax.random.key(7), axis_name="data",
            return_own_decompressed=True)
        return (own[0][None, None],)
    (jici,) = _shard(ici_body, 1, 1)(*_stacked(grads, shapes))
    jici = _rows([jici])[0]
    world = LocalWorld(W, "cpu", num_slices=S)
    for s in range(S):
        _, own = tcoll.compressed_allreduce(
            world.ici(s), _torch(grads[s * 4:(s + 1) * 4]), tmake("qsgd"),
            prng.key(7), return_own_decompressed=True)
        for d in range(W // S):
            np.testing.assert_allclose(own[d][0].numpy(), jici[s * 4 + d],
                                       rtol=1e-6, atol=0)


def test_error_feedback_identity():
    """tolerance (f32 association) and bounded flips against JAX: per
    worker g - own_eff = (g - own_ici) + (within - own_dcn), every worker
    of a slice holding the same DCN term, in both packages."""
    grads = _grads(21, [(4000,)])
    comp_j, comp_t = jmake("qsgd"), tmake("qsgd")

    def body(leaf):
        key = jax.random.key(7)
        g = leaf[0, 0]
        within, own_ici = jcoll.compressed_allreduce(
            [g], comp_j, key, axis_name="data", return_own_decompressed=True)
        _, own_dcn = jcoll.compressed_allreduce(
            within, comp_j, jax.random.fold_in(key, 0xDC4), axis_name="dcn",
            return_own_decompressed=True)
        _, own_eff = jcoll.hierarchical_compressed_allreduce(
            g, comp_j, key, return_own_decompressed=True)
        return tuple(x[None, None] for x in
                     (within[0], own_ici[0], own_dcn[0], own_eff))
    jw, jici, jdcn, jeff = _rows(_shard(body, 1, 4)(
        *_stacked(grads, [(4000,)])))
    world = LocalWorld(W, "cpu", num_slices=S)
    key = prng.key(7)
    tw, tici = [], []
    for s in range(S):
        avg, own = tcoll.compressed_allreduce(
            world.ici(s), _torch(grads[s * 4:(s + 1) * 4]), comp_t, key,
            return_own_decompressed=True)
        tw.append(avg)
        tici.extend(own)
    _, tdcn = tcoll.compressed_allreduce(
        world.dcn(0), tw, comp_t, prng.fold_in(key, 0xDC4),
        return_own_decompressed=True)
    _, teff = tcoll.hierarchical_compressed_allreduce(
        world, _torch(grads), comp_t, key, return_own_decompressed=True)
    scale = max(np.abs(g[0]).max() for g in grads)
    for r in range(W):
        s = r // (W // S)
        g = grads[r][0].astype(np.float64)
        for eff, ici, within, dcn in (
                (teff[r][0].numpy(), tici[r][0].numpy(), tw[s][0].numpy(),
                 tdcn[s][0].numpy()),
                (jeff[r], jici[r], jw[r], jdcn[r])):
            rhs = (g - ici) + (within.astype(np.float64) - dcn)
            np.testing.assert_allclose(g - eff, rhs, rtol=0,
                                       atol=4e-7 * scale)
        # the DCN term is the slice's: the same on each of its workers
        assert np.array_equal(jw[r] - jdcn[r], jw[s * 4] - jdcn[s * 4])
        _close_own(teff[r][0].numpy(), jeff[r], scale)


@functools.lru_cache(maxsize=None)
def _trees(net):
    """The JAX parameter shapes and the port's ``(name, jax_shape)``
    leaves of ``net``."""
    from ewdml_tpu.models import build_model as jbuild, init_variables
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs

    dataset, shape = (("mnist10k", (2, 28, 28, 1)) if net == "LeNet"
                      else ("Cifar10", (2, 32, 32, 3)))
    jm = jbuild(net, 10, jnp.float32)
    params = jax.eval_shape(lambda: init_variables(
        jm, jax.random.key(0), jnp.zeros(shape)))["params"]
    leaves = [(s.name, s.jax_shape)
              for s in leaf_specs(build_model(net, 10, dataset=dataset,
                                              seed=0))]
    return params, leaves


def _plans(kw, net, world=W):
    from ewdml_tpu.core import config as jconfig
    from ewdml_tpu.train.metrics import wire_plan as jplan
    from ewdml_tpu_torch.core import config as tconfig
    from ewdml_tpu_torch.train.metrics import wire_plan as tplan

    params, leaves = _trees(net)
    return (jplan(jconfig.TrainConfig(**kw), params, world=world),
            tplan(tconfig.TrainConfig(**kw), leaves, world=world))


@pytest.mark.parametrize("net", ["LeNet", "VGG11"])
@pytest.mark.parametrize("kw", [
    dict(method=1), dict(method=2), dict(method=4),
    dict(method=4, error_feedback=True, fusion="none"),
    dict(method=5, topk_ratio=0.01), dict(method=6),
    dict(method=4, overlap="bucket", overlap_buckets=3),
    dict(method=4, precision_policy="bf16_wire"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_wire_plan_dcn_rows_are_the_jax_ones(net, kw, monkeypatch):
    """bit: every row (the ``dcn/`` ones amortized over W/S), the per-step
    bytes and the one ``<monolithic>`` bucket; and unamortized with no
    world."""
    from ewdml_tpu.obs import registry as oreg

    # Hold the JAX plan's process-global fallback gauge unset (ROADMAP
    # Queue 3 item 25).
    monkeypatch.setattr(oreg.gauge("adapt.comm_frac"), "value", None)
    kw = dict(kw, num_slices=S)
    for world in (W, None):
        j, t = _plans(kw, net, world)
        for f in ("per_layer_up", "per_layer_down", "per_step_bytes",
                  "per_step_bytes_total", "wire_dtype", "transport",
                  "overlap", "per_bucket_up", "per_bucket_down",
                  "per_bucket_bytes", "per_rank_exchange_bytes",
                  "per_layer_bytes"):
            assert getattr(t, f) == getattr(j, f), (f, world)
        dcn = [n for n in t.per_layer_up if n.startswith("dcn/")]
        assert len(dcn) == (0 if kw["method"] == 1
                            else len(t.per_layer_up) // 2)
        assert list(t.per_bucket_up) == ["<monolithic>"]


@pytest.fixture
def jax_init_once(monkeypatch):
    """The JAX trainer's initial variables, computed once a process: a pure
    function of the model, the key and the sample input, which the three
    trainer pairs share (each would compile its own ``model.init``)."""
    import ewdml_tpu.models as jmodels

    init = jmodels.init_variables

    def cached(model, key, sample_input, train=False):
        x = np.asarray(sample_input)
        k = (repr(model), np.asarray(jax.random.key_data(key)).tobytes(),
             x.shape, x.dtype.str, x.tobytes(), train)
        if k not in _JAX_INITS:
            _JAX_INITS[k] = init(model, key, sample_input, train=train)
        return _JAX_INITS[k]
    monkeypatch.setattr(jmodels, "init_variables", cached)


_JAX_INITS = {}


@pytest.mark.parametrize("kw", [
    dict(method=1, max_steps=1),
    dict(method=4, max_steps=2),
    dict(method=5, topk_ratio=0.01, error_feedback=True, max_steps=2),
], ids=["m1_1step", "m4_2steps", "m5_ef_2steps"])
def test_trainer_steps_at_2x2_match(tmp_path, jax_twins, plain_calls,
                                    jax_init_once, kw):
    """The slice's oracles at --num-workers 4 --num-slices 2: exact wire
    rows, ``check_dense`` (tolerance) for M1, ``check_with_flips``
    (tolerance plus bounded flips) for M4 and M5 with error feedback."""
    pair = run_pair(tmp_path, num_slices=2, **kw)
    assert pair.tt.world.num_slices == 2 and pair.tt.world.size == 4
    assert pair.jt.mesh.shape["dcn"] == 2
    check_wire(pair)
    assert any(n.startswith("dcn/") for n in pair.tt.wire.per_layer_up) \
        == (kw["method"] != 1)
    steps = kw["max_steps"]
    if kw["method"] == 1:
        check_dense(pair)
        assert sum(plain_calls.values()) == 0
        return
    check_with_flips(pair)
    if kw["method"] == 4:
        # Per step and leaf: 4 quantizes in the slices, 2 over DCN and
        # the relay; dequant_mean once a slice and once over DCN.
        assert plain_calls["qsgd_quantize"] == steps * 8 * (4 + 2 + 1)
        assert plain_calls["dequant_mean"] == steps * 8 * (2 + 1)
    else:
        # fc1 selects in blocks: one block_top1 a worker in the slices,
        # one a slice over DCN.
        assert plain_calls["block_top1"] == steps * (4 + 2)
        for ws in pair.tt.state.workers:
            assert any(float(r.abs().max()) > 0 for r in ws.residual)
    assert abs(pair.tres.final_loss - pair.jres.final_loss) <= \
        1e-3 * abs(pair.jres.final_loss)


REFUSALS = [
    dict(method=4, num_aggregate=2), dict(method=4, gather_type="ring_rs"),
    dict(method=5, gather_type="ring"), dict(method=3, collective="fused_q"),
    dict(method=4, overlap="bucket"), dict(method=4, adapt="variance"),
]


@pytest.mark.parametrize("kw", REFUSALS,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_refusals_are_the_jax_ones(tmp_path, kw):
    """bit: the JAX package's message, word for word (the hierarchical
    exchange's own refusal names --num-slices; fused_q, --overlap bucket
    and --adapt say "single-slice meshes only")."""
    from ewdml_tpu.adapt import validate_config as jadapt
    from ewdml_tpu.core.config import TrainConfig as JConfig
    from ewdml_tpu.models import build_model as jbuild
    from ewdml_tpu.optim import make_optimizer as jopt
    from ewdml_tpu.train.trainer import make_train_step as jstep
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.train.loop import Trainer

    common = dict(network="LeNet", dataset="mnist10k", num_workers=4,
                  num_slices=2, batch_size=8, train_dir=str(tmp_path) + "/")
    jcfg = JConfig(**common, **kw)
    with pytest.raises(ValueError) as jerr:
        if jcfg.adapt != "off":
            jadapt(jcfg, surface="trainer")
        jstep(jbuild("LeNet", 10), jopt("sgd", 0.01), jcfg,
              build_multislice_mesh(2, num_devices=4))
    with pytest.raises(ValueError) as terr:
        Trainer(TrainConfig(platform="cpu", **common, **kw))
    assert str(terr.value) == str(jerr.value)
    assert "num-slices" in str(terr.value) or \
        "single-slice" in str(terr.value)


def test_checkpoint_restores_and_evaluates_at_8x2(tmp_path):
    """bit: a W = 8, S = 2 run's checkpoint restores every worker's state
    and step, and the evaluator reads it as the trainer evaluates
    (``tests/test_train.py:192-201``)."""
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.train import checkpoint
    from ewdml_tpu_torch.train.evaluator import DistributedEvaluator
    from ewdml_tpu_torch.train.loop import Trainer

    cfg = TrainConfig(platform="cpu", network="LeNet", dataset="mnist10k",
                      num_workers=8, num_slices=2, method=5, topk_ratio=0.01,
                      error_feedback=True, batch_size=4, max_steps=4,
                      eval_freq=2, test_batch_size=500, epochs=100,
                      log_every=1000, bf16_compute=False,
                      train_dir=str(tmp_path) + "/")
    t = Trainer(cfg)
    t.train()
    ev = t.evaluate()
    t2 = Trainer(cfg)
    assert t2.maybe_restore() and t2.state.step == 4
    for a, b in zip(t.state.workers, t2.state.workers):
        for x, y in zip(a.model.state_dict().values(),
                        b.model.state_dict().values()):
            assert torch.equal(x, y)
        for x, y in zip(a.residual, b.residual):
            assert torch.equal(x, y)
    result = DistributedEvaluator(cfg).evaluate_once(
        checkpoint.latest_path(cfg.train_dir))
    assert result["step"] == 4
    assert result["loss"] == ev["loss"] and result["top1"] == ev["top1"]


def test_device_feed_on_2x4_is_the_jax_one():
    """bit: each worker's batch of the device feed on the (dcn, data) mesh
    (the JAX step's rank over the axis tuple) is the port's at its linear
    rank, augmentation included."""
    from ewdml_tpu.data import device_feed as jfeed
    from ewdml_tpu_torch.data import device_feed as tfeed
    from ewdml_tpu_torch.utils.keytable import HostKeys

    rng = np.random.RandomState(3)
    data = rng.randint(0, 256, (200, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 10, (200,)).astype(np.int32)
    batch, step = 6, 5
    base = jax.random.key(42)

    def body(data, labels):
        axes = ("dcn", "data")
        dkey = jax.random.fold_in(jax.random.fold_in(
            base, jfeed.DATA_TAG), jfeed.DATA_TAG)
        images, labs = jfeed.fetch(
            data, labels, dkey, step, batch, jax.lax.axis_size(axes),
            jax.lax.axis_index(axes), augment=True)
        return images[None, None], labs[None, None]

    f = jax.jit(jax.shard_map(body, mesh=build_multislice_mesh(2),
                              in_specs=(P(), P()),
                              out_specs=(P("dcn", "data"),) * 2,
                              check_vma=False))
    jimg, jlab = _rows(f(jnp.asarray(data), jnp.asarray(labels)))
    feed = tfeed.DeviceFeed(prng.key(42), 200, batch, W, augment=True)
    got = feed.batches(torch.from_numpy(data), torch.from_numpy(labels),
                       step, HostKeys(prng.key(42)))
    for r, (img, lab) in enumerate(got):
        assert np.array_equal(img.numpy(), jimg[r])
        assert np.array_equal(lab.numpy(), jlab[r])


def test_window_is_the_per_step_run_at_2x2(tmp_path):
    """bit: a ``--scan-window 2`` run of M5 with error feedback at 2 x 2
    (a loop over a key table on the CPU) against the per-step run: every
    metrics row, parameter and residual."""
    from ewdml_tpu_torch.core.config import TrainConfig
    from ewdml_tpu_torch.train.loop import Trainer

    runs = []
    for window in (1, 2):
        cfg = TrainConfig(platform="cpu", network="LeNet", dataset="mnist10k",
                          num_workers=4, num_slices=2, method=5,
                          topk_ratio=0.01, error_feedback=True, batch_size=4,
                          max_steps=4, epochs=100, log_every=1000,
                          eval_freq=0, bf16_compute=False, feed="device",
                          scan_window=window,
                          train_dir=str(tmp_path / str(window)) + "/")
        t = Trainer(cfg)
        runs.append((t, t.train()))
    (a, ra), (b, rb) = runs
    assert b.window_step is not None and a.window_step is None
    assert np.array_equal(ra.rows, rb.rows)
    for x, y in zip(a.state.workers, b.state.workers):
        for p, q in zip(x.model.parameters(), y.model.parameters()):
            assert torch.equal(p, q)
        for p, q in zip(x.residual, y.residual):
            assert torch.equal(p, q)
