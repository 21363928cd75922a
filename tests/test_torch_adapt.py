"""The adaptive controller's host units against the JAX package's
(``ewdml_tpu/adapt``), on the CPU.

Oracles, per test:
- the streaming moments: bit, against both packages' two-pass reference
  (the same float64 numpy operations in the same order);
- the controller's Pareto frontier, rung bytes and noise, effective budget,
  ``decide`` and ``plan_bytes`` over seeded variance vectors and
  ``comm_frac`` in {None, 0.1, 0.4, 0.9}, on the payload and the
  homomorphic wire: bit (integer bytes, float64 noise, the plan's JSON);
- ``plan_wire_bytes`` and ``homomorphic_unit_bytes`` of every ladder rung
  on every leaf of LeNet, VGG11-BN and ResNet18, and the unit names:
  exact;
- the ledger: lines byte-equal apart from ``latency_ms`` (a wall time);
  a ledger written by either package replays in the other with the same
  plans at the same steps;
- ``reconfigure``: the same hit and miss counts for the same call
  sequence;
- ``PlannedCompressor``: per-rung payloads against the JAX compressors
  under the same keys, leaves below the kernel gate (the threefry draws):
  bit for indices, levels and norms up to the ``test_torch_compressors``
  norm rounding bound;
- the wire plan under a per-unit compressor: the same per-layer rows.

No test reads or sets a process-global gauge: the JAX runtime's comm/comp
read is held with ``monkeypatch``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.adapt import controller as jcontroller
from ewdml_tpu.adapt import ledger as jledger
from ewdml_tpu.adapt import plan as jplan
from ewdml_tpu.adapt import runtime as jruntime
from ewdml_tpu.adapt import variance as jvariance
from ewdml_tpu.core.config import TrainConfig as JConfig
from ewdml_tpu.models import build_model as jbuild
from ewdml_tpu.ops import chain as jchain
from ewdml_tpu.train import metrics as jmetrics
from ewdml_tpu_torch.adapt import controller, ledger, plan, runtime, variance
from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.models import build_model
from ewdml_tpu_torch.models.convert import leaf_specs
from ewdml_tpu_torch.ops import chain
from ewdml_tpu_torch.train import metrics
from ewdml_tpu_torch.utils import prng

torch.set_num_threads(2)

NETS = {"LeNet": ("mnist", (1, 28, 28, 1)), "VGG11": ("cifar10", (1, 32, 32, 3)),
        "ResNet18": ("cifar10", (1, 32, 32, 3))}


@pytest.fixture(scope="module")
def units():
    """Per network: the JAX and the port's (names, sizes)."""
    out = {}
    for net, (ds, shape) in NETS.items():
        variables = jax.eval_shape(
            lambda net=net, shape=shape: jbuild(net).init(
                jax.random.key(0), jnp.zeros(shape), train=False))
        jnames = jplan.unit_names_and_sizes(variables["params"])
        tnames = plan.unit_names_and_sizes(
            leaf_specs(build_model(net, dataset=ds)))
        out[net] = (jnames, tnames)
    return out


# -- the estimator ---------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.2, 0.5, 1.0])
def test_streaming_moments_bit_equal(alpha):
    rng = np.random.default_rng(3)
    samples = rng.standard_normal((7, 5, 2)) ** 2
    js = jvariance.StreamingMoments(5, alpha)
    ts = variance.StreamingMoments(5, alpha)
    for s in samples.astype(np.float32):  # the steps' samples are f32
        js.update(s)
        ts.update(s)
    for a, b in zip(js.moments(), ts.moments()):
        assert np.array_equal(a, b)
    assert np.array_equal(js.variance(), ts.variance())
    ref = variance.two_pass_reference(samples.astype(np.float32), alpha)
    jref = jvariance.two_pass_reference(samples.astype(np.float32), alpha)
    for a, b in zip(ref, jref):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(ts.variance(), ref[2], rtol=1e-12, atol=1e-15)
    z = variance.two_pass_reference(np.zeros((0, 3, 2)))
    assert all(np.array_equal(a, b) for a, b in
               zip(z, jvariance.two_pass_reference(np.zeros((0, 3, 2)))))


# -- the controller --------------------------------------------------------------

@pytest.mark.parametrize("net", ["LeNet", "VGG11"])
@pytest.mark.parametrize("wire", ["payload", "homomorphic"])
@pytest.mark.parametrize("block", [None, 4096])
def test_controller_decisions_bit_equal(units, net, wire, block):
    (jn, js), (tn, ts) = units[net]
    assert (tn, ts) == (jn, js)
    budget = jplan.plan_wire_bytes(
        jplan.static_plan(JConfig(compress_grad="topk_qsgd"), jn, js), js,
        block=block, wire=wire)
    jc = jcontroller.VarianceController(jn, js, budget_bytes=budget,
                                        block=block, wire=wire)
    tc = controller.VarianceController(tn, ts, budget_bytes=budget,
                                       block=block, wire=wire)
    assert tc._frontier == jc._frontier
    assert tc._bytes == jc._bytes and tc._noise == jc._noise
    rng = np.random.default_rng(len(js))
    for trial in range(4):
        var = rng.gamma(0.5, 1e-4, size=len(js))
        if trial == 3:
            var[:] = var[0]          # ties break on the lowest unit index
        for cf in (None, 0.1, 0.4, 0.9):
            assert tc.effective_budget(cf) == jc.effective_budget(cf)
            jp = jc.decide(17, var, cf, version=trial + 1)
            tp = tc.decide(17, var, cf, version=trial + 1)
            assert tp.to_json() == jp.to_json()
            assert tc.plan_bytes(tp) == jc.plan_bytes(jp)
            assert tp.summary() == jp.summary()


def test_ladder_and_constants():
    assert controller.DEFAULT_LADDER == jcontroller.DEFAULT_LADDER
    assert controller.TARGET_COMM_FRAC == jcontroller.TARGET_COMM_FRAC
    assert plan.METHODS == jplan.METHODS


@pytest.mark.parametrize("net", list(NETS))
def test_rung_bytes_on_every_leaf(units, net):
    (jn, js), (tn, ts) = units[net]
    assert tn == jn and ts == js
    for m, s, r in controller.DEFAULT_LADDER:
        for block in (None, 4096):
            jp = jplan.Plan(0, 0, tuple(jplan.UnitDecision(u, n, m, s, r)
                                        for u, n in enumerate(jn)))
            tp = plan.Plan(0, 0, tuple(plan.UnitDecision(u, n, m, s, r)
                                       for u, n in enumerate(tn)))
            for wire in ("payload", "homomorphic"):
                assert plan.plan_wire_bytes(tp, ts, block=block, wire=wire) \
                    == jplan.plan_wire_bytes(jp, js, block=block, wire=wire)
        for n in ts:
            assert plan.homomorphic_unit_bytes(m, s, r, n) == \
                jplan.homomorphic_unit_bytes(m, s, r, n)
    with pytest.raises(ValueError, match="no shared-scale wire"):
        plan.homomorphic_unit_bytes("zstd", 0, 0.0, 10)


def test_plan_json_and_static_plan():
    for cg in ("qsgd", "topk_qsgd"):
        kw = dict(compress_grad=cg, quantum_num=7, topk_ratio=0.05)
        jp = jplan.static_plan(JConfig(**kw), ["a/kernel", "b"], [10, 20])
        tp = plan.static_plan(TrainConfig(**kw), ["a/kernel", "b"], [10, 20])
        assert tp.to_json() == jp.to_json() and tp.key() == jp.key()
        assert plan.Plan.from_json(json.loads(json.dumps(jp.to_json()))) == tp
    for bad in ("none", "topk"):
        with pytest.raises(ValueError) as je:
            jplan.static_plan(JConfig(compress_grad=bad), ["a"], [1])
        with pytest.raises(ValueError) as te:
            plan.static_plan(TrainConfig(compress_grad=bad), ["a"], [1])
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="unknown method"):
        plan.UnitDecision(0, "a", "zstd")


# -- the ledger ------------------------------------------------------------------

def _mixed_plan(mod, version, step):
    ds = [mod.UnitDecision(0, "conv1/kernel", "dense"),
          mod.UnitDecision(1, "conv1/bias", "qsgd", s=7),
          mod.UnitDecision(2, "fc1/kernel", "topk_qsgd", s=127, ratio=0.01)]
    return mod.Plan(version, step, tuple(ds))


def _strip(line: str) -> dict:
    rec = json.loads(line)
    rec.pop("latency_ms", None)
    return rec


def test_ledger_lines_and_cross_replay(tmp_path):
    paths = {}
    for name, mod, pmod in (("jax", jledger, jplan), ("port", ledger, plan)):
        path = tmp_path / f"{name}.jsonl"
        lg = mod.DecisionLedger(str(path), meta={"mode": "variance",
                                                 "units": ["a", "b"]})
        lg.append_decision(_mixed_plan(pmod, 0, 0), trigger="init",
                           switched=False, bytes_per_sync=123)
        lg.append_decision(_mixed_plan(pmod, 1, 5), trigger="variance",
                           switched=True, signals={"comm_frac": 0.4},
                           bytes_per_sync=99, latency_s=1e-3)
        lg.append_decision(_mixed_plan(pmod, 2, 5), trigger="resume",
                           switched=True)
        lg.close()
        with open(path, "a") as f:
            f.write('{"kind": "decision", "step": 9, "pla')  # a torn tail
        paths[name] = path
    jl = open(paths["jax"]).read().splitlines()
    tl = open(paths["port"]).read().splitlines()
    assert tl[0] == jl[0] and tl[-1] == jl[-1]
    assert [_strip(x) for x in tl[1:-1]] == [_strip(x) for x in jl[1:-1]]
    # Either package's ledger replays in the other; the last row for a
    # step wins.
    for path in paths.values():
        js = jledger.ReplaySchedule.from_path(str(path))
        ts = ledger.ReplaySchedule.from_path(str(path))
        assert ts.steps == js.steps == [0, 5]
        for step in (0, 3, 5, 7):
            assert ts.plan_at_or_before(step).to_json() == \
                js.plan_at_or_before(step).to_json()
        assert ts.plan_at(5).version == 2
    assert ledger.read_decisions(str(tmp_path / "none.jsonl")) == []
    with pytest.raises(FileNotFoundError, match="no decisions"):
        ledger.ReplaySchedule.from_path(str(tmp_path / "none.jsonl"))


def _cfgs(tmp_path, **kw):
    base = dict(compress_grad="topk_qsgd", topk_ratio=0.5, adapt="variance",
                adapt_every=2, train_dir=str(tmp_path) + "/")
    base.update(kw)
    return JConfig(**base), TrainConfig(**base)


def test_runtime_ledger_byte_equal(tmp_path, monkeypatch, units):
    """Both runtimes fed the same moment samples and comm/comp ratios
    journal the same lines; the JAX one reads its ratio from a gauge,
    held here with monkeypatch."""
    (jn, js), _ = units["LeNet"]
    rng = np.random.default_rng(11)
    samples = [np.stack([rng.normal(0, 1e-3, len(js)),
                         rng.gamma(0.5, 1e-4, len(js))], axis=1)
               .astype(np.float32) for _ in range(5)]
    fracs = [None, 0.1, 0.4, 0.9, 0.9]
    jr = jruntime.AdaptRuntime(_cfgs(tmp_path / "j")[0], jn, js)
    tr = runtime.AdaptRuntime(_cfgs(tmp_path / "t")[1], jn, js)
    for i, (m, cf) in enumerate(zip(samples, fracs)):
        monkeypatch.setattr(jruntime, "live_comm_frac", lambda cf=cf: cf)
        step = 2 * (i + 1)
        jp, tp = jr.on_window(step, m), tr.on_window(step, m, comm_frac=cf)
        assert (tp is None) == (jp is None)
        if tp is not None:
            assert tp.to_json() == jp.to_json()
    jr.close()
    tr.close()
    jl = open(jr.ledger_path).read().splitlines()
    tl = open(tr.ledger_path).read().splitlines()
    assert [_strip(x) for x in tl] == [_strip(x) for x in jl]
    assert [(s, p.to_json()) for s, p in tr.applied] == \
        [(s, p.to_json()) for s, p in jr.applied]
    snap = tr.registry.snapshot()
    assert snap["histograms"]["adapt.decision_latency_s"]["count"] == 5
    assert snap["gauges"]["adapt.plan_version"] == tr.plan.version


def test_runtime_replay_and_fast_forward(tmp_path, units):
    (jn, js), _ = units["LeNet"]
    _, tcfg = _cfgs(tmp_path)
    rec = runtime.AdaptRuntime(tcfg, jn, js)
    moments = np.stack([np.full(len(js), 1e-3), np.full(len(js), 1e-2)],
                       axis=1)
    for step in (2, 4):
        rec.on_window(step, moments, comm_frac=0.9)
    rec.close()
    assert len(rec.applied) >= 2
    _, rcfg = _cfgs(tmp_path, adapt="replay",
                    adapt_ledger=rec.ledger_path)
    rep = runtime.AdaptRuntime(rcfg, jn, js)
    assert [rep.due(s) for s in range(6)] == [True, False, True, False,
                                              True, False]
    for step in (2, 4):
        rep.on_window(step, None)
    assert [(s, p.key()) for s, p in rep.applied] == \
        [(s, p.key()) for s, p in rec.applied]
    # Resume: a fresh variance runtime on the same ledger adopts the plan
    # in force and continues its version numbering.
    again = runtime.AdaptRuntime(tcfg, jn, js)
    adopted = again.fast_forward(3)
    assert adopted is not None and adopted.key() == rec.plan.key()
    assert again.plan.version == rec.plan.version
    again.close()
    for kw, msg in ((dict(adapt="bogus"), "--adapt must be one of"),
                    (dict(compress_grad="none"), "compressed config"),
                    (dict(adapt="replay"), "--adapt-ledger"),
                    (dict(lossy_weights_down=True), "lossy-weights-down"),
                    (dict(gather_type="ring"), "all_gather")):
        jc, tc = _cfgs(tmp_path, **kw)
        with pytest.raises(ValueError) as je:
            jruntime.validate_config(jc)
        with pytest.raises(ValueError, match=msg) as te:
            runtime.validate_config(tc)
        assert str(te.value) == str(je.value)
    jc, tc = _cfgs(tmp_path, ps_down="delta")
    with pytest.raises(ValueError) as je:
        jruntime.validate_config(jc, surface="ps")
    with pytest.raises(ValueError) as te:
        runtime.validate_config(tc, surface="ps")
    assert str(te.value) == str(je.value)
    assert runtime.resolve_ledger_path(tc) == jruntime.resolve_ledger_path(jc)


# -- reconfigure and the planned compressor ----------------------------------------

def test_reconfigure_cache_counts():
    jchain.reconfigure_cache_clear()
    chain.reconfigure_cache_clear()
    calls = [dict(bits=8, fraction=0.01), dict(s=127, fraction=0.01),
             dict(bits=4, fraction=0.05), dict(s=7, fraction=0.05, block=4096),
             dict(bits=4, fraction=0.05), dict()]
    for kw in calls:
        j = jchain.reconfigure(jchain.TopKQSGDCompressor, **kw)
        t = chain.reconfigure(chain.TopKQSGDCompressor, **kw)
        assert (t.compress_ratio, t.quantum_num, t.exact, t.block) == \
            (j.compress_ratio, j.quantum_num, j.exact, j.block)
    base = chain.reconfigure(chain.TopKQSGDCompressor, fraction=0.3)
    jbase = jchain.reconfigure(jchain.TopKQSGDCompressor, fraction=0.3)
    assert chain.reconfigure(base, bits=4).quantum_num == \
        jchain.reconfigure(jbase, bits=4).quantum_num == 7
    assert chain.reconfigure_cache_stats() == jchain.reconfigure_cache_stats()
    with pytest.raises(ValueError, match="bits or s"):
        chain.reconfigure(bits=4, s=7)


@pytest.mark.parametrize("rung", range(5))
@pytest.mark.parametrize("block", [None, 4096])
def test_planned_payloads_match(rung, block):
    m, s, r = controller.DEFAULT_LADDER[rung]
    n = 40_000
    x = np.random.default_rng(rung).standard_normal(n).astype(np.float32)
    jp = jplan.build_planned_compressor(
        jplan.Plan(0, 0, (jplan.UnitDecision(0, "w", m, s, r),)), block=block)
    tp = plan.build_planned_compressor(
        plan.Plan(0, 0, (plan.UnitDecision(0, "w", m, s, r),)), block=block)
    with pytest.raises(TypeError, match="for_leaf"):
        tp.compress(prng.key(0), torch.from_numpy(x))
    with pytest.raises(TypeError, match="unit index"):
        tp.wire_bytes((n,))
    assert tp.wire_bytes((n,), unit=0) == jp.wire_bytes((n,), unit=0)
    jc, tc = jp.for_leaf(0), tp.for_leaf(0)
    assert type(tc).__name__ == type(jc).__name__
    jpl = jc.compress(jax.random.fold_in(jax.random.key(5), 1), jnp.asarray(x))
    tpl = tc.compress(prng.fold_in(prng.key(5), 1), torch.from_numpy(x))
    assert tpl.wire_bytes == jpl.wire_bytes
    if m == "dense":
        assert np.array_equal(tpl.values.numpy(), np.asarray(jpl.values))
        return
    if m == "topk_qsgd":
        assert np.array_equal(tpl.indices.numpy(), np.asarray(jpl.indices))
    np.testing.assert_allclose(tpl.norm.numpy(), np.asarray(jpl.norm),
                               rtol=2e-6, atol=0)
    jl = np.asarray(jpl.levels).astype(np.int64)
    tl = tpl.levels.numpy().astype(np.int64)
    if np.array_equal(np.asarray(jpl.norm), tpl.norm.numpy()):
        assert np.array_equal(tl, jl)
    else:
        assert np.abs(tl - jl).max(initial=0) <= 1
    np.testing.assert_allclose(tc.decompress(tpl).numpy(),
                               np.asarray(jc.decompress(jpl)), rtol=0,
                               atol=float(np.max(np.asarray(jpl.norm)))
                               / max(1, s) * 1.0001)


@pytest.mark.parametrize("mode,agg", [("normal", "decode"),
                                      ("async", "homomorphic")])
def test_wire_plan_with_a_planned_compressor(units, mode, agg):
    (jn, js), _ = units["LeNet"]
    specs = leaf_specs(build_model("LeNet", dataset="mnist"))
    ds = [(controller.DEFAULT_LADDER[u % 5]) for u in range(len(jn))]
    jp = jplan.build_planned_compressor(jplan.Plan(1, 4, tuple(
        jplan.UnitDecision(u, n, *d) for u, (n, d) in enumerate(zip(jn, ds)))))
    tp = plan.build_planned_compressor(plan.Plan(1, 4, tuple(
        plan.UnitDecision(u, n, *d) for u, (n, d) in enumerate(zip(jn, ds)))))
    kw = dict(compress_grad="topk_qsgd", method=5, fusion="none", mode=mode,
              server_agg=agg)
    params = {s.name.split("/")[0]: {} for s in specs}
    for s in specs:
        params[s.name.split("/")[0]][s.name.split("/")[1]] = \
            jax.ShapeDtypeStruct(s.jax_shape, jnp.float32)
    jw = jmetrics.wire_plan(JConfig(**kw), params, world=4, compressor=jp)
    tw = metrics.wire_plan(TrainConfig(**kw),
                           [(s.name, s.jax_shape) for s in specs], world=4,
                           compressor=tp)
    assert tw.per_layer_up == jw.per_layer_up
    assert tw.per_layer_down == jw.per_layer_down
    assert tw.per_step_bytes == jw.per_step_bytes
    assert metrics.leaf_path_name(("conv1", "kernel")) == "conv1/kernel"


# -- the table and its report ------------------------------------------------------

def test_adaptive_report_renders_as_the_jax_reporter(tmp_path):
    """Exact: a baseline_adaptive rows dict (an adaptive row with its
    ``adapt`` block) through both reporters gives the same REPRO.md apart
    from the command line and the hardware line (the AD column and the
    decision provenance block included), and the same REPRO.json apart
    from the hardware signatures."""
    from ewdml_tpu.experiments import registry as jregistry
    from ewdml_tpu.experiments import report as jreport
    from ewdml_tpu_torch.experiments import registry, report
    from test_torch_experiments import _rows

    rows = _rows()
    ad = dict(rows["lenet_mnist/m1"], cell="lenet_mnist/adaptive")
    ad["adapt"] = {"mode": "variance", "ledger": "/x/adapt_ledger.jsonl",
                   "decisions": 2, "switches": 1, "windows": [
                       {"step": 0, "plan_version": 0, "switched": False,
                        "trigger": "init", "bytes_per_sync": 1077732,
                        "comm_frac": None,
                        "methods": {"dense": 0, "qsgd": 0, "topk_qsgd": 8}},
                       {"step": 2, "plan_version": 1, "switched": True,
                        "trigger": "variance", "bytes_per_sync": 132516,
                        "comm_frac": 0.4,
                        "methods": {"dense": 7, "qsgd": 0, "topk_qsgd": 1}}]}
    rows["lenet_mnist/adaptive"] = ad
    outs = {}
    for name, mod, reg in (("port", report, registry),
                           ("jax", jreport, jregistry)):
        md, js = mod.write_report(
            "baseline_adaptive", reg.table_cells("baseline_adaptive"), rows,
            out_dir=str(tmp_path / name), smoke=True, attempts={},
            summary={})
        outs[name] = (open(md).read().splitlines(), json.load(open(js)))
    (ours, our_js), (theirs, their_js) = outs["port"], outs["jax"]
    assert len(ours) == len(theirs)
    differ = [i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b]
    assert [ours[i].split(":")[0] for i in differ] == [
        "One command", "- **this run**"]
    assert "## Adaptive decision provenance" in ours
    assert any(x.startswith("| Metric | row |") and x.endswith("| AD |")
               for x in ours)
    our_js.pop("hardware_signatures")
    their_js.pop("hardware_signatures")
    assert our_js == their_js
