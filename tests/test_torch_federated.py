"""The federated round machinery of the port against the JAX package, on
the CPU: the partition, the cohort sampler, the config matrix, the cohort
policy, the coordinator and its journal, the round plan, the registry's
absorber and the refusals by name (``--adapt`` with federated rounds,
``--metrics-port`` where the JAX package accepts it and serves nothing).

Oracles, per test (each is exact: these are integer, set and string
results, or sums of integer byte counts):
- the shards and ``skew_stat`` of all three schemes, on the committed
  ``mnist10k`` labels and on synthetic ones: bit (the same numpy draws);
- the sampler's draws and resamples: bit;
- ``validate_federated`` / ``validate_round_pipeline``: the same accept or
  reject, with the same message;
- a scripted ``CohortPolicy`` and coordinator call sequence (wire retries
  included): the same verdict strings, callbacks and snapshots;
- the journal of that script: byte-equal files; a coordinator restored
  from it: the same state in both packages;
- every ``FederatedRoundPlan`` field for LeNet and VGG11, homomorphic and
  decode, ``--pull-delta`` on and off: equal;
- ``evaluate_params`` on VGG11 without ``batch_stats``: both raise.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ewdml_tpu.core import config as jconfig
from ewdml_tpu.data import datasets as jdatasets
from ewdml_tpu.data import partition as jpart
from ewdml_tpu.federated import coordinator as jcoord
from ewdml_tpu.federated import ledger as jledger
from ewdml_tpu.federated import sampler as jsampler
from ewdml_tpu.parallel import policy as jpolicy
from ewdml_tpu.train import metrics as jmetrics
from ewdml_tpu_torch.core import config
from ewdml_tpu_torch.data import partition
from ewdml_tpu_torch.federated import coordinator, ledger, sampler
from ewdml_tpu_torch.obs.registry import MetricsRegistry
from ewdml_tpu_torch.parallel import policy
from ewdml_tpu_torch.train import metrics

torch.set_num_threads(2)

FED = dict(network="LeNet", dataset="MNIST", batch_size=8,
           compress_grad="qsgd", quantum_num=127, synthetic_data=True,
           synthetic_size=256, bf16_compute=False, server_agg="homomorphic",
           federated=True, pool_size=12, cohort=4, local_steps=2,
           partition="iid", fed_rounds=2, momentum=0.0, lr=0.05)


def _cfgs(**kw):
    merged = dict(FED, **kw)
    return jconfig.TrainConfig(**merged), config.TrainConfig(**merged)


# -- the partition ------------------------------------------------------------

def _labels(kind: str) -> np.ndarray:
    if kind == "mnist10k":
        ds = jdatasets.load("mnist10k", train=True, seed=0)
        assert ds.source == "real"
        return ds.labels
    # Synthetic: skewed class sizes, one class absent.
    rng = np.random.default_rng(7)
    return rng.choice([0, 1, 2, 3, 5, 6, 7, 8, 9], size=3001,
                      p=[0.3, 0.2, 0.1, 0.1, 0.1, 0.05, 0.05, 0.05, 0.05]
                      ).astype(np.int32)


@pytest.mark.parametrize("kind", ["mnist10k", "synthetic"])
@pytest.mark.parametrize("scheme,pool,seed,alpha", [
    ("iid", 64, 42, 0.5), ("dirichlet", 64, 42, 0.1),
    ("dirichlet", 30, 2, 0.005), ("dirichlet", 12, 5, 2.0),
    ("shard", 64, 42, 0.5), ("shard", 7, 3, 0.5)])
def test_partition_is_the_jax_one(kind, scheme, pool, seed, alpha):
    """Bit: every shard, the histograms and the skew statistic."""
    labels = _labels(kind)
    got = partition.partition_indices(labels, pool, scheme, seed,
                                      alpha=alpha)
    want = jpart.partition_indices(labels, pool, scheme, seed, alpha=alpha)
    assert len(got) == len(want) == pool
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
        assert np.array_equal(partition.label_histogram(labels, g, 10),
                              jpart.label_histogram(labels, w, 10))
    assert np.array_equal(np.sort(np.concatenate(got)),
                          np.arange(len(labels)))
    assert partition.skew_stat(labels, got, 10) == jpart.skew_stat(
        labels, want, 10)


@pytest.mark.parametrize("args", [
    (np.zeros(5, np.int32), 6, "iid", 0), (np.zeros(5, np.int32), 0, "iid", 0),
    (np.arange(10) % 2, 3, "zipf", 0), (np.arange(10) % 2, 6, "shard", 0)])
def test_partition_refusals_are_the_jax_ones(args):
    with pytest.raises(ValueError) as want:
        jpart.partition_indices(*args)
    with pytest.raises(ValueError) as got:
        partition.partition_indices(*args)
    assert str(got.value) == str(want.value)
    assert partition.PARTITION_SCHEMES == jpart.PARTITION_SCHEMES
    assert config.PARTITION_SCHEMES is partition.PARTITION_SCHEMES


# -- the sampler -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 42, 7, 2**33 + 5])
def test_sampler_draws_are_the_jax_ones(seed):
    """Bit: primary draws and resamples over shrinking eligible sets."""
    t, j = sampler.CohortSampler(40, 6, seed), jsampler.CohortSampler(
        40, 6, seed)
    eligible = set(range(40))
    for r in range(12):
        cohort = t.sample(r, eligible)
        assert cohort == j.sample(r, eligible)
        for attempt in (1, 2, 3):
            rest = eligible - set(cohort)
            assert t.resample_one(r, attempt, rest) == j.resample_one(
                r, attempt, rest)
        eligible.discard(cohort[r % len(cohort)])
    assert t.resample_one(0, 1, set()) == j.resample_one(0, 1, set()) == -1
    for bad in (lambda m: m.CohortSampler(4, 5, 0),
                lambda m: m.CohortSampler(4, 3, 0).sample(0, {1, 2})):
        with pytest.raises((ValueError, RuntimeError)) as want:
            bad(jsampler)
        with pytest.raises(type(want.value)) as got:
            bad(sampler)
        assert str(got.value) == str(want.value)


# -- the config matrix ----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, dict(federated=False, pool_size=0), dict(pool_size=0),
    dict(cohort=0), dict(cohort=13), dict(num_aggregate=5),
    dict(num_aggregate=-1), dict(num_aggregate=0), dict(local_steps=0),
    dict(fed_rounds=0), dict(partition="zipf"), dict(partition_alpha=0.0),
    dict(adapt="variance"), dict(ps_down="delta", qsgd_block=4096),
    dict(ps_bootstrap="bf16"), dict(lossy_weights_down=True),
    dict(overlap="bucket"), dict(server_agg="decode", cohort=12),
    dict(quantum_num=127, pool_size=20_000_000, cohort=16_909_321),
    dict(quantum_num=127, pool_size=20_000_000, cohort=16_909_320),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "base")
def test_validate_federated_is_the_jax_one(kw):
    """Exact: the same verdict and message."""
    j, t = _cfgs(**kw)
    try:
        jconfig.validate_federated(j)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            config.validate_federated(t)
        assert str(got.value) == str(e)
    else:
        config.validate_federated(t)
    assert config.federated_max_cohort(t) == jconfig.federated_max_cohort(j)


@pytest.mark.parametrize("mode", ["off", "overlap", "async", "later"])
def test_validate_round_pipeline(mode):
    """``off``, ``overlap`` and ``async`` pass in both on the federated
    homomorphic config; an unknown value is the same ValueError (the
    whole matrix is in ``tests/test_torch_round_pipeline.py``)."""
    j, t = _cfgs(round_pipeline=mode)
    if mode == "later":
        with pytest.raises(ValueError) as want:
            jconfig.validate_round_pipeline(j)
        with pytest.raises(ValueError) as got:
            config.validate_round_pipeline(t)
        assert str(got.value) == str(want.value)
    else:
        jconfig.validate_round_pipeline(j)
        config.validate_round_pipeline(t)


# -- the cohort policy ------------------------------------------------------------

def _policy_script(mod) -> list:
    """One call sequence through a cohort policy; every verdict, callback
    and counter in order."""
    out = []
    pol = mod.CohortPolicy(num_aggregate=2,
                           on_round=lambda *a: out.append(("cb", a)))
    out.append(pol.admit_push(0))                 # no round yet
    pol.begin_round(0, [1, 2, 3])
    out.append(pol.admit_push(9))                 # not in the cohort
    out.append(pol.admit_push(1))
    out.append(pol.admit_push(1))                 # duplicate
    pol.retract_push(1)
    out.append(pol.admit_push(1))                 # the retracted slot
    pol.extend_cohort(9)
    out.append(pol.admit_subtree([1, 9]))         # 1 already counted
    out.append(pol.admit_subtree([7]))            # outsider
    out.append(pol.admit_subtree([2, 3]))         # past the quota
    out.append(pol.admit_push(2))
    out.append(pol.admit_push(3))                 # quota filled
    try:
        pol.begin_round(1, [4])
    except RuntimeError as e:
        out.append(("begin while open", str(e)))
    pol.note_applied(1, [2, 1], round_id=None)
    pol.note_applied(2, [5])                      # closed: no callback
    out.append(pol.admit_push(3))                 # after the commit
    out.append(pol.admit_push(2))                 # contributed, closed
    out.append(pol.admit_subtree([3, 2]))
    out.append(pol.admit_subtree([2]))
    pol.retract_subtree([2])
    pol.begin_round(1, [4, 5])
    out.append(pol.admit_subtree([4, 5]))
    pol.retract_subtree([4])
    out.append(pol.admit_subtree([4]))
    pol.exclude(4, "dropout")
    out.append((pol.is_excluded(4), pol.quota_dropped, pol.stale(1),
                pol.stale(0), pol.kill_threshold, pol.observe(4)))
    return out


def test_cohort_policy_verdicts_are_the_jax_ones():
    """Exact: verdict strings, the commit callback and the counters."""
    assert _policy_script(policy) == _policy_script(jpolicy)


# -- the coordinator and its journal ------------------------------------------------

def _coordinator_script(mod, cfg, path) -> list:
    """Register, begin (with a retry), drop (with a retry), an
    out-of-order begin, a filled round committed through the policy, the
    next round and a drop outside the current round."""
    kw = {"registry": MetricsRegistry()} if mod is coordinator else {}
    fed = mod.FederatedCoordinator(cfg, path, **kw)
    out = [fed.register(c) for c in range(cfg.pool_size)]
    out.append(fed.register(3))
    for bad in (-1, cfg.pool_size):
        try:
            fed.register(bad)
        except ValueError as e:
            out.append(str(e))
    cohort = fed.begin_round(0, version=0)
    out += [cohort, fed.begin_round(0, version=0)]
    rep = fed.report_drop(cohort[0], 0)
    out += [rep, fed.report_drop(cohort[0], 0), fed.dropouts, fed.resampled]
    try:
        fed.begin_round(2)
    except RuntimeError as e:
        out.append(str(e))
    out.append(fed.wait_round(0, timeout=0.01))
    live = [c for c in cohort[1:] + [rep] if c >= 0]
    for c in live:
        out.append(fed.policy.admit_push(c))
    fed.policy.note_applied(1, live)
    out += [fed.wait_round(0, timeout=1.0), fed.rounds_done()]
    out.append(fed.begin_round(1, version=1))
    out.append(fed.report_drop(out[-1][1], 0))    # not the current round
    out += [fed.snapshot(), fed.state()]
    fed.close()
    return out


def test_coordinator_script_and_journal_are_the_jax_ones(tmp_path):
    """Exact: every return and snapshot; the journals byte-equal; then
    both packages restore the same state from that journal."""
    jcfg, tcfg = _cfgs(num_aggregate=3, train_dir=str(tmp_path))
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    assert _coordinator_script(coordinator, tcfg, tpath) == \
        _coordinator_script(jcoord, jcfg, jpath)
    with open(jpath, "rb") as f:
        jbytes = f.read()
    with open(tpath, "rb") as f:
        assert f.read() == jbytes
    events = [json.loads(line)["event"] for line in jbytes.splitlines()]
    assert events.count("register") == 12 and "dropout" in events
    assert ledger.round_sequence(ledger.read_ledger(tpath)) == \
        jledger.round_sequence(jledger.read_ledger(jpath))
    # Recovery: both restore from the journal, then the retried begin of
    # the completed round 0 replays its cohort, and round 1 begins again.
    jfed = jcoord.FederatedCoordinator(jcfg, jpath, resume=True)
    tfed = coordinator.FederatedCoordinator(tcfg, tpath, resume=True,
                                            registry=MetricsRegistry())
    assert tfed.state() == jfed.state()
    assert tfed.snapshot() == jfed.snapshot()
    assert tfed.policy.excluded() == jfed.policy.excluded()
    assert tfed.begin_round(0) == jfed.begin_round(0)
    assert tfed.report_drop(next(iter(tfed.policy.excluded())), 0) == \
        jfed.report_drop(next(iter(jfed.policy.excluded())), 0)
    assert tfed.begin_round(1, version=1) == jfed.begin_round(1, version=1)
    jfed.close()
    tfed.close()
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()


def test_coordinator_metrics_go_to_the_callers_registry(tmp_path):
    """Exact: the gauges and counters land in the registry passed in, and
    ``absorb_federated`` sets the snapshot's keys as the JAX absorber
    does (``max_cohort`` skipped when unbounded)."""
    _, tcfg = _cfgs(train_dir=str(tmp_path))
    reg = MetricsRegistry()
    fed = coordinator.FederatedCoordinator(tcfg, None, registry=reg)
    for c in range(12):
        fed.register(c)
    cohort = fed.begin_round(0)
    fed.report_drop(cohort[0], 0)
    snap = reg.snapshot()
    assert snap["gauges"]["federated.round"] == 0
    assert snap["gauges"]["federated.pool"] == 11
    assert snap["gauges"]["federated.cohort"] == 4
    assert snap["gauges"]["federated.max_cohort"] == \
        config.federated_max_cohort(tcfg)
    assert snap["counters"] == {"federated.dropouts": 1,
                                "federated.resampled": 1}
    other = MetricsRegistry()
    other.absorb_federated(dict(fed.snapshot(), max_cohort=None))
    g = other.snapshot()["gauges"]
    assert g["federated.rounds_done"] == 0 and g["federated.pool"] == 11
    assert "federated.max_cohort" not in g
    assert set(g) == {f"federated.{k}" for k in (
        "pool", "round", "rounds_done", "cohort", "accept", "dropouts",
        "resampled", "quota_dropped")}
    for mode, cls in (("overlap", policy.PipelinedCohortPolicy),
                      ("async", policy.AsyncCohortPolicy)):
        fed = coordinator.FederatedCoordinator(
            config.TrainConfig(**dict(FED, round_pipeline=mode)), None)
        assert type(fed.policy) is cls and fed.snapshot()[
            "round_pipeline"] == mode


# -- the round plan -----------------------------------------------------------------

def _shapes(network: str, dataset: str):
    from ewdml_tpu.models import build_model as jbuild
    from ewdml_tpu.models import init_variables, input_shape_for
    from ewdml_tpu_torch.models import build_model
    from ewdml_tpu_torch.models.convert import leaf_specs, to_jax
    from ewdml_tpu_torch.train.state import leaf_params

    h, w, c = input_shape_for(dataset)
    jtree = jax.eval_shape(lambda: init_variables(
        jbuild(network, 10), jax.random.key(0),
        jnp.zeros((2, h, w, c), jnp.float32)))["params"]
    model = build_model(network, 10, dataset=dataset)
    specs = leaf_specs(model)
    return jtree, [to_jax(p, s.kind) for p, s in
                   zip(leaf_params(model, specs), specs)]


@pytest.mark.parametrize("network,dataset", [("LeNet", "MNIST"),
                                             ("VGG11", "mnist10k32")])
@pytest.mark.parametrize("kw", [
    {}, dict(server_agg="decode", num_aggregate=3),
    dict(pull_delta=True, keyframe_every=64),
    dict(pull_delta=True, keyframe_every=4, server_agg="decode"),
    dict(compress_grad="topk_qsgd", topk_ratio=0.01),
    dict(compress_grad="none", server_agg="decode"),
    dict(round_pipeline="overlap"), dict(qsgd_block=4096, local_steps=5),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "base")
def test_federated_wire_plan_is_the_jax_one(network, dataset, kw):
    """Exact: every field and property of the round plan."""
    jtree, leaves = _shapes(network, dataset)
    j, t = _cfgs(network=network, dataset=dataset, **kw)
    jp = jmetrics.federated_wire_plan(j, jtree)
    tp = metrics.federated_wire_plan(t, leaves)
    assert tp == metrics.federated_wire_plan(t, [x.shape for x in leaves])
    for f in ("cohort", "accept", "local_steps", "delta_bytes", "down_bytes",
              "server_decodes", "dense_delta_bytes", "pull_delta_down_bytes",
              "round_pipeline", "pipeline_depth",
              "pull_delta_down_bytes_round", "down_compression",
              "up_bytes_round", "down_bytes_round", "total_bytes_round",
              "up_bytes_per_local_step", "in_flight_up_bytes",
              "in_flight_down_bytes"):
        assert getattr(tp, f) == getattr(jp, f), f


# -- evaluation and the refusals ---------------------------------------------------

def test_evaluate_params_without_batch_stats_raises_in_both():
    """Reference behaviour (ROADMAP Queue 3 item 21): on VGG11-BN without
    ``batch_stats`` the JAX function raises Flax's
    ``ScopeCollectionNotFound`` and the port a ``ValueError`` naming the
    missing statistics."""
    from flax.errors import ScopeCollectionNotFound

    from ewdml_tpu.federated.loop import evaluate_params as jeval
    from ewdml_tpu.models import build_model as jbuild
    from ewdml_tpu.models import init_variables
    from ewdml_tpu_torch.federated.loop import evaluate_params

    j, t = _cfgs(network="VGG11", dataset="mnist10k32", platform="cpu",
                 test_batch_size=8)
    jparams = init_variables(jbuild("VGG11", 10), jax.random.key(0),
                             jnp.zeros((2, 32, 32, 1), jnp.float32))["params"]
    with pytest.raises(ScopeCollectionNotFound, match="batch_stats"):
        jeval(j, jparams)
    _, leaves = _shapes("VGG11", "mnist10k32")
    with pytest.raises(ValueError, match="BatchNorm statistics.*bn0/mean"):
        evaluate_params(t, leaves)


def test_later_slices_are_refused_by_name(tmp_path):
    """``--metrics-port`` is refused by name, with the reason, on the
    federated CLI and on ``--role fed_driver``, where the JAX package
    accepts the flag and arms no exporter (the federated server serves
    it: ``tests/test_torch_ps_net.py``); ``--adapt``, ported, is refused
    with federated rounds as the JAX package refuses it
    (``validate_federated``)."""
    from ewdml_tpu_torch.cli import main
    from ewdml_tpu_torch.parallel import ps_net

    with pytest.raises(NotImplementedError,
                       match="--metrics-port on the federated CLI .*arms no "
                             "exporter"):
        main(["--federated", "--platform", "cpu", "--round-pipeline",
              "overlap", "--server-agg", "homomorphic", "--compress-grad",
              "qsgd", "--pool-size", "8", "--cohort", "2",
              "--metrics-port", "0", "--train-dir", str(tmp_path) + "/"])
    base = ["--platform", "cpu", "--network", "LeNet", "--dataset",
            "mnist10k", "--synthetic-data", "--federated", "--server-agg",
            "homomorphic", "--compress-grad", "qsgd"]
    for extra, name, exc in (
            (["--role", "server", "--pool-size", "8", "--cohort", "2",
              "--adapt", "variance"],
             "--federated is incompatible with --adapt", ValueError),
            (["--role", "fed_driver", "--metrics-port", "0"],
             "--metrics-port on --role fed_driver .*arms no exporter",
             NotImplementedError)):
        with pytest.raises(exc, match=name):
            ps_net.main(base + extra)
