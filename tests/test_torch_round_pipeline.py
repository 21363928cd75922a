"""The round pipeline of the port (``--round-pipeline overlap|async``)
against the JAX package, on the CPU: the two pipelined cohort policies,
the config matrix, the pipelined coordinator and its journal, and the
in-process runs.

Oracles, per test:
- ``PipelinedCohortPolicy`` and ``AsyncCohortPolicy`` on scripted begin,
  admit, retract, extend, commit sequences: bit (the same verdict
  strings, ``round_stale`` answers, callbacks and counters); ``push_weight``
  for staleness 0-5 at decay 0, 0.5 and 1: bit (the same integers);
- ``validate_round_pipeline``: the same accept or reject, with the same
  message;
- the pipelined coordinator's journal of a scripted sequence with a drop
  in each open round: bit (byte-equal files), and equal snapshots;
- ``run_federated`` under ``async`` on the reference's ``fed_cfg`` with a
  deferred straggler, against ``ewdml_tpu.federated.run_federated``: bit
  for the ledger, exact for the counters, bounded flips for the final
  parameters (per leaf, ||d|| <= 1e-3 ||m|| with m the reference's move,
  as in ``tests/test_torch_federated_run.py``);
- ``run_federated`` under ``overlap``: structure, as the reference's own
  test checks it (round 1 begins before round 0 commits, three commits,
  one decode a commit, at least one round-stale drop): the commit order
  of two open rounds depends on thread arrival;
- the CLI's ``--round-pipeline async``: structure of its summary line and
  journal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ewdml_tpu_torch.models as tmodels
from ewdml_tpu.core import config as jconfig
from ewdml_tpu.federated import CohortSampler as JSampler
from ewdml_tpu.federated import coordinator as jcoord
from ewdml_tpu.federated import run_federated as jrun_federated
from ewdml_tpu.models import build_model as jbuild
from ewdml_tpu.models import init_variables
from ewdml_tpu.parallel import policy as jpolicy
from ewdml_tpu_torch.core import config
from ewdml_tpu_torch.federated import coordinator, read_ledger, run_federated
from ewdml_tpu_torch.models.convert import flax_to_torch, leaf_specs
from ewdml_tpu_torch.obs.registry import MetricsRegistry
from ewdml_tpu_torch.parallel import policy

torch.set_num_threads(2)

SEED = 42
FED = dict(network="LeNet", dataset="MNIST", batch_size=8,
           compress_grad="qsgd", quantum_num=127, synthetic_data=True,
           synthetic_size=256, bf16_compute=False, server_agg="homomorphic",
           federated=True, pool_size=12, cohort=4, local_steps=2,
           partition="iid", fed_rounds=2, momentum=0.0, lr=0.05, seed=SEED)


def _cfgs(**kw):
    merged = dict(FED, **kw)
    return jconfig.TrainConfig(**merged), config.TrainConfig(**merged)


def _verdicts(fn):
    """``fn()``'s result, or its error's type and message."""
    try:
        return fn()
    except (RuntimeError, ValueError) as e:
        return (type(e).__name__, str(e))


# -- the policies ------------------------------------------------------------

def _pipelined_script(mod) -> list:
    out = []
    pol = mod.PipelinedCohortPolicy(
        num_aggregate=2, on_round=lambda r, acc, v: out.append(("cb", r,
                                                                acc, v)))
    pol.begin_round(0, [1, 2, 3])
    pol.begin_round(1, [4, 5, 6])
    out.append(_verdicts(lambda: pol.begin_round(2, [7])))
    pol.begin_round(0, [9])                       # a retried begin
    for w, r in ((1, 0), (4, 1), (1, 1), (2, 0), (3, 0), (5, 1), (7, 3),
                 (1, 0)):
        out.append(pol.admit_push(w, round_id=r))
    pol.extend_cohort(8, round_idx=1)
    pol.retract_push(5, round_id=1)
    out.append(pol.admit_push(8, round_id=1))
    out.append(pol.admit_push(6, round_id=1))
    out.append(pol.admit_subtree([1, 2]))
    pol.note_applied(1, [2, 1], round_id=0)
    pol.note_applied(1, [2, 1], round_id=None)    # unrouted: no-op
    out += [pol.round_stale(r) for r in range(3)]
    out.append(pol.admit_push(3, round_id=0))
    pol.begin_round(2, [3])
    pol.extend_cohort(0)                          # the newest round
    out.append(pol.admit_push(0, round_id=2))
    pol.note_applied(2, [4, 8], round_id=1)
    out += [pol.quota_dropped, pol.max_staleness, pol.depth,
            pol.snapshot().members]
    return out


def _async_script(mod) -> list:
    out = []
    pol = mod.AsyncCohortPolicy(
        accept=2, decay=0.5, bound=1,
        on_commit=lambda c, acc, v: out.append(("cb", c, acc, v)))
    pol.begin_round(0, [1, 2])
    out.append(pol.admit_push(1, round_id=0))
    out.append(pol.push_weight(0))
    pol.begin_round(1, [3, 4])
    pol.begin_round(1, [9])                       # a retried begin
    out += [pol.round_stale(0), pol.push_weight(0), pol.push_weight(1)]
    pol.begin_round(2, [5])                       # round 0 leaves
    out += [pol.round_stale(r) for r in (-1, 0, 1, 2, 3)]
    for w, r in ((2, 0), (3, 1), (3, 1), (9, 2), (5, 2), (5, 7)):
        out.append(pol.admit_push(w, round_id=r))
    pol.extend_cohort(6)
    pol.extend_cohort(7, round_idx=1)
    pol.retract_push(3, round_id=1)
    out += [pol.admit_push(6, round_id=2), pol.admit_push(7, round_id=1),
            pol.admit_push(3, round_id=1), pol.admit_subtree([3])]
    pol.note_applied(5, [1, 3, 1], round_id=-1)
    pol.note_applied(6, [2], round_id=None)
    out += [pol.num_aggregate, pol.weight_scale, pol.accept, pol.bound,
            pol.max_staleness, pol.quota_dropped, pol.ready_to_apply(7),
            pol.ready_to_apply(8)]
    return out


@pytest.mark.parametrize("script", [_pipelined_script, _async_script],
                         ids=["overlap", "async"])
def test_policy_script_matches_jax(script):
    """Bit: every verdict, answer, callback and counter."""
    assert script(policy) == script(jpolicy)


@pytest.mark.parametrize("decay", [0.0, 0.5, 1.0])
def test_push_weight_curve_matches_jax(decay):
    """Bit: the tick weight at staleness 0-5 (Python's half-to-even
    ``round``; decay 0.5 at staleness 3 is 4 * 0.5 = 2.0, at 5 is 1.63)."""
    got = []
    for mod in (policy, jpolicy):
        pol = mod.AsyncCohortPolicy(accept=3, decay=decay, bound=8)
        for r in range(6):
            pol.begin_round(r, [r])
        got.append([pol.push_weight(5 - s) for s in range(6)])
    assert got[0] == got[1]
    assert got[0][0] == 4 and min(got[0]) >= 1
    assert policy.StragglerPolicy().push_weight(3) == 1
    assert policy.StragglerPolicy().round_stale(3) is False


# -- the config matrix ---------------------------------------------------------

@pytest.mark.parametrize("mode,kw", [
    ("overlap", {}),
    ("async", {}),
    ("overlap", dict(federated=False)),
    ("async", dict(server_agg="decode")),
    ("overlap", dict(agg_tree="127.0.0.1:1,127.0.0.1:2")),
    ("async", dict(replicas="127.0.0.1:1")),
    ("overlap", dict(server_state_dir="/nonexistent/state")),
    ("async", dict(fed_staleness_decay=-0.5)),
    ("async", dict(fed_staleness_bound=0)),
    ("async", dict(quantum_num=2**27)),
    ("async", dict(quantum_num=2**26, num_aggregate=2)),
    ("off", dict(server_agg="decode", federated=False)),
], ids=lambda v: str(v))
def test_validate_round_pipeline_matrix(mode, kw):
    """The same accept or reject as the JAX package, the same message."""
    j, t = _cfgs(round_pipeline=mode, **kw)
    try:
        jconfig.validate_round_pipeline(j)
    except ValueError as want:
        with pytest.raises(ValueError) as got:
            config.validate_round_pipeline(t)
        assert str(got.value) == str(want)
        return
    config.validate_round_pipeline(t)


# -- the pipelined coordinator ------------------------------------------------

def _coord_script(fed) -> list:
    out = []
    for c in range(12):
        out.append(fed.register(c))
    c0 = fed.begin_round(0, version=0)
    out += [c0, fed.begin_round(0, version=0)]   # a retried begin
    c1 = fed.begin_round(1, version=0)
    out.append(c1)
    if fed.mode == "overlap":
        out.append(_verdicts(lambda: fed.begin_round(2, version=0)))
    # A drop in each open round, each resampled into its own round, and a
    # retried drop that replays its replacement.
    out.append(fed.report_drop(c0[0], 0))
    out.append(fed.report_drop(c1[1], 1))
    out.append(fed.report_drop(c0[0], 0))
    out.append(_verdicts(lambda: fed.begin_round(5, version=0)))
    pol = fed.policy
    fed._on_round_applied(1 if fed.mode == "overlap" else 0, c1[2:], 1)
    if fed.mode == "overlap":
        pol.note_applied(2, c0[1:3], round_id=0)
    else:
        pol.note_applied(2, c0[1:3], round_id=-1)
    out.append(fed.begin_round(2, version=2))
    out += [fed.wait_round(0, timeout=0), fed.wait_round(1, timeout=0),
            fed.rounds_done(), fed.snapshot(), fed.state(),
            sorted(pol.excluded())]
    fed.close()
    return out


@pytest.mark.parametrize("mode", ["overlap", "async"])
def test_pipelined_coordinator_journal_is_the_jax_one(mode, tmp_path):
    """Bit: the replies, the snapshots and the journal file."""
    jcfg, tcfg = _cfgs(round_pipeline=mode, num_aggregate=3)
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    want = _coord_script(jcoord.FederatedCoordinator(jcfg, jpath))
    reg = MetricsRegistry()
    got = _coord_script(coordinator.FederatedCoordinator(tcfg, tpath,
                                                         registry=reg))
    assert got == want
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    events = [r["event"] for r in read_ledger(tpath)]
    assert "round_pipeline_begin" in events and "round_commit" in events
    assert "round_begin" not in events and "round_done" not in events
    assert reg.snapshot()["counters"]["federated.dropouts"] == 2


# -- the in-process runs ------------------------------------------------------

def _jax_init():
    return jax.tree.map(np.asarray, init_variables(
        jbuild("LeNet", 10), jax.random.key(SEED),
        jnp.zeros((2, 28, 28, 1), jnp.float32))["params"])


def _from_jax_init(mp, init) -> None:
    """Every port model of the run starts from the JAX initial state."""
    build = tmodels.build_model

    def built(*a, **kw):
        model = build(*a, **kw)
        model.load_state_dict(flax_to_torch(model, init))
        return model

    mp.setattr(tmodels, "build_model", built)


def _straggler() -> int:
    return JSampler(8, 4, SEED).sample(0, range(8))[0]


@pytest.fixture(scope="module")
def async_runs(tmp_path_factory):
    """The reference's async run (``tests/test_federated.py``'s
    ``test_async_pipeline_run``) in both packages."""
    kw = dict(FED, pool_size=8, cohort=4, fed_rounds=3,
              round_pipeline="async", fault_spec=f"delay@{_straggler()}=0.3")
    root = tmp_path_factory.mktemp("fed_async")
    jres = jrun_federated(jconfig.TrainConfig(
        **dict(kw, train_dir=str(root / "jax"))))
    init = _jax_init()
    reg = MetricsRegistry()
    with pytest.MonkeyPatch.context() as mp:
        _from_jax_init(mp, init)
        tres = run_federated(config.TrainConfig(
            **dict(kw, train_dir=str(root / "port"), platform="cpu")),
            registry=reg)
    return jres, tres, init, reg


def test_async_ledger_is_byte_equal(async_runs):
    """Bit: the two journals (commit indices, accepted sets, versions)."""
    jres, tres, _, _ = async_runs
    with open(jres.ledger_path, "rb") as f:
        want = f.read()
    with open(tres.ledger_path, "rb") as f:
        assert f.read() == want
    commits = [r for r in read_ledger(tres.ledger_path)
               if r["event"] == "round_commit"]
    assert [r["round"] for r in commits] == list(range(len(commits)))


def test_async_counters_are_the_jax_ones(async_runs):
    """Exact: the tick and staleness counters, the applies and decodes."""
    jres, tres, _, reg = async_runs
    for f in ("async_ticks", "async_downweighted", "dropped_round_stale",
              "apply_rounds", "decode_count", "pushes", "updates",
              "bytes_up", "bytes_down", "fed_rejected"):
        assert getattr(tres.stats, f) == getattr(jres.stats, f), f
    for f in ("rounds", "round_records", "dropouts", "resampled",
              "rejected"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert tres.coordinator == jres.coordinator
    assert tres.stats.async_downweighted >= 1
    assert tres.stats.dropped_round_stale == 0
    assert tres.stats.decode_count == tres.stats.apply_rounds >= 1
    snap = reg.snapshot()
    assert snap["histograms"]["federated.round_s"]["count"] == 3
    # Under async the coordinator counts commits as rounds done.
    assert snap["gauges"]["federated.rounds_done"] == \
        tres.stats.apply_rounds


def test_async_params_within_bounded_flips(async_runs):
    """Bounded flips (module docstring)."""
    jres, tres, init, _ = async_runs
    np.testing.assert_allclose(tres.round_losses, jres.round_losses,
                               rtol=1e-5)
    model = tmodels.build_model("LeNet", 10)
    for spec, tp in zip(leaf_specs(model), tres.params):
        layer, leaf = spec.name.split("/")
        j = np.asarray(jres.params[layer][leaf], np.float64)
        m = j - np.asarray(init[layer][leaf], np.float64)
        d = tp.numpy().astype(np.float64) - j
        assert np.abs(m).max() > 0, spec.name
        assert np.linalg.norm(d) <= 1e-3 * np.linalg.norm(m), spec.name


def test_overlap_run_structure(tmp_path):
    """Structure (``tests/test_federated.py:602-631``): round 1 begins
    before round 0 commits, three commits, one decode a commit, and the
    straggler's push after its round's commit is round-stale."""
    cfg = config.TrainConfig(**dict(
        FED, pool_size=8, cohort=4, num_aggregate=3, fed_rounds=3,
        round_pipeline="overlap", fault_spec=f"delay@{_straggler()}=0.3",
        train_dir=str(tmp_path), platform="cpu"))
    res = run_federated(cfg)
    assert res.rounds == 3
    assert res.stats.decode_count == res.stats.apply_rounds == 3
    assert res.stats.dropped_round_stale >= 1 and res.rejected >= 1
    ev = [(r["event"], r["round"]) for r in read_ledger(res.ledger_path)
          if r["event"] in ("round_pipeline_begin", "round_commit")]
    first_commit0 = ev.index(("round_commit", 0))
    assert ("round_pipeline_begin", 1) in ev[:first_commit0], ev
    assert sum(e == "round_commit" for e, _ in ev) == 3, ev
    assert all(np.isfinite(p.numpy()).all() for p in res.params)


def test_cli_runs_async_rounds(tmp_path, capsys):
    """Structure: ``cli --federated --round-pipeline async`` runs, prints
    its summary with one decode a commit, and journals the async
    grammar."""
    from ewdml_tpu_torch.cli import main

    rc = main(["--federated", "--platform", "cpu", "--network", "LeNet",
               "--dataset", "mnist10k", "--synthetic-data",
               "--synthetic-size", "128", "--round-pipeline", "async",
               "--server-agg", "homomorphic", "--compress-grad", "qsgd",
               "--pool-size", "6", "--cohort", "2", "--local-steps", "1",
               "--fed-rounds", "2", "--batch-size", "8", "--no-bf16",
               "--train-dir", str(tmp_path) + "/"])
    out = capsys.readouterr().out
    assert rc == 0 and "federated done: rounds=2" in out and "eval:" in out
    events = [r["event"] for r in read_ledger(
        str(tmp_path / "fed_rounds.jsonl"))]
    assert events.count("round_pipeline_begin") == 2
    commits = events.count("round_commit")
    assert f"decodes={commits}/{commits} rounds" in out
