"""The federated slice as a whole: the port's ``run_federated`` and its
``--federated`` CLI against ``ewdml_tpu.federated.run_federated``, on the
CPU.

Configuration: the JAX package's own ``fed_cfg`` (LeNet, synthetic MNIST
of 256, pool 12, cohort 4, local steps 2, 2 rounds, ``--server-agg
homomorphic`` QSGD, lr 0.05, momentum 0) and its churn variant (the first
sampled client crashes in round 0, accept 3 of 4). The two packages'
initial weights differ (the port's initialisers draw from a torch
generator), so the port runs from the JAX initial parameters.

Oracles, per test:
- the round ledger: bit (byte-equal ``fed_rounds.jsonl``); the counters,
  byte totals, dropouts, resamples, rejections, skew and data source:
  exact;
- the round losses and the final parameters: bounded flips. Both packages
  draw the homomorphic encode from the same threefry stream, so a level
  can differ only where XLA:CPU's contraction of ``p - lr * g`` into an
  FMA moves an input by an ulp: per leaf, with d the difference of the
  final parameters and m the reference's own move, ||d|| <= 1e-3 ||m||
  and max|d| <= 1e-2 max|m|; losses within 1e-5 relative;
- one client round fed the JAX server's pulled buffer: its int8 levels
  differ by at most 1 on at most 0.1% of elements;
- the local-steps scale template: within 1e-5 of the leaf's largest
  scale of the JAX one (the template gradients agree to f32 rounding, up
  to 1.4e-6 of it here), and bit-equal across two port derivations and to
  the one-step template times ``local_steps`` in f32;
- the CPU CLI's ``federated done`` line: the JAX run's fields;
- a thread-batched run: structural (each round's accepted set is a
  subset of its cohort, of the accept size; one decode a round).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ewdml_tpu_torch.models as tmodels
from ewdml_tpu.core.config import TrainConfig as JConfig
from ewdml_tpu.federated import CohortSampler as JSampler
from ewdml_tpu.federated import run_federated as jrun_federated
from ewdml_tpu.models import build_model as jbuild
from ewdml_tpu.models import init_variables
from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.federated import read_ledger, run_federated
from ewdml_tpu_torch.models.convert import flax_to_torch, leaf_specs
from ewdml_tpu_torch.obs.registry import MetricsRegistry

torch.set_num_threads(2)

SEED = 42
FED = dict(network="LeNet", dataset="MNIST", batch_size=8,
           compress_grad="qsgd", quantum_num=127, synthetic_data=True,
           synthetic_size=256, bf16_compute=False, server_agg="homomorphic",
           federated=True, pool_size=12, cohort=4, local_steps=2,
           partition="iid", fed_rounds=2, momentum=0.0, lr=0.05, seed=SEED)


def _variant(name: str) -> dict:
    if name == "plain":
        return {}
    victim = JSampler(12, 4, SEED).sample(0, range(12))[0]
    return dict(num_aggregate=3, fault_spec=f"crash@{victim}=0")


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


@pytest.fixture(scope="module", params=["plain", "churn"])
def runs(request, tmp_path_factory):
    """One JAX run and one port run of a variant, shared by its tests."""
    kw = dict(FED, **_variant(request.param))
    root = tmp_path_factory.mktemp(f"fed_{request.param}")
    jcfg = JConfig(**dict(kw, train_dir=str(root / "jax")))
    tcfg = TrainConfig(**dict(kw, train_dir=str(root / "port"),
                              platform="cpu"))
    jres = jrun_federated(jcfg)
    init = _jax_init()
    reg = MetricsRegistry()
    with pytest.MonkeyPatch.context() as mp:
        _from_jax_init(mp, init)
        tres = run_federated(tcfg, registry=reg)
    return request.param, jcfg, tcfg, jres, tres, init, reg


def test_round_ledger_is_byte_equal(runs):
    """Bit: the two journals."""
    _, jcfg, tcfg, jres, tres, _, _ = runs
    with open(jres.ledger_path, "rb") as f:
        want = f.read()
    with open(tres.ledger_path, "rb") as f:
        assert f.read() == want
    assert tres.ledger_path.endswith("port/fed_rounds.jsonl")


def test_counters_are_the_jax_ones(runs):
    """Exact: the server's counters and bytes, the driver's dropouts,
    resamples and rejections, the round records, skew and data source."""
    name, _, tcfg, jres, tres, _, reg = runs
    for f in ("apply_rounds", "decode_count", "fed_rejected", "bytes_up",
              "bytes_down", "pushes", "updates", "dropped_stale"):
        assert getattr(tres.stats, f) == getattr(jres.stats, f), f
    for f in ("rounds", "round_records", "dropouts", "resampled", "rejected",
              "skew", "data_source"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert tres.stats.decode_count == tres.stats.apply_rounds == 2
    assert tres.coordinator == jres.coordinator
    churn = name == "churn"
    assert (tres.dropouts, tres.resampled, tres.rejected) == (
        (1, 1, 2) if churn else (0, 0, 0))
    snap = reg.snapshot()
    assert snap["gauges"]["federated.rounds_done"] == 2
    assert snap["gauges"]["ps.bytes_up"] == tres.stats.bytes_up
    assert snap["histograms"]["federated.round_s"]["count"] == 2
    # Every client round is timed; the quota's refusals never pend.
    assert snap["histograms"]["federated.client_s"]["count"] == \
        tres.stats.pushes + tres.stats.fed_rejected
    # bytes_up is the admitted pushes' frames, each the leaves' int8
    # levels in one native frame.
    frame = tres.stats.bytes_up // tres.stats.pushes
    assert tres.stats.bytes_up == frame * tres.stats.pushes
    records = read_ledger(tres.ledger_path)
    drops = [r for r in records if r["event"] == "dropout"]
    assert len(drops) == tres.dropouts


def test_losses_and_params_within_bounded_flips(runs):
    """Bounded flips (module docstring)."""
    _, _, _, jres, tres, init, _ = runs
    np.testing.assert_allclose(tres.round_losses, jres.round_losses,
                               rtol=1e-5)
    model = tmodels.build_model("LeNet", 10)
    moved = 0
    for spec, tp in zip(leaf_specs(model), tres.params):
        layer, leaf = spec.name.split("/")
        j = np.asarray(jres.params[layer][leaf], np.float64)
        t = tp.numpy().astype(np.float64)
        m = j - np.asarray(init[layer][leaf], np.float64)
        d = t - j
        assert np.linalg.norm(d) <= 1e-3 * np.linalg.norm(m), spec.name
        assert np.abs(d).max() <= 1e-2 * np.abs(m).max(), spec.name
        moved += np.abs(m).max() > 0
    assert moved == len(tres.params)


def test_one_client_round_on_the_jax_pulled_buffer(monkeypatch):
    """Bounded flips on the int8 levels of one client round (homomorphic,
    local steps 2), both packages fed the JAX server's packed weights."""
    from ewdml_tpu.data import datasets as jdatasets
    from ewdml_tpu.federated.client import ClientPool as JPool
    from ewdml_tpu.parallel import ps_net as jps_net
    from ewdml_tpu.utils import transfer as jtransfer
    from ewdml_tpu_torch.data import datasets
    from ewdml_tpu_torch.federated.client import ClientPool
    from ewdml_tpu_torch.parallel import ps_net

    jcfg = JConfig(**FED)
    tcfg = TrainConfig(**dict(FED, platform="cpu"))
    _, _, variables, grad_fn, compress_tree, _, _ = \
        jps_net.build_endpoint_setup(jcfg)
    ds_kw = dict(train=True, synthetic=True, seed=SEED, synthetic_size=256)
    jpool = JPool(jcfg, jdatasets.load("MNIST", **ds_kw), variables,
                  grad_fn, compress_tree)
    _from_jax_init(monkeypatch, _jax_init())
    tpool = ClientPool(tcfg, datasets.load("MNIST", **ds_kw),
                       ps_net.build_endpoint_setup(tcfg))
    buf = np.asarray(jtransfer.make_device_packer()(variables["params"]))
    for client, rnd in ((3, 0), (7, 5)):
        jbuf, jloss = jpool.run_client_round(client, buf, rnd)
        tbuf, tloss = tpool.run_client_round(client, buf, rnd)
        assert tbuf.dtype == jbuf.dtype and tbuf.shape == jbuf.shape
        diff = np.abs(tbuf.view(np.int8).astype(np.int32)
                      - jbuf.view(np.int8).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        assert np.isclose(tloss, jloss, rtol=1e-5)


def test_local_steps_scale_template():
    """The contract template under ``--local-steps 3``: within 1e-5 of the
    JAX one (module docstring); bit-equal across two port derivations and to the one-step
    template times 3 in f32."""
    from ewdml_tpu.parallel import ps_net as jps_net
    from ewdml_tpu_torch.parallel import ps_net

    init = _jax_init()
    with pytest.MonkeyPatch.context() as mp:
        _from_jax_init(mp, init)
        cfg3 = TrainConfig(**dict(FED, local_steps=3, platform="cpu"))
        a = ps_net.build_endpoint_setup(cfg3).grads_scale
        b = ps_net.build_endpoint_setup(cfg3).grads_scale
        one = ps_net.build_endpoint_setup(TrainConfig(**dict(
            FED, local_steps=1, platform="cpu"))).grads_scale
    j = jax.tree.leaves(jps_net.build_endpoint_setup(
        JConfig(**dict(FED, local_steps=3)))[6])
    assert len(a) == len(j)
    for x, y, z, w in zip(a, b, one, j):
        assert torch.equal(x, y)
        assert torch.equal(x, z * torch.tensor(3.0, dtype=torch.float32))
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_cli_summary_is_the_jax_runs(runs, capsys, monkeypatch):
    """Exact: the CPU CLI's ``federated done`` line carries the JAX run's
    rounds, pool, cohort, skew, decodes, dropouts, resamples, rejections,
    bytes and planned up-link; its loss is the JAX run's to four places."""
    from ewdml_tpu.train.metrics import federated_wire_plan
    from ewdml_tpu_torch.cli import main

    name, jcfg, tcfg, jres, _, init, _ = runs
    _from_jax_init(monkeypatch, init)
    extra = []
    for flag, value in _variant(name).items():
        extra += ["--" + flag.replace("_", "-"), str(value)]
    rc = main(["--platform", "cpu", "--federated", "--network", "LeNet",
               "--dataset", "MNIST", "--synthetic-data", "--synthetic-size",
               "256", "--server-agg", "homomorphic", "--compress-grad",
               "qsgd", "--pool-size", "12", "--cohort", "4",
               "--local-steps", "2", "--fed-rounds", "2", "--batch-size",
               "8", "--lr", "0.05", "--momentum", "0", "--no-bf16",
               "--seed", str(SEED), *extra,
               "--train-dir", tcfg.train_dir + "_cli/"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    done = [l for l in out if l.startswith("federated done:")]
    assert len(done) == 1, out
    s = jres.stats
    plan = federated_wire_plan(jcfg, jres.params)
    assert done[0] == (
        f"federated done: rounds=2 pool=12 cohort=4 partition=iid "
        f"skew={jres.skew:.3f} final_loss={jres.final_loss:.4f} "
        f"decodes={s.decode_count}/{s.apply_rounds} rounds "
        f"(flat server cost) dropouts={jres.dropouts} "
        f"resampled={jres.resampled} rejected={jres.rejected} "
        f"up={s.bytes_up / 1e6:.2f}MB down={s.bytes_down / 1e6:.2f}MB "
        f"planned_up/round={plan.up_bytes_round / 1e6:.2f}MB")
    assert [l for l in out if l.startswith("eval: loss=")]


def test_thread_batched_run_is_structurally_sound(tmp_path):
    """Structural: four clients a thread batch, accept 3 of 4."""
    cfg = TrainConfig(**dict(FED, pool_size=8, num_aggregate=3,
                             local_steps=1, synthetic_size=64,
                             train_dir=str(tmp_path), platform="cpu"))
    res = run_federated(cfg, thread_batch=4)
    assert res.rounds == 2
    assert res.stats.apply_rounds == res.stats.decode_count == 2
    records = read_ledger(res.ledger_path)
    cohorts = {r["round"]: r["cohort"] for r in records
               if r["event"] == "round_begin"}
    sampler = JSampler(8, 4, SEED)
    for rec in res.round_records:
        assert cohorts[rec["round"]] == sampler.sample(rec["round"],
                                                        range(8))
        assert len(rec["accepted"]) == 3
        assert set(rec["accepted"]) <= set(cohorts[rec["round"]])
    assert res.stats.fed_rejected == res.rejected == 2
    assert res.coordinator["quota_dropped"] == 2
