"""Adaptive compression on the parameter-server surfaces, on the CPU: the
in-process server (``parallel/ps.py``) and the TCP tier
(``parallel/ps_net.py``), against the JAX package where the wire meets.

LeNet at batch 8 on synthetic ``mnist10k``, QSGD, ``--platform cpu``,
``--adapt variance --adapt-every 2``. The JAX server's runtime reads its
comm/comp ratio from a process-global gauge; it is held at None here with
``monkeypatch`` (the port's parameter-server surfaces pass None).

Oracles, per test:
- the in-process server, decode and homomorphic: it journals at least one
  switch, and the plan-stale accounting closes exactly:
  ``pushes == updates * K + dropped_plan_stale + dropped_stale +
  pending``;
- ``ParameterServer(adapt=)`` refusals: the JAX package's messages;
- over TCP, a port server and a JAX worker, and a JAX server and a port
  worker, across a plan switch: the worker adopts the server's plan JSON
  (equal dicts), its rejected pushes are the server's plan-stale drops, and
  ``pushes == updates + dropped_plan_stale`` (K = 1);
- a port server and port workers under ``--server-agg homomorphic``
  across a switch: every pull's scale-CRC check passes and the worker's
  contract checksum per plan is the server's;
- the per-plan scale contract against the JAX one built from the same
  template: scales within the ``shared_scales`` tolerance of
  ``test_torch_homomorphic.py`` and, given the JAX scales, the same CRC.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.adapt import plan as jplan
from ewdml_tpu.adapt import runtime as jruntime
from ewdml_tpu.core.config import from_args as jfrom_args
from ewdml_tpu.ops import homomorphic as jhom
from ewdml_tpu.parallel import ps_net as jps_net
from ewdml_tpu_torch.adapt import AdaptRuntime, plan
from ewdml_tpu_torch.adapt.plan import unit_names_and_sizes
from ewdml_tpu_torch.cli import build_async
from ewdml_tpu_torch.core.config import TrainConfig, from_args
from ewdml_tpu_torch.ops import homomorphic
from ewdml_tpu_torch.optim.sgd import SGD
from ewdml_tpu_torch.parallel import ps, ps_net

torch.set_num_threads(2)

FLAGS = ["--network", "LeNet", "--dataset", "mnist10k", "--synthetic-data",
         "--batch-size", "8", "--compress-grad", "qsgd", "--fusion", "none",
         "--platform", "cpu", "--adapt", "variance", "--adapt-every", "2"]


def _cfgs(tmp_path, *extra):
    argv = FLAGS + ["--train-dir", str(tmp_path) + "/"] + list(extra)
    return jfrom_args(argv), from_args(argv)


@pytest.mark.parametrize("agg", ["decode", "homomorphic"])
def test_in_process_server_adapts_and_accounts(tmp_path, agg):
    _, cfg = _cfgs(tmp_path, "--mode", "async", "--num-workers", "4",
                   "--num-aggregate", "2", "--max-steps", "32",
                   "--server-agg", agg)
    run = build_async(cfg)
    server = run.server
    assert server.adapt is not None and server.plan_version == 0
    _, stats = run.run()
    rt = server.adapt
    assert len(rt.applied) >= 2 and server.plan_version == rt.plan.version
    assert stats.pushes == (stats.updates * 2 + stats.dropped_plan_stale
                            + stats.dropped_stale + len(server._pending))
    decisions = open(rt.ledger_path).read().splitlines()[1:]
    assert len(decisions) == 1 + stats.updates // 2
    if agg == "homomorphic":
        assert isinstance(server.compressor, homomorphic.HomomorphicCompressor)
        assert server.compressor.plan.key() == rt.plan.key()
        assert stats.decode_count == stats.updates


def test_parameter_server_adapt_refusals(tmp_path):
    _, cfg = _cfgs(tmp_path, "--mode", "async")
    setup = ps_net.build_endpoint_setup(cfg)
    names, sizes = unit_names_and_sizes(setup.specs)
    rt = AdaptRuntime(cfg, names, sizes, surface="ps")
    for kw, msg in ((dict(down_mode="delta"), "--adapt requires --ps-down"),
                    (dict(relay_compress=True), "lossy weights-down relay")):
        with pytest.raises(ValueError, match=msg):
            ps.ParameterServer(setup.params, SGD(0.1), None, device="cpu",
                               adapt=rt, **kw)
    with pytest.raises(ValueError, match="set_scale_base"):
        ps.ParameterServer(setup.params, SGD(0.1), None, device="cpu",
                           adapt=rt, server_agg="homomorphic")
    with pytest.raises(ValueError, match="disagrees with"):
        batch = (np.zeros((8, 28, 28, 1), np.float32), np.zeros(8, np.int32))
        ps.build_async_ps(setup.model, SGD(0.1), lambda i: iter([batch]),
                          num_workers=1,
                          steps_per_worker=1, adapt_cfg=cfg,
                          server_agg="homomorphic", device="cpu")
    rt.close()


class _Serving:
    def __init__(self, server):
        self.server = server
        self.thread = threading.Thread(target=server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def address(self):
        return tuple(self.server.address)

    def stop(self):
        if self.thread.is_alive():
            ps_net.client_call(self.address, {"op": "shutdown"})
        self.thread.join(30)
        self.server.close()


def _worker_plan(worker) -> dict:
    """The plan JSON a worker of either package encodes under."""
    comp, _ = next(c for c in worker._ctree_cache.values()
                   if c[0].plan.version == worker._plan_version)
    return comp.plan.to_json()


@pytest.mark.parametrize("pairing", ["port-server", "jax-server"])
def test_plan_negotiation_across_packages(tmp_path, monkeypatch, pairing):
    monkeypatch.setattr(jruntime, "live_comm_frac", lambda: None)
    jcfg, cfg = _cfgs(tmp_path, "--num-aggregate", "1")
    if pairing == "port-server":
        server, worker = ps_net.PSNetServer(cfg, port=0), jps_net.PSNetWorker
        wcfg = jcfg
    else:
        server, worker = jps_net.PSNetServer(jcfg, port=0), ps_net.PSNetWorker
        wcfg = cfg
    serving = _Serving(server)
    try:
        w = worker(wcfg, 0, serving.address)
        result = w.run(7)
        stats, _ = ps_net.client_call(serving.address, {"op": "stats"})
        plan_json = server.server.adapt.plan.to_json()
    finally:
        serving.stop()
    assert stats["plan_version"] >= 1 and w._plan_version >= 1
    assert stats["pushes"] == 7
    assert stats["pushes"] == stats["updates"] + stats["dropped_plan_stale"]
    assert result["rejected"] == stats["dropped_plan_stale"]
    assert w._plan_version == stats["plan_version"]
    assert _worker_plan(w) == plan_json


def test_homomorphic_contract_follows_every_plan(tmp_path):
    _, cfg = _cfgs(tmp_path, "--num-aggregate", "2", "--server-agg",
                   "homomorphic")
    server = ps_net.PSNetServer(cfg, port=0)
    serving = _Serving(server)
    results = {}
    try:
        workers = [ps_net.PSNetWorker(cfg, i, serving.address)
                   for i in range(2)]
        threads = [threading.Thread(
            target=lambda w=w: results.setdefault(w.index, w.run(8)))
            for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        stats, _ = ps_net.client_call(serving.address, {"op": "stats"})
        pv, comp = server.server.current_plan()
    finally:
        serving.stop()
    assert len(results) == 2 and stats["plan_version"] == pv >= 1
    for w in workers:
        # Every pull checked the worker's CRC against the server's at the
        # plan version it encodes under; here, the contract of each plan
        # this worker built is the server runtime's for the same plan.
        for key, (wcomp, _) in w._ctree_cache.items():
            scomp = server.server.adapt._compressors[key]
            assert wcomp.contract_checksum() == scomp.contract_checksum()
    assert stats["pushes"] == (stats["updates"] * 2
                               + stats["dropped_plan_stale"]
                               + stats["dropped_stale"]
                               + len(server.server._pending))


def test_per_plan_contract_matches_jax():
    rng = np.random.default_rng(2)
    shapes = [(5000,), (300_000,), (9000,), (400,)]
    leaves = [rng.standard_normal(s).astype(np.float32) * 0.01 for s in shapes]
    decisions = [("qsgd", 7, 0.0), ("topk_qsgd", 127, 0.01),
                 ("qsgd", 127, 0.0), ("dense", 0, 0.0)]
    jp = jplan.build_planned_compressor(jplan.Plan(1, 2, tuple(
        jplan.UnitDecision(u, f"l{u}", *d) for u, d in enumerate(decisions))),
        block=4096)
    tp = plan.build_planned_compressor(plan.Plan(1, 2, tuple(
        plan.UnitDecision(u, f"l{u}", *d) for u, d in enumerate(decisions))),
        block=4096)
    jc = jhom.make_homomorphic(jp, {f"l{u}": jnp.asarray(x)
                                    for u, x in enumerate(leaves)})
    tc = homomorphic.make_homomorphic(tp, [torch.from_numpy(x)
                                           for x in leaves])
    assert tc.plan is tp.plan
    for i in range(len(leaves)):
        js, ts = jc.for_leaf(i), tc.for_leaf(i)
        assert type(js).__name__ == type(ts).__name__
        if hasattr(js, "scales"):
            np.testing.assert_allclose(ts.scales.numpy(),
                                       np.asarray(js.scales),
                                       rtol=2.0 ** -21, atol=0)
            ts.scales = torch.from_numpy(np.array(js.scales))
        n = leaves[i].size
        assert tc.wire_bytes((n,), unit=i) == jc.wire_bytes((n,), unit=i)
    assert tc.contract_checksum() == jc.contract_checksum()


def test_runtime_prices_the_homomorphic_wire(tmp_path):
    cfg = TrainConfig(compress_grad="qsgd", quantum_num=7, adapt="variance",
                      adapt_every=2, server_agg="homomorphic",
                      train_dir=str(tmp_path) + "/")
    jcfg = jfrom_args(["--compress-grad", "qsgd", "--quantum-num", "7",
                       "--adapt", "variance", "--adapt-every", "2",
                       "--server-agg", "homomorphic", "--train-dir",
                       str(tmp_path / "j") + "/"])
    names, sizes = ["a", "b"], [300_000, 70]
    rt = AdaptRuntime(cfg, names, sizes, surface="ps")
    jr = jruntime.AdaptRuntime(jcfg, names, sizes, surface="ps")
    assert rt.wire == jr.wire == "homomorphic"
    assert rt.budget_bytes == jr.budget_bytes
    rt.close()
    jr.close()
