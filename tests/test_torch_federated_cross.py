"""Federated rounds across the packages over TCP: the port's
``NetTransport`` drives a JAX ``PSNetServer --federated``, and the JAX
``NetTransport`` drives a port server (threads of this test process, LeNet
on synthetic MNIST, ``--platform cpu``).

The rounds run under ``--server-agg decode``: a homomorphic pairing across
the packages fails on the scale contract's CRC by design
(``tests/test_torch_ps_net_cross.py``). The port server starts from the JAX
initial parameters (its initialisers draw from a torch generator).

Oracles: the server's ``round_sequence`` (round, cohort, accepted): exact,
equal to the port's in-process run of the same config from the JAX initial
parameters (whose ledger is the JAX package's byte for byte,
``tests/test_torch_federated_run.py``); the server's final parameters:
bounded flips against that run, per leaf ||d|| <= 1e-3 ||m|| with m its
move (the oracle of ``tests/test_torch_federated_run.py``).
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ewdml_tpu_torch.models as tmodels
from ewdml_tpu.core.config import TrainConfig as JConfig
from ewdml_tpu.federated import read_ledger as jread_ledger
from ewdml_tpu.federated import round_sequence as jround_sequence
from ewdml_tpu.federated import run_federated as jrun_federated
from ewdml_tpu.models import build_model as jbuild
from ewdml_tpu.models import init_variables
from ewdml_tpu.parallel import ps_net as jps_net
from ewdml_tpu_torch.core.config import TrainConfig
from ewdml_tpu_torch.federated import read_ledger, round_sequence, \
    run_federated
from ewdml_tpu_torch.models.convert import flax_to_torch, leaf_specs
from ewdml_tpu_torch.parallel import ps_net

torch.set_num_threads(2)

SEED = 42
FED = dict(network="LeNet", dataset="MNIST", batch_size=8,
           compress_grad="qsgd", quantum_num=127, synthetic_data=True,
           synthetic_size=64, bf16_compute=False, server_agg="decode",
           federated=True, pool_size=6, cohort=2, local_steps=1,
           partition="iid", fed_rounds=2, momentum=0.0, lr=0.05, seed=SEED,
           net_timeout_s=20.0)


def _jax_init():
    return jax.tree.map(np.asarray, init_variables(
        jbuild("LeNet", 10), jax.random.key(SEED),
        jnp.zeros((2, 28, 28, 1), jnp.float32))["params"])


def _from_jax_init(mp, init) -> None:
    """Every port model built starts from the JAX initial state."""
    build = tmodels.build_model

    def built(*a, **kw):
        model = build(*a, **kw)
        model.load_state_dict(flax_to_torch(model, init))
        return model

    mp.setattr(tmodels, "build_model", built)


def _tree(leaves) -> dict:
    """A port leaf list as the JAX {layer: {leaf: array}} tree."""
    out: dict = {}
    for spec, p in zip(leaf_specs(tmodels.build_model("LeNet", 10)),
                       leaves):
        layer, leaf = spec.name.split("/")
        out.setdefault(layer, {})[leaf] = p.numpy()
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The port's in-process run from the JAX initial parameters: its
    round sequence and final parameters."""
    d = tmp_path_factory.mktemp("ref")
    with pytest.MonkeyPatch.context() as mp:
        _from_jax_init(mp, _jax_init())
        res = run_federated(TrainConfig(**dict(FED, train_dir=str(d),
                                               platform="cpu")))
    return round_sequence(read_ledger(res.ledger_path)), _tree(res.params)


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def _stop(addr, thread) -> None:
    ps_net.client_call(addr, {"op": "shutdown"}, retries=0, timeout_s=20)
    thread.join(30)


def _check_params(got: dict, want: dict) -> None:
    init = _jax_init()
    for spec in leaf_specs(tmodels.build_model("LeNet", 10)):
        layer, leaf = spec.name.split("/")
        j = np.asarray(want[layer][leaf], np.float64)
        m = j - np.asarray(init[layer][leaf], np.float64)
        d = np.asarray(got[layer][leaf], np.float64) - j
        assert np.abs(m).max() > 0, spec.name
        assert np.linalg.norm(d) <= 1e-3 * np.linalg.norm(m), spec.name


def test_port_driver_against_a_jax_server(reference, tmp_path):
    seq, params = reference
    jserver = jps_net.PSNetServer(JConfig(**dict(
        FED, train_dir=str(tmp_path / "jsrv"))), port=0)
    thread = _serve(jserver)
    try:
        res = run_federated(TrainConfig(**dict(
            FED, train_dir=str(tmp_path / "drv"), platform="cpu")),
            addr=jserver.address)
    finally:
        _stop(jserver.address, thread)
    assert res.rounds == 2 and res.rejected == 0
    assert jround_sequence(jread_ledger(
        str(tmp_path / "jsrv" / "fed_rounds.jsonl"))) == seq
    _check_params(jax.tree.map(np.asarray, jserver.server.params), params)


def test_jax_driver_against_a_port_server(reference, tmp_path,
                                          monkeypatch):
    seq, params = reference
    _from_jax_init(monkeypatch, _jax_init())
    server = ps_net.PSNetServer(TrainConfig(**dict(
        FED, train_dir=str(tmp_path / "srv"), platform="cpu")))
    thread = _serve(server)
    try:
        res = jrun_federated(JConfig(**dict(
            FED, train_dir=str(tmp_path / "jdrv"))), addr=server.address)
    finally:
        _stop(server.address, thread)
    assert res.rounds == 2 and res.rejected == 0
    assert round_sequence(read_ledger(
        str(tmp_path / "srv" / "fed_rounds.jsonl"))) == seq
    _check_params(_tree(server.server.params), params)
