"""The port's checkpoint codec (``ewdml_tpu_torch/utils/msgpack.py``) and
the Flax state dict of ``WorkerState`` it writes
(``ewdml_tpu_torch/train/state.state_tree``), against
``flax.serialization``.

Oracles (all bit):
- the bytes of a checkpoint of the port's state equal
  ``flax.serialization.to_bytes`` of the JAX package's ``WorkerState`` with
  the same values, for LeNet and a narrow VGG-BN, collapsed (one worker)
  and full (``[W, ...]``, the workers' values different);
- the codec's bytes equal flax's for the state dict with a bf16 leaf, a
  numpy scalar, empty arrays and every int/str/bin length class;
- decoding flax's bytes gives equal arrays (bf16 included);
- ``peek_step`` agrees with the JAX package's.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack as pymsgpack
import numpy as np
import pytest
import torch

from ewdml_tpu.models import LeNet as JLeNet
from ewdml_tpu.models import VGG as JVGG
from ewdml_tpu.optim.sgd import SGD as JSGD
from ewdml_tpu.train import checkpoint as jckpt
from ewdml_tpu.train.state import WorkerState as JWorkerState
from ewdml_tpu_torch.models import LeNet, VGG
from ewdml_tpu_torch.optim.sgd import SGD
from ewdml_tpu_torch.train import checkpoint
from ewdml_tpu_torch.train.state import (load_state_tree, make_train_state,
                                         state_tree)
from ewdml_tpu_torch.utils import msgpack

torch.set_num_threads(2)

NARROW_CFG = (8, "M", 16, "M", 16, 16, "M")
W = 3


def to_torch(tree):
    """A numpy/jax state dict as nested dicts of CPU tensors (bf16 kept)."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def jax_worker_state(jmodel, shape, full: bool, seed: int):
    """A JAX ``WorkerState`` (numpy leaves) with random values in every
    leaf: params, momentum, BatchNorm statistics and residuals; ``full``
    stacks W workers whose values differ."""
    variables = jmodel.init(jax.random.key(0), jnp.zeros(shape), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.RandomState(seed)

    def rand(p):
        lead = (W,) if full else ()
        return rng.randn(*lead, *p.shape).astype(np.float32)

    opt = JSGD(0.1, momentum=0.9).init(params)
    return JWorkerState(
        params=jax.tree.map(rand, params),
        opt_state=opt._replace(
            momentum_buf=jax.tree.map(rand, params),
            initialized=np.asarray([True] * W if full else True)),
        batch_stats=jax.tree.map(
            lambda s: np.abs(rand(s)),
            jax.tree.map(np.asarray, variables.get("batch_stats", {}))),
        residual=jax.tree.map(rand, params))


MODELS = {
    "lenet": (lambda: JLeNet(num_classes=10), lambda: LeNet(),
              (2, 28, 28, 1)),
    "vgg_bn": (lambda: JVGG(cfg=NARROW_CFG, batch_norm=True, num_classes=10),
               lambda: VGG(cfg=NARROW_CFG, batch_norm=True, num_classes=10),
               (2, 32, 32, 3)),
}


@pytest.mark.parametrize("full", [False, True], ids=["collapsed", "full"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_state_bytes_equal_flax_to_bytes(name, full):
    """The port's workers, loaded with the JAX state's values, save the
    bytes flax writes for it."""
    jmodel, tmodel, shape = MODELS[name]
    jws = jax_worker_state(jmodel(), shape, full, seed=len(name))
    world = W if full else 0
    want = flax.serialization.to_bytes(
        {"step": 7, "world": world, "worker": jws})
    workers = make_train_state(tmodel(), SGD(0.1, momentum=0.9),
                               W if full else 1, "cpu",
                               error_feedback=True).workers
    jtree = to_torch(flax.serialization.to_state_dict(jws))
    load_state_tree(workers, jtree, stacked=full)
    got = msgpack.packb({"step": 7, "world": world,
                         "worker": state_tree(workers, stacked=full)})
    assert got == want


def test_codec_bytes_equal_flax_with_a_bf16_leaf_and_scalars():
    jws = jax_worker_state(MODELS["vgg_bn"][0](), MODELS["vgg_bn"][2],
                           full=True, seed=3)
    sd = flax.serialization.to_state_dict(jws)
    mb = sd["opt_state"]["momentum_buf"]
    mb["conv0"]["kernel"] = np.asarray(
        jnp.asarray(mb["conv0"]["kernel"], jnp.bfloat16))
    tree = {"step": 2 ** 33, "world": W, "worker": sd,
            "extra": {"scalar": np.float32(0.25), "empty": np.zeros((0, 3)),
                      "ints": [0, 127, 128, 255, 256, 65535, 65536,
                               2 ** 32 - 1, -1, -32, -33, -128, -129,
                               -32768, -32769, -2 ** 31, -2 ** 31 - 1],
                      "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                               "e" * 70000],
                      "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
                      "misc": [None, True, False, 1.5, -0.0],
                      "wide": {str(i): i for i in range(17)}}}
    want = flax.serialization.msgpack_serialize(tree, in_place=False)
    # msgpack_serialize sorts the maps it copies; encode the same order.
    assert msgpack.packb(to_torch_keep(
        pymsgpack.unpackb(want, raw=False, strict_map_key=False,
                          ext_hook=lambda c, d: pymsgpack.ExtType(c, d)),
        tree)) == want


def to_torch_keep(decoded, original):
    """``decoded`` (maps in the written order, arrays as raw ExtTypes) with
    each array replaced by ``original``'s value as a tensor, scalars by the
    numpy scalar: the same object flax encoded, in its order."""
    if isinstance(decoded, dict):
        return {k: to_torch_keep(v, original[k]) for k, v in decoded.items()}
    if isinstance(decoded, list):
        return [to_torch_keep(v, o) for v, o in zip(decoded, original)]
    if isinstance(decoded, pymsgpack.ExtType):
        if decoded.code == msgpack.EXT_NPSCALAR:
            return original
        return to_torch(original)
    return decoded


def test_decoding_flax_bytes_gives_equal_arrays():
    jws = jax_worker_state(MODELS["vgg_bn"][0](), MODELS["vgg_bn"][2],
                           full=True, seed=4)
    sd = flax.serialization.to_state_dict(jws)
    last = sorted(sd["residual"])[-1]
    sd["residual"][last]["bias"] = np.asarray(
        jnp.asarray(sd["residual"][last]["bias"], jnp.bfloat16))
    blob = flax.serialization.to_bytes({"step": 3, "world": W, "worker": sd})
    got = msgpack.unpackb(blob)
    ref = flax.serialization.msgpack_restore(blob)
    assert (got["step"], got["world"]) == (3, W)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref["worker"])[0]
    flat_got = jax.tree_util.tree_flatten_with_path(got["worker"])[0]
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_got]
    for (path, r), (_, g) in zip(flat_ref, flat_got):
        r = np.asarray(r)
        if r.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          r.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=str(path))


def test_peek_step_agrees_with_jax(tmp_path):
    jws = jax_worker_state(MODELS["lenet"][0](), MODELS["lenet"][2],
                           full=False, seed=5)
    jpath = jckpt.save(str(tmp_path / "j"), jws, step=123456)
    workers = make_train_state(LeNet(), SGD(0.1, momentum=0.9), 2,
                               "cpu").workers
    tpath = checkpoint.save(str(tmp_path / "t"), state_tree(workers,
                                                            stacked=True),
                            step=77, world=2)
    for path, step in ((jpath, 123456), (tpath, 77)):
        assert checkpoint.peek_step(path) == jckpt.peek_step(path) == step


def test_a_leaf_flax_would_chunk_raises():
    big = torch.empty(2 ** 28, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="chunk"):
        msgpack.packb({"x": big})


def _jax_policy_state(jmodel, shape, full: bool, seed: int, optimizer: str,
                      bf16: bool):
    """:func:`jax_worker_state` under ``optimizer`` (``AdamState`` with a
    count for Adam), its optimizer state and residuals bf16 when ``bf16``
    (``--precision-policy bf16_wire_state``)."""
    from ewdml_tpu.optim.adam import Adam as JAdam

    jws = jax_worker_state(jmodel, shape, full, seed)
    rng = np.random.RandomState(seed + 1)
    narrow = ((lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))) if bf16
              else (lambda a: a))
    if optimizer == "adam":
        def rand(p):
            return narrow(np.abs(rng.randn(*p.shape)).astype(np.float32))
        st = JAdam(1e-3).init(jax.tree.map(jnp.asarray, jws.params))
        opt = st._replace(
            count=np.asarray([5] * W if full else 5, np.int32),
            mu=jax.tree.map(rand, jws.params),
            nu=jax.tree.map(rand, jws.params))
    else:
        opt = jws.opt_state._replace(
            momentum_buf=jax.tree.map(narrow, jws.opt_state.momentum_buf))
    return jws.replace(opt_state=opt,
                       residual=jax.tree.map(narrow, jws.residual))


@pytest.mark.parametrize("optimizer,bf16", [("adam", False), ("adam", True),
                                            ("sgd", True)],
                         ids=["adam", "adam_bf16", "sgd_bf16"])
@pytest.mark.parametrize("full", [False, True], ids=["collapsed", "full"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_policy_and_adam_state_bytes_equal_flax_to_bytes(name, full,
                                                         optimizer, bf16):
    """Under Adam and under bf16 state the port writes flax's bytes, the
    bf16 leaves included, and reads them back bit for bit."""
    from ewdml_tpu_torch.optim import make_optimizer

    jmodel, tmodel, shape = MODELS[name]
    jws = _jax_policy_state(jmodel(), shape, full, len(name), optimizer, bf16)
    world = W if full else 0
    want = flax.serialization.to_bytes(
        {"step": 7, "world": world, "worker": jws})
    dtype = torch.bfloat16 if bf16 else None
    workers = make_train_state(
        tmodel(), make_optimizer(optimizer, 0.1, state_dtype=dtype),
        W if full else 1, "cpu", error_feedback=True,
        residual_dtype=dtype).workers
    load_state_tree(workers, to_torch(flax.serialization.to_state_dict(jws)),
                    stacked=full)
    tree = state_tree(workers, stacked=full)
    got = msgpack.packb({"step": 7, "world": world, "worker": tree})
    assert got == want
    back = msgpack.unpackb(got)["worker"]
    assert back["opt_state"].keys() == tree["opt_state"].keys()
