"""Top-k -> QSGD at ratio 0.5 with the Method 4/5 relay, stage by stage.

A leaf of LeNet fc1's size (400 000 elements, 60% exact zeros, as ReLU
gradients have) at ``--topk-ratio 0.5`` resolves to 'approx' selection. The
JAX package and the port get the same numpy inputs at each stage:

1. selection (``topk.compress``): bit.
2. the winners' QSGD norm: tolerance, 2 f32 ulps; levels given the same
   key: bit.
3. the relay (``collectives._sparse_relay``) of the same average and
   candidates: tolerance, 2e-6 of the leaf's scale at every element (no
   flipped level).
4. the whole ``compressed_allreduce`` with the relay: the same tolerance.

The port once summed the norm in f32 with PyTorch's CPU reduction, 8.6e-5
relative off XLA's over the relay's 200 000 winners; every relayed value
carries that norm, so 44 000 of 400 000 averaged elements differed (ROADMAP
Queue 3 item 6). ``ops/qsgd.l2_norms`` sums in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ewdml_tpu.ops import make_compressor as jmake
from ewdml_tpu.ops import qsgd as jqsgd
from ewdml_tpu.ops import topk as jtopk
from ewdml_tpu.parallel import collectives as jcoll
from ewdml_tpu_torch.ops import make_compressor as tmake
from ewdml_tpu_torch.ops import qsgd as tqsgd
from ewdml_tpu_torch.ops import topk as ttopk
from ewdml_tpu_torch.parallel import collectives as tcoll
from ewdml_tpu_torch.utils import prng
from test_torch_collectives import _jax_allreduce, _port_allreduce

torch.set_num_threads(2)

W, N, RATIO = 4, 400_000, 0.5
K = int(N * RATIO)


def _grads():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(W):
        g = (rng.randn(N) * 1e-3).astype(np.float32)
        g[rng.rand(N) < 0.6] = 0.0
        out.append(g)
    return out


def _worker_stages(grads):
    """Stages 1 and 2 per worker; returns the JAX winners' indices and
    decoded values (the inputs of the mean)."""
    idx, vals = [], []
    for w, g in enumerate(grads):
        assert ttopk.resolve_mode(None, N, RATIO) == "approx"
        js = jtopk.compress(jnp.asarray(g), RATIO, None)
        ts = ttopk.compress(torch.from_numpy(g), RATIO, None)
        assert np.array_equal(ts.indices.numpy(), np.asarray(js.indices))
        assert np.array_equal(ts.values.numpy(), np.asarray(js.values))
        jq = jqsgd.compress(jax.random.key(w), js.values, 127)
        tq = tqsgd.compress(prng.key(w), ts.values, 127)
        jn, tn = float(jq.norm), float(tq.norm)
        assert abs(tn - jn) <= 2 * np.spacing(np.float32(jn)), (w, tn, jn)
        assert np.array_equal(tq.levels.numpy(), np.asarray(jq.levels))
        idx.append(np.asarray(js.indices))
        vals.append(np.asarray(jqsgd.decompress(jq)))
    return idx, vals


def test_relay_stages_agree_on_identical_inputs():
    idx, vals = _worker_stages(_grads())
    cand = np.concatenate(idx).astype(np.int32)
    dense = np.zeros(N, np.float32)
    for i, v in zip(idx, vals):
        np.add.at(dense, i, v)
    avg = dense / np.float32(W)
    rk = 99
    jout = np.asarray(jcoll._sparse_relay(
        jnp.asarray(avg), jnp.asarray(cand), K,
        jmake("topk_qsgd", topk_ratio=RATIO), jax.random.key(rk), world=W))
    tout = tcoll._sparse_relay(
        torch.from_numpy(avg), torch.from_numpy(cand), K,
        tmake("topk_qsgd", topk_ratio=RATIO), prng.key(rk), world=W).numpy()
    assert (jout != 0).sum() > 0.1 * N  # the relayed levels that are not 0
    tol = 2e-6 * np.abs(jout).max()
    assert np.abs(tout.astype(np.float64) - jout).max() <= tol


def test_relayed_allreduce_agrees():
    grads = [[g.reshape(800, 500)] for g in _grads()]
    kw = dict(relay=True)
    javg, _ = _jax_allreduce(grads, jmake("topk_qsgd", topk_ratio=RATIO), 5, kw)
    tavg, _ = _port_allreduce(grads, tmake("topk_qsgd", topk_ratio=RATIO), 5,
                              kw)
    j, t = javg[0][0].astype(np.float64), tavg[0].numpy().astype(np.float64)
    assert np.abs(t - j).max() <= 2e-6 * np.abs(j).max()
