"""Adam (``optim/adam.py``) against the JAX package's, and on the state tree.

The same parameters and gradients, made from a numpy seed, go through
``ewdml_tpu.optim.Adam`` and the port's ``Adam`` for 3 updates, with the
same key words. Oracles:

- f32 state: tolerance. Parameters and moments within 2e-6 relative of the
  leaf's largest value: ``bc1``/``bc2`` take XLA's ``pow`` and PyTorch's,
  which may differ in the last bit, and XLA may contract the moment EMAs
  into FMAs. Measured at these inputs: within 1.1e-8 relative.
- bf16 state: the moments within one bf16 ulp of the JAX state, at most
  1% of the elements flipped (measured: none), the parameters within the
  same 2e-6. The stores themselves are the bit-equal ones of
  ``test_torch_precision.py``.
- ``count`` is a device tensor advanced in place, and bc1/bc2 read it:
  the update takes no host value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewdml_tpu.optim.adam import Adam as JAdam
from ewdml_tpu_torch.models.convert import from_jax, to_jax
from ewdml_tpu_torch.optim import Adam, AdamState, make_optimizer

torch.set_num_threads(2)

LEAVES = [("conv", (3, 3, 16, 32)), ("dense", (120, 84)), ("vector", (84,))]


def _key_words(key) -> tuple:
    return tuple(int(v) for v in jax.random.key_data(key))


def _run(state_dtype, weight_decay, torch_layout, steps=3, seed=0):
    rng = np.random.RandomState(seed)
    params = [(rng.randn(*s) * 0.1).astype(np.float32) for _, s in LEAVES]
    grads = [[(rng.randn(*s) * 0.05).astype(np.float32) for _, s in LEAVES]
             for _ in range(steps)]
    kinds = [k for k, _ in LEAVES]
    jdt = None if state_dtype is None else jnp.bfloat16
    tdt = None if state_dtype is None else torch.bfloat16
    jopt = JAdam(1e-3, weight_decay=weight_decay, state_dtype=jdt)
    jp = [jnp.array(p) for p in params]
    jst = jopt.init(jp)
    topt = Adam(1e-3, weight_decay=weight_decay, state_dtype=tdt)

    def conv(x, k):
        t = torch.from_numpy(x.copy())
        return from_jax(t, k).contiguous() if torch_layout else t

    def back(t, k):
        return to_jax(t, k).contiguous() if torch_layout else t

    tp = [conv(p, k) for p, k in zip(params, kinds)]
    tst = topt.init(tp)
    for step, g in enumerate(grads):
        key = jax.random.fold_in(jax.random.key(4), step)
        upd, jst = jopt.update([jnp.array(x) for x in g], jst, jp, key=key)
        jp = [p + u for p, u in zip(jp, upd)]
        topt.update([conv(x, k) for x, k in zip(g, kinds)], tst, tp,
                    key=_key_words(key), kinds=kinds if torch_layout else None)
    return jp, jst, [back(p, k) for p, k in zip(tp, kinds)], tst, kinds


def _close(t, j, rel=2e-6):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(np.asarray(t, np.float32), j, rtol=0,
                               atol=rel * max(np.abs(j).max(), 1e-30))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
@pytest.mark.parametrize("torch_layout", [True, False],
                         ids=["torch_layout", "jax_layout"])
def test_f32_adam_follows_the_jax_one(weight_decay, torch_layout):
    jp, jst, tp, tst, kinds = _run(None, weight_decay, torch_layout)
    assert int(tst.count) == int(jst.count) == 3
    for j, t in zip(jp, tp):
        _close(t.numpy(), j)
    for jm, tm, k in zip(jst.mu, tst.mu, kinds):
        assert tm.dtype == torch.float32
        tm = to_jax(tm, k) if torch_layout else tm
        _close(tm.numpy(), jm)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
@pytest.mark.parametrize("torch_layout", [True, False],
                         ids=["torch_layout", "jax_layout"])
def test_bf16_adam_follows_the_jax_one(weight_decay, torch_layout):
    jp, jst, tp, tst, kinds = _run("bf16", weight_decay, torch_layout)
    for j, t in zip(jp, tp):
        _close(t.numpy(), j)
    for jtree, ttree in ((jst.mu, tst.mu), (jst.nu, tst.nu)):
        for j, t, k in zip(jtree, ttree, kinds):
            assert t.dtype == torch.bfloat16
            t = (to_jax(t, k) if torch_layout else t).float().numpy()
            j = np.asarray(j, np.float32)
            steps = np.abs(t.view(np.int32).astype(np.int64)
                           - j.view(np.int32).astype(np.int64)) >> 16
            assert steps.max() <= 1
            assert (steps > 0).mean() <= 0.01
    assert all(float(v.float().min()) >= 0.0 for v in tst.nu)


def test_adam_count_is_a_device_tensor_advanced_in_place():
    opt = make_optimizer("adam", 1e-3)
    p = [torch.zeros(5)]
    st = opt.init(p)
    assert isinstance(st, AdamState) and st.count.dtype == torch.int32
    count = st.count
    opt.update([torch.ones(5)], st, p)
    opt.update([torch.ones(5)], st, p)
    assert st.count is count and int(count) == 2
    # Two steps of a constant gradient: mu/bc1 = 1 and nu/bc2 = 1 up to the
    # f32 cancellation in 1 - b2^t, so each step moves by about lr.
    np.testing.assert_allclose(p[0].numpy(), -2e-3, rtol=1e-4)


def test_adam_without_a_key_stores_to_nearest_even():
    opt = Adam(1e-3, state_dtype=torch.bfloat16)
    p = [torch.zeros(7)]
    st = opt.init(p)
    g = torch.linspace(-1, 1, 7)
    opt.update([g], st, p)
    want = ((1 - 0.9) * g).to(torch.bfloat16)
    assert torch.equal(st.mu[0].view(torch.int16), want.view(torch.int16))
