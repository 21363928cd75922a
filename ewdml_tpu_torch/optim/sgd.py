"""Momentum SGD taking explicit gradients (``ewdml_tpu/optim/sgd.py:42-100``).

The reference hand-modified ``torch.optim.SGD`` so that ``step`` applies
externally supplied (decompressed, averaged) gradients. The semantics are
torch SGD's, in the JAX package's order of operations:

    d_p = g + weight_decay * p
    buf = momentum * buf + (1 - dampening) * d_p     (buf := d_p on first use)
    d_p = d_p + momentum * buf   if nesterov else   buf
    p  += -lr * d_p

The update is in place on the parameters and the momentum buffers.

``state_dtype=torch.bfloat16`` (``--precision-policy bf16_wire_state``)
stores the buffers at half width: every leaf's new buffer is computed in
f32, the whole set is stored in one call of
``core/precision.tree_store_round``, leaf i under ``layer_key(key, i)``
(seeded stochastic rounding, one kernel launch on the card;
round-to-nearest without a key), and the step is taken from the *stored*
values, so the trajectory is a function of the stored state alone.
``kinds`` names each leaf's layout (``models/convert``): the trainer holds
its parameters and buffers in PyTorch's layout, and the rounding draws by
the JAX layout's index.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class SGDState:
    momentum_buf: list = field(default_factory=list)
    initialized: bool = False


class SGD:
    def __init__(self, lr: float, momentum: float = 0.0, dampening: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 state_dtype=None):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero "
                             "dampening")
        self.lr = lr
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.state_dtype = state_dtype

    def init(self, params: list) -> SGDState:
        return SGDState([torch.zeros_like(p, dtype=self.state_dtype or p.dtype)
                         for p in params], False)

    @torch.no_grad()
    def update(self, grads: list, state: SGDState, params: list, key=None,
               kinds=None, lr=None) -> None:
        """Apply one step to ``params`` (in place) from ``grads``. ``key``
        seeds the bf16 stores (leaf i under ``layer_key(key, i)``); ``lr``
        overrides ``self.lr`` for this step (the horovod-style warmup)."""
        from ewdml_tpu_torch.core.precision import tree_store_round

        lr = self.lr if lr is None else lr
        mu, damp = self.momentum, self.dampening
        bufs = state.momentum_buf
        d_ps = [g.to(torch.float32) + self.weight_decay * p
                if self.weight_decay else g.to(torch.float32)
                for g, p in zip(grads, params)]
        if mu:
            new = [mu * buf.float() + (1.0 - damp) * d_p
                   if state.initialized else d_p
                   for d_p, buf in zip(d_ps, bufs)]
            tree_store_round(key, new, bufs, kinds, outs=bufs)
        for p, buf, d_p in zip(params, bufs, d_ps):
            if mu:
                used = buf.float()
                step_dir = d_p + mu * used if self.nesterov else used
            else:
                step_dir = d_p
            p.add_(-lr * step_dir)
        state.initialized = True
