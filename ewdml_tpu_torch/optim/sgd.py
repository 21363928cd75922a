"""Momentum SGD taking explicit gradients (``ewdml_tpu/optim/sgd.py:42-100``).

The reference hand-modified ``torch.optim.SGD`` so that ``step`` applies
externally supplied (decompressed, averaged) gradients. The semantics are
torch SGD's, in the JAX package's order of operations:

    d_p = g + weight_decay * p
    buf = momentum * buf + (1 - dampening) * d_p     (buf := d_p on first use)
    d_p = d_p + momentum * buf   if nesterov else   buf
    p  += -lr * d_p

The update is in place on the parameters and the momentum buffers.
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
                 weight_decay: float = 0.0, nesterov: bool = False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero "
                             "dampening")
        self.lr = lr
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    def init(self, params: list) -> SGDState:
        return SGDState([torch.zeros_like(p) for p in params], False)

    @torch.no_grad()
    def update(self, grads: list, state: SGDState, params: list) -> None:
        """Apply one step to ``params`` (in place) from ``grads``."""
        mu, damp = self.momentum, self.dampening
        for g, p, buf in zip(grads, params, state.momentum_buf):
            g = g.to(torch.float32)
            d_p = g + self.weight_decay * p if self.weight_decay else g
            if mu:
                if state.initialized:
                    buf.copy_(mu * buf + (1.0 - damp) * d_p)
                else:
                    buf.copy_(d_p)
                step_dir = d_p + mu * buf if self.nesterov else buf
            else:
                step_dir = d_p
            p.add_(-self.lr * step_dir)
        state.initialized = True


def make_optimizer(name: str, lr: float, momentum: float = 0.9,
                   weight_decay: float = 0.0, nesterov: bool = False):
    """``sgd`` only in this slice; Adam is a later one."""
    name = name.lower()
    if name == "sgd":
        return SGD(lr, momentum=momentum, weight_decay=weight_decay,
                   nesterov=nesterov)
    if name == "adam":
        raise NotImplementedError("--optimizer adam is not ported yet")
    raise ValueError(f"unknown optimizer {name!r}")
