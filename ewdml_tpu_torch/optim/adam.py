"""Adam taking explicit gradients (``ewdml_tpu/optim/adam.py:28-86``).

The reference's hand-modified Adam consumed gradients straight off the
wire; here the bias-corrected moments are the JAX package's, in its order
of operations:

    g   = g + weight_decay * p
    mu  = b1 * mu + (1 - b1) * g
    nu  = b2 * nu + (1 - b2) * g^2
    p  += -lr * (mu / bc1) / (sqrt(nu / bc2) + eps),  bc_k = 1 - b_k^t

The update is in place on the parameters and the moments, and ``count``
is a 0-d int32 tensor on the device, advanced in place: ``bc1``/``bc2``
are computed from it on the device, so a captured window reads no host
value.

``state_dtype=torch.bfloat16`` (``--precision-policy bf16_wire_state``)
stores both moments at half width: every leaf's moments are computed in
f32 and both stored as one set by ``core/precision.tree_store_round`` (one
kernel launch on the card), ``mu`` under ``fold_in(layer_key(key, i), 0)``
and ``nu`` under ``fold_in(..., 1)``, and the update is taken from the
*stored* moments. ``nu`` stays non-negative (both bf16 neighbours of a
non-negative f32 are non-negative). ``kinds`` as for
:class:`~ewdml_tpu_torch.optim.sgd.SGD`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class AdamState:
    count: torch.Tensor
    mu: list = field(default_factory=list)
    nu: list = field(default_factory=list)


class Adam:
    def __init__(self, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 state_dtype=None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.state_dtype = state_dtype

    def init(self, params: list) -> AdamState:
        device = params[0].device if params else None

        def zeros():
            return [torch.zeros_like(p, dtype=self.state_dtype or p.dtype)
                    for p in params]
        return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                         zeros(), zeros())

    @torch.no_grad()
    def update(self, grads: list, state: AdamState, params: list, key=None,
               kinds=None, lr=None) -> None:
        """Apply one step to ``params`` (in place) from ``grads``; ``lr``
        overrides ``self.lr`` for this step."""
        from ewdml_tpu_torch.core.precision import tree_store_round

        lr = self.lr if lr is None else lr
        state.count.add_(1)
        t = state.count.to(torch.float32)
        bc1 = 1.0 - torch.pow(self.b1, t)
        bc2 = 1.0 - torch.pow(self.b2, t)
        n = len(params)
        m_f, v_f = [], []
        for g, p, m, v in zip(grads, params, state.mu, state.nu):
            g = g.to(torch.float32)
            if self.weight_decay:
                g = g + self.weight_decay * p
            m_f.append(self.b1 * m.float() + (1 - self.b1) * g)
            v_f.append(self.b2 * v.float() + (1 - self.b2) * torch.square(g))
        kinds = list(kinds) if kinds else ["vector"] * n
        stored = state.mu + state.nu
        tree_store_round(key, m_f + v_f, stored, kinds * 2, outs=stored,
                         paths=[(i, 0) for i in range(n)]
                         + [(i, 1) for i in range(n)])
        for p, m, v in zip(params, state.mu, state.nu):
            p.add_(-lr * (m.float() / bc1)
                   / (torch.sqrt(v.float() / bc2) + self.eps))
