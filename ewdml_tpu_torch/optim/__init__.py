"""Explicit-gradient optimizers (``ewdml_tpu/optim``)."""

from __future__ import annotations

import inspect

from ewdml_tpu_torch.optim.adam import Adam, AdamState  # noqa: F401
from ewdml_tpu_torch.optim.sgd import SGD, SGDState  # noqa: F401


def update_accepts_key(optimizer) -> bool:
    """Whether ``optimizer.update`` takes the seeded-rounding ``key``
    (the port's SGD and Adam do; a foreign optimizer keeps the plain
    ``update(grads, state, params)`` protocol)."""
    try:
        return "key" in inspect.signature(optimizer.update).parameters
    except (TypeError, ValueError):
        return False


def make_optimizer(name: str, lr: float, momentum: float = 0.9,
                   weight_decay: float = 0.0, nesterov: bool = False,
                   state_dtype=None):
    """``state_dtype`` is the precision policy's optimizer-state storage
    dtype (``cfg.precision.state_dtype``): bf16 stores the momentum or the
    moments at half width with seeded stochastic rounding; None or f32 is
    the full-precision state."""
    name = name.lower()
    if name == "sgd":
        return SGD(lr, momentum=momentum, weight_decay=weight_decay,
                   nesterov=nesterov, state_dtype=state_dtype)
    if name == "adam":
        return Adam(lr, weight_decay=weight_decay, state_dtype=state_dtype)
    raise ValueError(f"unknown optimizer {name!r}")

