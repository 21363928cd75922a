"""Analytic bytes-on-wire accounting, and payload stacking for the exchange.

Payloads are dataclasses whose tensor fields cross the wire and whose other
fields are static metadata (shape, s, block, ...), the layout of the JAX
package's ``flax.struct`` payloads. ``stack_payloads`` is the all-gather of
a payload over the workers (every tensor field gains a leading ``[W]``
axis, metadata is shared); ``take_payloads`` selects workers from it.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def numel(shape) -> int:
    """Static element count of a shape tuple."""
    return math.prod(int(d) for d in shape)


def stack_payloads(payloads: list):
    """All-gather a list of same-structure payloads (one per worker)."""
    first = payloads[0]
    kw = {}
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        kw[f.name] = (torch.stack([getattr(p, f.name) for p in payloads])
                      if isinstance(v, torch.Tensor) else v)
    return type(first)(**kw)


def take_payloads(gathered, idx: list):
    """Rows ``idx`` (worker indices, in order) of every tensor field of a
    gathered payload. The rows are taken one by one with Python ints, so no
    index tensor crosses from the host (a CUDA graph can hold the copy)."""
    kw = {}
    for f in dataclasses.fields(gathered):
        v = getattr(gathered, f.name)
        kw[f.name] = (torch.stack([v[int(i)] for i in idx])
                      if isinstance(v, torch.Tensor) else v)
    return type(gathered)(**kw)


def unstack_payload(gathered, w: int):
    """Worker ``w``'s payload out of a gathered one."""
    kw = {}
    for f in dataclasses.fields(gathered):
        v = getattr(gathered, f.name)
        kw[f.name] = v[w] if isinstance(v, torch.Tensor) else v
    return type(gathered)(**kw)


def tensor_nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()
