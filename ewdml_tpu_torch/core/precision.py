"""The precision policy: one dtype contract for gradient-shaped bytes
(``ewdml_tpu/core/precision.py``).

==================  =========  ==========  ===========
policy              wire       opt state   weights
==================  =========  ==========  ===========
``f32`` (default)   f32        f32         f32
``bf16_wire``       bf16       f32         f32
``bf16_wire_state``  bf16      bf16        f32
==================  =========  ==========  ===========

"wire" is everything that moves or holds gradient-shaped data: the dense
all-reduce payload (``parallel.collectives.dense_allreduce_mean``), the
error-feedback residuals and the dense push frames of the parameter
server. "opt state" is SGD's momentum and Adam's moments, stored bf16 with
seeded *stochastic* rounding (:func:`stochastic_round`), so the EMA stays
unbiased: round-to-nearest at bf16's 8 mantissa bits drops every
``(1 - b) * g`` increment below half an ulp of the buffer.

Weights stay f32 under every policy: the reference's negative result is
that lossy weights prevent convergence (``--lossy-weights-down``
reproduces it on purpose). bf16 is a storage and wire format here, never
an arithmetic one: every sum runs in f32.

On the card the store is one hand-written kernel
(``ops/kernels.stochastic_round_set``), which draws the JAX package's
threefry bits for each element in registers, one launch for a whole store
set (:func:`tree_store_round`: every leaf an optimizer update stores, or
every residual of a step); elsewhere its plain version runs, bit for bit
the same.
"""

from __future__ import annotations

import dataclasses

import torch

#: The accepted ``--precision-policy`` values, narrowest last.
POLICIES = ("f32", "bf16_wire", "bf16_wire_state")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """The resolved dtype contract of one run (module docstring)."""

    name: str

    @property
    def bf16_wire(self) -> bool:
        return self.name in ("bf16_wire", "bf16_wire_state")

    @property
    def bf16_state(self) -> bool:
        return self.name == "bf16_wire_state"

    @property
    def wire_dtype(self) -> torch.dtype:
        """Storage dtype of dense gradient payloads and EF residuals."""
        return torch.bfloat16 if self.bf16_wire else torch.float32

    @property
    def state_dtype(self) -> torch.dtype:
        """Storage dtype of the optimizer's momentum and moment buffers."""
        return torch.bfloat16 if self.bf16_state else torch.float32

    @property
    def wire_itemsize(self) -> int:
        """Bytes per element on the dense gradient wire."""
        return 2 if self.bf16_wire else 4


def resolve_policy(name: str | None) -> PrecisionPolicy:
    """Validate and freeze a ``--precision-policy`` value."""
    name = (name or "f32").lower()
    if name not in POLICIES:
        raise ValueError(
            f"unknown precision policy {name!r}; choose from {POLICIES}")
    return PrecisionPolicy(name)


def stochastic_round(key, x: torch.Tensor, kind: str = "vector",
                     out=None) -> torch.Tensor:
    """Unbiased stochastic rounding f32 -> bf16 under ``key``: the f32 bits
    plus a uniform 16-bit dither, truncated to the upper half; a
    non-finite element takes the plain cast. ``x`` is a leaf of ``kind`` in
    PyTorch's layout (``models/convert``): the dither of each element is the
    one the JAX package draws at its index in the JAX layout. ``out``
    (bf16, ``x``'s shape) receives the result where given.

    Dispatched as the kernels are (``ops/kernels.active``): the CUDA kernel
    for a CUDA tensor, the plain version on the CPU and under ``--pallas
    off`` or ``interpret``."""
    from ewdml_tpu_torch.ops import kernels

    x = x.to(torch.float32)
    if kernels.active(x.device) == "kernel":
        return kernels.stochastic_round_bf16(x, key, kind, out)
    return kernels.stochastic_round_ref(x, key, kind, out)


def store_round(key, x: torch.Tensor, dtype: torch.dtype,
                kind: str = "vector", out=None) -> torch.Tensor:
    """Store ``x`` at ``dtype``: an f32 target takes ``x`` as it is; a bf16
    target rounds stochastically under ``key``, or to nearest even with no
    key (a caller outside the seeded training step). ``out`` as for
    :func:`stochastic_round` (then also written for the other two cases)."""
    if dtype != torch.bfloat16:
        res = x
    elif key is None:
        res = x.to(torch.bfloat16)
    else:
        return stochastic_round(key, x, kind, out)
    if out is not None:
        out.copy_(res)
        return out
    return res


def round_set(key, xs: list, paths: list, kinds=None, outs=None) -> list:
    """:func:`stochastic_round` of a store set: leaf ``i`` under the key its
    fold-in path ``paths[i]`` derives from ``key``. Dispatched as
    :func:`stochastic_round`: on CUDA the kernel (one launch for up to
    ``kernels.ROUND_MAX_LEAVES`` leaves, each leaf's key derived there),
    else the plain version leaf by leaf."""
    from ewdml_tpu_torch.ops import kernels

    xs = [x.to(torch.float32) for x in xs]
    if xs and kernels.active(xs[0].device) == "kernel":
        return kernels.stochastic_round_set(key, xs, paths, kinds, outs)
    return kernels.stochastic_round_set_ref(key, xs, paths, kinds, outs)


def tree_store_round(key, leaves: list, like: list, kinds=None, outs=None,
                     paths=None) -> list:
    """:func:`store_round` of each leaf at the dtype of the matching
    ``like`` leaf, leaf ``i`` under the key its fold-in path ``paths[i]``
    derives from ``key`` (default ``(i,)``: ``prng.layer_key(key, i)``, the
    one keying convention of seeded bf16 stores). The leaves that round
    (bf16, under a key) are stored as one set (:func:`round_set`).
    ``kinds`` (default: every leaf in the JAX layout) and ``outs`` per
    leaf."""
    n = len(leaves)
    kinds = kinds or ["vector"] * n
    outs = outs or [None] * n
    paths = paths or [(i,) for i in range(n)]
    res = [None] * n
    rounded = []
    for i, (x, l) in enumerate(zip(leaves, like)):
        if key is not None and l.dtype == torch.bfloat16:
            rounded.append(i)
        else:
            res[i] = store_round(None, x, l.dtype, kinds[i], outs[i])
    if rounded:
        got = round_set(key, [leaves[i] for i in rounded],
                        [paths[i] for i in rounded],
                        [kinds[i] for i in rounded],
                        [outs[i] for i in rounded])
        for i, r in zip(rounded, got):
            res[i] = r
    return res


def wire_cast(leaves: list, wire_dtype: torch.dtype = torch.bfloat16) -> list:
    """The wire's view of a gradient or parameter list: f32 leaves narrow to
    ``wire_dtype``, every other dtype passes through (one definition for
    the dense collective and the parameter server's push frames)."""
    if wire_dtype == torch.float32:
        return list(leaves)
    return [x.to(wire_dtype) if x.dtype == torch.float32 else x
            for x in leaves]
