"""Horovod-style API (``ewdml_tpu/hvd/__init__.py``).

The reference's second distributed substrate (``horvod_pytorch.py:119-205``,
``horovod_compression.py``, ``tensorflow_mnist.py``): ``init``, ``size``,
``rank``, ``broadcast_parameters``, a metric ``allreduce``, and a
``DistributedOptimizer`` that puts a compressed allreduce in front of an
explicit-gradient optimizer, so reference scripts translate line for line.

The worker axis is the port's :class:`~ewdml_tpu_torch.core.world.LocalWorld`:
``init(num_workers)`` takes a world of W workers emulated on one device (as
``--num-workers`` does), :func:`size` is its W, and
:meth:`DistributedOptimizer.update` takes the W per-worker gradient lists
that the JAX package's ``update`` sees one rank at a time inside
``shard_map``. Keys fold per (rank, leaf) exactly as there.

The reference's Horovod QSGD allreduce *averaged the integer levels* and
decompressed them with each rank's own norm, an approximation (SURVEY.md
§3.3). ``DistributedOptimizer(quirk_average_levels=True)`` reproduces it;
the ranks' results then differ, so the port returns one result per rank.
The default decompresses, then averages.
"""

from __future__ import annotations

import torch

from ewdml_tpu_torch.core.world import (LocalWorld, default_num_workers,
                                        resolve_device)
from ewdml_tpu_torch.models.convert import from_jax
from ewdml_tpu_torch.ops import qsgd as qsgd_ops
from ewdml_tpu_torch.optim import update_accepts_key
from ewdml_tpu_torch.parallel import collectives, launcher
from ewdml_tpu_torch.utils import prng

#: The inner optimizer's key tag (``hvd/__init__.py:175``): its bf16 stores
#: draw from ``fold_in(key, 0x0917)``, apart from the exchange's chain.
OPT_TAG = 0x0917

_world: LocalWorld | None = None


def init(num_workers: int | None = None,
         platform: str | None = None) -> LocalWorld:
    """``hvd.init()`` (reference ``horvod_pytorch.py:125``): the world of
    ``num_workers`` workers on the card (``platform='cpu'`` for the CPU);
    by default one worker per visible GPU."""
    global _world
    dev = resolve_device(platform)
    _world = LocalWorld(num_workers or default_num_workers(dev), dev)
    return _world


def world() -> LocalWorld:
    """The world :func:`init` made (made with the defaults on first use)."""
    return _world if _world is not None else init()


def size() -> int:
    """World size W (``hvd.size()``, the lr scaling at
    ``horvod_pytorch.py:173``)."""
    return world().size


def rank() -> int:
    """The controller's rank: this process's index in a
    ``torch.distributed`` cluster (``parallel/launcher.py``), else 0 (one
    process drives every worker)."""
    return launcher.process_index()


def local_rank() -> int:
    """This process's index on its host (0 outside a cluster)."""
    return launcher.local_rank() if launcher.is_initialized() else 0


def broadcast_parameters(params, root_rank: int = 0):
    """``hvd.broadcast_parameters`` (``horvod_pytorch.py:187``): every
    worker's replica is made from one host copy, so this is the identity,
    kept for script parity."""
    del root_rank
    return params


broadcast_optimizer_state = broadcast_parameters


def allreduce(value, average: bool = True):
    """Metric averaging (``metric_average``, ``horvod_pytorch.py:84-87``):
    a list of W per-worker values is reduced (mean, or sum); a single
    value is already global and comes back as it is."""
    if not isinstance(value, (list, tuple)):
        return value
    total = torch.stack([torch.as_tensor(v) for v in value]).sum(dim=0)
    return total / len(value) if average else total


class Compression:
    """Namespace parity with ``horovod.torch.compression``."""

    @staticmethod
    def none():
        from ewdml_tpu_torch.ops import make_compressor
        return make_compressor("none")

    @staticmethod
    def qsgd(quantum_num: int = 127):
        from ewdml_tpu_torch.ops import make_compressor
        return make_compressor("qsgd", quantum_num=quantum_num)

    @staticmethod
    def topk_qsgd(ratio: float = 0.01, quantum_num: int = 127, exact=None):
        """The Method-5 stack through the horovod-style API (the
        reference's plugin shipped QSGD only); large leaves take the
        structured block wire where ``ops/topk.resolve_mode`` picks it."""
        from ewdml_tpu_torch.ops import make_compressor
        return make_compressor("topk_qsgd", quantum_num=quantum_num,
                               topk_ratio=ratio, topk_exact=exact)


class DistributedOptimizer:
    """An explicit-gradient optimizer behind a compressed allreduce: the
    ``hvd.DistributedOptimizer(opt, compression=..., op=...,
    gradient_predivide_factor=...)`` surface (``horvod_pytorch.py:197-201``).

    :meth:`update` compresses every worker's gradients, exchanges and
    reduces them, then takes the inner optimizer's step."""

    def __init__(self, optimizer, compressor=None, op: str = "Average",
                 gradient_predivide_factor: float = 1.0,
                 quirk_average_levels: bool = False,
                 world: LocalWorld | None = None):
        if op not in ("Average", "Adasum", "Sum"):
            raise ValueError(f"unknown op {op!r}")
        self.optimizer = optimizer
        self.compressor = compressor
        self.op = op
        self.predivide = gradient_predivide_factor
        self.quirk = quirk_average_levels
        self._world = world
        # Only an inner optimizer that declares the seeded-rounding key
        # (the port's SGD and Adam) is given one; a foreign optimizer is
        # called as update(grads, state, params, lr=lr), as in the JAX
        # package.
        self._inner_takes_key = update_accepts_key(optimizer)

    @property
    def world(self) -> LocalWorld:
        return self._world if self._world is not None else world()

    def init(self, params):
        return self.optimizer.init(params)

    def exchange(self, grads: list, key) -> list:
        """The reduced gradients of every rank, ``out[r]``, from ``grads[r]``,
        rank r's leaves (``hvd/__init__.py:132``). ``key`` is the step key.
        Where the ranks agree (every op but the quirk) ``out`` holds one
        list W times."""
        w = self.world
        if self.predivide != 1.0:
            grads = [[g / self.predivide for g in gs] for gs in grads]
        if self.compressor is None:
            out = collectives.dense_allreduce_mean(w, grads)
            if self.op == "Sum":
                out = [g * w.size for g in out]
            return [out] * w.size
        if self.quirk:
            return _quirk_average_levels(w, grads, self.compressor, key)
        if self.op == "Adasum":
            return [_adasum(w, grads, self.compressor, key)] * w.size
        return [collectives.compressed_allreduce(w, grads, self.compressor,
                                                 key)] * w.size

    def update(self, grads: list, state, params, key=None, lr=None,
               kinds=None) -> list:
        """One step: reduce ``grads`` (``grads[r]``, rank r's leaves in the
        JAX layout) and apply them in place.

        ``params``/``state`` are rank r's replica at ``params[r]`` and
        ``state[r]``, W of them; where the ranks agree and ``params`` holds
        one replica W times, the step is taken once. ``kinds`` (from
        ``models/convert.leaf_specs``) names each leaf's layout when the
        parameters are held in PyTorch's: the reduced gradients move there
        before the step. ``key`` defaults to ``key(0)``, as the JAX
        package's; the inner optimizer's bf16 stores draw from
        ``fold_in(key, 0x0917)`` (none without a key). Returns the reduced
        gradients, one list per rank."""
        reduced = self.exchange(
            # ewdml: allow[prng] -- documented fallback for the keyless
            # optax-style update() protocol; determinism-minded callers
            # pass their own key
            grads, prng.key(0) if key is None else key)
        okey = None if key is None else prng.fold_in(key, OPT_TAG)
        done = []
        for r, red in enumerate(reduced):
            if any(red is d_red and params[r] is d_p for d_red, d_p in done):
                continue
            done.append((red, params[r]))
            g = red if kinds is None else [from_jax(x, k)
                                           for x, k in zip(red, kinds)]
            if self._inner_takes_key:
                self.optimizer.update(g, state[r], params[r], key=okey,
                                      kinds=kinds, lr=lr)
            else:
                self.optimizer.update(g, state[r], params[r], lr=lr)
        return reduced

    def synchronize(self):
        """``optimizer.synchronize()`` (``horvod_pytorch.py:73``): the
        exchange finishes inside :meth:`update`; nothing to wait for."""
        return None


def _quirk_average_levels(world: LocalWorld, grads: list, compressor,
                          key) -> list:
    """The reference's math (``horovod_compression.py`` with Horovod's
    average): the ranks' integer levels are averaged, and each rank
    rescales the mean by its own norm."""
    out = [[] for _ in world.ranks]
    for i in range(len(grads[0])):
        pays = [compressor.compress(prng.layer_key(prng.rank_key(key, r), i),
                                    grads[r][i]) for r in world.ranks]
        n = grads[0][i].numel()
        mean_levels = world.pmean([
            qsgd_ops.levels_as_float(p.levels, p.s, n, p.packed)
            for p in pays])
        for r, p in enumerate(pays):
            out[r].append(qsgd_ops.scale_levels(mean_levels, p.norm, p.s,
                                                p.block, n).reshape(p.shape))
    return out


def _adasum(world: LocalWorld, grads: list, compressor, key) -> list:
    """Adasum (``horvod_pytorch.py:200``): the scale-insensitive pairwise
    combination a ⊕ b = (1 - a·b / (2|b|²)) b + (1 - a·b / (2|a|²)) a,
    folded in rank order over the decompressed per-rank gradients."""
    out = []
    for i in range(len(grads[0])):
        dec = [compressor.decompress(compressor.compress(
            prng.layer_key(prng.rank_key(key, r), i), grads[r][i]))
            for r in world.ranks]
        acc = dec[0]
        for b in dec[1:]:
            dot = torch.vdot(acc.reshape(-1), b.reshape(-1))
            na = torch.vdot(acc.reshape(-1), acc.reshape(-1))
            nb = torch.vdot(b.reshape(-1), b.reshape(-1))
            acc = ((1 - dot / torch.clamp(2 * nb, min=1e-30)) * b
                   + (1 - dot / torch.clamp(2 * na, min=1e-30)) * acc)
        out.append(acc)
    return out
