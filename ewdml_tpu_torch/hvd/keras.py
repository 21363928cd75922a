"""Keras-style high-level API (``ewdml_tpu/hvd/keras.py``): the reference's
TF/Keras Horovod entry (``tensorflow_mnist.py:1-79``) as a ``Model`` with
``compile``/``fit``/``evaluate``, Horovod's callback set, rank-0 weight
files and lr × world scaling, on a port ``nn.Module`` and the world of
:func:`ewdml_tpu_torch.hvd.init`.

``fit`` runs the JAX package's ``shard_map``-ed step over the W workers of
the world: one replica of the parameters, worker r's forward and backward
on its contiguous shard of the global batch with dropout key
``fold_in(step_key, r)``, the gradients exchanged through
``hvd.DistributedOptimizer`` in the JAX tree's leaf order and layout, one
optimizer step, and the workers' mean loss and accuracy. As the JAX step's
``out_specs=P()`` keeps rank 0's shard, the BatchNorm statistics after a
step are rank 0's (its own batch's update, not a mean over the ranks).

The module's initial weights are its own (``build_model(..., seed=...)``);
:meth:`Model.load_weights` of a JAX ``save_weights`` file starts it where a
JAX ``Model`` starts. Weight files are ``.npz`` archives keyed by the JAX
tree's ``keystr`` paths in Flax layout, so either package reads the
other's.
"""

from __future__ import annotations

import copy
import logging
from typing import Optional, Sequence

import numpy as np
import torch

from ewdml_tpu_torch import hvd
from ewdml_tpu_torch.hvd import DistributedOptimizer
from ewdml_tpu_torch.models.convert import (from_jax, leaf_specs,
                                            torch_to_flax, to_jax)
from ewdml_tpu_torch.train.state import _stat_buffers, leaf_params
from ewdml_tpu_torch.train.trainer import cross_entropy, has_dropout
from ewdml_tpu_torch.utils import prng

logger = logging.getLogger("ewdml_tpu_torch.hvd.keras")


class History:
    """``model.fit``'s return value (keras parity)."""

    def __init__(self):
        self.history: dict[str, list] = {}

    def append(self, logs: dict):
        for k, v in logs.items():
            self.history.setdefault(k, []).append(v)


class Callback:
    """The keras/horovod callback protocol (the subset the reference used,
    ``tensorflow_mnist.py:52-72``)."""

    model: "Model" = None

    def on_train_begin(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass


class BroadcastGlobalVariablesCallback(Callback):
    """``hvd.callbacks.BroadcastGlobalVariablesCallback(0)``
    (``tensorflow_mnist.py:55``): one replica serves every worker, so the
    broadcast is the identity (as ``hvd.broadcast_parameters``)."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank


class MetricAverageCallback(Callback):
    """``hvd.callbacks.MetricAverageCallback`` (``tensorflow_mnist.py:62``):
    the epoch metrics are already means over the workers."""


class LearningRateWarmupCallback(Callback):
    """``hvd.callbacks.LearningRateWarmupCallback(warmup_epochs, verbose)``
    (``tensorflow_mnist.py:65-68``): the lr ramps linearly from
    ``lr / world`` to ``lr`` over the first ``warmup_epochs`` epochs."""

    def __init__(self, warmup_epochs: int = 5, verbose: int = 0):
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        world = self.model.world.size
        if epoch >= self.warmup_epochs or world == 1:
            mult = 1.0
        else:
            start = 1.0 / world
            mult = start + (1.0 - start) * (epoch + 1) / self.warmup_epochs
        self.model.lr_multiplier = mult
        if self.verbose:
            logger.info("epoch %d: warmup lr multiplier %.4f", epoch, mult)


class ModelCheckpoint(Callback):
    """Rank 0's weight file each epoch (``tensorflow_mnist.py:71-72``:
    ``ModelCheckpoint('./checkpoint-{epoch}.h5')`` on rank 0)."""

    def __init__(self, filepath: str = "./checkpoint-{epoch}.npz"):
        self.filepath = filepath

    def on_epoch_end(self, epoch, logs=None):
        if hvd.rank() == 0:
            self.model.save_weights(self.filepath.format(epoch=epoch))


def _keystr(flax_path: str) -> str:
    """``jax.tree_util.keystr`` of a nested-dict path (``conv1/kernel`` ->
    ``['conv1']['kernel']``): the weight files' keys."""
    return "".join(f"[{part!r}]" for part in flax_path.split("/"))


class Model:
    """Keras surface over a port ``nn.Module`` on the world's W workers.

    ``input_shape`` (H, W, C) is the JAX ``Model``'s, kept for parity: the
    module is already built. ``seed`` seeds the shuffle and the step keys;
    ``world`` defaults to :func:`ewdml_tpu_torch.hvd.world`."""

    def __init__(self, module: torch.nn.Module, input_shape: tuple,
                 seed: int = 0, world=None):
        self.world = world if world is not None else hvd.world()
        del input_shape
        self.module = module.to(self.world.device)
        self.specs = leaf_specs(self.module)
        self.kinds = [s.kind for s in self.specs]
        self.seed = seed
        self.lr_multiplier = 1.0
        self.optimizer = None

    @property
    def params(self) -> dict:
        """The parameters as the JAX ``Model`` holds them: nested dicts of
        numpy arrays in Flax layout."""
        return torch_to_flax(self.module)[0]

    @property
    def batch_stats(self) -> dict:
        """The BatchNorm statistics in Flax layout ({} without BN)."""
        return torch_to_flax(self.module)[1]

    def compile(self, optimizer, compression=None, scale_lr: bool = True,
                op: str = "Average"):
        """``hvd.DistributedOptimizer(...)`` with lr × size
        (``tensorflow_mnist.py:38-42``; ``scale_lr=False`` keeps the lr).
        The caller's optimizer is copied, never changed: a second compile
        or a shared instance does not compound the factor."""
        self._base_lr = optimizer.lr * (self.world.size if scale_lr else 1)
        self.optimizer = DistributedOptimizer(copy.copy(optimizer),
                                              compressor=compression, op=op,
                                              world=self.world)
        self.opt_state = self.optimizer.init(
            leaf_params(self.module, self.specs))
        return self

    def _step(self, x: torch.Tensor, y: torch.Tensor, key, lr: float):
        """One data-parallel step on the global batch; returns the workers'
        mean (loss, accuracy) as tensors."""
        world, module = self.world, self.module
        params = leaf_params(module, self.specs)
        stats = [b for _, b in _stat_buffers(module)]
        start = [b.clone() for b in stats]
        rank0 = start
        dropout = has_dropout(module)
        per = x.shape[0] // world.size
        grads, losses, accs = [], [], []
        for r in world.ranks:
            if r and stats:
                for b, s in zip(stats, start):
                    b.copy_(s)
            xr, yr = x[r * per:(r + 1) * per], y[r * per:(r + 1) * per]
            gen = (prng.generator(prng.fold_in(key, r), world.device)
                   if dropout else None)
            module.zero_grad(set_to_none=True)
            logits = module(xr, train=True, generator=gen).float()
            loss = cross_entropy(logits, yr)
            loss.backward()
            grads.append([to_jax(p.grad, k)
                          for p, k in zip(params, self.kinds)])
            losses.append(loss.detach())
            accs.append((logits.detach().argmax(1) == yr).float().mean())
            if r == 0 and stats:
                rank0 = [b.clone() for b in stats]
        w = world.size
        with torch.no_grad():
            for b, s in zip(stats, rank0):
                b.copy_(s)
            self.optimizer.update(grads, [self.opt_state] * w, [params] * w,
                                  key=key, lr=lr, kinds=self.kinds)
        return (torch.stack(losses).sum() / w, torch.stack(accs).sum() / w)

    def fit(self, images: np.ndarray, labels: np.ndarray, *,
            batch_size: int = 64, epochs: int = 1,
            callbacks: Sequence[Callback] = (), verbose: int = 1,
            seed: Optional[int] = None) -> History:
        assert self.optimizer is not None, "call compile() first"
        for cb in callbacks:
            cb.model = self
        history = History()
        rng = np.random.RandomState(self.seed if seed is None else seed)
        global_batch = batch_size * self.world.size
        if len(images) < global_batch:
            raise ValueError(
                f"dataset of {len(images)} examples is smaller than one "
                f"global batch ({batch_size} x {self.world.size} workers); "
                "reduce batch_size")
        key = prng.key(self.seed)
        device = self.world.device
        for cb in callbacks:
            cb.on_train_begin()
        step = 0
        for epoch in range(epochs):
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            order = rng.permutation(len(images))
            losses, accs = [], []
            for s in range(len(images) // global_batch):
                idx = order[s * global_batch:(s + 1) * global_batch]
                x = torch.from_numpy(np.ascontiguousarray(images[idx])).to(
                    device)
                y = torch.from_numpy(labels[idx].astype(np.int64)).to(device)
                loss, acc = self._step(x, y, prng.step_key(key, step),
                                       self._base_lr * self.lr_multiplier)
                losses.append(float(loss))
                accs.append(float(acc))
                step += 1
            logs = {"loss": float(np.mean(losses)),
                    "accuracy": float(np.mean(accs))}
            history.append(logs)
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs)
            if verbose:
                logger.info("epoch %d/%d: %s", epoch + 1, epochs, logs)
        return history

    @torch.no_grad()
    def evaluate(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int = 500) -> dict:
        """Mean loss and top-1 over the split; the tail batch is padded to
        ``batch_size`` and masked, as in the JAX package."""
        device = self.world.device
        total, loss_sum, acc_sum = 0, 0.0, 0.0
        for s in range(0, len(images), batch_size):
            x = images[s:s + batch_size]
            y = labels[s:s + batch_size].astype(np.int64)
            valid = len(x)
            if valid < batch_size:
                pad = batch_size - valid
                x = np.concatenate([x, np.zeros((pad,) + x.shape[1:],
                                                x.dtype)])
                y = np.concatenate([y, np.zeros((pad,), y.dtype)])
            yt = torch.from_numpy(y).to(device)
            logits = self.module(torch.from_numpy(
                np.ascontiguousarray(x)).to(device), train=False).float()
            logp = torch.log_softmax(logits, dim=-1)
            loss = -logp.gather(1, yt[:, None])[:, 0]
            top1 = (logits.argmax(1) == yt).float()
            loss_sum += float(loss[:valid].sum())
            acc_sum += float(top1[:valid].sum())
            total += valid
        return {"loss": loss_sum / total, "accuracy": acc_sum / total}

    def save_weights(self, path: str):
        """The parameters as an ``.npz`` keyed by the JAX ``keystr`` paths,
        in Flax layout (what the JAX ``Model.save_weights`` writes)."""
        named = dict(self.module.named_parameters())
        arrays = {_keystr(s.name): to_jax(named[s.torch_name].detach(),
                                          s.kind).contiguous().cpu().numpy()
                  for s in self.specs}
        np.savez(path, **arrays)

    @torch.no_grad()
    def load_weights(self, path: str):
        """Load an ``.npz`` of either package's ``save_weights``."""
        data = np.load(path)
        named = dict(self.module.named_parameters())
        for s in self.specs:
            p = named[s.torch_name]
            arr = torch.from_numpy(np.asarray(data[_keystr(s.name)],
                                              np.float32))
            p.copy_(from_jax(arr, s.kind).to(p.device))
