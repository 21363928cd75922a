"""Device-resident input pipeline (``--feed device``;
``ewdml_tpu/data/device_feed.py``).

The whole training split is uploaded to the device once (uint8 where the
dataset has raw pixels) and the step gathers, shuffles and augments its own
batch there, so the host sends no input bytes per step and a step is a pure
function of ``(state.step, key)``:

- **epoch shuffle**: ``jax.random.permutation`` of the example indices,
  keyed by (data key, epoch), recomputed on the device every step;
- **per-worker batch slice**: worker ``w`` reads rows ``[pos·GB + w·B,
  +B)`` of the permutation (``drop_last``), ``pos = step % steps_per_epoch``;
- **augmentation**: pad-4 reflect, random 32×32 crop, horizontal flip, in
  uint8 (reference ``util.py:37-47``).

The draws are the JAX package's bit for bit (``utils/prng``). The batch
start is index arithmetic on the permutation (``arange + start``), so it may
be a 0-d device tensor, as the key table of a captured window gives it.
"""

from __future__ import annotations

import functools

import torch

from ewdml_tpu_torch.utils import prng

# Fold-in tags of the feed's draws. The data key folds DATA_TAG twice: a
# single fold would equal the compressor's step key at step == DATA_TAG.
DATA_TAG = 0xDA7A
AUG_TAG = 0xA06


def data_key(base: tuple) -> tuple:
    """``fold_in(fold_in(base, DATA_TAG), DATA_TAG)``, step-independent."""
    return prng.fold_in(prng.fold_in(base, DATA_TAG), DATA_TAG)


def steps_per_epoch(n: int, per_worker_batch: int, world: int) -> int:
    gb = per_worker_batch * world
    if n // gb < 1:
        raise ValueError(
            f"--feed device needs at least one global batch per epoch: "
            f"dataset has {n} examples < global batch {gb}")
    return n // gb


def epoch_perm(dkey: tuple, epoch: int, n: int, device=None) -> torch.Tensor:
    """The epoch's example permutation, the same on every worker."""
    return prng.permutation(prng.fold_in(dkey, epoch), n, device)


def take_batch(perm: torch.Tensor, start, size: int) -> torch.Tensor:
    """``perm[start : start + size]``; ``start`` an int or a 0-d tensor."""
    idx = torch.arange(size, dtype=torch.int64, device=perm.device) + start
    return perm.index_select(0, idx)


def batch_indices(dkey: tuple, step: int, n: int, per_worker_batch: int,
                  world: int, rank: int, device=None) -> torch.Tensor:
    """Example indices for (step, rank): this worker's shard of the global
    batch at position ``step % steps_per_epoch`` of epoch
    ``step // steps_per_epoch``; the tail ``n % (B·world)`` of each
    permutation is dropped."""
    spe = steps_per_epoch(n, per_worker_batch, world)
    perm = epoch_perm(dkey, step // spe, n, device)
    start = (step % spe) * per_worker_batch * world + rank * per_worker_batch
    return take_batch(perm, start, per_worker_batch)


def _reflect(p: torch.Tensor, size: int) -> torch.Tensor:
    """Index ``p`` of a reflect-padded axis (numpy's ``reflect``: the edge
    is not repeated) as an index of the unpadded axis."""
    p = torch.where(p < 0, -p, p)
    return torch.where(p > size - 1, 2 * (size - 1) - p, p)


def apply_crops(images: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                flips: torch.Tensor) -> torch.Tensor:
    """Pad-4 reflect, crop ``(H, W)`` at ``(ys, xs)`` per image, flip
    horizontally where ``flips``: one gather from the unpadded NHWC batch
    (dtype-preserving). Offsets (4, 4) with no flip are the identity."""
    b, h, w, _ = images.shape
    dev = images.device
    ar_h = torch.arange(h, device=dev)
    ar_w = torch.arange(w, device=dev)
    rows = _reflect(ys.to(torch.int64)[:, None] + ar_h[None, :] - 4, h)
    cols = torch.where(flips[:, None], (w - 1) - ar_w[None, :], ar_w[None, :])
    cols = _reflect(xs.to(torch.int64)[:, None] + cols - 4, w)
    bi = torch.arange(b, device=dev)[:, None, None]
    return images[bi, rows[:, :, None], cols[:, None, :]]


def augment_batch(images: torch.Tensor, key: tuple) -> torch.Tensor:
    """Pad-4 reflect, random crop, random horizontal flip (9 offsets per
    axis, p = 0.5), with the JAX package's draws for ``key``."""
    b = images.shape[0]
    ky, kx, kf = prng.split(key, 3)
    dev = images.device
    return apply_crops(images, prng.randint(ky, (b,), 0, 9, dev),
                       prng.randint(kx, (b,), 0, 9, dev),
                       prng.bernoulli(kf, 0.5, (b,), dev))


def fetch(data: torch.Tensor, labels: torch.Tensor, dkey: tuple, step: int,
          per_worker_batch: int, world: int, rank: int,
          augment: bool) -> tuple:
    """One worker's ``(images, labels)`` for ``step``, gathered from the
    device-resident split; augmentation draws fold (step, rank)."""
    idx = batch_indices(dkey, step, data.shape[0], per_worker_batch, world,
                        rank, data.device)
    images = data.index_select(0, idx)
    if augment:
        akey = prng.fold_in(prng.fold_in(prng.fold_in(dkey, AUG_TAG), step),
                            rank)
        images = augment_batch(images, akey)
    return images, labels.index_select(0, idx)


class DeviceFeed:
    """The batches of the workers ``ranks`` (default: all ``world``) for
    one step, from a key source (``utils/keytable``): :func:`fetch` for
    each rank, with the epoch key, each rank's start and the augmentation
    key taken from the source, and the permutation computed once for all
    of them. A process of a ``torch.distributed`` world passes its own
    global ranks and holds the whole split."""

    def __init__(self, base: tuple, n: int, per_worker_batch: int,
                 world: int, augment: bool, ranks=None):
        self.dkey = data_key(base)
        self.n, self.batch, self.world = n, per_worker_batch, world
        self.ranks = tuple(range(world) if ranks is None else ranks)
        self.spe = steps_per_epoch(n, per_worker_batch, world)
        self.augment = augment
        self._aug_key = prng.fold_in(self.dkey, AUG_TAG)
        self._starts = [functools.partial(self._start, r) for r in self.ranks]

    def _epoch_key(self, step: int) -> tuple:
        return prng.fold_in(self.dkey, step // self.spe)

    def _start(self, rank: int, step: int) -> int:
        return ((step % self.spe) * self.batch * self.world
                + rank * self.batch)

    def _aug_step_key(self, step: int) -> tuple:
        return prng.fold_in(self._aug_key, step)

    def batches(self, data: torch.Tensor, labels: torch.Tensor, step: int,
                keys) -> list:
        """``[(images, labels)]`` per rank of ``ranks`` for ``step``."""
        perm = prng.permutation(keys.key(self._epoch_key, step), self.n,
                                data.device)
        out = []
        for r, start in zip(self.ranks, self._starts):
            idx = take_batch(perm, keys.scalar(start, step), self.batch)
            images = data.index_select(0, idx)
            if self.augment:
                akey = prng.fold_in(keys.key(self._aug_step_key, step), r)
                images = augment_batch(images, akey)
            out.append((images, labels.index_select(0, idx)))
        return out
