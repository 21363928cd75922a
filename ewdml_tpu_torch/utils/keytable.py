"""Where a training step takes its step-dependent keys and scalars.

The JAX package runs a window of K steps as one ``lax.scan``: the keys and
the feed's batch position derive from ``state.step`` inside the program.
On the GPU the window is one CUDA graph, which replays fixed kernel
arguments; so everything a step derives from its step number must come
from device memory. Every such value is a pure function of the step (and
of constants: the base key, a rank, a unit, a hop, a tag), and the host
computes it.

- :class:`HostKeys` hands the step those values as host constants: the
  per-step dispatch, where the Python step runs every step.
- :class:`KeyTable` records, while the step runs once (a graph capture, or
  a window on the CPU), which values it took and how each derives from
  its step, and hands out views of a device buffer instead. Before each
  replay :meth:`KeyTable.load` derives every value again for the window's
  first step and copies the table to the device in one transfer.

Keys handed out by a table are :class:`~ewdml_tpu_torch.utils.prng.Key`
tuples: their words are the host values, and the draws they feed
(``prng.seed_tensor``, ``prng.key_words``, ``prng.generator``) take
theirs from the table.
"""

from __future__ import annotations

import numpy as np
import torch

from ewdml_tpu_torch.utils import prng


class HostKeys:
    """The step's keys and scalars as host values (the per-step path)."""

    def __init__(self, base: tuple):
        self.base = tuple(base)

    def step_key(self, step: int) -> tuple:
        return prng.step_key(self.base, step)

    def key(self, fn, step: int) -> tuple:
        return fn(step)

    def scalar(self, fn, step: int) -> int:
        return fn(step)


class KeyTable:
    """The keys, murmur seeds, scalars and dropout generators of one
    window of steps, held in a device buffer.

    ``start`` is the window's first step. A value is recorded as a slot with
    its path: ``(fn, j)`` is ``fn(start + j)``, and each further element a
    ``fold_in``. On the CPU (no graph) the device buffer is written as each
    slot is recorded; on CUDA it is written by :meth:`load`, which the
    capture of the window precedes. ``generators`` are the
    ``torch.Generator`` objects a graph registered for the dropout streams,
    handed out in request order and seeded in :meth:`load`.
    """

    def __init__(self, base: tuple, device, start: int, capacity: int = 1 << 16,
                 generators=()):
        self.base = tuple(base)
        self.device = torch.device(device)
        self.start = int(start)
        self._immediate = self.device.type != "cuda"
        self._seed_host = np.zeros(capacity, np.int32)
        self._int_host = np.zeros(capacity, np.int64)
        self._seeds = torch.zeros(capacity, dtype=torch.int32, device=self.device)
        self._ints = torch.zeros(capacity, dtype=torch.int64, device=self.device)
        self._pool = list(generators)
        self._seed_paths, self._int_paths, self._gen_paths = [], [], []
        self._step_fn = self._step_words

    def _step_words(self, step: int) -> tuple:
        return prng.step_key(self.base, step)

    # -- what the step asks for ------------------------------------------------

    def step_key(self, step: int) -> prng.Key:
        return self.key(self._step_fn, step)

    def key(self, fn, step: int) -> prng.Key:
        """``fn(step)`` (a key's words) as a key bound to this table."""
        return prng.Key(fn(step), self, (fn, step - self.start))

    def scalar(self, fn, step: int) -> torch.Tensor:
        """``fn(step)`` (an int64) as a 0-d view of the device buffer."""
        i = self._take_ints(((fn, step - self.start), None))
        self._write_int(i, fn(step))
        return self._ints[i]

    def seed(self, k: prng.Key) -> torch.Tensor:
        """The murmur seed of ``k`` as an int32 ``[1]`` view."""
        i = len(self._seed_paths)
        if i >= len(self._seed_host):
            raise RuntimeError(f"key table full: more than {i} seeds")
        self._seed_paths.append(k.path)
        v = prng.seed_from_key(k)
        self._seed_host[i] = v
        if self._immediate:
            self._seeds[i] = v
        return self._seeds[i:i + 1]

    def words(self, k: prng.Key) -> tuple:
        """The two words of ``k`` as 0-d int64 views."""
        i = self._take_ints((k.path, 0))
        self._take_ints((k.path, 1))
        self._write_int(i, k[0])
        self._write_int(i + 1, k[1])
        return self._ints[i], self._ints[i + 1]

    def packed(self, k: prng.Key) -> torch.Tensor:
        """The words of ``k`` packed into one int64 (``prng.packed_key``)
        as an int64 ``[1]`` view."""
        i = self._take_ints((k.path, "packed"))
        self._write_int(i, prng.packed_key(k))
        return self._ints[i:i + 1]

    def generator(self, k: prng.Key) -> torch.Generator:
        """A dropout stream seeded from ``k``: on the CPU a new generator,
        on CUDA the next registered one (seeded by :meth:`load`)."""
        if self._immediate:
            return prng.generator(tuple(k), self.device)
        i = len(self._gen_paths)
        if i >= len(self._pool):
            raise RuntimeError(f"key table has {len(self._pool)} registered "
                               "generators; the step asked for more")
        self._gen_paths.append(k.path)
        return self._pool[i]

    def _take_ints(self, path) -> int:
        i = len(self._int_paths)
        if i >= len(self._int_host):
            raise RuntimeError(f"key table full: more than {i} int64 slots")
        self._int_paths.append(path)
        return i

    def _write_int(self, i: int, v: int) -> None:
        self._int_host[i] = v
        if self._immediate:
            self._ints[i] = v

    # -- a later window --------------------------------------------------------

    def _derive(self, path, memo: dict):
        v = memo.get(path)
        if v is None:
            if len(path) == 2:
                fn, j = path
                v = fn(self.start + j)
            else:
                v = prng.fold_in(tuple(self._derive(path[:-1], memo)), path[-1])
            memo[path] = v
        return v

    def load(self, start: int) -> None:
        """Derive every recorded value for a window that starts at
        ``start``, copy the table to the device (on the current stream,
        after the work already queued there), and seed the generators."""
        self.start = int(start)
        memo = {}
        for i, path in enumerate(self._seed_paths):
            self._seed_host[i] = prng.seed_from_key(self._derive(path, memo))
        for i, (path, word) in enumerate(self._int_paths):
            v = self._derive(path, memo)
            if word == "packed":
                v = prng.packed_key(v)
            elif word is not None:
                v = v[word]
            self._int_host[i] = v
        for gen, path in zip(self._pool, self._gen_paths):
            k = self._derive(path, memo)
            gen.manual_seed((k[0] << 32) | k[1])
        n_seeds, n_ints = len(self._seed_paths), len(self._int_paths)
        # Pageable sources: the copy is staged before the call returns, so
        # the host buffer may be refilled for the next window at once.
        if n_seeds:
            self._seeds[:n_seeds].copy_(
                torch.from_numpy(self._seed_host[:n_seeds]), non_blocking=True)
        if n_ints:
            self._ints[:n_ints].copy_(
                torch.from_numpy(self._int_host[:n_ints]), non_blocking=True)

    def values(self) -> dict:
        """The host side of the table (for tests): seeds, int64 slots."""
        return dict(seeds=self._seed_host[:len(self._seed_paths)].copy(),
                    ints=self._int_host[:len(self._int_paths)].copy())
