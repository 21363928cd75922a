"""The client pool: shared local-SGD machinery over private shards
(``ewdml_tpu/federated/client.py``).

A registered client is data, not a thread: its shard's index array and a
key derived from the seed. The model, the gradient function
(``parallel/ps.make_grad_fn``) and the compressor are built once, so a pool
of a thousand clients costs a partition table and only the sampled cohort
computes.

Per sampled client round: unpack the pulled weights onto the device, run
``local_steps`` steps of plain SGD (``p - lr * g`` in f32) on batches of
the client's own shard, form the pseudo-gradient ``(w_pulled - w_local) /
lr`` (the sum of the local gradients, which the server's SGD apply at the
same ``lr`` turns back into the FedAvg mean-delta update), compress it and
pack it with one copy to the host. Clients keep no optimizer state, and
every round starts from the initial BatchNorm statistics; in train mode
BatchNorm normalizes with the batch's statistics, so the running ones
never reach a pseudo-gradient.

``make_grad_fn`` loads the parameters into a module and updates its
buffers in place, so each concurrent client (``thread_batch``) takes a
module copy of its own from a free list.
"""

from __future__ import annotations

import copy
import threading

import numpy as np
import torch

from ewdml_tpu_torch.data import partition as dpart
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.utils import prng, transfer


class ClientPool:
    """Shared machinery and per-client shards for one federated run.
    ``setup`` is the run's ``parallel/ps_net.EndpointSetup``."""

    def __init__(self, cfg, ds, setup):
        self.cfg = cfg
        self.ds = ds
        self.device = setup.device
        self.shards = dpart.partition_indices(
            ds.labels, cfg.pool_size, cfg.partition, cfg.seed,
            alpha=cfg.partition_alpha)
        self.skew = dpart.skew_stat(ds.labels, self.shards, ds.num_classes)
        self._model = setup.model
        self._buffers0 = {name: b.detach().clone()
                          for name, b in setup.model.named_buffers()}
        self._free: list = []          # module copies not in use
        self._free_lock = threading.Lock()
        self._grad_fn = setup.grad_fn
        self._compress_tree = setup.compress_tree
        self._pack = transfer.make_device_packer()
        self._unpack = transfer.make_device_unpacker(setup.params)
        self._base_key = prng.key(cfg.seed)
        self._lr = kernels.f32_scalar(cfg.lr)

    def unpack_params(self, buf: np.ndarray) -> list:
        buf = np.ascontiguousarray(buf)
        if not buf.flags.writeable:  # torch.from_numpy needs a writable one
            buf = buf.copy()
        return self._unpack(torch.from_numpy(buf).to(self.device))

    def _take_module(self) -> torch.nn.Module:
        """A module copy no other client uses, its BatchNorm statistics
        reset to the initial ones."""
        with self._free_lock:
            module = self._free.pop() if self._free else None
        if module is None:
            module = copy.deepcopy(self._model)
        with torch.no_grad():
            for name, b in module.named_buffers():
                b.copy_(self._buffers0[name])
        return module

    def _batches(self, client: int, round_idx: int):
        """``local_steps`` batches of the client's shard, drawn from numpy
        at ``[seed, 0xDA7A, client, round]``; a shard smaller than a batch
        is sampled with replacement."""
        cfg = self.cfg
        shard = self.shards[client]
        rng = np.random.default_rng(
            [cfg.seed & 0x7FFFFFFF, 0xDA7A, int(client), int(round_idx)])
        for _ in range(cfg.local_steps):
            idx = rng.choice(shard, size=cfg.batch_size,
                             replace=len(shard) < cfg.batch_size)
            yield self.ds.images[idx], self.ds.labels[idx]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def run_client_round(self, client: int, params_buf: np.ndarray,
                         round_idx: int) -> tuple[np.ndarray, float]:
        """One sampled client's round: ``(packed payload buffer, mean local
        loss)``, the buffer on the push schema, ready for
        ``native.encode_arrays``."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        w0 = self.unpack_params(params_buf)
        ckey = prng.fold_in(self._base_key, int(client))
        lr = self._lr
        module = self._take_module()
        try:
            w, losses = w0, []
            for t, (x, y) in enumerate(self._batches(client, round_idx)):
                k = prng.step_key(ckey, round_idx * self.cfg.local_steps + t)
                loss, grads = self._grad_fn(module, w, self._to_device(x),
                                            self._to_device(y), k)
                with torch.no_grad():
                    w = [p - lr * g for p, g in zip(w, grads)]
                losses.append(loss)
        finally:
            with self._free_lock:
                self._free.append(module)
        with torch.no_grad():
            # (w0 - w)/lr: the sum of the local gradients along the
            # client's path, the unit the scale contract is sized for.
            grads = [(a - b) / lr for a, b in zip(w0, w)]
            if self._compress_tree is not None:
                # A key stream apart from the local steps' (those fold
                # round * local_steps + t, far below 10**9).
                payloads = self._compress_tree(
                    grads, prng.step_key(ckey, 10**9 + round_idx))
            else:
                payloads = grads
            buf = self._pack(payloads).cpu().numpy()  # one D2H
        return buf, float(np.mean([float(l) for l in losses]))
