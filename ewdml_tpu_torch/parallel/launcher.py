"""Multi-process launch (``ewdml_tpu/parallel/launcher.py``).

The reference launched one OS process per rank and joined them with
``dist.init_process_group('gloo')`` (``distributed_nn.py:81``); the JAX
package joins its processes with ``jax.distributed.initialize``. Here
:func:`initialize` joins them with ``torch.distributed.init_process_group``,
and the trainer's world (``core/world.ProcessWorld``) spreads the W workers
over them, L = W / P in each.

Where the address comes from, in order:

- the arguments (``"host:port"``, or a URL such as ``"file:///tmp/rdzv"``);
- ``EWDML_INIT_METHOD`` (a URL) with ``RANK`` and ``WORLD_SIZE``;
- torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``.

With none of them :func:`initialize` is a no-op, as the JAX one is on a
single host. The backend is ``nccl`` on CUDA and ``gloo`` on the CPU unless
the caller (or ``EWDML_DIST_BACKEND``) names one; on CUDA each process
drives ``cuda:{LOCAL_RANK % device_count}``. NCCL puts at most one rank on
a card, so :func:`resolve_backend` refuses it where more processes share a
host than it has cards: ``backend="gloo"`` runs them on one card.

    torchrun --nproc-per-node 2 -m ewdml_tpu_torch.cli --platform cpu \\
        --network LeNet --dataset mnist10k --num-workers 4 --method 4
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger("ewdml_tpu_torch.launcher")

#: Seconds a collective (and the rendezvous) waits before it fails.
TIMEOUT_S = 300
INIT_METHOD_ENV = "EWDML_INIT_METHOD"
BACKEND_ENV = "EWDML_DIST_BACKEND"

_device_index = None  # the card this process drives, once initialized


def resolve_backend(device_type: str, backend: str | None = None,
                    local_processes: int = 1, device_count: int = 0) -> str:
    """The process group's backend: ``backend`` if given, else ``nccl``
    on CUDA and ``gloo`` on the CPU. Raises where NCCL cannot run:
    on the CPU, or with more processes on this host than it has cards."""
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl | gloo)")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("backend 'nccl' needs CUDA devices; a CPU run "
                             'uses backend="gloo"')
        if local_processes > device_count:
            raise RuntimeError(
                f"{local_processes} processes share this host's "
                f"{device_count} CUDA device(s), and NCCL puts at most one "
                'rank on a card: pass backend="gloo" (EWDML_DIST_BACKEND='
                "gloo) to run several processes on one card")
    return backend


def _init_method(coordinator_address: str | None) -> str | None:
    if coordinator_address:
        return (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    if os.environ.get(INIT_METHOD_ENV):
        return os.environ[INIT_METHOD_ENV]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return "env://"
    return None


def _env_int(name: str, given: int | None) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f"a multi-process run needs {name} (set by "
                         "torchrun, or by hand with the rendezvous address)")
    return int(os.environ[name])


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               platform: str | None = None) -> dict:
    """Join this process to the cluster (a no-op on a single host, or when
    already joined). ``platform`` is the run's (``cpu`` or ``cuda``, the
    default). Returns the JAX launcher's summary keys."""
    global _device_index
    method = _init_method(coordinator_address)
    if not dist.is_initialized() and (method or num_processes is not None):
        from ewdml_tpu_torch.core.world import resolve_device

        if method is None:
            raise ValueError("num_processes needs a coordinator address")
        world_size = _env_int("WORLD_SIZE", num_processes)
        rank = _env_int("RANK", process_id)
        device_type = resolve_device(platform).type
        count = torch.cuda.device_count() if device_type == "cuda" else 0
        backend = resolve_backend(
            device_type, backend or os.environ.get(BACKEND_ENV),
            int(os.environ.get("LOCAL_WORLD_SIZE", world_size)), count)
        if device_type == "cuda":
            _device_index = local_rank(rank) % count
            torch.cuda.set_device(_device_index)
        dist.init_process_group(
            backend, init_method=method, world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    info = {"process_index": process_index(),
            "process_count": process_count(),
            # Each process drives one device.
            "local_devices": 1,
            "global_devices": process_count()}
    logger.info("launcher: %s", info)
    return info


def shutdown() -> None:
    """Leave the cluster (a no-op when not joined)."""
    global _device_index
    if dist.is_initialized():
        dist.destroy_process_group()
    _device_index = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank(rank: int | None = None) -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``; the
    global rank where the cluster was started by hand on one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_index() if rank is None else rank


def device_index() -> int | None:
    """The card this process drives, or None (the CPU, or not joined)."""
    return _device_index if is_initialized() else None


def backend() -> str | None:
    return dist.get_backend() if is_initialized() else None


def is_coordinator() -> bool:
    """Rank-0 duties (checkpoint writing, logging): the master-process
    role (``distributed_nn.py:123``) reduced to a predicate."""
    return process_index() == 0
