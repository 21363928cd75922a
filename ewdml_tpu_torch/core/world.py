"""The data-parallel worker axis (counterpart of ``ewdml_tpu/core/mesh.py``).

The JAX package gets W workers on one host from W devices of a mesh, with
a ``[W, ...]`` worker axis on every state leaf. Here a :class:`LocalWorld`
holds the W workers' replicas in one process on one device, and its
collectives work over the list of per-worker values: ``all_gather`` is a
stack, ``pmean`` a mean over the stack, ``ppermute`` a rotation of the list.
``--num-workers 4`` on one H100 therefore emulates four workers, as the JAX
tests do on CPU devices.

A ``torch.distributed`` world across several GPUs is a later slice.
"""

from __future__ import annotations

import dataclasses

import torch


def value_nbytes(value) -> int:
    """Bytes of the tensors in a value: a tensor, a tuple or list of them,
    or a payload dataclass (its tensor fields)."""
    from ewdml_tpu_torch.ops.bytes import tensor_nbytes

    if isinstance(value, torch.Tensor):
        return tensor_nbytes(value)
    if isinstance(value, (tuple, list)):
        return sum(value_nbytes(v) for v in value)
    if dataclasses.is_dataclass(value):
        return sum(value_nbytes(getattr(value, f.name))
                   for f in dataclasses.fields(value)
                   if isinstance(getattr(value, f.name), torch.Tensor))
    raise TypeError(f"no byte count for {type(value).__name__}")


def resolve_device(platform: str | None = None, device=None) -> torch.device:
    """The device a run uses: CUDA unless the caller asks for the CPU.

    A CUDA run with no GPU present raises; it never continues on the CPU."""
    if device is not None:
        dev = torch.device(device)
    elif platform is None or platform.lower() in ("cuda", "gpu"):
        dev = torch.device("cuda")
    elif platform.lower() == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unknown platform {platform!r} (cpu | cuda)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA run was requested but no GPU is visible; "
                           "pass --platform cpu to run on the CPU")
    return dev


def default_num_workers(device: torch.device) -> int:
    """One worker per visible device: the GPU count, or 1 on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


class LocalWorld:
    """W workers emulated in one process on one device."""

    def __init__(self, size: int, device):
        if size < 1:
            raise ValueError(f"world size must be >= 1, got {size}")
        self.size = int(size)
        self.device = torch.device(device)
        #: Bytes one rank has received over :meth:`ppermute` (every rank of
        #: a ring receives the same amount), summed over calls.
        self.ppermute_bytes = 0

    @property
    def ranks(self) -> range:
        return range(self.size)

    def all_gather(self, values: list):
        """``[W, ...]`` stack of one value per worker. A payload (a
        dataclass of tensors and static metadata) is gathered field by
        field."""
        if isinstance(values[0], torch.Tensor):
            return torch.stack(values)
        from ewdml_tpu_torch.ops.bytes import stack_payloads
        return stack_payloads(values)

    def ppermute(self, values: list, shift: int = 1) -> list:
        """The ring shift ``perm = [(r, (r + shift) % W)]``: receiver r gets
        sender ``(r - shift) % W``'s value. A payload moves whole, all of
        its fields together, as ``jax.lax.ppermute`` moves a pytree."""
        self.ppermute_bytes += value_nbytes(values[0])
        return [values[(r - shift) % self.size] for r in self.ranks]

    def pmean(self, values: list) -> torch.Tensor:
        """The mean over workers (psum, then divide by W), the same value
        handed to every worker."""
        return torch.stack(values).sum(dim=0) / self.size
