"""The data-parallel worker axis (counterpart of ``ewdml_tpu/core/mesh.py``).

The JAX package gets W workers on one host from W devices of a mesh, with
a ``[W, ...]`` worker axis on every state leaf. Here a :class:`LocalWorld`
holds the W workers' replicas in one process on one device, and its
collectives work over the list of per-worker values: ``all_gather`` is a
stack, ``pmean`` a mean over the stack. ``--num-workers 4`` on one H100
therefore emulates four workers, as the JAX tests do on CPU devices.

A ``torch.distributed`` world across several GPUs is a later slice.
"""

from __future__ import annotations

import torch


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

    def pmean(self, values: list) -> torch.Tensor:
        """The mean over workers (psum, then divide by W), the same value
        handed to every worker."""
        return torch.stack(values).sum(dim=0) / self.size
