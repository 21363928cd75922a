"""The data-parallel worker axis (counterpart of ``ewdml_tpu/core/mesh.py``).

The JAX package gets W workers on one host from W devices of a mesh, with
a ``[W, ...]`` worker axis on every state leaf. Here a :class:`LocalWorld`
holds the W workers' replicas in one process on one device, and its
collectives work over the list of per-worker values: ``all_gather`` is a
stack, ``pmean`` a mean over the stack, ``ppermute`` a rotation of the list.
``--num-workers 4`` on one H100 therefore emulates four workers, as the JAX
tests do on CPU devices.

``--num-slices S`` makes the world two-level, as ``build_multislice_mesh``
(``mesh.py:39-53``) makes the mesh ``(dcn, data)``: the W workers are
linearized major to minor, so worker r is slice ``r // (W/S)`` at ICI rank
``r % (W/S)``. Each slice is an ICI sub-world of W/S workers and each ICI
rank a DCN sub-world (a column) of S workers; a sub-world's ``ranks`` are
the level's axis index, which the collectives fold into their keys as
``jax.lax.axis_index`` does inside ``shard_map``. Everything per worker
(the batch shard, the dropout stream, the metrics rows) keeps the linear
rank, as the JAX step does over the axis tuple.

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


def check_slices(size: int, num_slices: int, hint: str = "") -> None:
    """Raise the JAX package's ``ValueError`` (``mesh.py:48-52``) where
    ``num_slices`` does not divide the ``size`` workers."""
    if num_slices < 1:
        raise ValueError(f"--num-slices must be >= 1, got {num_slices}")
    if size % num_slices != 0:
        raise ValueError(
            f"--num-slices {num_slices} does not divide the {size} "
            "available devices; pick a divisor (or set --num-workers to a "
            "multiple of the slice count)" + hint)


def build_world(num_workers, num_slices: int, device) -> "LocalWorld":
    """The trainer's world: ``num_workers`` workers (one per visible device
    when unset) in ``num_slices`` slices."""
    device = torch.device(device)
    size = num_workers or default_num_workers(device)
    if not num_workers:
        # One card gives one worker, which no S > 1 divides.
        check_slices(size, num_slices, hint=(
            f" (with no --num-workers the world is one worker per visible "
            f"device, {size} here; --num-workers W emulates W workers on "
            "one device)"))
    return LocalWorld(size, device, num_slices=num_slices)


class LocalWorld:
    """W workers emulated in one process on one device, in ``num_slices``
    slices of W/S workers (one slice: the flat world)."""

    def __init__(self, size: int, device, num_slices: int = 1,
                 members=None):
        if size < 1:
            raise ValueError(f"world size must be >= 1, got {size}")
        self.size = int(size)
        self.device = torch.device(device)
        check_slices(self.size, int(num_slices))
        self.num_slices = int(num_slices)
        #: The workers of the parent world this one holds, in rank order
        #: (a sub-world's; the world's own ranks for a top-level one).
        self.members = tuple(members) if members is not None \
            else tuple(range(self.size))
        #: Bytes one rank has received over :meth:`ppermute` (every rank of
        #: a ring receives the same amount), summed over calls.
        self.ppermute_bytes = 0

    @property
    def ranks(self) -> range:
        return range(self.size)

    @property
    def slice_size(self) -> int:
        """Workers per slice, W/S."""
        return self.size // self.num_slices

    def coords(self, r: int) -> tuple:
        """Worker r's ``(slice, ICI rank)``, major to minor."""
        return divmod(r, self.slice_size)

    def ici(self, s: int) -> "LocalWorld":
        """Slice s as a world of its W/S workers (the ``data`` axis)."""
        lo = s * self.slice_size
        return LocalWorld(self.slice_size, self.device,
                          members=range(lo, lo + self.slice_size))

    def dcn(self, d: int) -> "LocalWorld":
        """ICI rank d's column as a world of its S workers, one a slice
        (the ``dcn`` axis)."""
        return LocalWorld(self.num_slices, self.device,
                          members=range(d, self.size, self.slice_size))

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
