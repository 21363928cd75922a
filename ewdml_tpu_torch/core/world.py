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

A :class:`ProcessWorld` spreads the W workers over the P processes of a
``torch.distributed`` cluster (``parallel/launcher.py``), L = W / P in
each, with :class:`LocalWorld`'s interface: its ``ranks`` are this
process's global ranks (process p holds ``[p·L, (p+1)·L)``, linear and
major to minor as above), its collectives take the local ranks' values,
and ``all_gather`` returns the global ``[W, ...]`` stack in rank order.
Every process then reduces the same bytes in the same order, so a
P-process run is bit-identical to the emulated W-worker run on the same
device type. ``ppermute`` is the same ring shift over the global ranks:
values stay in place within a process, and each process boundary is one
point-to-point exchange of raw bytes, so the ring transports (``--gather-type
ring|ring_rs``, ``--collective fused_q``) run across processes as the JAX
package's ``shard_map`` runs them over the global mesh.
:func:`place_global` gives a process its rows of a global batch
(``mesh.py:72-96``).
"""

from __future__ import annotations

import dataclasses

import torch


def _tensor_leaves(value) -> list:
    """The tensors of a value in a fixed order: a tensor, a tuple or list
    of values, or a payload dataclass (its tensor fields)."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _tensor_leaves(v)]
    if dataclasses.is_dataclass(value):
        return [getattr(value, f.name) for f in dataclasses.fields(value)
                if isinstance(getattr(value, f.name), torch.Tensor)]
    raise TypeError(f"no tensors in {type(value).__name__}")


def value_nbytes(value) -> int:
    """Bytes of the tensors in a value: a tensor, a tuple or list of them,
    or a payload dataclass (its tensor fields)."""
    from ewdml_tpu_torch.ops.bytes import tensor_nbytes

    return sum(tensor_nbytes(t) for t in _tensor_leaves(value))


def _with_leaves(template, leaves):
    """``template`` with its tensors (in :func:`_tensor_leaves`' order)
    taken from the iterator ``leaves``; its static fields kept."""
    if isinstance(template, torch.Tensor):
        return next(leaves)
    if isinstance(template, (tuple, list)):
        return type(template)(_with_leaves(v, leaves) for v in template)
    return dataclasses.replace(template, **{
        f.name: next(leaves) for f in dataclasses.fields(template)
        if isinstance(getattr(template, f.name), torch.Tensor)})


def _raw_bytes(values: list) -> torch.Tensor:
    """Every tensor of ``values`` as raw bytes, packed into one uint8
    buffer in order."""
    views = [t.detach().contiguous().reshape(-1).view(torch.uint8)
             for v in values for t in _tensor_leaves(v)]
    return torch.cat(views) if len(views) > 1 else views[0]


def _from_raw_bytes(flat: torch.Tensor, template, count: int,
                    device) -> list:
    """``count`` values shaped as ``template`` from the bytes of
    :func:`_raw_bytes`, on ``device``."""
    flat = flat.to(device)
    specs = [(t.dtype, tuple(t.shape), t.element_size(), t.numel())
             for t in _tensor_leaves(template)]
    out, off = [], 0
    for _ in range(count):
        leaves = []
        for dtype, shape, size, numel in specs:
            part = flat[off:off + size * numel]
            if off % size:
                part = part.clone()   # a view of another dtype needs alignment
            leaves.append(part.view(dtype).reshape(shape))
            off += size * numel
        out.append(_with_leaves(template, iter(leaves)))
    return out


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
    if dev.type == "cuda" and dev.index is None:
        from ewdml_tpu_torch.parallel import launcher

        # A process of a cluster drives the card the launcher gave it.
        if launcher.device_index() is not None:
            dev = torch.device("cuda", launcher.device_index())
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


def build_world(num_workers, num_slices: int, device):
    """The trainer's world: ``num_workers`` workers (one per visible device
    when unset) in ``num_slices`` slices. In a ``torch.distributed``
    cluster (``parallel/launcher.py``) a :class:`ProcessWorld`, where
    ``num_workers`` is the global count (one per process when unset), as
    ``cfg.num_workers`` is the global mesh size in JAX (``mesh.py:25-34``)."""
    from ewdml_tpu_torch.parallel import launcher

    device = torch.device(device)
    if launcher.is_initialized():
        return ProcessWorld(num_workers or launcher.process_count(), device,
                            num_slices=num_slices)
    size = num_workers or default_num_workers(device)
    if not num_workers:
        # One card gives one worker, which no S > 1 divides.
        check_slices(size, num_slices, hint=(
            f" (with no --num-workers the world is one worker per visible "
            f"device, {size} here; --num-workers W emulates W workers on "
            "one device)"))
    return LocalWorld(size, device, num_slices=num_slices)


def place_global(world, host_array) -> torch.Tensor:
    """This process's rows of a global batch (``mesh.py:72-96``) on the
    world's device: the whole array on a :class:`LocalWorld`, rows
    ``[p·L·B, (p+1)·L·B)`` of a :class:`ProcessWorld`'s process p. Every
    process holds the same global host array, the data stream being
    seed-synchronized (``distributed_nn.py:75-85``)."""
    import numpy as np

    rows = np.asarray(host_array)
    if isinstance(world, ProcessWorld):
        per = rows.shape[0] // world.size
        lo = world.ranks[0] * per
        rows = rows[lo:lo + per * len(world.ranks)]
    t = torch.from_numpy(np.ascontiguousarray(rows))
    if world.device.type == "cuda":
        t = t.pin_memory()
    return t.to(world.device, non_blocking=True)


class LocalWorld:
    """W workers emulated in one process on one device, in ``num_slices``
    slices of W/S workers (one slice: the flat world)."""

    #: Whether the exchange stages through host memory (a gloo
    #: :class:`ProcessWorld`): then no CUDA graph can capture a step, and
    #: no collective may be issued from autograd's hooks.
    host_staged = False

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
    def local_members(self) -> tuple:
        """The parent world's ranks of this process's workers: all of
        them."""
        return self.members

    @property
    def slices(self) -> range:
        """The slices this process holds workers of: all of them."""
        return range(self.num_slices)

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

    def gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """The ``[W, ...]`` rows of every worker from this process's
        ``[L, ...]`` (here L = W: the rows themselves)."""
        return rows


@dataclasses.dataclass(frozen=True)
class ProcessLayout:
    """Where the W workers and S slices of a world lie over P processes:
    process p holds the L = W / P workers ``[p·L, (p+1)·L)``. With S > 1
    either every process holds whole slices (``ici_groups`` empty: each
    slice's exchange stays in its process) or every slice spans whole
    processes, k = (W/S) / L of them (``ici_groups[s]``, the processes of
    slice s; ``dcn_groups[q]``, the processes at position q of their
    slice, one a slice). The JAX pod shape (slice s = process s) is the
    first."""

    size: int
    num_slices: int
    process_index: int
    process_count: int

    @property
    def local(self) -> int:
        return self.size // self.process_count

    @property
    def ranks(self) -> range:
        lo = self.process_index * self.local
        return range(lo, lo + self.local)

    @property
    def slice_size(self) -> int:
        return self.size // self.num_slices

    @property
    def per_slice(self) -> int:
        """Processes a slice spans (1 where a process holds whole slices)."""
        return max(1, self.slice_size // self.local)

    @property
    def slices(self) -> range:
        """The slices this process holds workers of."""
        first = self.ranks[0] // self.slice_size
        last = self.ranks[-1] // self.slice_size
        return range(first, last + 1)

    @property
    def ici_groups(self) -> tuple:
        k = self.per_slice
        if k == 1 or self.num_slices == 1:
            return ()
        return tuple(tuple(range(s * k, (s + 1) * k))
                     for s in range(self.num_slices))

    @property
    def dcn_groups(self) -> tuple:
        k = self.per_slice
        if k == 1 or self.num_slices == 1:
            return ()
        return tuple(tuple(s * k + q for s in range(self.num_slices))
                     for q in range(k))


def process_layout(size: int, num_slices: int, process_index: int,
                   process_count: int) -> ProcessLayout:
    """The :class:`ProcessLayout` of W = ``size`` workers in
    ``num_slices`` slices over ``process_count`` processes, or a
    ``ValueError`` naming what does not divide."""
    if size % process_count != 0:
        raise ValueError(
            f"--num-workers {size} is not a multiple of the {process_count} "
            "processes: every process holds W / P workers (--num-workers is "
            "the global count)")
    check_slices(size, num_slices)
    layout = ProcessLayout(size, num_slices, process_index, process_count)
    if layout.local % layout.slice_size and layout.slice_size % layout.local:
        raise ValueError(
            f"--num-slices {num_slices} over {size} workers in "
            f"{process_count} processes: a slice of {layout.slice_size} "
            f"workers neither lies whole in a process of {layout.local} "
            "workers nor spans whole processes; pick S so that every "
            "process holds whole slices or every slice whole processes")
    return layout


class ProcessWorld:
    """The W workers of a ``torch.distributed`` cluster, L = W / P in this
    process, behind :class:`LocalWorld`'s interface.

    ``ranks`` are this process's ranks (the level's axis index on a
    sub-world), ``all_gather`` takes their values and returns the
    ``[W, ...]`` stack in rank order. Each gather moves every tensor field
    as raw bytes, packed into one buffer: NCCL gathers device tensors with
    ``all_gather_into_tensor``; gloo's is staged through host memory, one
    copy to the host and one back a gather. ``gather_bytes`` counts the
    bytes this process has put into the gathers of its exchange,
    ``sent_bytes`` those its ring shifts (:meth:`ppermute`) sent to other
    processes. Use
    :func:`build_world`, which builds the top-level world; its sub-worlds
    (:meth:`ici`, :meth:`dcn`) share its counters. The process groups of
    both levels are made once, here, every one on every process in one
    order (``new_group`` is collective over the whole cluster)."""

    def __init__(self, size: int, device, num_slices: int = 1):
        import torch.distributed as dist

        from ewdml_tpu_torch.parallel import launcher

        self.device = torch.device(device)
        self.ppermute_bytes = 0
        self.gather_bytes = 0
        self.sent_bytes = 0
        self.layout = process_layout(int(size), int(num_slices),
                                     launcher.process_index(),
                                     launcher.process_count())
        self._root = self
        self.size = self.layout.size
        self.num_slices = self.layout.num_slices
        self._ranks = self.layout.ranks
        self.group = None
        self.group_size = self.layout.process_count
        self._procs = tuple(range(self.group_size))
        self.members = tuple(range(self.size))
        self._local_members = tuple(self._ranks)
        #: gloo takes CPU tensors only: every collective stages through
        #: host memory (:attr:`LocalWorld.host_staged`); NCCL's do not.
        self.host_staged = dist.get_backend() != "nccl"
        self._ici_groups = [dist.new_group(list(g))
                            for g in self.layout.ici_groups]
        self._dcn_groups = [dist.new_group(list(g))
                            for g in self.layout.dcn_groups]

    def _sub(self, size: int, ranks, group, procs, members,
             local_members) -> "ProcessWorld":
        """A one-level sub-world of ``size`` workers over ``group`` (None:
        every process), whose processes are ``procs`` (global process
        ranks, in the group's order), this process holding ``ranks`` of
        them (the parent's ``local_members``); it counts into this world's
        ``gather_bytes`` and ``sent_bytes``."""
        sub = ProcessWorld.__new__(ProcessWorld)
        sub.device, sub.ppermute_bytes = self.device, 0
        sub.gather_bytes = sub.sent_bytes = 0
        sub._root, sub.size, sub.num_slices = self, size, 1
        sub._ranks, sub.group, sub.group_size = ranks, group, len(procs)
        sub._procs = tuple(procs)
        sub.members, sub._local_members = tuple(members), tuple(local_members)
        sub.host_staged = self.host_staged
        return sub

    @property
    def ranks(self) -> range:
        return self._ranks

    @property
    def local_members(self) -> tuple:
        """The parent world's ranks of this process's workers."""
        return self._local_members

    @property
    def slices(self) -> range:
        return self.layout.slices if self._root is self \
            else range(self.num_slices)

    @property
    def slice_size(self) -> int:
        return self.size // self.num_slices

    def coords(self, r: int) -> tuple:
        return divmod(r, self.slice_size)

    def ici(self, s: int):
        """Slice s as a world of its W/S workers: a :class:`LocalWorld`
        where it lies in this process, else a world over its processes'
        group (which must hold this process)."""
        lay = self.layout
        lo = s * lay.slice_size
        members = range(lo, lo + lay.slice_size)
        if lay.per_slice == 1:
            if s not in lay.slices:
                raise ValueError(f"slice {s} is not held by process "
                                 f"{lay.process_index}")
            return LocalWorld(lay.slice_size, self.device, members=members)
        if s != lay.slices[0]:
            raise ValueError(f"slice {s} does not span process "
                             f"{lay.process_index}")
        q = lay.process_index % lay.per_slice
        return self._sub(lay.slice_size,
                         range(q * lay.local, (q + 1) * lay.local),
                         self._ici_groups[s], lay.ici_groups[s], members,
                         self.ranks)

    def dcn(self, d: int):
        """ICI rank d's column as a world of its S workers, one a slice:
        over every process where each holds whole slices, else over the
        processes at d's position in their slices (which must hold this
        process). Its ranks are the slices this process holds."""
        lay = self.layout
        members = range(d, self.size, lay.slice_size)
        if lay.per_slice == 1:
            ranks = lay.slices
            return self._sub(self.num_slices, ranks, None,
                             range(lay.process_count), members,
                             [s * lay.slice_size + d for s in ranks])
        q = lay.process_index % lay.per_slice
        if d // lay.local != q:
            raise ValueError(f"ICI rank {d} is not held by process "
                             f"{lay.process_index}")
        s = lay.slices[0]
        return self._sub(self.num_slices, range(s, s + 1),
                         self._dcn_groups[q], lay.dcn_groups[q], members,
                         [s * lay.slice_size + d])

    # -- the exchange ------------------------------------------------------
    def _gather_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """``[group_size, n]`` uint8: every process's ``flat`` (n bytes)."""
        import torch.distributed as dist

        n = flat.numel()
        if not self.host_staged:
            flat = flat.to(self.device)
            out = torch.empty(self.group_size * n, dtype=torch.uint8,
                              device=self.device)
            dist.all_gather_into_tensor(out, flat, group=self.group)
        else:
            host = flat.cpu()
            parts = [torch.empty_like(host) for _ in range(self.group_size)]
            dist.all_gather(parts, host, group=self.group)
            out = torch.cat(parts).to(self.device)
        return out.reshape(self.group_size, n)

    def _gather_tensors(self, tensors: list, count: bool) -> list:
        """Each ``[L, ...]`` tensor as the ``[W, ...]`` stack of every
        process's, in one gather of their raw bytes."""
        flat = _raw_bytes(tensors)
        if count:
            self._root.gather_bytes += flat.numel()
        out = self._gather_flat(flat)
        res, off = [], 0
        for t in tensors:
            nb = t.numel() * t.element_size()
            part = out[:, off:off + nb].contiguous().view(t.dtype)
            res.append(part.reshape((-1,) + tuple(t.shape[1:])))
            off += nb
        return res

    def all_gather(self, values: list):
        """``[W, ...]`` stack of one value per worker from this process's
        values (its ranks'), field by field for a payload."""
        if isinstance(values[0], torch.Tensor):
            return self._gather_tensors([torch.stack(values)], True)[0]
        from ewdml_tpu_torch.ops.bytes import stack_payloads

        local = stack_payloads(values)
        gathered = self._gather_tensors(_tensor_leaves(local), True)
        return _with_leaves(local, iter(gathered))

    def gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """The ``[W, ...]`` rows of every worker from this process's
        ``[L, ...]`` (metrics, checkpoint leaves: not counted)."""
        return self._gather_tensors([rows], False)[0]

    def gather_rows_of(self, tensors: list) -> list:
        """:meth:`gather_rows` of several ``[L, ...]`` tensors in one
        gather (not counted)."""
        return self._gather_tensors(tensors, False)

    def pmean(self, values: list) -> torch.Tensor:
        """The gathered ``[W, ...]`` stack's ``sum(dim=0) / W``, as
        :meth:`LocalWorld.pmean` sums it: every process adds the same bytes
        in the same order."""
        return self.all_gather(values).sum(dim=0) / self.size

    def ppermute(self, values: list, shift: int = 1) -> list:
        """The ring shift ``perm = [(r, (r + shift) % W)]`` over the
        world's global ranks, as :meth:`LocalWorld.ppermute`: receiver r
        gets sender ``(r - shift) % W``'s value, a payload whole.

        ``values`` are this process's ranks' values, all of one structure.
        A value whose sender and receiver are both here moves in place.
        The others cross in one batch of point-to-point operations: one
        buffer to each peer process and one from each, every tensor packed
        as raw bytes as the gathers pack them, every send and receive of
        the batch posted together, so that no order of posts deadlocks.
        NCCL moves the device buffers; gloo's (which takes CPU tensors
        only) are staged through host memory. ``ppermute_bytes`` counts
        what one rank received, as on a :class:`LocalWorld`;
        ``sent_bytes`` the bytes this process sent to other processes."""
        import torch.distributed as dist

        w, ranks = self.size, self.ranks
        n, lo = len(ranks), self.ranks[0]
        per_value = value_nbytes(values[0])
        self.ppermute_bytes += per_value
        out = [None] * n
        sends, recvs = {}, {}   # peer position -> local indices, in order
        for j, r in enumerate(ranks):
            src, dst = (r - shift) % w, (r + shift) % w
            if lo <= src < lo + n:
                out[j] = values[src - lo]
            else:
                recvs.setdefault(src // n, []).append(j)
            if not lo <= dst < lo + n:
                sends.setdefault(dst // n, []).append(j)
        if not sends and not recvs:
            return out
        stage = (torch.device("cpu") if self.host_staged
                 else self.device)
        ops, incoming = [], []
        for pos, js in sends.items():
            flat = _raw_bytes([values[j] for j in js]).to(stage)
            self._root.sent_bytes += flat.numel()
            ops.append(dist.P2POp(dist.isend, flat, self._procs[pos],
                                  group=self.group))
        for pos, js in recvs.items():
            buf = torch.empty(per_value * len(js), dtype=torch.uint8,
                              device=stage)
            incoming.append((js, buf))
            ops.append(dist.P2POp(dist.irecv, buf, self._procs[pos],
                                  group=self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for js, buf in incoming:
            for j, v in zip(js, _from_raw_bytes(buf, values[0], len(js),
                                                self.device)):
                out[j] = v
        return out
