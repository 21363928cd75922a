"""The compression kernels of the training step, with their dispatch.

Counterpart of ``ewdml_tpu/ops/pallas_kernels.py``. All seven of its
Pallas kernels are ported here as CUDA kernels for Hopper
(``ewdml_tpu_torch/kernels/compress.cu``, and ``decode.cu`` for the
decode): five on the sync trainer's paths, two in the parameter server's
compressed-domain apply. Two more
have no Pallas counterpart and draw the JAX package's threefry bits (XLA
code there), so their bound is their operations (20 threefry rounds an
element), not their bytes: ``stochastic_round_set`` (``kernels/
precision.cu``), the precision policy's seeded bf16 store
(``ewdml_tpu/core/precision.py:87``), one launch a store set; and
``random_bits`` (``kernels/random.cu``), ``jax.random.bits`` and
``uniform`` (``ewdml_tpu/ops/qsgd.py:122,230``, the device feed's
permutation, crops and flips), one launch a draw.

=========================  =========================  ======================
wrapper                    replaces                   bound on the H100
=========================  =========================  ======================
``qsgd_quantize``          ``pallas_kernels.py:169``  5n bytes
``dequant_mean``           ``pallas_kernels.py:232``  (W + 4)n bytes
``block_top1``             ``pallas_kernels.py:290``  4RC + 8C bytes
``chunk_encode``           ``pallas_kernels.py:431``  5n + 4nb bytes
``dequant_acc_requant``    ``pallas_kernels.py:479``  6n + 8nb bytes
``int_accumulate``         ``pallas_kernels.py:587``  (K + 4)n bytes
``acc_decode_set``         ``pallas_kernels.py:629``  8n bytes a leaf
``stochastic_round_set``   ``precision.py:87``        77n operations
``random_bits``            ``qsgd.py:122,230``        75n operations
=========================  =========================  ======================

The first seven move bytes and do a few operations per byte, so HBM
bandwidth bounds them; each streams its input once and keeps nothing in device memory
between the read and the write. At the shapes the training paths give
them the bound is a few microseconds, less than one launch takes, so a
kernel's time there is the latency of its chain: ``block_top1`` has every
row of a column in flight at once (32 columns by 8 row slices per thread
block); ``chunk_encode`` at every size, and the hop on a chunk of at most
two blocks per SM, draw their random bits while their loads are in flight
and spread each block over a cluster of two thread blocks (a larger hop
keeps one thread block per block, which fills the card). ``qsgd_quantize``
keeps 64 warps on every SM, so the murmur hash (~25 instructions an
element, half the byte time at the instruction rate) runs while other warps'
loads are in flight; it takes within a microsecond of a pass that moves
the same bytes with no arithmetic. ``dequant_mean`` and ``int_accumulate``
share one worker-axis reduce: a warp owns 512 elements, each lane loads its
four words of every row before the first add (the row count is a template
parameter up to 8) and stores whole-warp ``uint4``; rows that start off a
4-byte boundary are realigned in registers, and the grid is one resident
wave. ``chunk_encode`` and
``dequant_acc_requant`` are the per-hop passes of the ring transports
(``--collective fused_q``, ``--gather-type ring_rs``); ``int_accumulate``
and ``acc_decode_set`` sum K same-contract int8 payloads and decode the
sum once per round (``--mode async --server-agg homomorphic``): the decode
takes every quantized leaf of an apply in one launch (up to 448 leaves,
their descriptors in the kernel's parameters), so an apply pays one
decode launch where it paid one per large leaf and three plain ops per
small one; ``acc_decode`` is a set of one.

Each wrapper has a plain PyTorch version beside it (``*_ref``) that repeats
the kernel's arithmetic in the same rounding order. A wrapper given a CPU
tensor runs the plain version; given a CUDA tensor it launches the kernel or
raises. ``LAUNCHES`` counts kernel launches per wrapper, and
:func:`kernel_bytes` tallies the bytes they read and write.

Dispatch mirrors ``pallas_kernels.active``/``active_for``, with two
choices kept apart: which random stream quantizes (the murmur stream of the
kernels, or ``jax.random``'s threefry stream, ``utils/prng.uniform``) and
which implementation runs it.

- ``auto``: on CUDA the kernels (murmur stream) at ``n >= MIN_ELEMS`` and
  the threefry path below; on the CPU threefry everywhere (the JAX
  package's CPU behaviour, where no kernel is available).
- ``on``: the CUDA kernels at every size; raises on the CPU.
- ``interpret``: the murmur stream at every size through the plain
  versions (the CPU twin of JAX's ``--pallas interpret``).
- ``off``: threefry and plain PyTorch everywhere.

The two ring kernels have no threefry variant and no size gate: the ring
transports call :func:`active` (not :func:`active_for`), as the JAX package
does, and take the kernel on CUDA at every size in ``auto``/``on`` and the
plain version on the CPU or under ``off``/``interpret``.

The server-apply pair draws no random bits; :func:`accumulate` and
:func:`decode_sum` dispatch it as ``pallas_kernels`` does when no
``interpret`` flag is given: the kernel where :func:`active_for` picks it
(and, for the decode, the scale is per tensor or its block a multiple of
4096), the plain version elsewhere. The apply's decode,
:meth:`DecodeSet.decode`, takes the kernel on CUDA under 'auto' and 'on'
at every size (one launch costs the same whatever the leaf count, and the
kernel is bit-equal to the plain version, so ``MIN_ELEMS`` gates nothing
there) and raises for a block the kernel does not take.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from ewdml_tpu_torch.ops.bytes import tensor_nbytes

_LANES = 128
_BLOCK = 32 * _LANES

#: Element count of the fused-collective quantization block (the int8 tile
#: of the TPU kernels): one f32 scale per this many int8 levels.
BLOCK_ELEMS = _BLOCK

# Below this element count the threefry path is used in 'auto' mode, as the
# JAX package does below its kernel launch gate (pallas_kernels.py:73).
MIN_ELEMS = 1 << 17

_MODE = "auto"  # auto | on | interpret | off

#: Kernel launches per wrapper (CUDA only; the plain versions never count).
LAUNCHES = {"qsgd_quantize": 0, "dequant_mean": 0, "block_top1": 0,
            "chunk_encode": 0, "dequant_acc_requant": 0, "int_accumulate": 0,
            "acc_decode": 0, "stochastic_round": 0, "random_bits": 0}
#: Leaves decoded on a CUDA tensor by the plain version
#: (:func:`acc_decode_ref`): none on the main path, which decodes every leaf
#: in the set kernel; a ``ps_net`` server's ``stats`` reply reports both.
PLAIN_DECODES_ON_CARD = {"acc_decode": 0}
# The parameter server's worker threads launch kernels concurrently.
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        PLAIN_DECODES_ON_CARD["acc_decode"] = 0


def add_launches(counts: dict) -> None:
    """Count the launches a CUDA graph replay makes: the wrappers count
    while a window is captured, the window takes those counts back out
    (nothing launched then), and adds them again at every replay."""
    with _launch_lock:
        for k, v in counts.items():
            LAUNCHES[k] += v


#: The byte tallies open in :func:`kernel_bytes` (``flops.count_bytes``).
_byte_tallies: list = []


@dataclasses.dataclass
class ByteTally:
    """Bytes the kernels read and wrote while a tally was open."""

    nbytes: int = 0


@contextlib.contextmanager
def kernel_bytes():
    """Tally the bytes every kernel launch reads and writes (each operand
    once, each result once: what a bound counts). The kernels are called
    through ``ctypes``, outside the dispatcher that ``flops.count_bytes``
    counts the aten ops in, so each wrapper reports its own."""
    tally = ByteTally()
    with _launch_lock:
        _byte_tallies.append(tally)
    try:
        yield tally
    finally:
        with _launch_lock:
            _byte_tallies.remove(tally)


def _count(name: str, *tensors: torch.Tensor) -> None:
    """Count one launch of ``name``, whose operands and results are
    ``tensors``."""
    with _launch_lock:
        LAUNCHES[name] += 1
        if _byte_tallies:
            nbytes = sum(map(tensor_nbytes, tensors))
            for tally in _byte_tallies:
                tally.nbytes += nbytes


def _count_nbytes(name: str, nbytes: int) -> None:
    """Count one launch of ``name`` that reads and writes ``nbytes``."""
    with _launch_lock:
        LAUNCHES[name] += 1
        for tally in _byte_tallies:
            tally.nbytes += nbytes


def configure(mode: str) -> None:
    """Select the kernel path: 'auto' | 'on' | 'interpret' | 'off'."""
    global _MODE
    if mode not in ("auto", "on", "interpret", "off"):
        raise ValueError(f"unknown kernel mode {mode!r}")
    _MODE = mode


def active(device) -> str | None:
    """``'kernel'`` (the CUDA kernel), ``'plain'`` (the kernel's murmur
    stream through its plain version), or None (the threefry path)."""
    device = torch.device(device)
    if _MODE == "off":
        return None
    if _MODE == "interpret":
        return "plain"
    if _MODE == "on":
        if device.type != "cuda":
            raise RuntimeError("--pallas on needs CUDA tensors; got "
                               f"{device.type}")
        return "kernel"
    return "kernel" if device.type == "cuda" else None


def active_for(n: int, device) -> str | None:
    """:func:`active` plus the ``MIN_ELEMS`` gate, in 'auto' mode only."""
    impl = active(device)
    if impl is not None and _MODE == "auto" and n < MIN_ELEMS:
        return None
    return impl


def blockwise_supported(block) -> bool:
    """Blockwise norms ride the kernels when ``block % 4096 == 0``."""
    return block is not None and block % _BLOCK == 0


def _check_norms(norms_size: int, n: int, block: int) -> None:
    expected = -(-n // block)
    if norms_size != expected:
        raise ValueError(
            f"blockwise norms length {norms_size} does not match "
            f"ceil({n}/{block}) = {expected}")


def f32_scalar(value: float) -> torch.Tensor:
    """``value`` rounded once to f32, as a 0-d CPU tensor. In an op with a
    CUDA tensor it is passed by value: no host-to-device copy, no stream
    synchronisation, and no rounding but the one to f32."""
    return torch.tensor(value, dtype=torch.float32)


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _require_cuda(t: torch.Tensor, name: str, dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


# -- kernel 1: QSGD quantize --------------------------------------------------

def _seed_u32(seed):
    """An int32 seed (a Python int, or a one-element tensor) as its uint32
    value: an int, or a 0-d int64 tensor on the seed's device."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(-1)[0].to(torch.int64) & 0xFFFFFFFF
    return int(seed) & 0xFFFFFFFF


def _seed_arg(seed, device) -> torch.Tensor:
    """The seed as the kernels take it: an int32 ``[1]`` tensor in device
    memory (a Python int is filled into one there, with no host copy)."""
    if not isinstance(seed, torch.Tensor):
        v = int(seed) & 0xFFFFFFFF
        return torch.full((1,), v - (1 << 32) if v >= 1 << 31 else v,
                          dtype=torch.int32, device=device)
    if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != device:
        raise ValueError(f"the seed must be one int32 on {device}, got "
                         f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
    return seed


def uniform_hash(idx: torch.Tensor, seed) -> torch.Tensor:
    """The murmur3-finalizer uniform of ``pallas_kernels._uniform_hash``,
    for int64 flat indices (uint32 arithmetic, masked). ``seed``: an int,
    or an int32 tensor of one element on ``idx``'s device."""
    mask = 0xFFFFFFFF
    x = _mul32(idx & mask, 2654435761) ^ _seed_u32(seed)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for uint32 values in int64, without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _norm_per_element(norms: torch.Tensor, n: int, block) -> torch.Tensor:
    if block is None:
        return norms.reshape(-1)[:1].expand(n)
    idx = torch.arange(n, device=norms.device) // block
    return norms.reshape(-1)[idx]


def quantize_levels(x: torch.Tensor, norm_el: torch.Tensor, u: torch.Tensor,
                    s: int) -> torch.Tensor:
    """``sign(x) * (floor(s/norm * |x|) + [u < frac])`` with zero levels for
    a zero norm, as f32 (the arithmetic of the kernel and of the threefry
    path alike)."""
    safe = torch.where(norm_el == 0.0, torch.ones_like(norm_el), norm_el)
    level_float = (f32_scalar(float(s)) / safe) * x.abs()
    previous = torch.floor(level_float)
    level = previous + (u < (level_float - previous)).to(torch.float32)
    return torch.sign(x) * level


def qsgd_quantize_ref(x: torch.Tensor, norm: torch.Tensor, seed, s: int,
                      *, block=None) -> torch.Tensor:
    """Plain version of :func:`qsgd_quantize` (same murmur stream, same
    rounding order, saturating int8 cast)."""
    _check_quantize_args(s, block)
    x = x.reshape(-1).to(torch.float32)
    n = x.numel()
    norms = norm.to(torch.float32).reshape(-1)
    if block is not None:
        _check_norms(norms.numel(), n, block)
    u = uniform_hash(torch.arange(n, dtype=torch.int64, device=x.device), seed)
    v = quantize_levels(x, _norm_per_element(norms, n, block), u, s)
    return v.clamp(-128, 127).to(torch.int8)


def _check_quantize_args(s: int, block) -> None:
    if s > 127:
        raise ValueError(f"the kernel path is int8-only (s <= 127), got s={s}")
    if block is not None and not blockwise_supported(block):
        raise ValueError(f"block must be a multiple of {_BLOCK}, got {block}")


def qsgd_quantize(x: torch.Tensor, norm: torch.Tensor, seed, s: int,
                  *, block=None) -> torch.Tensor:
    """Fused stochastic quantization of a flat f32 tensor to int8 levels.

    ``norm``: scalar f32 (per tensor) or f32 ``[ceil(n/block)]`` with
    ``block`` a multiple of 4096; ``seed``: an int32, as an int or as a
    one-element int32 tensor on ``x``'s device (the kernel reads it from
    there, so a captured launch takes each replay's seed). Levels are
    bit-equal to ``pallas_kernels.qsgd_quantize`` for the same inputs. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return qsgd_quantize_ref(x, norm, seed, s, block=block)
    from ewdml_tpu_torch.kernels import library

    _check_quantize_args(s, block)
    x = x.reshape(-1)
    _require_cuda(x, "qsgd_quantize", torch.float32)
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel's float4 loads need 16-byte alignment
    n = x.numel()
    norms = norm.to(device=x.device, dtype=torch.float32).reshape(-1).contiguous()
    if block is not None:
        _check_norms(norms.numel(), n, block)
    elif norms.numel() != 1:
        raise ValueError("per-tensor quantize takes one norm")
    seed = _seed_arg(seed, x.device)
    out = torch.empty(n, dtype=torch.int8, device=x.device)
    rc = library().ewdml_qsgd_quantize(
        x.data_ptr(), norms.data_ptr(), n, block or 0, seed.data_ptr(),
        int(s), out.data_ptr(), _stream_ptr(x))
    _launch_check(rc, "qsgd_quantize")
    _count("qsgd_quantize", x, norms, out)
    return out


# -- kernel 2: dequantize + mean over workers ----------------------------------

def dequant_mean_ref(levels: torch.Tensor, norms: torch.Tensor, s: int,
                     *, block=None) -> torch.Tensor:
    """Plain version of :func:`dequant_mean`: ``sum_w norm[w, b] * lv[w]``
    accumulated in worker order, then times ``f32(1 / (s * W))``."""
    _check_dequant_args(levels, block)
    world, n = levels.shape
    norms2 = norms.to(torch.float32).reshape(world, -1)
    if block is not None:
        _check_norms(norms2.shape[1], n, block)
    acc = torch.zeros(n, dtype=torch.float32, device=levels.device)
    for w in range(world):
        acc = acc + _norm_per_element(norms2[w], n, block) * levels[w].to(
            torch.float32)
    factor = f32_scalar(1.0 / (s * world))
    return acc * factor


def _check_dequant_args(levels: torch.Tensor, block) -> None:
    if levels.dtype != torch.int8:
        raise ValueError(f"dequant_mean is int8-only, got {levels.dtype}")
    if levels.dim() != 2:
        raise ValueError(f"dequant_mean takes [W, n] levels, got "
                         f"{tuple(levels.shape)}")
    if block is not None and not blockwise_supported(block):
        raise ValueError(f"block must be a multiple of {_BLOCK}, got {block}")


def dequant_mean(levels: torch.Tensor, norms: torch.Tensor, s: int,
                 *, block=None) -> torch.Tensor:
    """Fused ``mean_w(norms[w] / s * levels[w])`` over the worker axis.

    ``levels``: [W, n] int8; ``norms``: [W] f32 or [W, nblocks] with
    ``block`` a multiple of 4096. Returns [n] f32. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if levels.device.type == "cpu":
        return dequant_mean_ref(levels, norms, s, block=block)
    from ewdml_tpu_torch.kernels import library

    _check_dequant_args(levels, block)
    _require_cuda(levels, "dequant_mean", torch.int8)
    world, n = levels.shape
    norms2 = norms.to(device=levels.device, dtype=torch.float32).reshape(
        world, -1).contiguous()
    nb = norms2.shape[1]
    if block is not None:
        _check_norms(nb, n, block)
    elif nb != 1:
        raise ValueError("per-tensor dequant_mean takes one norm per worker")
    out = torch.empty(n, dtype=torch.float32, device=levels.device)
    rc = library().ewdml_dequant_mean(
        levels.data_ptr(), norms2.data_ptr(), world, n, nb, block or 0,
        1.0 / (s * world), out.data_ptr(), _stream_ptr(levels))
    _launch_check(rc, "dequant_mean")
    _count("dequant_mean", levels, norms2, out)
    return out


# -- kernel 3: strided block-top-1 selection ----------------------------------

def column_top1(x2: torch.Tensor):
    """Per column, the first row of the largest |x| and its value as it is
    (a -0 stays -0): the JAX package's non-kernel selection
    (``blocktopk._select_xla``)."""
    a = x2.abs()
    mx = a.max(dim=0).values
    r = x2.shape[0]
    rows = torch.arange(r, dtype=torch.int32, device=x2.device)[:, None]
    loc = torch.where(a == mx[None, :], rows,
                      torch.full_like(rows, r)).min(dim=0).values
    return x2.gather(0, loc[None, :].to(torch.int64))[0], loc


def block_top1_ref(x2: torch.Tensor):
    """Plain version of :func:`block_top1`: :func:`column_top1` plus zero,
    which turns a -0 winner into +0 exactly as the TPU kernel's masked
    column sum does."""
    _check_top1_args(x2)
    vals, loc = column_top1(x2)
    return vals + 0.0, loc


def _check_top1_args(x2: torch.Tensor) -> None:
    if x2.dim() != 2:
        raise ValueError(f"block_top1 takes an (R, C) matrix, got "
                         f"{tuple(x2.shape)}")
    r, c = x2.shape
    if c % _LANES:
        raise ValueError(f"C must be a multiple of {_LANES}, got {c}")
    if r % 8:
        raise ValueError(f"R must be a multiple of 8, got {r}")


def block_top1(x2: torch.Tensor):
    """Winner per column of an (R, C) f32 matrix: ``(vals [C] f32,
    locs [C] int32)``, the signed value and first row of the largest |x|.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x2.device.type == "cpu":
        return block_top1_ref(x2)
    from ewdml_tpu_torch.kernels import library

    _check_top1_args(x2)
    _require_cuda(x2, "block_top1", torch.float32)
    r, c = x2.shape
    vals = torch.empty(c, dtype=torch.float32, device=x2.device)
    locs = torch.empty(c, dtype=torch.int32, device=x2.device)
    rc = library().ewdml_block_top1(x2.data_ptr(), r, c, vals.data_ptr(),
                                    locs.data_ptr(), _stream_ptr(x2))
    _launch_check(rc, "block_top1")
    _count("block_top1", x2, vals, locs)
    return vals, locs


# -- kernels 4 + 5: the fused ring hops ----------------------------------------
#
# One CUDA thread block owns one quantization block of ``block`` elements
# with T = block // 16 threads; thread t holds the 16 elements
# ``4 * (t + T * j) + c`` (j, c in 0..3) in registers. The block's L2 norm is
# summed in one fixed order, which the plain versions repeat exactly:
#   1. each thread sums its 16 squares in (j, c) order, starting from 0;
#   2. each warp of 32 threads halves its sums at offsets 16, 8, 4, 2, 1
#      (lane i adds lane i + offset);
#   3. the T / 32 warp sums halve the same way, from half the next power
#      of two down to 1 (warps past T / 32 add zeros);
#   4. the norm is the correctly rounded square root of the total.
# Every product and sum rounds on its own (no FMA), so kernel and plain
# version agree bit for bit, norms and levels alike.

_RING_VEC = 16              # elements per thread of the ring kernels
_RING_MAX_BLOCK = 1024 * _RING_VEC  # one thread block has at most 1024 threads


def _check_ring_args(s: int, block: int) -> None:
    if s > 127:
        raise ValueError(f"the fused collective wire is int8-only (s <= 127), "
                         f"got s={s}")
    if not blockwise_supported(block):
        raise ValueError(f"block must be a multiple of {_BLOCK}, got {block}")


def _pad_blocks(x: torch.Tensor, nb: int, block: int) -> torch.Tensor:
    """``x`` flat, zero-padded to ``[nb, block]`` (its own dtype)."""
    out = torch.zeros(nb * block, dtype=x.dtype, device=x.device)
    out[:x.numel()] = x.reshape(-1)
    return out.reshape(nb, block)


def block_norms_ref(x2: torch.Tensor) -> torch.Tensor:
    """The L2 norm of each row of an f32 ``[nb, block]`` matrix, summed in
    the ring kernels' order (see above)."""
    nb, block = x2.shape
    threads = block // _RING_VEC
    sq = (x2 * x2).reshape(nb, 4, threads, 4).permute(0, 2, 1, 3).reshape(
        nb, threads, _RING_VEC)
    acc = torch.zeros((nb, threads), dtype=torch.float32, device=x2.device)
    for k in range(_RING_VEC):
        acc = acc + sq[:, :, k]
    acc = acc.reshape(nb, threads // 32, 32)
    for off in (16, 8, 4, 2, 1):
        acc = acc[:, :, :off] + acc[:, :, off:2 * off]
    # The warp sums halve from half the next power of two, the missing
    # warps entering as zeros (24 warps for a block of 12288).
    warps = threads // 32
    top = 1 << (warps - 1).bit_length()
    acc = torch.nn.functional.pad(acc[:, :, 0], (0, top - warps))
    off = top // 2
    while off:
        acc = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    return torch.sqrt(acc[:, 0])


def encode_blocks_ref(x: torch.Tensor, norms: torch.Tensor, seed,
                      s: int = 127, *, block: int = _BLOCK) -> torch.Tensor:
    """The quantize half of the ring kernels, given the block norms: int8
    levels ``[n]`` of ``pallas_kernels._encode_block`` (murmur stream over
    the flat index, zero levels for a zero norm, saturating cast)."""
    return qsgd_quantize_ref(x, norms, seed, s, block=block)


def chunk_encode_ref(x: torch.Tensor, seed, s: int = 127, *,
                     block: int = _BLOCK):
    """Plain version of :func:`chunk_encode`."""
    _check_ring_args(s, block)
    x = x.reshape(-1).to(torch.float32)
    norms = block_norms_ref(_pad_blocks(x, -(-x.numel() // block), block))
    return encode_blocks_ref(x, norms, seed, s, block=block), norms


def _check_hop_args(levels, norms, local, block) -> None:
    if levels.dtype != torch.int8:
        raise ValueError(f"dequant_acc_requant is int8-only, got {levels.dtype}")
    n = local.numel()
    if levels.numel() != n:
        raise ValueError(f"levels size {levels.numel()} != local size {n}")
    _check_norms(norms.numel(), n, block)


def dequant_acc_requant_ref(levels: torch.Tensor, norms: torch.Tensor,
                            local: torch.Tensor, seed, s: int = 127, *,
                            block: int = _BLOCK, scale: float = 1.0):
    """Plain version of :func:`dequant_acc_requant`: per element
    ``(local + (norm[b] * f32(1/s)) * lv) * f32(scale)`` in that order, then
    the block encode of :func:`chunk_encode_ref`."""
    _check_ring_args(s, block)
    _check_hop_args(levels, norms, local, block)
    n = local.numel()
    nb = -(-n // block)
    coef = norms.to(torch.float32).reshape(-1) * f32_scalar(1.0 / s)
    acc = (_pad_blocks(local.to(torch.float32), nb, block)
           + coef[:, None] * _pad_blocks(levels, nb, block).to(torch.float32))
    acc = acc * f32_scalar(float(scale))
    onorms = block_norms_ref(acc)
    return encode_blocks_ref(acc.reshape(-1)[:n], onorms, seed, s,
                             block=block), onorms


def decode_blocks(levels: torch.Tensor, norms: torch.Tensor, s: int, *,
                  block: int = _BLOCK) -> torch.Tensor:
    """``levels * (norm[b] * f32(1/s))``: the decode leg of the fused wire
    (``pallas_kernels.decode_blocks``, plain XLA there and a torch op
    here, since its output is the dense result)."""
    n = levels.numel()
    lv = _pad_blocks(levels.to(torch.float32), -(-n // block), block)
    coef = norms.to(torch.float32).reshape(-1)[:, None] * f32_scalar(1.0 / s)
    return (lv * coef).reshape(-1)[:n]


def _ring_kernel_block(block: int) -> None:
    if block > _RING_MAX_BLOCK:
        raise ValueError(f"the ring kernels take blocks of at most "
                         f"{_RING_MAX_BLOCK} elements, got {block}")


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t``, copied if its address is not a multiple of ``nbytes`` (the
    kernels' vector loads)."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def chunk_encode(x: torch.Tensor, seed, s: int = 127, *,
                 block: int = _BLOCK):
    """Encode a flat f32 chunk as ``(int8 levels [n], f32 norms [nb])``,
    one L2 norm per ``block`` elements taken in the same pass as the
    stochastic quantization. ``seed`` as for :func:`qsgd_quantize`. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return chunk_encode_ref(x, seed, s, block=block)
    from ewdml_tpu_torch.kernels import library

    _check_ring_args(s, block)
    _ring_kernel_block(block)
    x = x.reshape(-1)
    _require_cuda(x, "chunk_encode", torch.float32)
    x = _aligned(x, 16)
    n = x.numel()
    levels = torch.empty(n, dtype=torch.int8, device=x.device)
    norms = torch.empty(-(-n // block), dtype=torch.float32, device=x.device)
    seed = _seed_arg(seed, x.device)
    rc = library().ewdml_chunk_encode(
        x.data_ptr(), n, block, seed.data_ptr(), int(s), levels.data_ptr(),
        norms.data_ptr(), _stream_ptr(x))
    _launch_check(rc, "chunk_encode")
    _count("chunk_encode", x, levels, norms)
    return levels, norms


def dequant_acc_requant(levels: torch.Tensor, norms: torch.Tensor,
                        local: torch.Tensor, seed, s: int = 127, *,
                        block: int = _BLOCK, scale: float = 1.0):
    """One fused ring reduce-scatter hop: re-encode
    ``scale * (local + norms / s * levels)`` as ``(int8 levels [n], f32
    norms [nb])`` without writing the f32 partial sum to device memory.
    ``scale`` is 1/W on a ring's last hop; ``seed`` as for
    :func:`qsgd_quantize`. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if local.device.type == "cpu":
        return dequant_acc_requant_ref(levels, norms, local, seed, s,
                                       block=block, scale=scale)
    from ewdml_tpu_torch.kernels import library

    _check_ring_args(s, block)
    _ring_kernel_block(block)
    levels, local = levels.reshape(-1), local.reshape(-1)
    _check_hop_args(levels, norms, local, block)
    _require_cuda(levels, "dequant_acc_requant", torch.int8)
    _require_cuda(local, "dequant_acc_requant", torch.float32)
    levels, local = _aligned(levels, 4), _aligned(local, 16)
    norms = norms.to(device=local.device, dtype=torch.float32).reshape(
        -1).contiguous()
    n = local.numel()
    out = torch.empty(n, dtype=torch.int8, device=local.device)
    onorms = torch.empty(norms.numel(), dtype=torch.float32, device=local.device)
    seed = _seed_arg(seed, local.device)
    rc = library().ewdml_dequant_acc_requant(
        levels.data_ptr(), norms.data_ptr(), local.data_ptr(), n, block,
        seed.data_ptr(), int(s), 1.0 / s, float(scale), out.data_ptr(),
        onorms.data_ptr(), _stream_ptr(local))
    _launch_check(rc, "dequant_acc_requant")
    _count("dequant_acc_requant", levels, norms, local, out, onorms)
    return out, onorms


def ring_hops(device):
    """``(encode, hop)`` for the fused ring transports on ``device``: the
    CUDA kernels under 'auto'/'on' on CUDA, else their plain versions
    (``pallas_kernels.active``, with no size gate)."""
    if active(device) == "kernel":
        return chunk_encode, dequant_acc_requant
    return chunk_encode_ref, dequant_acc_requant_ref


# -- kernels 6 + 7: the compressed-domain server apply -------------------------

def _check_accumulate_args(levels: torch.Tensor) -> None:
    if levels.dtype != torch.int8:
        raise ValueError(f"int_accumulate is int8-only, got {levels.dtype}")
    if levels.dim() != 2:
        raise ValueError(f"int_accumulate takes [K, n] levels, got "
                         f"{tuple(levels.shape)}")


def _check_accumulate_out(out, n: int, device) -> None:
    if out.dtype != torch.int32 or out.shape != (n,) or out.device != device:
        raise ValueError(f"int_accumulate: out must be int32 [{n}] on "
                         f"{device}, got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")


def int_accumulate_ref(levels: torch.Tensor, out=None) -> torch.Tensor:
    """Plain version of :func:`int_accumulate`: the widened int32 sum over
    the K rows (exact, so its order does not matter)."""
    _check_accumulate_args(levels)
    if out is None:
        return levels.to(torch.int32).sum(dim=0, dtype=torch.int32)
    _check_accumulate_out(out, levels.shape[1], levels.device)
    return torch.sum(levels.to(torch.int32), dim=0, dtype=torch.int32,
                     out=out)


def int_accumulate(levels: torch.Tensor, out=None) -> torch.Tensor:
    """Sum K int8 level planes ``[K, n]`` into one int32 plane ``[n]``,
    written into ``out`` (int32 [n], contiguous, 16-byte aligned) where
    given. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if levels.device.type == "cpu":
        return int_accumulate_ref(levels, out)
    from ewdml_tpu_torch.kernels import library

    _check_accumulate_args(levels)
    _require_cuda(levels, "int_accumulate", torch.int8)
    world, n = levels.shape
    if out is None:
        out = torch.empty(n, dtype=torch.int32, device=levels.device)
    _check_accumulate_out(out, n, levels.device)
    if not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError("int_accumulate: out must be contiguous and "
                         "16-byte aligned")
    rc = library().ewdml_int_accumulate(levels.data_ptr(), world, n,
                                        out.data_ptr(), _stream_ptr(levels))
    _launch_check(rc, "int_accumulate")
    _count("int_accumulate", levels, out)
    return out


def _check_decode_args(acc: torch.Tensor, scales: torch.Tensor, block):
    if acc.dtype != torch.int32:
        raise ValueError(f"acc_decode is int32-only, got {acc.dtype}")
    scales = scales.to(device=acc.device, dtype=torch.float32).reshape(-1)
    per_tensor = block is None or scales.numel() == 1
    if not per_tensor:
        _check_norms(scales.numel(), acc.numel(), block)
    return scales, per_tensor


def acc_decode_ref(acc: torch.Tensor, scales: torch.Tensor, k: int, *,
                   block=None) -> torch.Tensor:
    """Plain version of :func:`acc_decode`, in the kernel's order: the
    factor ``scale[b] * f32(1/k)`` first, then ``f32(acc) * factor``."""
    scales, per_tensor = _check_decode_args(acc, scales, block)
    if acc.is_cuda:
        with _launch_lock:
            PLAIN_DECODES_ON_CARD["acc_decode"] += 1
    acc = acc.reshape(-1)
    # 1/k rounded once to f32, as jnp.float32(1.0 / float(k)).
    factor = scales * f32_scalar(1.0 / float(k))
    if per_tensor:
        return acc.to(torch.float32) * factor[0]
    n = acc.numel()
    nb = scales.numel()
    a = _pad_blocks(acc, nb, block).to(torch.float32)
    return (a * factor[:, None]).reshape(-1)[:n]


#: Elements a decode-set tile takes, and the leaves one launch takes
#: (``kernels/decode.cu``: kTile, kMaxLeaves; 448 descriptors of 40 bytes
#: hold a launch's parameters well under CUDA's 32 KB).
DECODE_TILE = 4096
DECODE_MAX_LEAVES = 448

#: One packed leaf of a decode set (``DecodeLeaf`` in ``decode.cu``).
DECODE_LEAF = np.dtype([
    ("acc", "<u8"), ("out", "<u8"), ("scales", "<u8"), ("n", "<u4"),
    ("first_tile", "<u4"), ("tiles_per_block", "<u4"), ("inv_k", "<f4")])


def decode_descriptors(leaves, max_leaves: int = DECODE_MAX_LEAVES,
                       tile: int = DECODE_TILE) -> list:
    """The decode kernel's launches for a set: ``leaves`` is a list of
    ``(acc, out, scales_ptr, n, block, inv_k)`` (``acc`` and ``out``
    pointers, or byte offsets from the launch's two bases; ``block`` None
    for one scale, else a multiple of ``tile``); returns one array of
    packed descriptors per launch, at most ``max_leaves`` each, the leaves
    in order, each leaf's first tile counted from 0 in its launch. Empty
    leaves take no descriptor."""
    rows, out = [], []
    first = 0
    for ap, op, sp, n, block, inv_k in leaves:
        if n == 0:
            continue
        if len(rows) == max_leaves:
            out.append(np.array(rows, DECODE_LEAF))
            rows, first = [], 0
        rows.append((ap, op, sp, n, first, (block or 0) // tile, inv_k))
        first += -(-n // tile)
    if rows:
        out.append(np.array(rows, DECODE_LEAF))
    return out


def decode_set_launches(leaves: int) -> int:
    """Launches of one decode set of ``leaves`` non-empty leaves."""
    return -(-leaves // DECODE_MAX_LEAVES)


@functools.lru_cache(maxsize=None)
def f32_inverse(k: int) -> float:
    """1/k rounded once to f32, as ``jnp.float32(1.0 / float(k))``."""
    return float(f32_scalar(1.0 / float(k)))


def _arena_split(sizes) -> tuple:
    """The 16-byte layout of an arena holding ``sizes`` elements of 4
    bytes: ``(offsets, total, split)``, every leaf but the last padded to
    4 elements, ``split`` the sizes ``Tensor.split`` cuts leaves and pads
    by (even entries the leaves)."""
    offsets, split, total = [], [], 0
    for i, n in enumerate(sizes):
        offsets.append(total)
        pad = 0 if i == len(sizes) - 1 else -n % 4
        split += [n, pad]
        total += n + pad
    return offsets, total, split[:-1]


def _set_bytes(descs, scales_numel: list) -> list:
    """The bytes each launch of a set reads and writes: 8 an element (an
    int32 in, an f32 out) and its leaves' scales."""
    out, i = [], 0
    for desc in descs:
        out.append(8 * int(desc["n"].sum())
                   + 4 * sum(scales_numel[i:i + len(desc)]))
        i += len(desc)
    return out


def _launch_set(descs, acc_base: int, out_base: int, stream,
                nbytes: list) -> None:
    """One ``acc_decode_set`` launch a descriptor array, counted with the
    bytes it moves."""
    from ewdml_tpu_torch.kernels import library

    lib = library()
    for desc, b in zip(descs, nbytes):
        rc = lib.ewdml_acc_decode_set(desc.ctypes.data, len(desc), acc_base,
                                      out_base, stream)
        _launch_check(rc, "acc_decode")
        _count_nbytes("acc_decode", b)


def _check_set_leaf(scales, n: int, block, device, kernel: bool):
    """A set leaf's scales as the kernel reads them (f32, flat, on
    ``device``) and its block (None for one scale); raises where the
    kernel takes no such block."""
    scales = torch.as_tensor(scales, dtype=torch.float32,
                             device=device).reshape(-1).contiguous()
    per_tensor = block is None or scales.numel() == 1
    if not per_tensor:
        _check_norms(scales.numel(), n, block)
        if kernel and not blockwise_supported(block):
            raise ValueError(f"the acc_decode kernel needs block % {_BLOCK} "
                             f"== 0, got {block}")
    return scales, None if per_tensor else block


class DecodeSet:
    """The layout of a decode set whose leaves' int32 sums lie in one
    arena and whose means are cut from another: ``leaves`` a list of
    ``(n, scales, k, block)``, as :func:`acc_decode` takes them. Packed
    once (descriptors with offsets into the two arenas, the scales made
    f32 on ``device``), so a decode costs one allocation and one launch
    for up to ``DECODE_MAX_LEAVES`` leaves whatever their count: the
    homomorphic apply keeps one a contract and divisor. On CUDA the
    kernel takes every leaf (a block that is not a multiple of 4096
    raises here); elsewhere :meth:`decode` runs the plain version."""

    def __init__(self, leaves: list, device):
        self.device = torch.device(device)
        self.kernel = self.device.type == "cuda"
        if self.kernel and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.sizes = [int(n) for n, _, _, _ in leaves]
        self.offsets, self.total, self._split = _arena_split(self.sizes)
        self.leaves = []
        for (n, scales, k, block), off in zip(leaves, self.offsets):
            scales, block = _check_set_leaf(scales, n, block, self.device,
                                            self.kernel)
            self.leaves.append((scales, int(k), block))
        if self.kernel:
            self._descs = decode_descriptors(
                [(4 * off, 4 * off, scales.data_ptr(), n, block,
                  f32_inverse(k))
                 for (scales, k, block), n, off in zip(
                     self.leaves, self.sizes, self.offsets)])
            self._nbytes = _set_bytes(self._descs, [
                sc.numel() for (sc, _, _), n in zip(self.leaves, self.sizes)
                if n])

    def acc_arena(self) -> torch.Tensor:
        """An int32 arena for the set's sums (uninitialised)."""
        return torch.empty(self.total, dtype=torch.int32, device=self.device)

    def views(self, arena: torch.Tensor) -> list:
        """Each leaf's flat view of ``arena`` (an acc or a means arena)."""
        if not self.sizes:
            return []
        return list(arena.split(self._split)[::2])

    def launch(self, acc: torch.Tensor) -> torch.Tensor:
        """The kernel on the sums in ``acc`` (an :meth:`acc_arena`): the
        f32 means arena, in ``decode_set_launches`` counted launches."""
        if not self.kernel:
            raise ValueError("DecodeSet.launch needs a set on CUDA")
        if (acc.dtype != torch.int32 or acc.shape != (self.total,)
                or acc.device != self.device or not acc.is_contiguous()
                or acc.data_ptr() % 16):
            raise ValueError(f"acc_decode: the sums arena must be int32 "
                             f"[{self.total}], contiguous and 16-byte "
                             f"aligned on {self.device}")
        out = torch.empty(self.total, dtype=torch.float32, device=self.device)
        _launch_set(self._descs, acc.data_ptr(), out.data_ptr(),
                    _stream_ptr(out), self._nbytes)
        return out

    def decode(self, acc: torch.Tensor) -> list:
        """Each leaf's flat mean from the sums arena ``acc``: the kernel on
        CUDA under 'auto' or 'on', the plain version leaf by leaf
        elsewhere (the CPU, 'off', 'interpret')."""
        if active(self.device) == "kernel":
            return self.views(self.launch(acc))
        return [acc_decode_ref(a, scales, k, block=block)
                for a, (scales, k, block) in zip(self.views(acc),
                                                 self.leaves)]


def decode_sum_set_ref(items: list) -> list:
    """Plain version of :func:`acc_decode_set`: leaf by leaf,
    :func:`acc_decode_ref`. ``items`` as for :func:`acc_decode_set`."""
    return [acc_decode_ref(acc, scales, k, block=block)
            for acc, scales, k, block in items]


def acc_decode_set(items: list) -> list:
    """The decode of a set of leaves whose sums lie anywhere: for each
    ``(acc, scales, k, block)`` (as :func:`acc_decode` takes them) its
    ``f32(acc) * (scale[b] * f32(1/k))``, flat, as views of one arena,
    each on a 16-byte boundary. CPU tensors take the plain version; CUDA
    tensors go to the kernel in launches of up to ``DECODE_MAX_LEAVES``
    leaves, one counted launch each, which raises for a blockwise scale
    whose block is not a multiple of 4096. The set is packed on every
    call (a :class:`DecodeSet` packs once). No host synchronisation and
    no allocation outside the caching allocator."""
    if not items:
        return []
    device = items[0][0].device
    if device.type == "cpu":
        return decode_sum_set_ref(items)
    accs, leaves = [], []
    for acc, scales, k, block in items:
        if acc.dtype != torch.int32:
            raise ValueError(f"acc_decode is int32-only, got {acc.dtype}")
        _require_cuda(acc, "acc_decode", torch.int32)
        if acc.device != device:
            raise ValueError("acc_decode: a set lies on one device; got "
                             f"{device} and {acc.device}")
        if acc.numel() >= 1 << 31:
            raise ValueError("acc_decode: a leaf takes fewer than 2^31 "
                             "elements")
        accs.append(_aligned(acc, 16))
        scales, block = _check_set_leaf(scales, acc.numel(), block, device,
                                        True)
        leaves.append((scales, int(k), block))
    sizes = [a.numel() for a in accs]
    offsets, total, split = _arena_split(sizes)
    arena = torch.empty(total, dtype=torch.float32, device=device)
    base = arena.data_ptr()
    descs = decode_descriptors(
        [(a.data_ptr(), base + 4 * off, scales.data_ptr(), n, block,
          f32_inverse(k))
         for a, (scales, k, block), n, off in zip(accs, leaves, sizes,
                                                   offsets)])
    _launch_set(descs, 0, 0, _stream_ptr(arena), _set_bytes(
        descs, [sc.numel() for (sc, _, _), n in zip(leaves, sizes) if n]))
    return list(arena.split(split)[::2])


def acc_decode(acc: torch.Tensor, scales: torch.Tensor, k: int, *,
               block=None) -> torch.Tensor:
    """The round's one dequantize: ``f32(acc) * (scale[b] * f32(1/k))``.

    ``acc``: [n] int32 (the sum over k payloads); ``scales``: f32 [1] (per
    tensor) or [ceil(n/block)] with ``block`` a multiple of 4096. CPU
    tensors take the plain version; CUDA tensors launch the set kernel on
    a set of one, which raises for any other block."""
    if acc.device.type == "cpu":
        return acc_decode_ref(acc, scales, k, block=block)
    return acc_decode_set([(acc, scales, k, block)])[0]


def accumulate(levels: torch.Tensor, out=None) -> torch.Tensor:
    """``pallas_kernels.int_accumulate`` with no ``interpret`` flag: the
    kernel where :func:`active_for` picks it, the plain version
    elsewhere; written into ``out`` where given."""
    _check_accumulate_args(levels)
    if active_for(levels.shape[1], levels.device) == "kernel":
        return int_accumulate(levels, out)
    return int_accumulate_ref(levels, out)


def decode_sum(acc: torch.Tensor, scales: torch.Tensor, k: int, *,
               block=None) -> torch.Tensor:
    """``pallas_kernels.acc_decode`` with no ``interpret`` flag: the kernel
    where :func:`active_for` picks it and the scale is per tensor or
    blockwise on a multiple of 4096; the plain version elsewhere (the two
    are bit-equal)."""
    scales, per_tensor = _check_decode_args(acc, scales, block)
    kernel_ok = per_tensor or blockwise_supported(block)
    if kernel_ok and active_for(acc.numel(), acc.device) == "kernel":
        return acc_decode(acc, scales, k, block=block)
    return acc_decode_ref(acc, scales, k, block=block)


# -- the precision policy's bf16 store: seeded stochastic rounding ------------

def jax_strides(shape, kind: str):
    """For a tensor of ``shape`` in PyTorch's layout of a leaf of ``kind``
    (``models/convert``): its dims padded to four and, for each, the stride
    of that coordinate in the JAX layout; None where the layouts agree."""
    if kind == "conv":
        o, i, kh, kw = shape
        return (o, i, kh, kw), (1, o, kw * i * o, i * o)
    if kind == "dense":
        o, i = shape
        return (o, i, 1, 1), (1, o, 0, 0)
    return None


@functools.lru_cache(maxsize=64)
def jax_index(shape, kind: str, device) -> torch.Tensor:
    """The flat JAX-layout index of each element of a ``kind`` leaf held in
    PyTorch's layout, in PyTorch's element order (int64). Cached per
    shape: the caller must not write into it."""
    n = 1
    for d in shape:
        n *= int(d)
    t = torch.arange(n, dtype=torch.int64, device=device)
    lay = jax_strides(tuple(shape), kind)
    if lay is None:
        return t
    dims, strides = lay
    j = torch.zeros_like(t)
    for d in (3, 2, 1, 0):
        j += (t % dims[d]) * strides[d]
        t = t // dims[d]
    return j


def _magic(d: int) -> tuple:
    """The multiplier and shift by which the round kernel divides by ``d``
    (``1 <= d < 2^32``): ``t // d == (umulhi(t, m) + t) >> s`` for every
    uint32 ``t``, the sum taken in 64 bits."""
    s = (d - 1).bit_length()
    return ((1 << 32) * ((1 << s) - d)) // d + 1, s


@dataclasses.dataclass(frozen=True)
class RoundLayout:
    """A leaf's index map as the round kernel takes it: PyTorch's element
    ``t`` has coordinates ``(c0, c1, c2)`` (innermost ``c2``) over dims
    ``(-, d1, d2)`` and JAX index ``c0 * s0 + c1 * s1 + c2 * s2``; ``m``
    and ``sh`` divide by ``d1``, ``d2`` (:func:`_magic`). ``permuted`` is
    False where the two layouts agree (the index is ``t``)."""

    n: int
    permuted: bool
    d1: int
    d2: int
    m1: int
    m2: int
    sh1: int
    sh2: int
    s0: int
    s1: int
    s2: int


@functools.lru_cache(maxsize=1024)
def round_layout(shape: tuple, kind: str) -> RoundLayout:
    """The :class:`RoundLayout` of a ``kind`` leaf of ``shape`` (PyTorch's
    layout): :func:`jax_strides` with the size-1 dims dropped and the dims
    that are contiguous in both layouts merged (a convolution's kh and kw),
    which leaves at most three."""
    n = 1
    for d in shape:
        n *= int(d)
    lay = jax_strides(tuple(shape), kind)
    dims, strides = lay if lay is not None else ((n,), (1,))
    merged = []
    for d, st in zip(dims, strides):
        if d <= 1:  # a size-1 dim, or an empty leaf (no element to map)
            continue
        if merged and merged[-1][1] == d * st:
            merged[-1] = (merged[-1][0] * d, st)
        else:
            merged.append((int(d), int(st)))
    permuted = not (not merged or (len(merged) == 1 and merged[0][1] == 1))
    if len(merged) > 3:
        raise ValueError(f"a {kind} leaf of shape {shape} has more than "
                         "three dims in its index map")
    merged = [(1, 0)] * (3 - len(merged)) + merged
    (_, s0), (d1, s1), (d2, s2) = merged
    (m1, sh1), (m2, sh2) = _magic(d1), _magic(d2)
    return RoundLayout(n, permuted, d1, d2, m1, m2, sh1, sh2, s0, s1, s2)


def round_index_twin(lay: RoundLayout, t) -> torch.Tensor:
    """The round kernel's index map on the host, in its uint32 arithmetic:
    for each element ``t`` (an int64 tensor) the JAX index the kernel draws
    at, reached as the kernel reaches it. The coordinates of the first
    element of ``t``'s 8-element vector come by multiply-high and shift;
    where the innermost dim is at least 8 long, element k of the vector is
    the first's index plus k strides plus one adjustment past the
    innermost coordinate's wrap, else a carry chain steps to it."""
    mask = 0xFFFFFFFF
    t = torch.as_tensor(t, dtype=torch.int64)
    if not lay.permuted:
        return t.clone()

    def div(v, m, sh):  # v * m < 2^64: the product's top half, exactly
        hi = ((v >> 16) * m + (((v & 0xFFFF) * m) >> 16)) >> 16
        return (hi + v) >> sh

    base = t - t % ROUND_VEC
    q = div(base, lay.m2, lay.sh2)
    c2 = base - q * lay.d2
    c0 = div(q, lay.m1, lay.sh1)
    c1 = q - c0 * lay.d1
    j = (c0 * lay.s0 + c1 * lay.s1 + c2 * lay.s2) & mask
    wrap2 = (lay.s1 - lay.d2 * lay.s2) & mask
    wrap1 = (lay.s0 - lay.d1 * lay.s1) & mask
    steps = t - base
    if lay.d2 >= ROUND_VEC:
        adj = wrap2 + (c1 + 1 == lay.d1) * wrap1
        past = steps >= lay.d2 - c2
        return (j + steps * lay.s2 + past * adj) & mask
    for k in range(1, ROUND_VEC):
        go = steps >= k
        c2 = c2 + go
        j = j + go * lay.s2
        w2 = c2 == lay.d2
        c2 = torch.where(w2, 0, c2)
        c1 = c1 + w2
        j = j + w2 * wrap2
        w1 = c1 == lay.d1
        c1 = torch.where(w1, 0, c1)
        j = (j + w1 * wrap1) & mask
    return j


#: Elements a round-kernel thread takes at once, a thread block in all, and
#: the leaves one launch takes (``kernels/precision.cu``: kVec, kBlockElems,
#: kMaxLeaves; 448 descriptors of 72 bytes hold a launch's parameters under
#: the 32 KB that CUDA 12.1 and later allow).
ROUND_VEC = 8
ROUND_BLOCK_ELEMS = 4096
ROUND_MAX_LEAVES = 448

#: One packed leaf of a round set (``RoundLeaf`` in ``precision.cu``).
ROUND_LEAF = np.dtype([
    ("x", "<u8"), ("out", "<u8"), ("n", "<u4"), ("first_block", "<u4"),
    ("d1", "<u4"), ("d2", "<u4"), ("m1", "<u4"), ("m2", "<u4"),
    ("s0", "<u4"), ("s1", "<u4"), ("s2", "<u4"), ("meta", "<u4"),
    ("path", "<u4", (3,)), ("pad", "<u4")])
_PERMUTED, _ALIGNED = 1 << 24, 1 << 25


def round_descriptors(leaves, max_leaves: int = ROUND_MAX_LEAVES,
                      block_elems: int = ROUND_BLOCK_ELEMS) -> list:
    """The round kernel's launches for a store set: ``leaves`` is a list of
    ``(x_ptr, out_ptr, layout, path)`` (a :class:`RoundLayout`, a fold-in
    path of up to three words); returns one array of packed descriptors
    per launch, at most ``max_leaves`` each, the leaves in order, each
    leaf's first thread block counted from 0 in its launch. Empty leaves
    take no descriptor."""
    rows, out = [], []
    first = 0
    for xp, op, lay, path in leaves:
        if lay.n == 0:
            continue
        if len(path) > 3:
            raise ValueError(f"a fold-in path of {len(path)} words; the "
                             "round kernel takes at most three")
        if len(rows) == max_leaves:
            out.append(np.array(rows, ROUND_LEAF))
            rows, first = [], 0
        meta = (lay.sh1 | lay.sh2 << 8 | len(path) << 16
                | (_PERMUTED if lay.permuted else 0)
                | (_ALIGNED if xp % 16 == 0 and op % 16 == 0 else 0))
        words = tuple(int(w) & 0xFFFFFFFF for w in path)
        rows.append((xp, op, lay.n, first, lay.d1, lay.d2, lay.m1, lay.m2,
                     lay.s0, lay.s1, lay.s2, meta,
                     words + (0,) * (3 - len(words)), 0))
        first += -(-lay.n // block_elems)
    if rows:
        out.append(np.array(rows, ROUND_LEAF))
    return out


def _i32(v):
    """A uint32 value (a Python int, or an int64 tensor) as int32 bits."""
    if isinstance(v, torch.Tensor):
        return (v & 0xFFFFFFFF).to(torch.int32)
    v = int(v) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def threefry_bits(k0, k1, idx: torch.Tensor) -> torch.Tensor:
    """``y0 ^ y1`` of ``threefry2x32(k0, k1, idx >> 32, idx & 0xFFFFFFFF)``
    (``prng.random_bits`` at the int64 counters ``idx``) as int32 bits:
    the rounds of ``prng.threefry2x32`` in wrapping int32 arithmetic, the
    right shift of each rotation masked to a logical one. ``k0``/``k1`` are
    Python ints or 0-d int64 tensors (a key table's words)."""
    from ewdml_tpu_torch.utils.prng import _ROT

    k0, k1 = _i32(k0), _i32(k1)
    ks = (k0, k1, _i32(k0 ^ k1 ^ 0x1BD11BDA))
    x0 = (idx >> 32).to(torch.int32) + ks[0]
    x1 = (idx & 0xFFFFFFFF).to(torch.int32) + ks[1]
    hi = torch.empty_like(x1)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 += x1
            torch.bitwise_right_shift(x1, 32 - r, out=hi)
            hi &= (1 << r) - 1
            x1 <<= r
            x1 |= hi
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += _i32(ks[(i + 2) % 3] + i + 1)
    return x0 ^ x1


def stochastic_round_ref(x: torch.Tensor, key, kind: str = "vector",
                         out=None) -> torch.Tensor:
    """Plain version of :func:`stochastic_round_bf16`: the dither is the
    low 16 bits of ``prng.random_bits`` at each element's JAX index, added
    to the f32 bits and truncated; non-finite elements take the plain cast.
    ``key`` is a key of ``utils/prng`` (host words, or a key-table key)."""
    from ewdml_tpu_torch.utils import prng

    f = x.to(torch.float32)
    idx = jax_index(tuple(f.shape), kind, f.device)
    dither = threefry_bits(*prng.key_words(key), idx) & 0xFFFF
    bits = f.contiguous().reshape(-1).view(torch.int32)
    up = ((bits + dither) >> 16) & 0xFFFF   # the upper half, wrapping add
    up = up - ((up >> 15) << 16)  # as a signed 16-bit value
    rounded = up.to(torch.int16).view(torch.bfloat16).reshape(f.shape)
    res = torch.where(torch.isfinite(f), rounded, f.to(torch.bfloat16))
    if out is None:
        return res
    out.copy_(res)
    return out


def stochastic_round_set_ref(key, xs: list, paths: list, kinds=None,
                             outs=None) -> list:
    """Plain version of :func:`stochastic_round_set`: leaf by leaf,
    :func:`stochastic_round_ref` under the key its path folds from
    ``key``."""
    from ewdml_tpu_torch.utils import prng

    n = len(xs)
    kinds = kinds or ["vector"] * n
    outs = outs or [None] * n
    return [stochastic_round_ref(x, prng.fold_path(key, path), kind, out)
            for x, path, kind, out in zip(xs, paths, kinds, outs)]


def round_launches(leaves: int) -> int:
    """Launches of one store set of ``leaves`` non-empty leaves."""
    return -(-leaves // ROUND_MAX_LEAVES)


def _key_arg(key, device) -> tuple:
    """A threefry kernel's key: ``(pointer, value)``, the key-table slot of
    a key bound to a table (``prng.key_tensor``; a captured launch reads
    each replay's key there), else no pointer and the packed key by value
    (no device tensor, no launch to fill one)."""
    from ewdml_tpu_torch.utils import prng

    if isinstance(key, prng.Key):
        return prng.key_tensor(key, device).data_ptr(), 0
    return None, prng.packed_key(key) & 0xFFFFFFFFFFFFFFFF


def stochastic_round_set(key, xs: list, paths: list, kinds=None,
                         outs=None) -> list:
    """Seeded stochastic rounding of a store set: f32 leaf ``xs[i]`` (of
    ``kinds[i]``, in PyTorch's layout) to bf16 under the key its fold-in
    path ``paths[i]`` (up to three words) derives from the parent ``key``,
    written into ``outs[i]`` where given. The leaves go to the kernel in
    launches of up to ``ROUND_MAX_LEAVES``, one counted launch each;
    each leaf's key is derived in the kernel, from the parent key read
    once. CPU tensors take the plain version."""
    if xs and xs[0].device.type == "cpu":
        return stochastic_round_set_ref(key, xs, paths, kinds, outs)
    from ewdml_tpu_torch.kernels import library

    n_leaves = len(xs)
    kinds = kinds or ["vector"] * n_leaves
    outs = list(outs) if outs else [None] * n_leaves
    if not xs:
        return []
    device = xs[0].device
    res, live, items = [], [], []
    for x, path, kind, out in zip(xs, paths, kinds, outs):
        x = x.contiguous()
        _require_cuda(x, "stochastic_round_bf16", torch.float32)
        if x.device != device:
            raise ValueError("stochastic_round_bf16: a set lies on one "
                             f"device; got {device} and {x.device}")
        if x.numel() >= 1 << 31:
            raise ValueError("stochastic_round_bf16: a leaf takes fewer "
                             "than 2^31 elements")
        if out is None:
            out = torch.empty(x.shape, dtype=torch.bfloat16, device=device)
        _require_cuda(out, "stochastic_round_bf16 out", torch.bfloat16)
        if out.shape != x.shape:
            raise ValueError(f"stochastic_round_bf16: out has shape "
                             f"{tuple(out.shape)}, x {tuple(x.shape)}")
        res.append(out)
        if x.numel():
            live += [x, out]
            items.append((x.data_ptr(), out.data_ptr(),
                          round_layout(tuple(x.shape), kind), tuple(path)))
    lib = library()
    keyp, keyv = _key_arg(key, device)
    stream = _stream_ptr(xs[0])
    per = ROUND_MAX_LEAVES
    for c, desc in enumerate(round_descriptors(items)):
        rc = lib.ewdml_stochastic_round_set(keyp, keyv, desc.ctypes.data,
                                            len(desc), stream)
        _launch_check(rc, "stochastic_round")
        _count("stochastic_round", *live[2 * c * per:2 * (c + 1) * per])
    return res


def stochastic_round_bf16(x: torch.Tensor, key, kind: str = "vector",
                          out=None) -> torch.Tensor:
    """Seeded stochastic rounding of f32 ``x`` to bf16 (``precision.py:87``,
    ``E[SR(x)] == x``), written into ``out`` (a bf16 tensor of ``x``'s
    shape) where given: a store set of one leaf under ``key`` itself.
    ``x`` is a leaf of ``kind`` in PyTorch's layout (``"vector"``: the
    layouts agree), and the draw is indexed by the JAX layout, so a leaf
    rounds as the JAX package rounds it. CPU tensors take the plain
    version; CUDA tensors launch the kernel, which reads a key-table key
    from device memory (``prng.key_tensor``: a slot under a captured
    window)."""
    if x.device.type == "cpu":
        return stochastic_round_ref(x, key, kind, out)
    return stochastic_round_set(key, [x], [()], [kind], [out])[0]


# -- jax.random's threefry draws ----------------------------------------------

def random_bits_ref(key, n: int, device, uniform: bool = False):
    """Plain version of :func:`random_bits`: the threefry rounds of
    ``prng.threefry2x32`` on int64 tensors holding uint32 values."""
    from ewdml_tpu_torch.utils import prng

    idx = torch.arange(n, dtype=torch.int64, device=device)
    k0, k1 = prng.key_words(key)
    y0, y1 = prng.threefry2x32(k0, k1, idx >> 32, idx & 0xFFFFFFFF)
    bits = y0 ^ y1
    if not uniform:
        return bits
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def random_bits(key, n: int, device, uniform: bool = False) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` under the partitionable
    layout, as int64 holding uint32 values; with ``uniform``,
    ``jax.random.uniform``'s f32 in [0, 1) from the same bits. CPU devices
    take the plain version; on CUDA one launch of the draw kernel, which
    reads a key-table key from device memory (a captured launch draws each
    replay's bits) and takes a host key by value."""
    device = torch.device(device)
    if device.type == "cpu":
        return random_bits_ref(key, n, device, uniform)
    from ewdml_tpu_torch.kernels import library

    if n >= 1 << 32:
        raise ValueError("random_bits: a draw takes fewer than 2^32 "
                         "elements")
    out = torch.empty(n, dtype=torch.float32 if uniform else torch.int64,
                      device=device)
    if n == 0:
        return out
    _require_cuda(out, "random_bits", out.dtype)
    keyp, keyv = _key_arg(key, device)
    rc = library().ewdml_random_bits(keyp, keyv, n, int(uniform),
                                     out.data_ptr(), _stream_ptr(out))
    _launch_check(rc, "random_bits")
    _count("random_bits", out)
    return out


def threefry_draw(key, n: int, device, uniform: bool = False):
    """The draw of ``prng.random_bits`` / ``prng.uniform``, dispatched as
    the kernels are: the draw kernel on CUDA (``--pallas auto`` or
    ``on``), the plain version on the CPU and under ``off`` or
    ``interpret``."""
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda" and active(device) == "kernel":
        return random_bits(key, n, device, uniform)
    return random_bits_ref(key, n, device, uniform)
