"""The msgpack subset a checkpoint is written in (the counterpart of what
``flax.serialization.to_bytes`` / ``msgpack_restore`` use).

A checkpoint of the JAX package is ``msgpack.packb(state_dict,
strict_types=True)`` with two extension types for arrays, so this module
writes and reads exactly that subset, byte for byte the same as flax for the
same state dict:

- maps with ``str`` keys (in insertion order), ``int``, ``float`` (always
  float64), ``str``, ``bytes`` (bin), ``bool``, ``None`` and lists;
- ext type 1, an array: ``packb((shape, dtype name, C-order bytes))``. A
  ``torch.Tensor`` or a ``numpy.ndarray`` encodes so, and decodes to a CPU
  ``torch.Tensor`` (``bfloat16`` by its name, which numpy lacks);
- ext type 3, a numpy scalar, stored as a 0-d array; it decodes to a 0-d
  tensor.

Flax splits an array of more than ``MAX_CHUNK_SIZE`` bytes into chunks; no
leaf of a model the port supports comes near it, so such a leaf raises
here instead.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

#: flax.serialization.MAX_CHUNK_SIZE: above it flax chunks a leaf.
MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY = 1
EXT_NPSCALAR = 3

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``torch.bfloat16`` -> ``bfloat16``)."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise TypeError(f"no checkpoint dtype for {dtype}") from None


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise TypeError(f"unsupported array dtype {name!r} in checkpoint") \
            from None


# -- encoder ------------------------------------------------------------------

def _header(out: list, n: int, small: int, small_max: int, codes) -> None:
    """A container/raw header: the fix form below ``small_max`` (if any),
    then the 8/16/32-bit length forms ``codes``."""
    if small_max and n < small_max:
        out.append(bytes([small | n]))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 2 ** 32:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack object of length {n} is too large")


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0x80 <= v <= 0xFF:
        out.append(struct.pack("BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0xFF < v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < -0x80:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError("Integer value out of range")


def _pack_bin(out: list, data) -> None:
    _header(out, len(data), 0, 0, (0xC4, 0xC5, 0xC6))
    out.append(data)


def _pack_array(out: list, code: int, shape, name: str, raw) -> None:
    """An array extension: flax's ``_ndarray_to_bytes`` payload,
    ``packb((shape, name, raw))``, with ``raw`` appended as it is (no copy
    of the element bytes)."""
    head: list = [b"\x93"]
    _header(head, len(shape), 0x90, 16, (None, 0xDC, 0xDD))
    for d in shape:
        _pack_int(head, int(d))
    _pack_str(head, name)
    _header(head, len(raw), 0, 0, (0xC4, 0xC5, 0xC6))
    head = b"".join(head)
    n = len(head) + len(raw)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fixed is not None:
        out.append(bytes([fixed]))
    elif n <= 0xFF:
        out.append(struct.pack(">BB", 0xC7, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xC8, n))
    else:
        out.append(struct.pack(">BI", 0xC9, n))
    out.append(struct.pack("b", code))
    out.append(head)
    out.append(raw)


def _pack_str(out: list, s: str) -> None:
    data = s.encode("utf-8")
    _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
    out.append(data)


def _tensor_raw(t: torch.Tensor) -> tuple:
    nbytes = t.numel() * t.element_size()
    if nbytes >= MAX_CHUNK_SIZE:
        raise ValueError(f"array leaf of {nbytes} bytes reaches "
                         f"{MAX_CHUNK_SIZE}; flax would chunk it")
    t = t.detach().to("cpu").contiguous()
    raw = (memoryview(t.reshape(-1).view(torch.uint8).numpy()) if nbytes
           else b"")
    return tuple(t.shape), dtype_name(t.dtype), raw


def pack_into(obj, out: list) -> None:
    """Append the msgpack encoding of ``obj`` to ``out`` (a list of byte
    chunks), as ``msgpack.packb(obj, default=flax's ext hook,
    strict_types=True)`` writes it."""
    tp = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif tp is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif tp is int:
        _pack_int(out, obj)
    elif tp is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif tp is str:
        _pack_str(out, obj)
    elif tp in (bytes, bytearray):
        _pack_bin(out, obj)
    elif tp is dict:
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            pack_into(k, out)
            pack_into(v, out)
    elif tp is list:
        _header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            pack_into(v, out)
    elif isinstance(obj, torch.Tensor):
        _pack_array(out, EXT_NDARRAY, *_tensor_raw(obj))
    elif isinstance(obj, np.ndarray):
        _pack_array(out, EXT_NDARRAY, *_numpy_raw(obj))
    elif isinstance(obj, np.generic):
        _pack_array(out, EXT_NPSCALAR, *_numpy_raw(np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialize {tp.__name__} to a checkpoint")


def _numpy_raw(a: np.ndarray) -> tuple:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if a.nbytes >= MAX_CHUNK_SIZE:
        raise ValueError(f"array leaf of {a.nbytes} bytes reaches "
                         f"{MAX_CHUNK_SIZE}; flax would chunk it")
    return a.shape, a.dtype.name, a.tobytes("C")


def packb(obj) -> bytes:
    """The msgpack encoding of ``obj`` (see :func:`pack_into`)."""
    out: list = []
    pack_into(obj, out)
    return b"".join(out)


# -- decoder ------------------------------------------------------------------

class Reader:
    """A cursor over a buffer. Arrays decode to tensors that are views of
    it (keep it writable, a ``bytearray``, so tensors can wrap it without a
    copy); with ``arrays=False`` they are stepped over and read as None."""

    def __init__(self, buf, arrays: bool = True):
        self.mv = memoryview(buf)
        self.pos = 0
        self.arrays = arrays

    def release(self) -> None:
        """Let go of the buffer (an ``mmap`` closes only after this)."""
        self.mv.release()

    def map_len(self) -> int:
        """The entry count of the map that starts here (its header read)."""
        b = self.byte()
        if 0x80 <= b <= 0x8F:
            return b & 0x0F
        if b in (0xDE, 0xDF):
            return self.unpack(">H" if b == 0xDE else ">I")
        raise ValueError(f"expected a msgpack map, found type byte 0x{b:02x}")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def byte(self) -> int:
        return self.take(1)[0]

    def value(self):
        b = self.byte()
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            v = self.unpack(ints[b])
            return float(v) if b in (0xCA, 0xCB) else v
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lens:
            return self.take(self.unpack(lens[b]))
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lens:
            return self._str(self.unpack(lens[b]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixed:
            return self._ext(fixed[b])
        lens = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lens:
            return self._ext(self.unpack(lens[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        if not self.arrays:
            return None
        inner = Reader(data)
        shape, name, raw = inner.value()
        return _tensor(tuple(shape), name, raw)


def _tensor(shape: tuple, name: str, raw: memoryview) -> torch.Tensor:
    dtype = torch_dtype(name)
    if len(raw) == 0:
        return torch.empty(shape, dtype=dtype)
    flat = torch.frombuffer(raw, dtype=torch.uint8)
    return flat.view(dtype).reshape(shape)


def unpackb(buf):
    """Decode one msgpack value from ``buf``. Arrays become CPU tensors that
    share ``buf``'s memory when it is a writable ``bytearray`` (a ``bytes``
    object is copied first)."""
    r = Reader(bytearray(buf) if isinstance(buf, bytes) else buf)
    out = r.value()
    if r.pos != len(r.mv):
        raise ValueError("extra data after the msgpack value")
    return out
