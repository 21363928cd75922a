"""ctypes loader for the native host runtime (``ewdml_tpu/native.py``).

Compiles ``native/ewdml_native.cpp`` (the repository's shared source) with
``g++`` on first use into ``ewdml_tpu_torch/kernels/_build/``; it never
writes under ``native/``. Everything here has a pure-Python fallback with
the same bytes: the library gates the fast path, never functionality.

The wire frame: ``[u32 magic][u32 n_sections][u32 total_len]`` then per
section ``[u32 len][u32 crc32][len bytes]``, each padded to 4 bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger("ewdml_tpu_torch.native")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "native", "ewdml_native.cpp")
_BUILD_DIR = os.path.join(_HERE, "kernels", "_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()
_build_failed = False


def _so_path() -> str:
    h = hashlib.sha1()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libewdml_native_{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    # Compile to a process-private temp path then rename, so a concurrent
    # process never loads a half-written library.
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except Exception as e:  # noqa: BLE001 -- the fallback serves instead
        logger.warning("native build failed (%s); using Python fallbacks", e)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(_SRC):
            _build_failed = True
            return None
        so = _so_path()
        if not os.path.exists(so) and not _build(so):
            _build_failed = True
            return None
        lib = ctypes.CDLL(so)
        u64, u32, vp = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_void_p
        lib.wire_encoded_size.restype = u64
        lib.wire_encoded_size.argtypes = [ctypes.POINTER(u64), u32]
        lib.wire_encode.restype = u64
        lib.wire_encode.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(u64),
                                    u32, vp]
        lib.wire_decode_header.restype = ctypes.c_int64
        lib.wire_decode_header.argtypes = [vp, u64, ctypes.POINTER(u64),
                                           ctypes.POINTER(u64), u32]
        _lib = lib
        return _lib


# -- wire codec --------------------------------------------------------------

def wire_encode(sections: list) -> bytes:
    """Concatenate byte sections into one checksummed message."""
    lib = get_lib()
    if lib is None:
        return _py_wire_encode(sections)
    n = len(sections)
    bufs = [np.frombuffer(s, np.uint8) for s in sections]
    lens = (ctypes.c_uint64 * n)(*[b.size for b in bufs])
    ptrs = (ctypes.c_void_p * n)(
        *[b.ctypes.data_as(ctypes.c_void_p).value for b in bufs])
    size = lib.wire_encoded_size(lens, n)
    out = np.empty(size, np.uint8)
    written = lib.wire_encode(ptrs, lens, n,
                              out.ctypes.data_as(ctypes.c_void_p))
    if written != size:
        raise RuntimeError(f"wire_encode wrote {written} of {size} bytes")
    return out.tobytes()


def wire_encoded_size(lens: list) -> int:
    """Exact encoded size for sections of the given lengths."""
    return 12 + sum(8 + (ln + 3) // 4 * 4 for ln in lens)


def wire_decode(msg: bytes, max_sections: int = 4096) -> list:
    """Inverse of :func:`wire_encode`; raises ValueError on corruption."""
    lib = get_lib()
    if lib is None:
        return _py_wire_decode(msg)
    buf = np.frombuffer(msg, np.uint8)
    lens = (ctypes.c_uint64 * max_sections)()
    offs = (ctypes.c_uint64 * max_sections)()
    n = lib.wire_decode_header(buf.ctypes.data_as(ctypes.c_void_p), buf.size,
                               lens, offs, max_sections)
    if n < 0:
        raise ValueError("corrupt wire message")
    return [buf[offs[i]:offs[i] + lens[i]].tobytes() for i in range(n)]


def _py_wire_encode(sections: list) -> bytes:
    import struct
    import zlib

    out = [struct.pack("<III", 0x45574D4C, len(sections), 0)]
    for s in sections:
        out.append(struct.pack("<II", len(s), zlib.crc32(s) & 0xFFFFFFFF))
        out.append(s + b"\x00" * ((-len(s)) % 4))
    msg = b"".join(out)
    return msg[:8] + struct.pack("<I", len(msg)) + msg[12:]


def _py_wire_decode(msg: bytes) -> list:
    import struct
    import zlib

    if len(msg) < 12:
        raise ValueError("corrupt wire message")
    magic, n, total = struct.unpack_from("<III", msg, 0)
    if magic != 0x45574D4C or total != len(msg):
        raise ValueError("corrupt wire message")
    off, out = 12, []
    for _ in range(n):
        ln, crc = struct.unpack_from("<II", msg, off)
        off += 8
        payload = msg[off:off + ln]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise ValueError("corrupt wire message")
        out.append(payload)
        off += ln + ((-ln) % 4)
    return out


# -- array transport (schema section + raw buffers) --------------------------

def _schema(arrays: list) -> bytes:
    import json

    return json.dumps([(a.dtype.str, list(a.shape)) for a in arrays]).encode()


def encode_arrays(arrays: list) -> bytes:
    """Numpy arrays as one wire message: section 0 is a JSON schema
    ``[(dtype, shape), ...]``, sections 1..N the raw buffers."""
    return wire_encode([_schema(arrays)]
                       + [np.ascontiguousarray(a).tobytes() for a in arrays])


def encoded_arrays_size(arrays: list) -> int:
    """Bytes :func:`encode_arrays` makes of ``arrays`` (their payload plus
    the frame and the schema)."""
    return wire_encoded_size([len(_schema(arrays))]
                             + [a.nbytes for a in arrays])


def decode_arrays(msg: bytes) -> list:
    import json

    sections = wire_decode(msg)
    meta = json.loads(sections[0].decode())
    return [np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
            for (dtype, shape), raw in zip(meta, sections[1:])]
