"""Build and load the hand-written CUDA kernels (``compress.cu``,
``decode.cu``, ``precision.cu``, ``random.cu``; the last two include
``threefry.cuh``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object, all of
them at once (one ``nvcc`` process per source), on first use, into
``kernels/_build/`` beside the sources; the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
library name carries a hash of the sources and the headers they include,
so an edited source or header is rebuilt and a stale build is never
loaded.
Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ewdml_tpu_torch.obs import clock

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_HERE, "compress.cu"),
           os.path.join(_HERE, "decode.cu"),
           os.path.join(_HERE, "precision.cu"),
           os.path.join(_HERE, "random.cu"))
#: Headers the sources include: hashed with them, not compiled alone.
HEADERS = (os.path.join(_HERE, "threefry.cuh"),)
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
#: Seconds the last build took (0.0 when a cached library was loaded).
build_seconds = 0.0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "the CUDA kernels need nvcc (CUDA toolkit) to build; none found "
            "on PATH or under $CUDA_HOME")
    return path


def _source_hash() -> str:
    h = hashlib.sha1()
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels (if this source has no build yet); return the
    library path. Raises with the compiler's output when nvcc fails."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libewdml_compress_{_source_hash()}.so")
    if os.path.exists(lib_path):
        build_seconds = 0.0
        return lib_path
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    nvcc = nvcc_path()
    objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
    t0 = clock.monotonic()
    try:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                for obj, src in zip(objs, SOURCES)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        outs = [p.communicate() for p in procs]
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        for cmd, p, (out, err) in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}\n{err}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
    os.replace(tmp, lib_path)
    build_seconds = clock.monotonic() - t0
    return lib_path


def _declare(lib) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    # The murmur seed is a pointer to an int32 in device memory.
    lib.ewdml_qsgd_quantize.argtypes = [p, p, i64, i64, p, i32, p, p]
    lib.ewdml_dequant_mean.argtypes = [p, p, i32, i64, i64, i64,
                                       ctypes.c_float, p, p]
    lib.ewdml_block_top1.argtypes = [p, i32, i32, p, p, p]
    f32 = ctypes.c_float
    lib.ewdml_chunk_encode.argtypes = [p, i64, i64, p, i32, p, p, p]
    lib.ewdml_dequant_acc_requant.argtypes = [p, p, p, i64, i64, p, i32,
                                              f32, f32, p, p, p]
    lib.ewdml_int_accumulate.argtypes = [p, i32, i64, p, p]
    # A decode set's and a store set's leaves are host arrays of packed
    # descriptors. The threefry kernels' key: a pointer to one uint64 in
    # device memory, or null and the packed key by value.
    lib.ewdml_acc_decode_set.argtypes = [p, i32, ctypes.c_uint64,
                                         ctypes.c_uint64, p]
    u64 = ctypes.c_uint64
    lib.ewdml_stochastic_round_set.argtypes = [p, u64, p, i32, p]
    lib.ewdml_random_bits.argtypes = [p, u64, i64, i32, p, p]
    for fn in (lib.ewdml_qsgd_quantize, lib.ewdml_dequant_mean,
               lib.ewdml_block_top1, lib.ewdml_chunk_encode,
               lib.ewdml_dequant_acc_requant, lib.ewdml_int_accumulate,
               lib.ewdml_acc_decode_set, lib.ewdml_stochastic_round_set,
               lib.ewdml_random_bits):
        fn.restype = ctypes.c_int


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib
