"""The kernels' build directory (``ewdml_tpu/core/cache.py``).

The JAX package's compile cost is XLA's, and its module points JAX's
persistent compilation cache at a directory. The port's compile cost is the
``nvcc`` build of its CUDA kernels (``kernels/__init__.build``: one object a
source, linked into one library whose name hashes the sources), so this
module says where that build lives: a library built there once is found by
every later process, on this host or any that shares the directory. The
host library of ``native.py`` (``g++``) builds there too.

- ``EWDML_COMPILE_CACHE=<dir>`` picks the directory;
- ``EWDML_COMPILE_CACHE=off`` (or ``0``) builds into a fresh temporary
  directory of this process, removed when it exits;
- otherwise ``ewdml_tpu_torch/kernels/_build/`` beside the sources (listed
  in ``.gitignore``), so that a checkout builds its own kernels from its
  own sources at first use.

On the CPU (no CUDA device) no kernel is built, and
:func:`enable_compilation_cache` returns None unless a directory is named,
as the JAX module does on the CPU backend; :func:`build_dir` names the
directory on any device, for the host library.
"""

from __future__ import annotations

import atexit
import logging
import os
import shutil
import tempfile

logger = logging.getLogger("ewdml_tpu_torch.cache")

ENV = "EWDML_COMPILE_CACHE"
DEFAULT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kernels", "_build")
_OFF = ("off", "0", "none", "")
_fresh = None   # this process's temporary directory under "off"


def _fresh_dir() -> str:
    global _fresh
    if _fresh is None:
        _fresh = tempfile.mkdtemp(prefix="ewdml_kernels_")
        atexit.register(shutil.rmtree, _fresh, True)
    return _fresh


def build_dir(path: str | None = None) -> str:
    """The build directory (created), on any device. ``path`` overrides
    the environment and the default; ``EWDML_COMPILE_CACHE=off`` gives
    this process a fresh one."""
    env = os.environ.get(ENV)
    if env is not None and env.lower() in _OFF:
        return _fresh_dir()
    target = path or env or DEFAULT
    os.makedirs(target, exist_ok=True)
    logger.debug("build directory %s", target)
    return target


def enable_compilation_cache(path: str | None = None) -> str | None:
    """The directory the kernels build into (:func:`build_dir`), or None
    on the CPU with none named."""
    if path is None and os.environ.get(ENV) is None:
        import torch

        if not torch.cuda.is_available():
            return None
    return build_dir(path)
