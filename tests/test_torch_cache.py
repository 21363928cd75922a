"""The kernels' build directory, ``ewdml_tpu_torch/core/cache.py``: the
port's counterpart of ``tests/test_cache.py``.

The JAX test holds a second process to the persistent XLA cache the first
one wrote. Here the cache is the kernels' build: a first process builds
the library into ``EWDML_COMPILE_CACHE`` (through ``kernels.build``, with a
stand-in ``nvcc`` on ``PATH``, since this machine has no CUDA toolkit) and
a second process, with no ``nvcc`` at all, finds it. Oracles: exact (paths,
the files present, the build seconds a cached load reports).
"""

import os
import stat
import subprocess
import sys

import pytest

from ewdml_tpu_torch import kernels
from ewdml_tpu_torch.core import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BUILD = r"""
import os
from ewdml_tpu_torch import kernels
path = kernels.build()
assert os.path.dirname(path) == os.environ["EWDML_COMPILE_CACHE"], path
print("BUILT", path, kernels.build_seconds > 0, flush=True)
"""

# Writes the file each -o names: an object, then the linked library.
_FAKE_NVCC = """#!/bin/sh
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo built > "$2"; fi
  shift
done
"""


def _run(cache_dir: str, bindir: str) -> tuple:
    env = dict(os.environ, EWDML_COMPILE_CACHE=cache_dir, PYTHONPATH=REPO,
               PATH=f"{bindir}:/usr/bin:/bin",
               CUDA_HOME=os.path.join(bindir, "no_cuda"))
    env.pop("CUDA_PATH", None)
    out = subprocess.run([sys.executable, "-c", _BUILD], env=env,
                         capture_output=True, text=True, cwd=REPO,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("BUILT")]
    _, path, built = line[-1].split()
    return path, built == "True"


class TestCompilationCache:
    def test_second_process_hits_cache(self, tmp_path):
        cc = str(tmp_path / "cc")
        with_nvcc = tmp_path / "bin"
        with_nvcc.mkdir()
        nvcc = with_nvcc / "nvcc"
        nvcc.write_text(_FAKE_NVCC)
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
        path, built = _run(cc, str(with_nvcc))
        assert built and os.path.isfile(path)
        # Only the library is left: the objects were removed.
        assert os.listdir(cc) == [os.path.basename(path)]
        without = tmp_path / "empty_bin"
        without.mkdir()
        again, built = _run(cc, str(without))
        assert again == path and not built
        assert os.listdir(cc) == [os.path.basename(path)]

    def test_off_switch(self, tmp_path, monkeypatch):
        monkeypatch.setenv("EWDML_COMPILE_CACHE", "off")
        d = cache.enable_compilation_cache()
        assert d is not None and os.path.isdir(d)
        assert os.path.realpath(d) != os.path.realpath(cache.DEFAULT)
        assert cache.enable_compilation_cache() == d   # one a process
        assert os.path.dirname(kernels.library_path()) == d
        monkeypatch.setenv("EWDML_COMPILE_CACHE", "0")
        assert cache.enable_compilation_cache() == d

    def test_override(self, tmp_path, monkeypatch):
        target = str(tmp_path / "a" / "b")
        monkeypatch.setenv("EWDML_COMPILE_CACHE", target)
        assert cache.enable_compilation_cache() == target
        assert os.path.isdir(target)
        assert os.path.dirname(kernels.library_path()) == target
        other = str(tmp_path / "c")
        assert cache.enable_compilation_cache(other) == other

    def test_cpu_default_is_none_and_builds_nothing(self, monkeypatch):
        monkeypatch.delenv("EWDML_COMPILE_CACHE", raising=False)
        assert cache.enable_compilation_cache() is None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kernels.library_path()

    def test_host_library_builds_into_the_same_directory(self, tmp_path):
        # native.py's g++ library takes the directory from core/cache.py
        # too, on the CPU as on the card.
        cc = str(tmp_path / "cc")
        code = ("from ewdml_tpu_torch import native\n"
                "assert native.get_lib() is not None\n"
                "print('SO', native._so_path())\n")
        env = dict(os.environ, EWDML_COMPILE_CACHE=cc, PYTHONPATH=REPO)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, cwd=REPO,
                             timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
        so = out.stdout.split("SO ")[-1].strip()
        assert os.path.dirname(so) == cc
        assert os.listdir(cc) == [os.path.basename(so)]

    def test_default_is_beside_the_sources_and_ignored(self):
        assert cache.DEFAULT == os.path.join(
            REPO, "ewdml_tpu_torch", "kernels", "_build")
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert "ewdml_tpu_torch/kernels/_build/" in f.read().split()
