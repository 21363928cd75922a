"""The port imports nothing of JAX and nothing of the JAX package.

Every module of ``ewdml_tpu_torch`` (``experiments`` included) is imported
in a fresh interpreter, which then must hold neither ``jax`` nor
``ewdml_tpu`` in ``sys.modules``. Oracle: exact.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import ewdml_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    ewdml_tpu_torch.__path__, "ewdml_tpu_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "ewdml_tpu"))
print(len(names), "modules;", "imported:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_jax_package():
    p = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr[-3000:]
    count = int(p.stdout.split()[0])
    assert count >= 60  # every module, the experiments package included
    assert "imported: []" in p.stdout


_NEW = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "ewdml_tpu"))
print("imported:", bad)
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("module", [
    "ewdml_tpu_torch.hvd", "ewdml_tpu_torch.hvd.keras",
    "ewdml_tpu_torch.obs.serve", "ewdml_tpu_torch.obs.merge",
    "ewdml_tpu_torch.obs.export", "ewdml_tpu_torch.obs.rounds",
    "ewdml_tpu_torch.obs.report", "ewdml_tpu_torch.examples",
    "ewdml_tpu_torch.examples.horovod_style"])
def test_slice_p_modules_import_no_jax(module):
    """Exact: the horovod-style substrate, the observability plane and
    the examples, each alone in a fresh interpreter, load neither ``jax``
    nor ``ewdml_tpu``; their sources name neither."""
    p = subprocess.run([sys.executable, "-c", _NEW, module], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr[-3000:]
    path = os.path.join(REPO, *module.split("."))
    path = (os.path.join(path, "__init__.py") if os.path.isdir(path)
            else path + ".py")
    with open(path) as f:
        src = f.read()
    assert not re.search(r"^\s*(from|import)\s+(jax|ewdml_tpu)\b", src,
                         re.MULTILINE)
