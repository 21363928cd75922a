"""The port imports nothing of JAX and nothing of the JAX package.

Every module of ``ewdml_tpu_torch`` (``experiments`` included) is imported
in a fresh interpreter, which then must hold neither ``jax`` nor
``ewdml_tpu`` in ``sys.modules``. Oracle: exact.
"""

import os
import subprocess
import sys

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
