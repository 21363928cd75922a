"""``ewdml_tpu_torch.experiments``: the resumable reproduction of the
paper's published table on the port (``ewdml_tpu/experiments``).

    python -m ewdml_tpu_torch.experiments --table baseline [--smoke]

- :mod:`~ewdml_tpu_torch.experiments.registry`: the paper's cells (Methods
  1-6 x {LeNet/MNIST, VGG11/CIFAR-10}) as declarative specs, and the
  published numbers they are judged against (BASELINE.md as data).
- :mod:`~ewdml_tpu_torch.experiments.runner`: the cells in order under a
  wall-clock budget, each journaled to a JSONL ledger keyed by a hash of
  its spec, each in its own child process under a watchdog; an
  interrupted sweep resumes by skipping completed cells and restarting
  the in-flight one from its checkpoint.
- :mod:`~ewdml_tpu_torch.experiments.collect`: a cell's metrics from the
  existing instruments (wire plan, evaluator, step timers, the
  epochs-to-target oracle).
- :mod:`~ewdml_tpu_torch.experiments.report`: ``REPRO.md`` (measured,
  published and deviation rows, hardware of both sides) and
  ``REPRO.json``.
"""

from ewdml_tpu_torch.experiments.registry import TABLES, CellSpec  # noqa: F401
