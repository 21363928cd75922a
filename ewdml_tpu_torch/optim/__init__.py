"""Explicit-gradient optimizers (``ewdml_tpu/optim``)."""

from ewdml_tpu_torch.optim.sgd import SGD, SGDState, make_optimizer  # noqa: F401
