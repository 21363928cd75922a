"""Example scripts of the port (``examples/`` of the JAX package), each run
as ``python -m ewdml_tpu_torch.examples.<name>``."""
