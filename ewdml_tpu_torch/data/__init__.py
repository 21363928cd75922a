"""Data pipelines (numpy), copied from the JAX package."""

from ewdml_tpu_torch.data.datasets import Dataset, load  # noqa: F401
from ewdml_tpu_torch.data.loader import eval_batches, global_batches  # noqa: F401
