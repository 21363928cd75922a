"""PyTorch/CUDA port of ewdml_tpu: synchronous data-parallel training with
gradient compression (Methods 1-6) on NVIDIA Hopper GPUs.

The JAX package ``ewdml_tpu`` is the reference this package is held
against; this package imports nothing of it.
"""
