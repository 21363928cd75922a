"""Cluster tools (``ewdml_tpu/tools/``): the GPU-instance provisioner."""
