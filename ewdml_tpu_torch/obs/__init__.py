"""Observability (``ewdml_tpu/obs``): only the clock so far."""
