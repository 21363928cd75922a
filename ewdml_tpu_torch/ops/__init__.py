"""Gradient compression transforms (``ewdml_tpu/ops/__init__.py``).

``make_compressor`` maps the ``--compress-grad`` switch to compressors with
a uniform ``compress(key, tensor) -> payload`` /
``decompress(payload) -> tensor`` / ``wire_bytes(shape) -> int`` API.
"""

from __future__ import annotations

import logging

from ewdml_tpu_torch.ops.chain import TopKQSGDCompressor
from ewdml_tpu_torch.ops.none import NoneCompressor
from ewdml_tpu_torch.ops.qsgd import QSGDCompressor
from ewdml_tpu_torch.ops.topk import TopKCompressor


def make_compressor(name: str, quantum_num: int = 127,
                    topk_ratio: float = 0.5, topk_exact=None,
                    qsgd_block=None):
    """Factory for the ``--compress-grad`` switch."""
    name = (name or "none").lower()
    if name in ("none", "dense", "non"):
        return NoneCompressor()
    if name in ("compress", "qsgd"):
        return QSGDCompressor(quantum_num, block=qsgd_block)
    if name in ("topk", "top_k"):
        if topk_exact == "block":
            logging.getLogger("ewdml_tpu_torch").warning(
                "--topk-block applies to the topk_qsgd stack only; the plain "
                "top-k compressor has no block wire")
        return TopKCompressor(topk_ratio, exact=topk_exact)
    if name in ("topk_qsgd", "topk-qsgd", "method5"):
        return TopKQSGDCompressor(topk_ratio, quantum_num, exact=topk_exact,
                                  block=qsgd_block)
    if name == "terngrad":
        return QSGDCompressor(1, norm_kind="linf")
    raise ValueError(f"unknown compressor {name!r}")
