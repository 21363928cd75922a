"""Identity "compressor": the dense path (``--compress-grad none``)."""

from __future__ import annotations

import dataclasses

import torch

from ewdml_tpu_torch.ops.bytes import numel, tensor_nbytes


@dataclasses.dataclass
class DensePayload:
    values: torch.Tensor
    shape: tuple

    @property
    def wire_bytes(self) -> int:
        return tensor_nbytes(self.values)


class NoneCompressor:
    def compress(self, key, tensor: torch.Tensor) -> DensePayload:
        del key
        return DensePayload(values=tensor.reshape(-1), shape=tuple(tensor.shape))

    def decompress(self, payload: DensePayload) -> torch.Tensor:
        return payload.values.reshape(payload.shape)

    def wire_bytes(self, shape, dtype=torch.float32) -> int:
        return numel(shape) * dtype.itemsize
