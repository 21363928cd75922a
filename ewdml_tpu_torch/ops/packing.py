"""Sub-byte bit packing for quantized levels (``ewdml_tpu/ops/packing.py``).

Levels in ``[-s, s]`` are biased to ``[0, 2s]`` and packed 2 or 4 per uint8
lane when they need fewer than 8 bits (s=7 -> 4 bits, s=1 -> 2 bits).
"""

from __future__ import annotations

import torch


def width_for(s: int) -> int:
    """Bits per element needed for levels in [-s, s], rounded to {2,4,8,16,32}."""
    span = 2 * s + 1
    for w in (2, 4, 8, 16):
        if span <= (1 << w):
            return w
    return 32


def pack(levels: torch.Tensor, s: int) -> torch.Tensor:
    """Pack signed levels [-s, s] into a uint8 tensor of ceil(n*w/8) bytes."""
    w = width_for(s)
    u = levels.to(torch.int64) + s
    if w == 32:
        return u.to(torch.int32).view(torch.uint8)  # little-endian uint32 bytes
    if w == 8:
        return u.to(torch.uint8)
    if w == 16:
        return u.to(torch.int16).view(torch.uint8)
    per = 8 // w
    pad = (-u.numel()) % per
    u = torch.nn.functional.pad(u, (0, pad)).reshape(-1, per)
    shifts = torch.arange(per, dtype=torch.int64, device=u.device) * w
    return (u << shifts).sum(dim=1).to(torch.uint8)


def unpack(packed: torch.Tensor, s: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack`; ``n`` is the original element count."""
    w = width_for(s)
    if w == 32:
        u = packed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    elif w == 8:
        u = packed.to(torch.int64)
    elif w == 16:
        u = packed.view(torch.int16).to(torch.int64) & 0xFFFF
    else:
        per = 8 // w
        shifts = torch.arange(per, dtype=torch.int64, device=packed.device) * w
        u = ((packed.to(torch.int64)[:, None] >> shifts) & ((1 << w) - 1))
        u = u.reshape(-1)[:n]
    return (u - s)[:n].to(torch.int32)


def packed_nbytes(n: int, s: int) -> int:
    w = width_for(s)
    return (n * w + 7) // 8
