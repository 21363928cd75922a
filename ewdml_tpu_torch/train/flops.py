"""FLOPs and MFU accounting (``ewdml_tpu/train/flops.py``).

The JAX package reads a step's FLOPs from XLA's cost model; here
:func:`count_flops` runs the step under ``torch.utils.flop_counter.
FlopCounterMode``, which counts the matrix products and convolutions of
the forward and backward passes (2 per multiply-add), the model FLOPs of
the PaLM appendix B convention. Elementwise work, the compressors and the
hand-written kernels are not counted.

MFU = FLOPs per second per device / the device's peak, as in the JAX
package.

:func:`count_bytes` is the counterpart of the bytes the JAX package reads
from XLA's cost model: the operand and result bytes of every aten op of one
call, plus what each hand-written kernel reads and writes. It counts before
any fusion, so it is not comparable with XLA's figure.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger("ewdml_tpu_torch.flops")

# Peak dense TFLOP/s per card by device-name substring, (bf16 tensor cores,
# f32 without tensor cores), from NVIDIA's H100 and H200 data sheets (dense,
# no sparsity; the SXM parts at their 700 W limit, the PCIe part at 350 W).
# A measured rate belongs in PERF.md beside the card's name and power limit.
_PEAKS = (
    ("h100 pcie", (756.0, 51.0)),
    ("h100", (989.0, 67.0)),     # H100 SXM5 80GB HBM3
    ("h200", (989.0, 67.0)),
)

# Peak device-memory GB/s per card, same sources.
_HBM_GBS = (
    ("h100 pcie", 2000.0),
    ("h100", 3350.0),
    ("h200", 4800.0),
)


def _cuda_name(device) -> str | None:
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(dev).lower()


def peak_tflops(device=None, bf16: bool = True) -> float | None:
    """Peak TFLOP/s of one card (bf16 tensor cores, or f32 with
    ``bf16=False``); None off the card or for an unknown one."""
    name = _cuda_name(device)
    if name is None:
        return None
    for sub, (peak_bf16, peak_f32) in _PEAKS:
        if sub in name:
            return peak_bf16 if bf16 else peak_f32
    logger.warning("unknown GPU %r: no peak FLOP/s in the table", name)
    return None


def hbm_peak_gbs(device=None) -> float | None:
    """Peak device-memory GB/s of one card; None off the card or for an
    unknown one."""
    name = _cuda_name(device)
    if name is None:
        return None
    for sub, gbs in _HBM_GBS:
        if sub in name:
            return gbs
    logger.warning("unknown GPU %r: no memory rate in the table", name)
    return None


def count_flops(fn, *args, **kwargs) -> float:
    """The FLOPs of one call ``fn(*args, **kwargs)``, counted while it runs
    (the call's side effects happen: give it a state that may advance)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def _tensor_bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves

    from ewdml_tpu_torch.ops.bytes import tensor_nbytes

    return sum(tensor_nbytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def count_bytes(fn, *args, **kwargs) -> float:
    """The bytes one call ``fn(*args, **kwargs)`` moves, counted while it
    runs (its side effects happen, as for :func:`count_flops`): each aten
    op's tensor operands read once and results written once, views and
    allocations none; each kernel launch its operands and results
    (``ops/kernels.kernel_bytes``: the kernels bypass the dispatcher)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ewdml_tpu_torch.ops import kernels

    aten = torch.ops.aten
    no_bytes = (aten.empty, aten.empty_like, aten.empty_strided,
                aten.new_empty, aten.new_empty_strided, aten._unsafe_view)

    class _Counter(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not (func.is_view or func.overloadpacket in no_bytes):
                self.total += _tensor_bytes((args, kwargs)) + \
                    _tensor_bytes(out)
            return out

    with kernels.kernel_bytes() as tally, _Counter() as counter:
        fn(*args, **kwargs)
    return float(counter.total + tally.nbytes)


def mfu(flops_per_step: float, step_s: float, n_devices: int = 1,
        device=None, bf16: bool = True) -> float | None:
    """Model FLOPs utilization in [0, 1]; None without a known peak."""
    peak = peak_tflops(device, bf16=bf16)
    if peak is None or step_s <= 0:
        return None
    per_chip = flops_per_step / max(1, n_devices)
    return per_chip / step_s / (peak * 1e12)
