"""Hardware provenance (``ewdml_tpu/utils/provenance.py``): what machine
produced a number of record.

On the card it reads the device (``torch.cuda.get_device_properties``),
its power limit (``nvidia-smi --query-gpu=name,power.limit``: a card set
below its maximum runs slower under load) and the torch and CUDA versions.
"""

from __future__ import annotations

import platform
import socket
import subprocess

import torch

from ewdml_tpu_torch.parallel import launcher


def smi_name_power() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` of card 0, as printed."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def hardware_provenance(mesh_devices: int | None = None) -> dict:
    """One JSON-able block: platform, device name and count, its memory,
    SMs and power limit, host and versions. ``mesh_devices`` records how
    many devices the measurement used."""
    cuda = torch.cuda.is_available()
    out = {
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "process_count": launcher.process_count(),
        "hostname": socket.gethostname(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": platform.python_version(),
        "os": platform.platform(),
    }
    if cuda:
        props = torch.cuda.get_device_properties(0)
        out.update({
            "sm_count": props.multi_processor_count,
            "memory_bytes": props.total_memory,
            "capability": f"{props.major}.{props.minor}",
            "name_power_limit": smi_name_power(),
        })
    if mesh_devices is not None:
        out["mesh_devices"] = int(mesh_devices)
    return out
