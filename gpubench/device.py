"""The card: its name, power limit and published peaks.

Peaks are NVIDIA's data-sheet figures, dense (no sparsity), keyed by
the name ``torch.cuda.get_device_name`` gives. A card missing from the
table has no peak, and the shares of a peak are then not reported.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

# name prefix -> (bf16 tensor-core FLOP/s, HBM bytes/s); longer prefixes
# first, so the PCIe and NVL parts are not read as the SXM part
PEAKS = (
    ("NVIDIA H100 PCIe", 756e12, 2.0e12),
    ("NVIDIA H100 NVL", 835e12, 3.9e12),
    ("NVIDIA H100", 989e12, 3.35e12),
    ("NVIDIA H200", 989e12, 4.8e12),
)


def peaks(name: str) -> Optional[tuple]:
    """``(flops, bytes)`` a second of the card named ``name``, or None."""
    for prefix, flops, nbytes in PEAKS:
        if name.startswith(prefix):
            return flops, nbytes
    return None


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not available"
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "not available"
