"""Device selection for the port's entry points.

Model builders, the weight bridge, and the serving engine run on the
CUDA card unless the caller asks for the CPU explicitly (the tests do).
With no card and no explicit request they raise: a run that silently
lands on the host would report host numbers under a device's name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the first CUDA device; anything else is taken as
    given. Raises ``RuntimeError`` when CUDA is asked for (explicitly or
    by default) and this process has no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the host"
        )
    return dev
