"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Without a
card they raise: a run that silently moved to the CPU would report the CPU's
speed under the card's name.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --cpu on the "
            "command line) to run on the CPU"
        )
    return dev
