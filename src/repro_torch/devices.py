"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for another device.
With no CUDA device and no explicit ``device=``, they raise: the port never
drops to the CPU quietly.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device`` as a torch.device; None means the current CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
