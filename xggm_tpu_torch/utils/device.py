"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return `device` as a torch.device; raise if it names CUDA and no card
    is present. There is no silent fallback to the CPU: a caller that wants
    the CPU passes `device="cpu"`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
