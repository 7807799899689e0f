"""Device choice for the port's entry points: the card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default, and asking
    for it without a usable GPU raises rather than running on the CPU; the
    CPU is used only when the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
