"""Device resolution shared by every entry point of the port.

The port runs on a CUDA card.  An entry point given no device takes
``cuda``; the CPU is used only when the caller asks for it (the tests do).
Without a card and without that request the entry point raises: nothing
carries on on the CPU by itself.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
