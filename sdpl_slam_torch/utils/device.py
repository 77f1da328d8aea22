"""The one rule for devices in this package: the card unless the caller
asks for the CPU, and no silent fallback from the card to the CPU."""

from __future__ import annotations

import torch


def checked_device(device, who: str) -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and there is no
    CUDA device.  ``who`` names the caller in the message."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("%s(device=%r): no CUDA device is available; pass "
                           "device='cpu' to run on the CPU" % (who, device))
    return dev
