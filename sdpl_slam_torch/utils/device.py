"""The one rule for devices in this package: the card unless the caller
asks for the CPU, and no silent fallback from the card to the CPU; and the
scatter-add that sums in one order on either."""

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


def scatter_add(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.index_add_(0, idx, src)`` in one fixed order of summation.  On
    the card ``index_add_`` adds with atomics in an order that varies from
    run to run; float32 CG amplifies that (the batch BA's iteration count
    and time vary with it), and a threshold compare after such a sum (the
    line detector's merge) can flip.  PyTorch's deterministic mode routes
    the call through a sorted accumulate instead.  It is switched on
    around this call alone: on for a whole solve it would also demand a
    cuBLAS workspace setting of the process."""
    if not dst.is_cuda or torch.are_deterministic_algorithms_enabled():
        dst.index_add_(0, idx, src)
        return
    torch.use_deterministic_algorithms(True)
    try:
        dst.index_add_(0, idx, src)
    finally:
        torch.use_deterministic_algorithms(False)
