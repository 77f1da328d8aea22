"""The one rule for devices in this package: the card unless the caller
asks for the CPU, and no silent fallback from the card to the CPU; the
scatter-add that sums in one order on either; the dense solves' library
on the card; and the copies in and home that do not wait for the card."""

from __future__ import annotations

import contextlib

import numpy as np
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


@contextlib.contextmanager
def cusolver_linalg(device: torch.device):
    """On the card, route ``torch.linalg``'s factorisations and solves to
    cuSOLVER / cuBLAS inside the block.  PyTorch's own heuristics send
    some shapes to MAGMA (a batch of small systems with 256 to 1024
    right-hand sides: the BA's Schur step), whose calls synchronise with
    the host and so cannot be captured into a CUDA graph; the eager plain
    version takes the same routes, so the two stay bit for bit equal.  A
    no-op on the CPU."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def copy_in(buffers: dict, arrays: dict) -> None:
    """Copy host arrays into the device buffers of the same names: on the
    card from a fresh pinned copy each, non-blocking (the caching host
    allocator keeps the pinned block until the copy has run, so the next
    frame's copy cannot overwrite it first).  NumPy fills the pinned
    block on the calling thread: ``Tensor.pin_memory()`` copies a frame's
    image with an OpenMP parallel region, whose idle workers then spin on
    the host's cores and slow the tracking loop's own thread."""
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a)
        dst = buffers[name]
        if dst.is_cuda:
            pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            np.copyto(pinned.numpy(), a)
            dst.copy_(pinned, non_blocking=True)
        else:
            dst.copy_(t)


def to_host_async(t: torch.Tensor):
    """Start ``t``'s copy home: on the card a non-blocking copy into pinned
    memory and a CUDA event recorded after it on the current stream; on
    the CPU a copy and no event.  Either way the copy is taken before any
    later work on the stream can overwrite ``t`` (a static buffer that
    the next frame rewrites).  :func:`host_array` waits for it."""
    if not t.is_cuda:
        return t.clone(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def host_array(host: torch.Tensor, ready) -> np.ndarray:
    """The numpy view of a :func:`to_host_async` copy, once it has landed."""
    if ready is not None:
        ready.synchronize()
    return host.numpy()
