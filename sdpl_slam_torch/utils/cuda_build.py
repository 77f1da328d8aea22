"""Build and load the package's CUDA kernels (``sdpl_slam_torch/csrc``).

Each ``.cu`` file exposes a plain C entry point, so it is compiled by
``nvcc`` straight into a shared library and bound with ``ctypes`` -- a few
seconds per file, where a PyTorch C++ extension takes minutes.  Libraries
go to ``build/sdpl_torch_kernels/`` beside the package, named by the hash
of their source, so an edited kernel is rebuilt at its first use and an
unchanged one is loaded as it is.  A failed build raises with nvcc's
output; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sdpl_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOADED: dict = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda, in that order."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path(source: str) -> Path:
    """Where the library for ``csrc/<source>`` lives once built."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / ("lib%s_%s.so" % (src.stem, digest))


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library of the same source hash
    exists; returns its path."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           str(CSRC / source)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed for %s (exit %d):\n%s\n%s" % (
            source, r.returncode, r.stdout, r.stderr))
    os.replace(tmp, out)              # atomic: concurrent builds agree
    (out.with_suffix(".ptxas.txt")).write_text(r.stderr)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (first use) and ``ctypes``-load ``csrc/<source>``; cached per
    process."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _LOADED[source] = lib
        return lib


def check_inputs(name: str, want):
    """The CUDA device of ``want``'s (label, tensor, dtype, shape) rows, a
    kernel's arguments; raises ValueError unless each is a tensor of its
    dtype and shape, contiguous, and all lie on one CUDA device."""
    for label, t, dtype, shape in want:
        if t is None:
            raise ValueError("%s: %s is missing" % (name, label))
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError("%s: %s is %s %s, wants %s %s" % (
                name, label, t.dtype, tuple(t.shape), dtype, shape))
        if not t.is_contiguous():
            raise ValueError("%s: %s is not contiguous" % (name, label))
    dev = want[0][1].device
    if dev.type != "cuda":
        raise ValueError("%s: %s lies on %s" % (name, want[0][0], dev))
    for label, t, _, _ in want[1:]:
        if t.device != dev:
            raise ValueError("%s: %s on %s, %s on %s"
                             % (name, label, t.device, want[0][0], dev))
    return dev
