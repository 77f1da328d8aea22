#!/usr/bin/env python3
"""Which dense linear-algebra calls of the BA steps a CUDA graph can hold
inside a WHILE body.

    python3 examples/linalg_capture_probe.py        # needs a CUDA card

Each call is warmed up on a side stream, then captured alone into a CUDA
graph, and the captured graph's nodes are counted by type
(``cudaGraphNodeType``: 0 kernel, 1 memcpy, 2 memset, 10 / 11 memory
allocation / free).  A capture that fails (a call that synchronises, such
as MAGMA's) prints FAILED.  A conditional node's body may hold no memory
nodes, so a call that adds them cannot sit in a captured LM loop
(``solvers.batch_ba.BAProgram``).  Run under PyTorch's own choice of
library and under ``preferred_linalg_library("cusolver")``.
"""

import ctypes
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sdpl_slam_torch.utils import cuda_graphs  # noqa: E402


def node_types(graph) -> dict:
    lib = cuda_graphs._lib()
    counts = (ctypes.c_int * 32)()
    lib.sdpl_graph_node_types(graph.raw_cuda_graph(), counts, 32)
    return {t: c for t, c in enumerate(counts) if c}


def spd(n, dtype, dev):
    a = torch.randn(n, n, device=dev, dtype=dtype)
    return a @ a.T + n * torch.eye(n, device=dev, dtype=dtype)


def calls(dev):
    """name -> call, at the BA steps' shapes: the reduced system (one SPD
    matrix of 6 (frames + motions) unknowns, up to 2048), the landmark
    blocks (a batch of 3x3 with NDOF + 1 right-hand sides), the pose
    preconditioner (a batch of 6x6 inverses)."""
    out = {}
    blocks = spd(3, torch.float32, dev).expand(800, 3, 3).contiguous()
    for k in (505, 2049):
        rhs = torch.randn(800, 3, k, device=dev)
        out["batched 3x3 solve_ex, %d right-hand sides" % k] = (
            lambda r=rhs: torch.linalg.solve_ex(blocks, r)[0])
    b6 = spd(6, torch.float32, dev).expand(20, 6, 6).contiguous()
    out["batched 6x6 inv_ex"] = lambda: torch.linalg.inv_ex(b6)[0]
    for n in (504, 640, 2048):
        for dt in (torch.float32, torch.float64):
            s = spd(n, dt, dev)
            r = torch.randn(n, 1, device=dev, dtype=dt)
            lo = torch.linalg.cholesky(s)
            tag = "%d %s" % (n, str(dt)[6:])
            out["cholesky_ex " + tag] = lambda s=s: torch.linalg.cholesky_ex(s)
            out["cholesky_solve " + tag] = (
                lambda r=r, lo=lo: torch.cholesky_solve(r, lo))
            out["two solve_triangular " + tag] = (
                lambda r=r, lo=lo: torch.linalg.solve_triangular(
                    lo.mT, torch.linalg.solve_triangular(lo, r, upper=False),
                    upper=True))
            out["lu_factor_ex " + tag] = (
                lambda s=s: torch.linalg.lu_factor_ex(s))
            out["solve_ex " + tag] = (
                lambda s=s, r=r: torch.linalg.solve_ex(s, r[:, 0]))
    return out


def main():
    if not torch.cuda.is_available():
        print("linalg_capture_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.manual_seed(0)
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    for pref in ("default", "cusolver"):
        for name, fn in calls(dev).items():
            prev = torch.backends.cuda.preferred_linalg_library()
            torch.backends.cuda.preferred_linalg_library(pref)
            try:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    fn()
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.stream(side):
                    graph.capture_begin()
                    try:
                        fn()
                    finally:
                        graph.capture_end()
                print("%-8s %-45s %s" % (pref, name, node_types(graph)))
            except RuntimeError as e:
                print("%-8s %-45s FAILED %s" % (pref, name,
                                                str(e).splitlines()[0]))
            finally:
                torch.backends.cuda.preferred_linalg_library(prev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
