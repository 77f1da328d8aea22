"""Captured CUDA graphs with device-side loops: the port's counterpart of
one jitted XLA program whose ``lax.while_loop`` ends on the device.

A :class:`GraphRecorder` captures a function into CUDA graphs that share
one memory pool.  Where the function hands a loop to
``recorder.loop(body, flag)`` (``solvers.frame_solvers.loop_runner``), the
segment captured so far is closed, the body is captured once as a graph of
its own and a new segment begins.  :meth:`GraphRecorder.stitch` then
builds one graph of the segments in order, each loop as a conditional
WHILE node that repeats its body while the device bool ``flag`` holds
(``csrc/graph_while.cu``, CUDA 12.4+; PyTorch 2.11 captures no WHILE
node).  Launching it is one host call and reads nothing back.

Counters that the captured code bumps on the host (kernel launch counts)
move at capture, not at replay: :class:`StitchedGraph` records what each
counter gained during the capture and adds that at every launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_V = ctypes.c_void_p


def _lib():
    lib = cuda_build.load("graph_while.cu")
    if not getattr(lib, "_sdpl_bound", False):
        lib.sdpl_graph_build.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(_V),
            ctypes.POINTER(_V), ctypes.POINTER(_V), ctypes.POINTER(_V)]
        lib.sdpl_graph_build.restype = ctypes.c_int
        lib.sdpl_graph_launch.argtypes = [_V, _V]
        lib.sdpl_graph_launch.restype = ctypes.c_int
        lib.sdpl_graph_destroy.argtypes = [_V, _V]
        lib.sdpl_graph_destroy.restype = ctypes.c_int
        lib.sdpl_graph_error_string.argtypes = [ctypes.c_int]
        lib.sdpl_graph_error_string.restype = ctypes.c_char_p
        lib._sdpl_bound = True
    return lib


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError("graph_while.cu: %s failed: %s (cudaError_t %d)"
                           % (what, lib.sdpl_graph_error_string(err).decode(),
                              err))


class StitchedGraph:
    """One instantiated graph of captured segments and device loops.
    ``launch()`` runs it on the current stream and adds each counter's
    per-launch gain.  It keeps the captured graphs (and so their memory
    pool) alive as long as it lives."""

    def __init__(self, items, counters):
        self._lib = _lib()
        self._items = items               # keeps graphs, pool and flags alive
        self._counters = counters         # [(owner, attribute, gain)]
        n = len(items)
        kinds = (ctypes.c_int * n)(*[0 if it[0] == "seg" else 1
                                     for it in items])
        graphs = (_V * n)(*[it[1].raw_cuda_graph() for it in items])
        flags = (_V * n)(*[it[2].data_ptr() if it[0] == "while" else None
                           for it in items])
        self._graph, self._exec = _V(), _V()
        _check(self._lib, self._lib.sdpl_graph_build(
            n, kinds, graphs, flags, ctypes.byref(self._graph),
            ctypes.byref(self._exec)), "building the graph")

    def launch(self):
        stream = torch.cuda.current_stream().cuda_stream
        _check(self._lib, self._lib.sdpl_graph_launch(self._exec, stream),
               "cudaGraphLaunch")
        for owner, attr, gain in self._counters:
            setattr(owner, attr, getattr(owner, attr) + gain)

    def __del__(self):
        if getattr(self, "_exec", None) is not None and self._exec.value:
            self._lib.sdpl_graph_destroy(self._graph, self._exec)
            self._exec = None


class GraphRecorder:
    """Captures one call of a function into segment and loop-body graphs
    on one stream and one memory pool, in the order they run.  Use as::

        rec = GraphRecorder(counters=[(fast_score_pyramid, "launches")])
        with rec:                      # on a side stream, after a warm-up
            with frame_solvers.loop_runner(rec.loop):
                fn()
        graph = rec.stitch()

    ``counters`` are (object, attribute) pairs of host counters that the
    captured code bumps; their capture-time gains are taken back and
    replayed by every :meth:`StitchedGraph.launch`."""

    def __init__(self, counters=()):
        self.pool = torch.cuda.graph_pool_handle()
        self.items = []
        self._cur = None
        self._counters = [(o, a, getattr(o, a)) for o, a in counters]

    def _begin_segment(self):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        g.capture_begin(pool=self.pool)
        self._cur = g

    def _end_segment(self):
        g, self._cur = self._cur, None
        g.capture_end()
        self.items.append(("seg", g))

    def __enter__(self):
        self._begin_segment()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            if self._cur is not None:
                try:
                    self._cur.capture_end()
                except RuntimeError:
                    pass
                self._cur = None
            return False
        self._end_segment()
        return False

    def loop(self, body, flag: torch.Tensor):
        """``while flag: body()`` as a WHILE node: closes the segment,
        captures ``body`` once and opens the next segment.  ``body`` must
        update ``flag`` and its state in place."""
        if flag.dtype != torch.bool or flag.numel() != 1 or not flag.is_cuda:
            raise ValueError("loop flag must be a one-element CUDA bool")
        self._end_segment()
        g = torch.cuda.CUDAGraph(keep_graph=True)
        g.capture_begin(pool=self.pool)
        self._cur = g                     # ended by __exit__ if body raises
        body()
        self._cur = None
        g.capture_end()
        self.items.append(("while", g, flag))
        self._begin_segment()

    def stitch(self) -> StitchedGraph:
        gains = []
        for owner, attr, before in self._counters:
            gains.append((owner, attr, getattr(owner, attr) - before))
            setattr(owner, attr, before)      # nothing ran: take it back
        return StitchedGraph(self.items, gains)
