"""Captured CUDA graphs with device-side loops: the port's counterpart of
one jitted XLA program whose ``lax.while_loop`` ends on the device.

Code that loops hands the loop to :func:`run_loop` as ``(body, flag)``:
``body()`` is one iteration that updates its state in place and ``flag``
the device bool that says whether another is due.  Without a
:func:`loop_runner` the caller loops on the host itself; under one, the
runner takes the loop.  :func:`host_while` is the runner that loops on
the host (``while flag: body()``, a read an iteration); a
:class:`GraphRecorder`'s :meth:`~GraphRecorder.loop` is the runner that
captures it.

A :class:`GraphRecorder` captures a function into CUDA graphs that share
one memory pool.  Where the function hands it a loop, the segment captured
so far is closed, the body is captured as a sequence of its own (segments,
and the loops the body hands over in turn: loops nest) and a new segment
begins.  :meth:`GraphRecorder.stitch` then builds one graph of the items
in order, each loop as a conditional WHILE node that repeats its body
while ``flag`` holds (``csrc/graph_while.cu``, CUDA 12.4+; PyTorch 2.11
captures no WHILE node).  Launching it is one host call and reads nothing
back.

Counters that the captured code bumps on the host (kernel launch counts)
move at capture, not at replay: :class:`StitchedGraph` records what each
counter gained during the capture and adds that at every launch.

Every launch is a ``graph.launch`` span of the span recorder
(``utils/trace.py``) inside a device span.  While the recorder is on, a
graph with a loop stitched then also times itself on the card: one-thread
stamp nodes around each segment, each loop as a whole and each loop body
add the item's nanoseconds and runs into a device array.  A graph without
a loop is one straight line that its device span times whole, and gets
no stamp: stamping the detector graphs, which run on their own stream
beside the step graph, cost the chained loop ~9 % of its frame rate on
an H100 (PERF.md).  Off, the stitched graph has no stamp node.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import gc
from typing import Callable

import torch

from . import cuda_build, trace

_V = ctypes.c_void_p
_SEG, _OPEN, _CLOSE = 0, 1, 2          # graph_while.cu's item kinds

_LOOP_RUNNER: contextvars.ContextVar = contextvars.ContextVar(
    "device_loop_runner", default=None)
_LOOP_NAME: contextvars.ContextVar = contextvars.ContextVar(
    "device_loop_name", default="loop")


@contextlib.contextmanager
def loop_runner(run: Callable):
    """Inside the block, every :func:`run_loop` hands its loop to
    ``run(body, flag)``, which must leave the state as ``while flag:
    body()`` would."""
    token = _LOOP_RUNNER.set(run)
    try:
        yield
    finally:
        _LOOP_RUNNER.reset(token)


def run_loop(body: Callable, flag: torch.Tensor, name: str = "loop") -> bool:
    """Hand ``while flag: body()`` to the active :func:`loop_runner`;
    False when there is none (the caller then loops on the host).
    ``name`` labels the loop in a captured graph's stamped items."""
    run = _LOOP_RUNNER.get()
    if run is None:
        return False
    token = _LOOP_NAME.set(name)
    try:
        run(body, flag)
    finally:
        _LOOP_NAME.reset(token)
    return True


def host_while(body: Callable, flag: torch.Tensor) -> None:
    """The runner that loops on the host: what a WHILE node does, with a
    read of ``flag`` before every iteration."""
    while bool(flag):
        body()


_STREAMS: dict = {}


def capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The one side stream a device's programs warm up and capture on:
    the caching allocator keeps freed blocks for the stream that used
    them, so a new stream a capture would strand each warm-up's memory."""
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream(dev)
    return _STREAMS[dev]


def _lib():
    lib = cuda_build.load("graph_while.cu")
    if not getattr(lib, "_sdpl_bound", False):
        lib.sdpl_graph_build.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(_V),
            ctypes.POINTER(_V), _V, ctypes.POINTER(_V), ctypes.POINTER(_V),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.sdpl_graph_build.restype = ctypes.c_int
        lib.sdpl_graph_node_count.argtypes = [
            _V, ctypes.POINTER(ctypes.c_size_t)]
        lib.sdpl_graph_node_count.restype = ctypes.c_int
        lib.sdpl_graph_node_types.argtypes = [
            _V, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.sdpl_graph_node_types.restype = ctypes.c_int
        lib.sdpl_graph_build_where.argtypes = []
        lib.sdpl_graph_build_where.restype = ctypes.c_char_p
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


def _flatten(items, out, keep=lambda graph: True):
    """The item tree in graph_while.cu's order: (kind, graph, flag); a
    segment only where ``keep(graph)`` (captures left empty are dropped)."""
    for it in items:
        if it[0] == "seg":
            if keep(it[1]):
                out.append((_SEG, it[1], None))
        else:
            out.append((_OPEN, None, it[2]))
            _flatten(it[1], out, keep)
            out.append((_CLOSE, None, None))
    return out


def _stamp_items(items, nodes, prefix, depth, out):
    """The stamped items in graph_while.cu's slot order (a kept segment;
    a loop, then its body, then the body's items), each a dict: ``path``
    (``<graph>/<index>.<seg or loop name>``, a body ``<loop path>/body``),
    ``name``, ``kind`` (seg / loop / body), ``depth`` (0 at the top; a
    body's items one deeper than its loop) and ``nodes`` (a segment's
    captured nodes; a loop's and a body's: those of one pass through the
    body).  ``nodes(graph)`` counts a capture; empty ones get no stamp."""
    for i, it in enumerate(items):
        if it[0] == "seg":
            n = nodes(it[1])
            if n:
                out.append(dict(path="%s/%d.seg" % (prefix, i), name="seg",
                                kind="seg", depth=depth, nodes=n))
            continue
        path = "%s/%d.%s" % (prefix, i, it[3])
        loop = dict(path=path, name=it[3], kind="loop", depth=depth)
        body = dict(path=path + "/body", name=it[3], kind="body",
                    depth=depth)
        out += [loop, body]
        first = len(out)
        _stamp_items(it[1], nodes, path + "/body", depth + 1, out)
        loop["nodes"] = body["nodes"] = sum(
            x["nodes"] for x in out[first:] if x["kind"] == "seg")
    return out


class StitchedGraph:
    """One instantiated graph of captured segments and device loops.
    ``launch()`` runs it on the current stream and adds each counter's
    per-launch gain.  It keeps the captured graphs (and so their memory
    pool) alive as long as it lives.  ``name`` labels its launches and
    stamped items (``step``, ``detector.fast``, ``ba``, ...); ``stamps``
    are its in-graph timers (``trace.Stamps``), or None (recorder off at
    the stitch, or no loop)."""

    def __init__(self, items, counters, name: str = "graph"):
        self._lib = _lib()
        self._items = items               # keeps graphs, pool and flags alive
        self._counters = counters         # [(owner, attribute, gain)]
        self.name = name
        self._device = torch.device("cuda", torch.cuda.current_device())
        flat = _flatten(items, [], lambda g: self._node_count(g) > 0)
        self.stamps = None
        if any(k == _OPEN for k, _, _ in flat):
            self.stamps = trace.stamps(
                name, _stamp_items(items, self._node_count, name, 0, []),
                self._device)
        n = len(flat)
        kinds = (ctypes.c_int * n)(*[k for k, _, _ in flat])
        graphs = (_V * n)(*[g.raw_cuda_graph() if g is not None else None
                            for _, g, _ in flat])
        flags = (_V * n)(*[f.data_ptr() if f is not None else None
                           for _, _, f in flat])
        self._graph, self._exec = _V(), _V()
        added = ctypes.c_size_t()
        err = self._lib.sdpl_graph_build(
            n, kinds, graphs, flags,
            None if self.stamps is None else self.stamps.dev.data_ptr(),
            ctypes.byref(self._graph), ctypes.byref(self._exec),
            ctypes.byref(added))
        if err:
            _check(self._lib, err, "building the graph (%s; node types by "
                   "segment, cudaGraphNodeType: count %s)" % (
                       self._lib.sdpl_graph_build_where().decode(),
                       [self._node_types(g) for _, g, _ in flat
                        if g is not None]))
        # every node of the graph: the builder's and the captures' cloned in
        self.node_total = added.value + sum(
            sum(self._node_types(g).values()) for _, g, _ in flat
            if g is not None)

    def _node_types(self, graph) -> dict:
        counts = (ctypes.c_int * 32)()
        _check(self._lib, self._lib.sdpl_graph_node_types(
            graph.raw_cuda_graph(), counts, 32), "cudaGraphNodeGetType")
        return {t: c for t, c in enumerate(counts) if c}

    def _node_count(self, graph) -> int:
        n = ctypes.c_size_t()
        _check(self._lib, self._lib.sdpl_graph_node_count(
            graph.raw_cuda_graph(), ctypes.byref(n)), "cudaGraphGetNodes")
        return n.value

    def node_counts(self):
        """The captured graphs' node counts as nested lists: an int a
        segment, a list a loop body."""
        def count(items):
            return [self._node_count(it[1]) if it[0] == "seg"
                    else count(it[1]) for it in items]
        return count(self._items)

    def launch(self):
        stream = torch.cuda.current_stream().cuda_stream
        with trace.device_span(self.name, self._device, self.stamps), \
                trace.span("graph.launch", kind=self.name):
            err = self._lib.sdpl_graph_launch(self._exec, stream)
        _check(self._lib, err, "cudaGraphLaunch")
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
            with loop_runner(rec.loop):
                fn()
        graph = rec.stitch()

    ``counters`` are (object, attribute) pairs of host counters that the
    captured code bumps; their capture-time gains are taken back and
    replayed by every :meth:`StitchedGraph.launch`.

    Python's cyclic garbage collector is paused while the recorder is
    open: a cycle collected mid-capture frees what it holds, and a
    dropped graph's destructor (``cudaGraphExecDestroy``) is a call that
    invalidates a capture in progress.  Captures that followed dropped
    graphs failed so on an H100 (PERF.md)."""

    def __init__(self, counters=()):
        self.pool = torch.cuda.graph_pool_handle()
        self._seqs = [[]]                 # the open sequences, outermost first
        self._cur = None
        self._counters = [(o, a, getattr(o, a)) for o, a in counters]
        self._gc = False

    @property
    def items(self):
        return self._seqs[0]

    def _begin_segment(self):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        g.capture_begin(pool=self.pool)
        self._cur = g

    def _end_segment(self):
        g, self._cur = self._cur, None
        g.capture_end()
        self._seqs[-1].append(("seg", g))

    def __enter__(self):
        self._gc = gc.isenabled()
        gc.disable()
        self._begin_segment()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
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
        finally:
            if self._gc:
                gc.enable()

    def loop(self, body, flag: torch.Tensor):
        """``while flag: body()`` as a WHILE node: closes the segment,
        captures ``body`` once as a sequence of its own (the loops it
        hands over nest) and opens the next segment.  ``body`` must update
        ``flag`` and its state in place.  The loop takes the name
        :func:`run_loop` was given."""
        name = _LOOP_NAME.get()
        if flag.dtype != torch.bool or flag.numel() != 1 or not flag.is_cuda:
            raise ValueError("loop flag must be a one-element CUDA bool")
        self._end_segment()
        self._seqs.append([])
        self._begin_segment()             # ended by __exit__ if body raises
        body()
        self._end_segment()
        seq = self._seqs.pop()
        self._seqs[-1].append(("while", seq, flag, name))
        self._begin_segment()

    def stitch(self, name: str = "graph") -> StitchedGraph:
        gains = []
        for owner, attr, before in self._counters:
            gains.append((owner, attr, getattr(owner, attr) - before))
            setattr(owner, attr, before)      # nothing ran: take it back
        return StitchedGraph(self.items, gains, name)
