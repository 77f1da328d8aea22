"""The port's one span and counter recorder.

Spans mark the layer boundaries of a frame on the host's clock: ``frame``
(``System.track_rgbd``, the root, with the frame id), the chained loop's
sections, the detectors' dispatch and wait, each captured graph's launch.
Device spans are pairs of CUDA events that a graph launch records around
itself on its stream; :func:`collect` puts them on the host's clock
through anchors (an event recorded on an idle device at a known host
time).  A graph with a loop stitched while the recorder is on also times
its own segments and loops on the card (``csrc/graph_while.cu``'s stamp
nodes); each launch's figures come back with its device span.

Switch.  Off unless ``SDPL_TRACE=1`` is set when this module is imported;
:func:`enabled` switches it for a block.  Off, :func:`span` returns one
shared null context (or, while a torch profiler runs, the profiler's
``record_function`` range of the same name) and records nothing.  On,
every span also enters that range while a profiler runs, so a
``System.start_profiler_trace`` stretch shows the spans on its clock.

Records stay in memory until :func:`collect` returns and clears them
(about 15 spans a frame, ~1,600 frames in a minute of KITTI-scale
tracking).  Spans are the tracking thread's: the stack that gives each
span its parent is not shared between threads.
"""

from __future__ import annotations

import contextlib
import os
import time
import weakref
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

ON = os.environ.get("SDPL_TRACE") == "1"

_NULL = contextlib.nullcontext()
_CHUNK = 4096                  # launches a pinned block of stamp rows holds


class Span(NamedTuple):
    """A host span: ``parent`` and ``frame`` index the span list (-1 for
    none); ``f_id`` is the frame id of its ``frame`` root; ``profiled``:
    opened while a torch profiler ran."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    frame: int
    f_id: Optional[int]
    kind: Optional[str]
    profiled: bool


class DeviceSpan(NamedTuple):
    """A launch's interval on the card, on the host's clock (ns).
    ``launch`` indexes the ``graph.launch`` span that launched it (-1 for
    none); ``ns`` / ``runs``: the graph's stamped items in this launch,
    or None where the graph has no stamps."""
    kind: str
    start_ns: int
    end_ns: int
    launch: int
    ns: Optional[list]
    runs: Optional[list]


class Stamps:
    """A stitched graph's in-graph timers: ``dev`` is the (3, n) int64
    array its stamp nodes write (row 0 ns, row 1 runs, row 2 the open
    item's start), ``items`` one dict an item (path, name, kind, depth,
    nodes) in the stamp nodes' order.  Each launch's rows 0-1 are copied
    into pinned host rows and zeroed after the launch."""

    def __init__(self, name: str, items: list, device):
        self.name, self.items = name, items
        self.dev = torch.zeros((3, len(items)), dtype=torch.int64,
                               device=device)
        self._chunks: list = []
        self.used = 0

    def take(self):
        """Copy this launch's figures home (no wait) and zero them; -> the
        (chunk, row) they land in."""
        n = len(self.items)
        c, r = divmod(self.used, _CHUNK)
        if c == len(self._chunks):
            self._chunks.append(torch.empty((_CHUNK, 2 * n),
                                            dtype=torch.int64,
                                            pin_memory=True))
        self._chunks[c][r].copy_(self.dev[:2].reshape(-1), non_blocking=True)
        self.dev[:2].zero_()
        self.used += 1
        return self, c, r

    def row(self, c: int, r: int):
        n = len(self.items)
        v = self._chunks[c][r].tolist()
        return v[:n], v[n:]


class _Recorder:
    def __init__(self):
        self.spans: list = []     # [name, start, end, parent, frame, f_id,
        #                           kind, profiled]
        self.stack: list = []
        self.counters: dict = {}
        self.device: list = []    # [kind, ev0, ev1, anchor, launch, take]
        self.anchors: list = []   # (event, host ns)
        self.sec_end = (-2, 0)    # (parent, end ns) of the last section
        self.stamps = weakref.WeakSet()
        self.gen = 0              # bumped by clear: spans open across one
        #                           record nothing

    def clear(self):
        self.gen += 1
        self.spans, self.stack, self.counters = [], [], {}
        self.device = []
        self.anchors = self.anchors[-1:]
        self.sec_end = (-2, 0)
        for s in list(self.stamps):
            s.used = 0


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "kind", "f_id", "section", "into", "i", "rf", "gen")

    def __init__(self, name, kind, f_id, section=False, into=None):
        self.name, self.kind, self.f_id = name, kind, f_id
        self.section, self.into, self.rf = section, into, None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        rec = _REC
        parent = rec.stack[-1] if rec.stack else -1
        now = time.perf_counter_ns()
        if self.section and rec.sec_end[0] == parent:
            now = rec.sec_end[1]          # where the last section ended
        if self.f_id is not None:
            frame, f_id = len(rec.spans), self.f_id
        elif parent >= 0:
            frame, f_id = rec.spans[parent][4], rec.spans[parent][5]
        else:
            frame, f_id = -1, None
        self.i, self.gen = len(rec.spans), rec.gen
        rec.spans.append([self.name, now, 0, parent, frame, f_id, self.kind,
                          self.rf is not None])
        rec.stack.append(self.i)
        return self

    def __exit__(self, *exc):
        rec = _REC
        if self.gen != rec.gen:           # cleared while open
            if self.rf is not None:
                self.rf.__exit__(*exc)
            return False
        now = time.perf_counter_ns()
        s = rec.spans[self.i]
        s[2] = now
        if rec.stack and rec.stack[-1] == self.i:
            rec.stack.pop()
        if self.section:
            rec.sec_end = (s[3], now)
            if self.into is not None:
                self.into.setdefault(self.name.partition(".")[2], []).append(
                    (now - s[1]) * 1e-6)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, kind: Optional[str] = None, f_id: Optional[int] = None):
    """A host span around the block; ``f_id`` makes it a frame's root, and
    its descendants carry that id; ``kind`` labels it."""
    if ON:
        return _Span(name, kind, f_id)
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def section(name: str, into: Optional[dict] = None):
    """A span that starts where the last section under the same parent
    ended, so consecutive sections tile their parent without a gap (the
    first starts at its own time).  On, the section's ms are appended to
    ``into[<name after its layer prefix>]`` (``chained.drain`` ->
    ``into["drain"]``)."""
    if ON:
        return _Span(name, None, None, True, into)
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (kept while the recorder is on)."""
    if ON:
        _REC.counters[name] = _REC.counters.get(name, 0) + n


class _DeviceSpan:
    __slots__ = ("kind", "stamps", "ev0", "first", "anchor", "gen")

    def __init__(self, kind, stamps):
        self.kind, self.stamps = kind, stamps

    def __enter__(self):
        rec = _REC
        if not rec.anchors:
            anchor()
        self.anchor, self.first, self.gen = (len(rec.anchors) - 1,
                                             len(rec.spans), rec.gen)
        self.ev0 = torch.cuda.Event(enable_timing=True)
        self.ev0.record()
        return self

    def __exit__(self, *exc):
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        rec = _REC
        if self.gen != rec.gen:           # cleared while open
            return False
        launch = (self.first if self.first < len(rec.spans)
                  and rec.spans[self.first][0] == "graph.launch" else -1)
        take = self.stamps.take() if self.stamps is not None else None
        rec.device.append([self.kind, self.ev0, ev1, self.anchor, launch,
                           take])
        return False


def device_span(kind: str, device: torch.device, stamps=None):
    """CUDA events around the block on the current stream, no
    synchronisation (on the card, while the recorder is on); the first
    ``graph.launch`` span opened in the block is the launch it belongs to.
    ``stamps``: the launched graph's :class:`Stamps`, taken after it."""
    if ON and device.type == "cuda":
        return _DeviceSpan(kind, stamps)
    return _NULL


def stamps(name: str, items: list, device: torch.device):
    """In-graph timers for a graph about to be stitched, while the
    recorder is on and the graph is on the card; else None."""
    if not (ON and device.type == "cuda" and items):
        return None
    s = Stamps(name, items, device)
    _REC.stamps.add(s)
    return s


def _anchor() -> None:
    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    _REC.anchors.append((ev, time.perf_counter_ns()))


def anchor() -> None:
    """Tie the clocks: wait for the card, record an event and read the
    host clock at once.  Device spans map through the last anchor before
    them.  A no-op while the recorder is off or before the card is used."""
    if ON and torch.cuda.is_available() and torch.cuda.is_initialized():
        _anchor()


def _reset() -> None:
    _REC.clear()
    _REC.anchors = []
    for s in list(_REC.stamps):
        s.dev.zero_()


def start() -> None:
    """Clear the records, zero every graph's in-graph timers and anchor
    the clocks."""
    _reset()
    anchor()


def collect() -> dict:
    """Every record since the last :func:`start` / :func:`collect`, then
    cleared.  -> ``spans`` (:class:`Span`), ``device``
    (:class:`DeviceSpan`, on the host's clock), ``counters``, ``graphs``
    (name -> items, launches taken, and each item's ns and runs summed
    over them) and ``anchors`` ((host ns, device ns since the first),
    whose difference in slope is the clocks' drift)."""
    rec = _REC
    if rec.device or rec.anchors:
        _anchor()              # the card has finished: every event is read
    anchors = rec.anchors
    a0 = anchors[0][0] if anchors else None
    a_dev = [a0.elapsed_time(ev) * 1e6 for ev, _ in anchors]
    spans = [Span(*s) for s in rec.spans]
    device, graphs = [], {}
    for kind, ev0, ev1, a, launch, take in rec.device:
        ev, t = anchors[a]
        s = t + ev.elapsed_time(ev0) * 1e6
        e = t + ev.elapsed_time(ev1) * 1e6
        ns = runs = None
        if take is not None:
            st, c, r = take
            ns, runs = st.row(c, r)
            g = graphs.setdefault(st.name, dict(
                items=st.items, launches=0, ns=[0] * len(ns),
                runs=[0] * len(ns)))
            g["launches"] += 1
            g["ns"] = [x + y for x, y in zip(g["ns"], ns)]
            g["runs"] = [x + y for x, y in zip(g["runs"], runs)]
        device.append(DeviceSpan(kind, int(s), int(e), launch, ns, runs))
    out = dict(spans=spans, device=device, counters=dict(rec.counters),
               graphs=graphs,
               anchors=[(t, d) for (_, t), d in zip(anchors, a_dev)])
    rec.clear()
    return out


def turn_on() -> None:
    """The recorder on for the rest of the process (its records cleared
    if it was off)."""
    global ON
    if not ON:
        _reset()
        ON = True


@contextlib.contextmanager
def enabled(on: bool = True):
    """The recorder on (or off) inside the block; the records stay for
    :func:`collect`.  Switching it on clears them."""
    global ON
    prev = ON
    if on and not prev:
        _reset()
    ON = on
    try:
        yield
    finally:
        ON = prev
