"""What the traced run records from its own files: CUDA events around every
program launch, and one short torch.profiler stretch.

:class:`LaunchLog` wraps the launch methods of the program's captured
programs (the chained step, the detector stages, the batch BA) and records
a pair of CUDA events around each launch on the stream it is launched on,
without any synchronisation; the intervals are read once the window has
closed.  :class:`Stretch` reads a torch.profiler trace of a few frames
from its raw Kineto events (the profiler's own event list costs
~0.5 ms an event).
"""

from __future__ import annotations

import contextlib
import time


def union(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, hi = 0.0, None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if hi is None or s > hi:
            total += e - s
            hi = e
        elif e > hi:
            total += e - hi
            hi = e
    return total


def gaps(intervals, lo, hi):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


class LaunchLog:
    """CUDA event pairs around the launches of the program's programs,
    by kind: ``step`` (``ChainedProgram``), ``detector`` (each stage of a
    ``DetectorProgram``), ``ba`` (``BAProgram``).  Inside :meth:`recording`
    the launch methods are wrapped; outside they are the program's own."""

    def __init__(self):
        self.events = []          # (kind, start event, end event)
        self.anchor = None

    def _wrap(self, cls, name, kind):
        import torch

        orig = getattr(cls, name)
        log = self

        def launch(prog, *args, **kwargs):
            if prog.device.type != "cuda":
                return orig(prog, *args, **kwargs)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = orig(prog, *args, **kwargs)
            e.record()
            log.events.append((kind, s, e))
            return out

        return orig, launch

    @contextlib.contextmanager
    def recording(self, device):
        import torch
        from sdpl_slam_torch.models.chained import ChainedProgram
        from sdpl_slam_torch.models.frame_program import DetectorProgram
        from sdpl_slam_torch.solvers.batch_ba import BAProgram

        targets = [(ChainedProgram, "__call__", "step"),
                   (DetectorProgram, "run_stage", "detector"),
                   (BAProgram, "__call__", "ba")]
        saved = []
        for cls, name, kind in targets:
            own = name in cls.__dict__
            orig, launch = self._wrap(cls, name, kind)
            saved.append((cls, name, own, orig))
            setattr(cls, name, launch)
        if torch.device(device).type == "cuda":
            self.anchor = torch.cuda.Event(enable_timing=True)
            self.anchor.record()
        try:
            yield self
        finally:
            for cls, name, own, orig in saved:
                if own:
                    setattr(cls, name, orig)
                else:
                    delattr(cls, name)

    def intervals(self):
        """[(kind, start ms, end ms)] after the anchor; call once the
        device has finished."""
        if self.anchor is None:
            return []
        a = self.anchor
        return [(k, a.elapsed_time(s), a.elapsed_time(e))
                for k, s, e in self.events]


class Stretch:
    """A torch.profiler trace from :meth:`start` to :meth:`stop`."""

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, device) -> dict:
        """Busy seconds (the union of every device event), the stretch's
        wall seconds, the kernels' durations by name (us), the 10 device
        operations that took most time, and the idle time of the 200
        longest gaps summed by the innermost host range open at each
        gap's middle, the 10 largest."""
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize(device)
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            rec = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            (dev if e.device_type() == DeviceType.CUDA else host).append(rec)
        # the host's profiler ranges are mirrored on the device's timeline:
        # only kernels, copies and fills are device work
        ranges = {n for n, _, _ in host}
        dev = [r for r in dev if r[0] not in ranges]
        by_name = {}
        for name, s, e in dev:
            by_name.setdefault(name, []).append(e - s)
        spans = [(s, e) for _, s, e in dev]
        out = dict(busy_s=union(spans) * 1e-6, window_s=wall, kernels=by_name,
                   device_ops=sorted(
                       ([n, sum(v) * 1e-6] for n, v in by_name.items()),
                       key=lambda x: -x[1])[:10])
        named = {}
        if spans:
            lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
            longest = sorted(gaps(spans, lo, hi), key=lambda g: g[0] - g[1])
            for gs, ge in longest[:200]:
                mid = 0.5 * (gs + ge)
                open_ = [(e - s, n) for n, s, e in host if s <= mid <= e]
                label = min(open_)[1] if open_ else "(no host range)"
                named[label] = named.get(label, 0.0) + (ge - gs) * 1e-6
        out["idle_gaps"] = sorted(([k, v] for k, v in named.items()),
                                  key=lambda x: -x[1])[:10]
        return out
