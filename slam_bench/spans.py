"""What the program's own span recorder (``sdpl_slam_torch/utils/trace.py``)
kept of the window, for the per-layer readers that read it.

The traced run switches the recorder on (``SDPL_CHAINED_PERF``, which the
program takes as its switch) before its first sequence and never collects
it; the first reader that asks collects everything once and keeps it in
``rec["program_records"]``.  The window is found in those records by its
frames: each sequence is a run of ``frame`` spans with rising frame ids;
the profiled stretch after the window (any sequence with a profiled
frame) is left out, and the window is the last sequences before it that
hold ``rec["frames"]`` frames, the warm-up before them left out too.

A program without the recorder reads nothing: every reader returns None.
On first use the step graph's stamped items, the clocks' drift and the
window's device gaps by host span are printed on standard error.
"""

from __future__ import annotations

import bisect
import sys

from .probes import gaps, union


def records(rec):
    """The recorder's records (collected once into ``rec``), or None."""
    if "program_records" not in rec:
        try:
            from sdpl_slam_torch.utils import trace
        except ImportError:            # a program without the recorder
            rec["program_records"] = None
        else:
            rec["program_records"] = trace.collect() if trace.ON else None
    return rec["program_records"]


def _sequences(spans):
    """The ``frame`` span indices, in runs of rising frame ids."""
    out = []
    for i, s in enumerate(spans):
        if s.name != "frame":
            continue
        if not out or s.f_id <= spans[out[-1][-1]].f_id:
            out.append([])
        out[-1].append(i)
    return out


def window(rec):
    """The window's part of the records (cached in ``rec``), or None:
    ``spans``, ``frames`` (the window's ``frame`` span indices),
    ``chained`` (those of chained frames), ``steps`` ([(device span, its
    ``graph.launch`` span)] of the step graph), ``items`` (the step
    graph's stamped items, or []), ``device`` (every device span of the
    window's frames) and ``anchors``."""
    if "program_window" in rec:
        return rec["program_window"]
    got = records(rec)
    out = None
    if got is not None:
        out = _window(got, rec["frames"])
        if out is not None:
            report(out)
    rec["program_window"] = out
    return out


def _window(got, n_frames):
    spans = got["spans"]
    seqs = [g for g in _sequences(spans)
            if not any(spans[i].profiled for i in g)]
    take, n = [], 0
    for g in reversed(seqs):
        if n >= n_frames:
            break
        take += g
        n += len(g)
    if n != n_frames:
        return None
    frames = set(take)
    chained = {s.frame for s in spans
               if s.name == "chained_step" and s.frame in frames}
    device = [d for d in got["device"]
              if d.launch >= 0 and spans[d.launch].frame in frames]
    steps = [(d, spans[d.launch]) for d in device if d.kind == "step"]
    items = got["graphs"].get("step", {}).get("items", [])
    return dict(spans=spans, frames=frames, chained=chained, steps=steps,
                items=items, device=device, anchors=got["anchors"])


def per_launch(w, kinds=("loop",), field="ns", depth=0):
    """Each step launch's sum of its stamped items of ``kinds`` (at
    ``depth``; None: any) in ``field`` (ns or runs)."""
    idx = [i for i, it in enumerate(w["items"]) if it["kind"] in kinds
           and (depth is None or it["depth"] == depth)]
    return [sum(getattr(d, field)[i] for i in idx)
            for d, _ in w["steps"] if d.ns is not None]


def report(w):
    """The step graph's items, the clocks' drift, each launch's items
    against its interval and the window's device gaps, on stderr."""
    p = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    steps = [d for d, _ in w["steps"] if d.ns is not None]
    a = w["anchors"]
    if len(a) > 1:
        drift = [(a[i + 1][0] - a[i][0]) - (a[i + 1][1] - a[i][1])
                 for i in range(len(a) - 1)]
        p("program trace: %d frames, %d chained, %d step launches; clocks: "
          "%d anchors over %.3f s, drift %.4f ms first to last (host less "
          "device), %.4f ms at most between two" % (
              len(w["frames"]), len(w["chained"]), len(w["steps"]), len(a),
              (a[-1][0] - a[0][0]) * 1e-9, sum(drift) * 1e-6,
              max(abs(x) for x in drift) * 1e-6))
    if steps:
        n = len(steps)
        p("step graph items (ms a launch / runs a launch / nodes / us a "
          "node a run):")
        for i, it in enumerate(w["items"]):
            ns = sum(d.ns[i] for d in steps)
            runs = sum(d.runs[i] for d in steps)
            per_node = (ns / runs / it["nodes"] * 1e-3
                        if runs and it["nodes"] else float("nan"))
            p("  %-48s %9.4f %8.2f %6d %8.3f" % (
                it["path"], ns / n * 1e-6, runs / n, it["nodes"], per_node))
        top = per_launch(w, ("seg", "loop"), "ns", 0)
        ratio = [t / (d.end_ns - d.start_ns) for t, d in zip(top, steps)
                 if d.end_ns > d.start_ns]
        if ratio:
            p("step launches: top-level items over the event interval "
              "%.4f-%.4f (median %.4f)" % (min(ratio), max(ratio),
                                            sorted(ratio)[len(ratio) // 2]))
    dev = [(d.start_ns, d.end_ns) for d in w["device"]]
    if dev:
        lo, hi = min(s for s, _ in dev), max(e for _, e in dev)
        holes = gaps(dev, lo, hi)
        spans, by_frame = w["spans"], {}
        for s in spans:
            if s.frame in w["frames"] and s.name != "frame":
                by_frame.setdefault(s.frame, []).append(s)
        frames = sorted(w["frames"], key=lambda i: spans[i].start_ns)
        starts = [spans[i].start_ns for i in frames]
        named = {}
        for gs, ge in holes:
            mid = 0.5 * (gs + ge)
            k = bisect.bisect_right(starts, mid) - 1
            label = "(no frame)"
            if k >= 0 and spans[frames[k]].end_ns >= mid:
                inner = [(s.end_ns - s.start_ns, s.name)
                         for s in by_frame.get(frames[k], [])
                         if s.start_ns <= mid <= s.end_ns]
                label = min(inner)[1] if inner else "frame"
            named[label] = named.get(label, 0.0) + (ge - gs) * 1e-6
        p("device: busy %.1f ms of %.1f ms (idle %.2f %%); idle ms by the "
          "innermost host span open at each gap's middle: %s" % (
              union(dev) * 1e-6, (hi - lo) * 1e-6,
              100.0 * (1.0 - union(dev) / (hi - lo)),
              ", ".join("%s %.1f" % kv for kv in sorted(
                  named.items(), key=lambda kv: -kv[1])[:10])))
