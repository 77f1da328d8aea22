"""Host ms a chained frame spends launching its step: the host's
``graph.launch`` spans of the step graph (``cudaGraphLaunch``), summed over
the window and divided by its chained frames.  No profiler runs in the
window.  Read from the program's span recorder (``slam_bench/spans.py``)."""

from slam_bench import spans


def read(rec):
    w = spans.window(rec)
    if not w or not w["steps"] or not w["chained"]:
        return None
    return sum(s.end_ns - s.start_ns
               for _, s in w["steps"]) / len(w["chained"]) * 1e-6
