"""Device ms of one chained step spent in its LM loops: the step graph's
stamped WHILE loops (each loop as a whole, at the top of the graph), summed
per launch and averaged over the window's step launches.  Read from the
program's span recorder (``slam_bench/spans.py``)."""

from slam_bench import spans


def read(rec):
    w = spans.window(rec)
    got = spans.per_launch(w, ("loop",), "ns", 0) if w else []
    return sum(got) / len(got) * 1e-6 if got else None
