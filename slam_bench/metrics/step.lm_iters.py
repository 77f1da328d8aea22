"""Iterations of the chained step's LM loops per launch: the runs of
every stamped loop body of the step graph (one a pass through the body),
summed per launch and averaged over the window's step launches.  Read from
the program's span recorder (``slam_bench/spans.py``)."""

from slam_bench import spans


def read(rec):
    w = spans.window(rec)
    got = spans.per_launch(w, ("body",), "runs", None) if w else []
    return sum(got) / len(got) if got else None
