"""How long a chained step waits in its stream behind the work before it:
the device start of each step launch less the start of the host's
``graph.launch`` span that launched it, on the host's clock, averaged over
the window's step launches.  Read from the program's span recorder
(``slam_bench/spans.py``)."""

from slam_bench import spans


def read(rec):
    w = spans.window(rec)
    if not w or not w["steps"]:
        return None
    return sum(d.start_ns - s.start_ns
               for d, s in w["steps"]) / len(w["steps"]) * 1e-6
