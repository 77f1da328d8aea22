"""Host ms a chained frame waits for its detections: the program's
``detector.take`` spans (the wait for the detector stream's copy home,
inside the ``chained.selection`` section) of the window's chained frames,
summed and divided by them.  Read from the program's span recorder
(``slam_bench/spans.py``)."""

from slam_bench import spans


def read(rec):
    w = spans.window(rec)
    if not w or not w["chained"]:
        return None
    return sum(s.end_ns - s.start_ns for s in w["spans"]
               if s.name == "detector.take"
               and s.frame in w["chained"]) / len(w["chained"]) * 1e-6
