"""Share of the window in which no program the benchmark wraps (chained
step, detector stages, batch BA) ran on the card: 100 less the union of
their event-bounded intervals over the window's event-bounded length."""

from slam_bench.probes import union


def read(rec):
    total = rec["device_window_ms"]
    if not total or not rec["launches"]:
        return None
    busy = union([(s, e) for _, s, e in rec["launches"]])
    return 100.0 * (1.0 - busy / total)
