"""Host ms a chained frame spends in its own sections: every section of
``ChainedDriver.perf`` but ``drain``, summed per frame and averaged over
the window's chained frames.  The window BA runs inside the
``dispatch_det`` section; its wall ms (``Tracking.ba_runs``) are taken
out, since ``ba.window_ms`` reads them."""


def read(rec):
    perf = rec["perf"]
    n = len(perf.get("drain", []))
    if not n:
        return None
    host = sum(sum(v) for k, v in perf.items() if k != "drain")
    return (host - sum(b["ms"] for b in rec["ba_runs"])) / n
