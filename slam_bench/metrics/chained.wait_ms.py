"""Host ms a chained frame waits for the card: ``ChainedDriver.perf``'s
``drain`` section, averaged over the window's chained frames."""


def read(rec):
    drain = rec["perf"].get("drain", [])
    return sum(drain) / len(drain) if drain else None
