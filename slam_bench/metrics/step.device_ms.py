"""Device ms of one chained step: CUDA events around each launch of the
``ChainedProgram`` on the stream it is launched on, averaged over the
window's launches."""


def read(rec):
    spans = [e - s for k, s, e in rec["launches"] if k == "step"]
    return sum(spans) / len(spans) if spans else None
