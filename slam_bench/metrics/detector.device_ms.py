"""Device ms of a frame's detectors: CUDA events around each stage launch
of the ``DetectorProgram`` on the detector stream, summed over the window
and divided by its frames."""


def read(rec):
    spans = [e - s for k, s, e in rec["launches"] if k == "detector"]
    return sum(spans) / rec["frames"] if spans and rec["frames"] else None
