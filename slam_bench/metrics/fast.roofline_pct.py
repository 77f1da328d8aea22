"""The FAST score kernel's share of its roofline: the least time the card
could take for one frame's pyramid (its bytes, ``fast_ref.pyramid_bytes``,
over the card's HBM bandwidth) over the kernel's mean duration in the
profiled stretch (one launch a frame).  Bytes bound it: its operations
take a fifth of that time at the float32 peak."""

from slam_bench import fast_ref
from slam_bench.peaks import PEAKS

KERNEL = "fast_pyramid_kernel"


def read(rec):
    st, peak = rec.get("stretch"), PEAKS.get(rec.get("device_kind"))
    if not st or not peak or not rec.get("fast_cfg"):
        return None
    us = [d for name, ds in st["kernels"].items() if KERNEL in name
          for d in ds]
    if not us:
        return None
    fc = rec["fast_cfg"]
    least_s = fast_ref.pyramid_bytes(*rec["frame_shape"], fc["n_levels"],
                                     fc["scale"]) / peak["hbm_bytes_per_s"]
    return 100.0 * least_s / (sum(us) / len(us) * 1e-6)
