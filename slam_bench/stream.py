"""The general traffic generator: sequences handed to the system under test
frame by frame, as its users run it.

A traffic file (``traffic/<name>.json``) holds:

- ``settings``: the program's settings the mix turns on or off (the
  window BA, say), over the configuration's.

The loop is closed: the next frame is handed in when the call returns,
each call passing the next two frames' images (``next_image``,
``next_image2``), as a prefetching loader has them.  Each sequence is a
new ``System``; the frames are the scene's noise-free frames with the
flow noise of (seed, sequence, frame).  The record of a
sequence holds what the reference judges and what the readers read.
"""

from __future__ import annotations

import resource
import time

import numpy as np

# the tracker's static candidate rows: the detector keeps at most these
N_CAND = 3000
# sequences of a window whose detections are checked, one frame each
FAST_CHECKS = 8


def alloc_counts() -> tuple:
    """(device segments, pinned host blocks) the card's caching allocators
    have made so far; (0, 0) without a card."""
    import torch

    if not torch.cuda.is_available():
        return 0, 0
    return (torch.cuda.memory_stats().get("segment.all.allocated", 0),
            torch.cuda.host_memory_stats().get("num_host_alloc", 0))


def make_settings(values: dict):
    """The program's ``Settings`` with ``values`` set (each must name a
    field)."""
    from sdpl_slam_torch.utils.config import Settings

    s = Settings()
    for k, v in values.items():
        if not hasattr(s, k):
            raise KeyError("Settings has no field %r" % k)
        setattr(s, k, v)
    return s


def fast_config(values: dict) -> dict:
    """The detector as ``values`` state it, in ``fast_ref.detect``'s
    arguments."""
    return dict(n_features=min(int(values.get("orb_n_features", 2500)), N_CAND),
                ini_th=float(values.get("orb_ini_th_fast", 20)),
                min_th=float(values.get("orb_min_th_fast", 7)),
                n_levels=int(values.get("orb_n_levels", 8)),
                scale=float(values.get("orb_scale_factor", 1.2)))


class _Detections:
    """Keeps what the tracker takes from its detector program during a
    sampled call: the last (uv, valid) of the call, copied."""

    def __init__(self):
        self.want, self.last = False, None

    def __enter__(self):
        from sdpl_slam_torch.models.tracking import Tracking

        self._orig = Tracking.__dict__["_take_detections"]
        fn, sink = self._orig.__func__, self

        def take(handle):
            out = fn(handle)
            if sink.want and out[0] is not None:
                sink.last = (np.array(out[0][0]), np.array(out[0][1]))
            return out

        Tracking._take_detections = staticmethod(take)
        return self

    def __exit__(self, *exc):
        from sdpl_slam_torch.models.tracking import Tracking

        Tracking._take_detections = self._orig


class Stream:
    def __init__(self, values: dict, seq, noise, device, seed: int):
        self.values = values
        self.seq, self.noise, self.device = seq, noise, device
        self.seed = int(seed) % (1 << 63)
        self.settings = make_settings(values)
        self.fast_cfg = (fast_config(values)
                         if values.get("use_sample_fea", 0) == 0 else None)

    def sampled_frame(self, index: int) -> int:
        """The frame of sequence ``index`` whose detections are checked."""
        rng = np.random.default_rng([self.seed, index + 1, 7])
        return int(rng.integers(0, self.seq.n - 1))

    def run(self, index: int, stop=None, hook=None) -> dict:
        """Sequence ``index``: frames 0..n-2 tracked (the last frame only
        gives the flow of the one before), then a flush.  ``stop``: track
        frames 0..stop-1 only; ``hook(t)`` is called before frame t's
        call."""
        from sdpl_slam_torch.models.system import System

        seq, n_all = self.seq, self.seq.n - 1
        n = n_all if stop is None else stop
        check = (self.sampled_frame(index)
                 if self.fast_cfg and index < FAST_CHECKS else -1)
        start = [0.0] * n
        done_at = [None] * n
        fast = {}
        t_seq, use0 = time.perf_counter(), resource.getrusage(
            resource.RUSAGE_SELF)
        alloc0 = alloc_counts()
        system = System(self.settings, verbose=False, device=self.device)
        have = 0
        with _Detections() as det:
            for t in range(n):
                flow = self.noise.noisy(seq.flow[t], index, t)
                nxt = [seq.gray[t + i] if t + i < n else None
                       for i in (1, 2)]
                if hook is not None:
                    hook(t)
                det.want, det.last = t == check, None
                start[t] = time.perf_counter()
                system.track_rgbd(seq.gray[t], seq.depth[t], flow,
                                  seq.mask[t], seq.pose[t], seq.rows[t],
                                  t / self.settings.fps, n_all + 1,
                                  next_image=nxt[0], next_image2=nxt[1])
                now = time.perf_counter()
                if det.last is not None:
                    fast[t] = det.last
                got = min(len(system.tracker.map.camera_poses), n)
                for f in range(have, got):
                    done_at[f] = now
                have = max(have, got)
        system.tracker.flush()
        now, use1 = time.perf_counter(), resource.getrusage(
            resource.RUSAGE_SELF)
        alloc1 = alloc_counts()
        done_at = [now if d is None else d for d in done_at]
        tr, m = system.tracker, system.tracker.map
        drv = tr._res
        return dict(
            index=index, n=n, wall_s=now - t_seq,
            host=dict(cpu_s=(use1.ru_utime + use1.ru_stime
                             - use0.ru_utime - use0.ru_stime),
                      segments=alloc1[0] - alloc0[0],
                      pinned=alloc1[1] - alloc0[1]),
            latency_s=[d - s for d, s in zip(done_at, start)],
            poses=list(m.camera_poses), motions=list(m.rigid_motions),
            rm_labels=list(m.rm_labels), sm_labels=list(m.sm_labels),
            ba_runs=list(tr.ba_runs),
            perf=getattr(drv, "perf", None), fast=fast,
            fast_cfg=self.fast_cfg)
