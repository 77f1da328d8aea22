#!/usr/bin/env python3
"""Smoke run of sdpl_slam_torch on one CUDA card.

    python3 chip_smoke.py

1. Builds the package's CUDA kernels from ``sdpl_slam_torch/csrc``.
2. Kernel phase: the FAST-9/16 score kernel against its plain PyTorch
   version at every pyramid level of a KITTI-size frame (1242x375 down to
   347x105), both thresholds; bit-exact at level 0, identical corner masks
   and rtol 1e-6 above it.  Times both with CUDA events (median of 25).
3. Slice phase: ~10 KITTI-scale synthetic frames (the JAX bench's
   sequence: 1242x375, 2 moving objects, 0.2 px flow noise, reference
   caps, FAST in the loop, lines injected) through
   ``System(settings, device="cuda").track_rgbd`` and ``save_results``.
   Checks that every frame ran the FAST kernel (8 launches a frame, one
   per pyramid level), that the 7 result files exist, that the camera RPE
   is under the bench's GT gates (t < 5 mm, r < 0.1 deg), and that the
   first frames agree with the same slice run on the CPU.

Any failure raises (non-zero exit).  The last two lines of standard
output are the kernels' JSON line and ``{"ok": true, "device": ...}``.
Without a CUDA device it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

N_FRAMES = 10          # tracked on the card
N_CPU_CHECK = 3        # of those, also run on the CPU as the reference
TIMING_REPS = 25


def _nvidia_smi():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + r.stderr)
    return r.stdout.strip().splitlines()[0]


def _median_ms(fn, reps=TIMING_REPS):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _device_ms(fn, reps=20):
    """Device time per call of ``fn``: the summed duration of the CUDA
    kernels it launches, from a torch.profiler trace; None when the
    profiler records no device activity on this machine."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    return total_us / 1e3 / reps if total_us > 0 else None


def kernel_phase(gray, dev):
    """FAST kernel vs plain at every level; returns (max_abs_err,
    kernel ms per frame, plain ms per frame, rows)."""
    import torch

    from sdpl_slam_torch.ops import fast

    img = torch.from_numpy(gray).to(dev).float()
    cfg = fast.FastPyramidConfig()
    h, w = img.shape
    max_err, k_total, p_total, rows = 0.0, 0.0, 0.0, []
    for lvl, s, lh, lw in fast.pyramid_shapes(h, w, cfg):
        li = (img if lvl == 0 else fast.resize_linear(img, lh, lw)).contiguous()
        hi, lo = fast.fast_score_maps(li, cfg.ini_threshold, cfg.min_threshold)
        ref_hi = fast.fast_score_map_torch(li, cfg.ini_threshold)
        ref_lo = fast.fast_score_map_torch(li, cfg.min_threshold)
        torch.cuda.synchronize()
        for got, ref in ((hi, ref_hi), (lo, ref_lo)):
            if lvl == 0 and not torch.equal(got, ref):
                raise AssertionError("level 0: kernel != plain (not bit-exact)")
            if not torch.equal(got > 0, ref > 0):
                raise AssertionError("level %d: corner masks differ" % lvl)
            if not torch.allclose(got, ref, rtol=1e-6, atol=0.0):
                raise AssertionError("level %d: scores differ beyond rtol 1e-6"
                                     % lvl)
            max_err = max(max_err, float((got - ref).abs().max()))

        def kernel():
            fast.fast_score_maps(li, cfg.ini_threshold, cfg.min_threshold)

        def plain():
            fast.fast_score_map_torch(li, cfg.ini_threshold)
            fast.fast_score_map_torch(li, cfg.min_threshold)

        k_ms, p_ms = _median_ms(kernel), _median_ms(plain)
        k_total += k_ms
        p_total += p_ms
        rows.append((lvl, lh, lw, k_ms, p_ms, _device_ms(kernel),
                     _device_ms(plain)))
    return max_err, k_total, p_total, rows


def slice_phase(seq, out_dir):
    """The port's main path on the card; returns its measurements."""
    import numpy as np
    import torch

    from sdpl_slam_torch.models.system import System
    from sdpl_slam_torch.ops import fast
    from sdpl_slam_torch.utils import metrics
    from sdpl_slam_torch.utils.synthetic import slice_settings

    system = System(slice_settings(seq.cfg), verbose=False, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    fast.fast_score_maps.launches = 0
    system.tracker.lm_host_syncs = 0
    frame_ms = []
    for t in range(N_FRAMES):
        f = seq.frame(t)
        t0 = time.perf_counter()
        pose = system.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                                 f.obj_rows, t * 0.1, N_FRAMES,
                                 line_detections=f.lines)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.all(np.isfinite(pose)) or pose.shape != (4, 4):
            raise AssertionError("frame %d: pose not a finite 4x4" % t)
    launches = fast.fast_score_maps.launches
    syncs = system.tracker.lm_host_syncs
    peak = torch.cuda.max_memory_allocated()

    levels = len(fast.pyramid_shapes(seq.cfg.height, seq.cfg.width))
    if launches != levels * N_FRAMES:
        raise AssertionError("FAST kernel launched %d times for %d frames "
                             "(%d levels)" % (launches, N_FRAMES, levels))
    system.save_results(out_dir)
    files = ("obj_mot_stereo_new.txt", "obj_mot_stereo_rf_new.txt",
             "obj_mot_gt.txt", "obj_centre.txt", "initial_stereo_new.txt",
             "refined_stereo_new.txt", "cam_pose_gt_stereo.txt")
    missing = [n for n in files if not os.path.getsize(os.path.join(out_dir, n))]
    if missing:
        raise AssertionError("empty result files: %s" % missing)
    m = system.map
    t_err, r_err = metrics.camera_rpe(m.camera_poses, m.camera_poses_gt)
    if not (t_err < 0.005 and r_err < 0.1):
        raise AssertionError("camera RPE %.5f m / %.4f deg over the GT gates"
                             % (t_err, r_err))
    n_obj = sum(len(x) - 1 for x in m.rm_labels)
    if n_obj == 0:
        raise AssertionError("no object was tracked")
    return dict(system=system, frame_ms=frame_ms, launches=launches,
                syncs=syncs, peak=peak, t_err=t_err, r_err=r_err,
                n_obj=n_obj)


def cpu_check(seq, cuda_map):
    """The first frames again on the CPU (plain kernels, same RANSAC
    draws): poses within 1e-4, identical label streams."""
    import numpy as np

    from sdpl_slam_torch.models.system import System
    from sdpl_slam_torch.utils.synthetic import slice_settings

    system = System(slice_settings(seq.cfg), verbose=False, device="cpu")
    for t in range(N_CPU_CHECK):
        f = seq.frame(t)
        system.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                          f.obj_rows, t * 0.1, N_FRAMES,
                          line_detections=f.lines)
    m = system.map
    err = max(float(np.abs(a - b).max()) for a, b in
              zip(m.camera_poses, cuda_map.camera_poses[:N_CPU_CHECK]))
    if err > 1e-4:
        raise AssertionError("card vs CPU camera poses differ by %g" % err)
    if m.rm_labels != cuda_map.rm_labels[:N_CPU_CHECK - 1]:
        raise AssertionError("card vs CPU label streams differ")
    return err


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import sdpl_slam_torch  # noqa: F401  (fails outside a checkout)
    from sdpl_slam_torch.utils import cuda_build
    from sdpl_slam_torch.utils.synthetic import SynthSequence, kitti_config

    print("python %s, torch %s, CUDA %s" % (
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    kind = torch.cuda.get_device_name(0)
    print("device:", kind)
    smi = _nvidia_smi()
    print("nvidia-smi:", smi)

    t0 = time.perf_counter()
    lib = cuda_build.build("fast_score.cu")
    print("build: %s in %.1f s" % (os.path.relpath(lib), time.perf_counter() - t0))
    ptxas = lib.with_suffix(".ptxas.txt")
    if ptxas.exists():
        for ln in ptxas.read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                print("  ptxas:", ln.strip())

    t0 = time.perf_counter()
    seq = SynthSequence(kitti_config(n_frames=N_FRAMES))
    print("synthetic KITTI-scale sequence: %d frames in %.1f s"
          % (N_FRAMES, time.perf_counter() - t0))

    max_err, k_ms, p_ms, rows = kernel_phase(seq.frame(0).gray,
                                             torch.device("cuda"))
    print("kernel phase: FAST-9/16 score maps, kernel == plain "
          "(max abs err %g)" % max_err)
    print("  both thresholds per call; wall = CUDA events around one call "
          "(median of %d), device = profiled kernel time" % TIMING_REPS)
    print("  level  shape      kernel_ms  plain_ms  kernel_dev_ms  plain_dev_ms")

    def fmt(x):
        return "not measured" if x is None else "%.4f" % x

    for lvl, lh, lw, k, p, kd, pd in rows:
        print("  %5d  %4dx%-4d  %9.4f  %8.4f  %13s  %12s"
              % (lvl, lw, lh, k, p, fmt(kd), fmt(pd)))
    dev = [r[5:] for r in rows]
    kd = None if any(d[0] is None for d in dev) else sum(d[0] for d in dev)
    pd = None if any(d[1] is None for d in dev) else sum(d[1] for d in dev)
    print("  pyramid    total      %9.4f  %8.4f  %13s  %12s"
          % (k_ms, p_ms, fmt(kd), fmt(pd)))

    with tempfile.TemporaryDirectory() as out_dir:
        res = slice_phase(seq, out_dir)
    fm = sorted(res["frame_ms"][1:])       # frame 0 initialises only
    print("slice phase: %d frames, camera RPE %.6f m / %.5f deg, %d object "
          "motions" % (N_FRAMES, res["t_err"], res["r_err"], res["n_obj"]))
    print("  per-frame ms: median %.2f (frames 1-%d), first %.2f, all %s" % (
        fm[len(fm) // 2], N_FRAMES - 1, res["frame_ms"][0],
        [round(x, 2) for x in res["frame_ms"]]))
    slots = np.median(np.asarray(res["system"].map.frame_times[1:]), axis=0)
    print("  host-clock slots, median ms (prep+detect, solve, grouping, "
          "commit, renew): %s" % " ".join("%.2f" % x for x in slots))
    print("  FAST kernel launches %d (%d per frame), LM host syncs %d, "
          "peak device memory %.1f MiB" % (
              res["launches"], res["launches"] // N_FRAMES, res["syncs"],
              res["peak"] / 2 ** 20))
    err = cpu_check(seq, res["system"].map)
    print("reference check: %d frames on the CPU, max camera pose "
          "difference %g" % (N_CPU_CHECK, err))

    print(json.dumps({"kernels": [{
        "name": "fast_score2",
        "route": "cuda",
        "source": "sdpl_slam_torch/csrc/fast_score.cu",
        "replaces": "sdpl_slam_tpu/ops/fast.py:119",
        "launches": res["launches"],
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
