#!/usr/bin/env python3
"""Smoke run of sdpl_slam_torch on one CUDA card.

    python3 chip_smoke.py

1. Builds the package's CUDA kernels from ``sdpl_slam_torch/csrc``.
2. Kernel phase: the FAST-9/16 pyramid kernel against its plain PyTorch
   version at every pyramid level of a KITTI-size frame (1242x375 down to
   347x105; one launch) and of two frames (one launch), both thresholds,
   bit for bit.  Device time from CUDA events around 200 back-to-back
   launches, warm and with the L2 cache flushed; wall time of one call;
   the bytes/operations bound of this run's data and the share reached.
3. Slice phase: ~10 KITTI-scale synthetic frames (the JAX bench's
   sequence: 1242x375, 2 moving objects, 0.2 px flow noise, reference
   caps, FAST in the loop, lines injected) through
   ``System(settings, device="cuda").track_rgbd`` and ``save_results``.
   Checks that every frame ran the FAST kernel (one launch a frame for
   the whole pyramid), that the 7 result files exist, that the camera RPE
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
TIMING_REPS = 25       # wall: median of single calls
DEVICE_REPS = 200      # device: back-to-back launches per event pair
L2_FLUSH_BYTES = 64 * 2 ** 20
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (the guide's table)
# float32 adds, compares and max outside the tensor cores: the 67 TFLOP/s
# peak counts a fused multiply-add as two operations
FP32_OPS_PER_S = 33.5e12


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


def _device_ms(fn, reps=DEVICE_REPS, flush=None):
    """Device time per call of ``fn`` from CUDA events: ``reps`` calls
    back to back, enqueued while the card is held in ``torch.cuda._sleep``
    so that the host's launch path does not pace them.  With ``flush`` (a
    tensor), each call follows a write of it (evicting the L2 cache) and
    is timed by its own pair of events."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 2 ** 27
    for _ in range(4):
        torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(2 if flush is None else 2 * reps)]
        if flush is None:
            ev[0].record()
            for _ in range(reps):
                fn()
            ev[1].record()
        else:
            for i in range(reps):
                flush.fill_(float(i))
                ev[2 * i].record()
                fn()
                ev[2 * i + 1].record()
        ahead = not slept.query()      # all enqueued before the card woke
        torch.cuda.synchronize()
        if ahead:
            return sum(ev[2 * i].elapsed_time(ev[2 * i + 1])
                       for i in range(len(ev) // 2)) / reps
        cycles *= 4
    raise RuntimeError("the host could not enqueue %d calls ahead of the "
                       "card" % reps)


def _ops_needed(levels, maps, t_lo):
    """Float operations the kernel does on this data, and its candidate
    count: for every pixel the compass test (8 min/max, 2 subtractions, 2
    compares); for each candidate (2 bright or 2 dark compass entries at
    t_lo) the window minima of one polarity and their tests (79 min/max, 1
    subtraction, 2 compares), 80 more where both polarities can run; for
    each t_lo corner the 16 differences and both SADs (2 x (16 subtractions,
    16 max, 15 adds))."""
    import torch
    import torch.nn.functional as F

    ops = cands = 0
    for lv, (hi, lo) in zip(levels, maps):
        h, w = lv.shape
        p = F.pad(lv, (3, 3, 3, 3))
        d = torch.stack([p[3 + dv:3 + dv + h, 3 + du:3 + du + w]
                         for du, dv in ((0, -3), (3, 0), (0, 3), (-3, 0))]) - lv
        bright = (d > t_lo).sum(0) >= 2
        dark = (d < -t_lo).sum(0) >= 2
        cand = int((bright | dark).sum())
        cands += cand
        ops += (12 * h * w + 82 * cand + 80 * int((bright & dark).sum())
                + 110 * int((lo > 0).sum()))
    return ops, cands


def _sass_sections(lib):
    """Instruction counts of the built kernel's SASS (cuobjdump -sass),
    split at its block barriers: [to the first barrier (the compass pass
    over one unit, 8 rows a lane), between the barriers (the full-test
    loop, one candidate a thread a trip), after]; None where the toolkit
    has no cuobjdump."""
    import re

    from sdpl_slam_torch.utils import cuda_build

    exe = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(exe):
        return None
    r = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                       text=True, timeout=120)
    if r.returncode != 0:
        return None
    sections = [0]
    for ln in r.stdout.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     ln)
        if not m or m.group(1) == "NOP":
            continue
        if m.group(1).startswith("BAR.SYNC"):
            sections.append(0)
        else:
            sections[-1] += 1
    return sections


def kernel_phase(grays, dev):
    """The FAST pyramid kernel against its plain version, bit for bit, at
    every level of one frame's pyramid (one launch) and of two frames'
    pyramids (one launch); then its times.  Returns a dict."""
    import torch

    from sdpl_slam_torch.ops import fast

    cfg = fast.FastPyramidConfig()
    t_hi, t_lo = cfg.ini_threshold, cfg.min_threshold
    frames = []
    for g in grays:
        img = torch.from_numpy(g).to(dev).float()
        frames.append([(img if lvl == 0 else fast.resize_linear(img, lh, lw))
                       .contiguous() for lvl, s, lh, lw in
                       fast.pyramid_shapes(*img.shape, cfg)])
    levels = frames[0]
    plain = [(fast.fast_score_map_torch(lv, t_hi),
              fast.fast_score_map_torch(lv, t_lo)) for lv in levels]
    plain += [(fast.fast_score_map_torch(lv, t_hi),
               fast.fast_score_map_torch(lv, t_lo)) for lv in frames[1]]
    max_err = 0.0
    for lvls, what in ((levels, "one pyramid"),
                       (frames[0] + frames[1], "two pyramids")):
        before = fast.fast_score_pyramid.launches
        maps = fast.fast_score_pyramid(lvls, t_hi, t_lo)
        torch.cuda.synchronize()
        if fast.fast_score_pyramid.launches != before + 1:
            raise AssertionError("%s: not one launch" % what)
        for i, (got, ref) in enumerate(zip(maps, plain)):
            for g, r, t in zip(got, ref, (t_hi, t_lo)):
                max_err = max(max_err, float((g - r).abs().max()))
                if not torch.equal(g, r):
                    raise AssertionError(
                        "%s, level %d, t=%g: kernel != plain (not bit-exact)"
                        % (what, i % len(levels), t))
    maps = plain[:len(levels)]
    pixels = sum(lv.numel() for lv in levels)
    bound_bytes = 12 * pixels          # read 4 B, write 2 x 4 B per pixel
    ops, cands = _ops_needed(levels, maps, t_lo)
    bound_ms = max(bound_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    bound_by = ("bytes" if bound_bytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S
                else "operations")

    def kernel(lvls=levels):
        fast.fast_score_pyramid(lvls, t_hi, t_lo)

    def plain_fn(lvls=levels):
        for lv in lvls:
            fast.fast_score_map_torch(lv, t_hi)
            fast.fast_score_map_torch(lv, t_lo)

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rows = []
    for i, lv in enumerate(levels):
        rows.append((i, lv.shape[1], lv.shape[0],
                     _device_ms(lambda: kernel([lv])),
                     _median_ms(lambda: kernel([lv])),
                     _median_ms(lambda: plain_fn([lv]))))
    return dict(max_err=max_err, rows=rows, pixels=pixels, cands=cands,
                bound_bytes=bound_bytes, ops=ops, bound_ms=bound_ms,
                bound_by=bound_by,
                dev_ms=_device_ms(kernel),
                dev_cold_ms=_device_ms(kernel, flush=flush),
                wall_ms=_median_ms(kernel), plain_ms=_median_ms(plain_fn),
                two_dev_ms=_device_ms(lambda: kernel(frames[0] + frames[1])))


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
    fast.fast_score_pyramid.launches = 0
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
    launches = fast.fast_score_pyramid.launches
    syncs = system.tracker.lm_host_syncs
    peak = torch.cuda.max_memory_allocated()

    if launches != N_FRAMES:
        raise AssertionError("FAST kernel launched %d times for %d frames "
                             "(one launch per frame expected)"
                             % (launches, N_FRAMES))
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
    sass = _sass_sections(lib)

    t0 = time.perf_counter()
    seq = SynthSequence(kitti_config(n_frames=N_FRAMES))
    print("synthetic KITTI-scale sequence: %d frames in %.1f s"
          % (N_FRAMES, time.perf_counter() - t0))

    k = kernel_phase([seq.frame(0).gray, seq.frame(1).gray],
                     torch.device("cuda"))
    print("kernel phase: FAST-9/16 score maps of the whole pyramid, both "
          "thresholds, one launch; kernel == plain bit for bit at all %d "
          "levels, also for two frames' pyramids in one launch (max abs err "
          "%g)" % (len(k["rows"]), k["max_err"]))
    print("  device = CUDA events around %d back-to-back launches / %d; "
          "wall = CUDA events around one call, launch path included (median "
          "of %d)" % (DEVICE_REPS, DEVICE_REPS, TIMING_REPS))
    print("  level  shape      kernel_dev_ms  kernel_wall_ms  plain_wall_ms")
    for lvl, lw, lh, kd, kw, pw in k["rows"]:
        print("  %5d  %4dx%-4d  %13.5f  %14.5f  %13.5f  (one-level launch)"
              % (lvl, lw, lh, kd, kw, pw))
    print("  pyramid  %d px   %13.5f  %14.5f  %13.5f  (one launch)"
          % (k["pixels"], k["dev_ms"], k["wall_ms"], k["plain_ms"]))
    print("  pyramid device ms with L2 flushed (64 MiB written before each "
          "launch): %.5f; the main path sees the warm figure (its levels "
          "were written by the resize just before)" % k["dev_cold_ms"])
    print("  two frames' pyramids, one launch: device %.5f ms"
          % k["two_dev_ms"])
    if sass is None or len(sass) != 3:
        print("  SASS instructions per pixel: not measured (sections %s)"
              % sass)
    else:
        frac = k["cands"] / k["pixels"]
        print("  SASS (static, cuobjdump): %d instructions; compass pass %d "
              "per unit of 8 rows = %.1f a pixel; full-test loop %d a "
              "candidate; %.2f %% of pixels are candidates, so %.1f a pixel "
              "on this frame" % (sum(sass), sass[0], sass[0] / 8, sass[1],
                                 100 * frac, sass[0] / 8 + frac * sass[1]))
    print("  bound: %d B (%.1f MB) over %.2f TB/s = %.5f ms; %d ops over "
          "%.1f T/s = %.5f ms; bound by %s; device time at %.1f %% of the "
          "bound (warm), %.1f %% (L2 flushed); %s" % (
              k["bound_bytes"], k["bound_bytes"] / 1e6, HBM_BYTES_PER_S / 1e12,
              k["bound_bytes"] / HBM_BYTES_PER_S * 1e3, k["ops"],
              FP32_OPS_PER_S / 1e12, k["ops"] / FP32_OPS_PER_S * 1e3,
              k["bound_by"], 100 * k["bound_ms"] / k["dev_ms"],
              100 * k["bound_ms"] / k["dev_cold_ms"], smi))

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
        "name": "fast_score_pyramid",
        "route": "cuda",
        "source": "sdpl_slam_torch/csrc/fast_score.cu",
        "replaces": "sdpl_slam_tpu/ops/fast.py:119",
        "launches": res["launches"],
        "max_abs_err": k["max_err"],
        "ms": k["dev_ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,            # no PyTorch call computes FAST-9/16
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
