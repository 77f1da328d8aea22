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
   Then the LM phase: the joint flow+pose LM's body, the kernel
   ``csrc/flow_pose_lm.cu`` against the plain PyTorch body at the
   chained step's capacities (1 lane of 1200 points and 400 lines; 8
   lanes of 800 and 100): one iteration from the same state, timed as a
   captured graph; then the whole loop captured with each body (a
   launch of it counted once on the host, and once an iteration by the
   kernel's own count).
3. Lines phase: ``ops.lines.detect_lines`` on two KITTI-size grey frames
   in both modes (0 LSD-style, 1 EDLines-style) on the card against the
   same call on the CPU (set-level match of the segments, gated), its
   device and wall time, its kernel launches under torch.profiler, and
   its recall of the generator's structure lines.  Fails if the detector
   finds nothing on an image that has strokes.  Then the line kernels
   (``csrc/line_detect.cu``: the NFA gate and the tile merge rounds) at
   both benchmark cells' frame sizes (1242x375, 640x480) and octaves
   against their plain chains on the card (the merge bit for bit), their
   device times beside their bounds and the plain chains', and the line
   stage's captured graph built with the plain chains and with the
   kernels: nodes, device ms and the kernels' launches a replay.
4. Disk phase, the main path at full width and depth: 37 KITTI-scale
   synthetic frames (the JAX bench's sequence: 1242x375, 2 moving
   objects, 0.2 px flow noise) are written to a temporary directory in
   the reference dataset layout by ``examples/make_demo_sequence_torch``'s
   writer, with a settings.yaml of the bench's configuration (reference
   caps, window BA 20 / 4, global BA).  36 of them are tracked as
   ``examples/run_sequence_torch.py`` tracks them: ``load_sequence``,
   ``FramePrefetcher``, ``System(settings.yaml)`` on the card, nothing
   injected (FAST and the line detector in the loop), windows at frames
   19 and 35 and the global BA at 35, ``save_results``.  Checks: one FAST
   launch and one line-detector run per frame, both windows and the
   global BA ran, the 7 result files parse, camera RPE of the primary and
   refined poses under the GT gates, static lines tracked in the steady
   frames, and the first frames agree with the same files run on the
   CPU.  Each frame's detectors run as two graph launches of the captured
   detector program (FAST, the line detector) and its solve as one launch
   of the captured fused-frame program of its object-lane count and line
   mode, both LMs ending on the card: no LM host read in the phase, one
   detector capture and at most three fused-frame captures.  On the
   inputs of frames 1-8 each graph program is held to its eager twin
   (the plain version) bit for bit, the two timed in turns; one frame's
   two graph programs under CUDA events and torch.profiler (host calls,
   device kernels, idle share).  Every window and global BA runs as one
   launch of its captured program with one host read (at most three
   captures in the phase); the first window is replayed warm, the second
   under torch.profiler to count its launches and device time.
5. Resident phase: the first 20 of the same files tracked again with
   ``resident_tracking = True`` (the whole frame on the card against device
   state, FAST and the line detector inside the step, the map stream two
   frames behind), the window BA at frame 19.  On the card the frame runs
   as one launch of its captured CUDA graph, both joint LMs ending on the
   device in WHILE nodes (``csrc/graph_while.cu``).  Checks:
   one FAST launch a frame (counted per replay), label streams identical
   to the disk phase's host run, camera poses of frames 0-18 within the
   North-star gates of that run (relative motion within 1 % of the GT
   motion and 0.03 deg), the RPE gates; on frames 1-8 the eager step (the
   plain version) from the same state and inputs gives state and output
   buffers equal to the graph's bit for bit, the two timed in turns; no LM
   host read in the phase; one steady frame under
   ``torch.cuda.set_sync_debug_mode("warn")`` calls no synchronising
   operation; one under torch.profiler for its host launch calls, device
   kernels and idle share (and one eager frame beside it); the first
   capture's seconds, the median wall of a call, peak memory.
6. Pipelined phase: the same 20 files with ``pipelined_tracking = True``
   and the next frames' images as hints (frame t+1's detectors run on a
   side stream during frame t; a frame's finish runs at the start of the
   next call), the window BA at frame 19.  Checks: one FAST launch a frame,
   label streams, camera poses and object motions before the window equal
   to the disk phase's synchronous run bit for bit, no LM host read; the
   median wall of a call against that run's, the detector ms left on the
   calling thread.
7. Chained phase: the same 20 files with ``chained_tracking = True`` at
   depth 2 (the device core fed by host-sampled bundles; the next two
   frames' detectors ahead), the window BA at 19; then frames 0-13 at
   depth 3.  Each step is one launch of the captured chained program (the
   joint LMs in WHILE nodes).  Checks: one FAST launch a frame, the RPE
   gates, camera poses before the window within tests/test_chained.py's
   gates of the disk phase's host run, no LM host read, no synchronising
   call in one steady frame under the sync debug mode, one capture a
   depth; on frames 1-8 at both depths the eager step (the plain
   version) from the same state, provenance and inputs, in turns with the
   graph (eager, graph, graph, eager), gives state, provenance and output
   bit for bit.  Beside the resident phase: wall a call, host calls and
   device kernels of one frame under torch.profiler and the card's idle
   share from CUDA events, bytes pushed a frame, peak memory; the
   captures' seconds and node counts.
   Then the bench phase: one pass of ``python -m sdpl_slam_torch.bench``'s
   run (``bench.run``) at its own configuration, the JAX bench's: 54
   generator frames (53 tracked) in the chained loop at KITTI scale,
   nothing injected, windows at 19, 35 and 51.  Checks the RPE gates, a
   headline above 0, one FAST launch a frame, no LM host read, three
   windows, every section of the chained driver's timers one entry a
   chained frame; the device-exec probe puts the chained program's
   buffers back bit for bit and captures nothing.  Prints the bench's
   JSON line after "bench line: ".
8. KITTI phase: 21 frames of the same generator written in the KITTI
   layout (disparity PNGs, KITTI object rows, ``ChooseData: 2``,
   ``ba_schur: 1``, the reference's boundary shrink), 20 tracked from the
   files on the card with a trajectory canvas, nothing injected: the
   window BA and the global BA at frame 19 by the dense-Schur step.
   Checks: one FAST launch a frame, both BAs by the Schur step, the 7
   result files and ``examples/evaluate_torch.py``'s scores of them under
   the RPE gates, the GT object motions parsed from the KITTI rows against
   the generator's, the canvas drawn; frames 0-3 again in the resident
   mode against the host run (North-star gates, identical labels).
9. Injected phase (the path of the earlier slices, cut to 5 frames): the
   generator's frames straight into ``System(settings)`` with lines
   injected and no BA.
10. Non-joint phase: 6 frames with ``use_joint_optimization = False``
   (the pose-only camera solver), lines injected; each frame's solve one
   launch of the captured non-joint program (camera init, the pose-only
   LM's 130 iterations unrolled, the objects' LM in a WHILE node).  Checks
   the RPE gates and no LM host read; on each tracked frame's inputs the
   program's graph against its eager twin in turns, bit for bit; the
   captures' seconds and node counts.
11. BA phase: the final map with its camera poses perturbed, one window BA
   (20 frames) by the CG step and by the dense-Schur step.  Each step's
   padded window graph runs on the card through its captured program
   (``run_ba_fused`` / ``run_ba_fused_schur``: one graph launch, the LM
   loop a WHILE node, for CG the CG loop a WHILE node nested in its body)
   and through the eager plain version (``run_ba`` / ``run_ba_schur``), in
   turns: state, cost and iterations bit for bit, one host read a graph
   call; the capture's seconds and node counts, one graph call under
   torch.profiler (host calls, device kernels) and the device's busy
   share from CUDA events, peak memory.  Then ``partial_batch_optimization``
   on the card and on the CPU in float64 to a fixed count of LM
   iterations (gain 1e-12): final costs and window poses within the
   tolerances below, both nearer the ground truth than the perturbed
   start; the Schur step's final cost at most 1.05 times the CG step's.
12. Descriptor phase: ORB for the selected keypoints (the FAST pyramid, one
   launch a frame, then the tracker's background and per-object caps) and
   LBD for the detected lines of the first disk-phase frames, on the card
   and on the CPU on the same inputs: the bits equal except where the two
   compared values lie within 1e-5 on either side; the Hamming matrix and
   mutual matches of frame t against t+1 identical on both; wall ms and
   kernel launches a call.
   Then the entry phase: ``sdpl_slam_torch.entry.entry()`` (the twin of
   ``__graft_entry__.entry``) once on the card, against the CPU.
13. Sharded BA phase (``parallel.sharded_ba``): a world of one under NCCL on
   the disk phase's global graph, and a gloo world of 4 ranks on the one
   card on the 500-frame ``synth_big_graph`` (both layouts), each step
   against ``batch_ba.ba_gn_step`` on one device; the partitioned LM run
   (3 iterations); the ``parallel.dryrun`` twin in a gloo world of 4.

Any failure raises (non-zero exit).  The last two lines of standard
output are the kernels' JSON line and ``{"ok": true, "device": ...}``.
Without a CUDA device it exits non-zero and prints no result.
"""

import concurrent.futures
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time

CUDA_SOURCES = ("fast_score.cu", "graph_while.cu",  # built at start
                "flow_pose_lm.cu", "line_detect.cu")
N_FRAMES = 36          # tracked from disk on the card
LBA_FRAMES = (19, 35)  # window BA (window 20, overlap 4); global BA at 35
N_CPU_CHECK = 3        # of those, also run on the CPU as the reference
N_RESIDENT = 20        # of those, again: resident, pipelined, chained
N_INJECTED = 5         # frames of the injected-lines path (no BA)
N_NONJOINT = 6         # frames of the non-joint path
N_KITTI = 20           # frames of the KITTI phase (window and global BA at 19)
# Disk path gates.  The files store depth in 1 cm steps; on the first 12
# of them on the CPU the JAX package reaches a camera RPE of 3.29 mm /
# 0.0158 deg and this package 1.11 mm / 0.0142 deg (1.01 mm / 0.0157 deg
# over all 36 without a BA), so the bench's GT gates hold as they are.
RPE_T_GATE, RPE_R_GATE = 0.005, 0.1
# static lines tracked per frame from frame 5 on: the CPU run of the same
# files keeps 9 to 42 (3 to 11 in the first frames)
MIN_STATIC_LINES, STEADY_FROM = 5, 5
CPU_POSE_ATOL = 1e-4   # first frames, card vs CPU camera poses
# lines phase: segments on the card vs on the CPU.  Both endpoints within
# LINE_MATCH_PX for at least LINE_MATCH_FRAC of either set, and at least
# LINE_ALONG_FRAC of either set lying along a segment of the other.  The
# card's float32 sums run in another order than the CPU's, and the
# generator's strokes sit on integer pixels, where the detector's rounded
# lookups and threshold compares tie: a few segments per image come out
# split, merged or extended differently (PERF.md).  Recall of the
# generator's structure lines: 0.81 to 1.0 on the CPU.
LINE_MATCH_PX, LINE_MATCH_FRAC = 0.5, 0.8
LINE_ALONG_FRAC, LINE_RECALL_MIN = 0.9, 0.6
NONJOINT_T_GATE, NONJOINT_R_GATE = 0.02, 0.2   # tests/test_nonjoint_path.py
BA_WINDOW = 20
# BA phase: card vs CPU final cost.  Float32 window runs stopped by the
# 1e-3 gain rule part by rounding and stop some steps apart (4.5e-3 and
# 1.76e-2 on maps tracked from disk, ROADMAP C6), so the card and the CPU
# are compared in float64 to a fixed count of LM iterations (gain 1e-12),
# a stop that rounding does not move; the limit stays 10 times the gain
# rule's resolution
BA_COST_RTOL = 1e-2
BA_POSE_ATOL = 1e-3    # BA phase: card vs CPU window poses (m, rotation)
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


def _device_ms(fn, reps=DEVICE_REPS, prepare=None, median=False):
    """Device time per call of ``fn`` from CUDA events: ``reps`` calls
    back to back, enqueued while the card is held in ``torch.cuda._sleep``
    so that the host's launch path does not pace them; their mean.  With
    ``prepare`` (a callable: a write that evicts the L2 cache, or one that
    puts a state back), each call follows ``prepare()`` and is timed by
    its own pair of events; the mean of those, or with ``median`` their
    median."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 2 ** 27
    for _ in range(4):
        torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(2 if prepare is None else 2 * reps)]
        if prepare is None:
            ev[0].record()
            for _ in range(reps):
                fn()
            ev[1].record()
        else:
            for i in range(reps):
                prepare()
                ev[2 * i].record()
                fn()
                ev[2 * i + 1].record()
        ahead = not slept.query()      # all enqueued before the card woke
        torch.cuda.synchronize()
        if ahead:
            if prepare is None:
                return ev[0].elapsed_time(ev[1]) / reps
            t = sorted(ev[2 * i].elapsed_time(ev[2 * i + 1])
                       for i in range(reps))
            return t[reps // 2] if median else sum(t) / reps
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
                dev_cold_ms=_device_ms(
                    kernel, prepare=lambda: flush.fill_(1.0)),
                wall_ms=_median_ms(kernel), plain_ms=_median_ms(plain_fn),
                two_dev_ms=_device_ms(lambda: kernel(frames[0] + frames[1])))


# LM phase: the joint flow+pose LM's body at the chained step's two
# capacities: (name, lanes, points, lines a lane, prior information)
LM_SHAPES = (("camera", 1, 1200, 400, 0.3), ("objects", 8, 800, 100, 0.5))
LM_MOTIONS = (1.0, 0.3, 2.0, 0.05, 0.5, 1.5, 0.1, 0.8)
LM_STATE = ("T", "f", "g", "cost", "lam", "nu", "it", "done", "active_any")
LM_REPS = 50         # a launch and 9 copies each: within the launch queue
# float operations of the kernel a feature, both passes (counted from
# csrc/flow_pose_lm.cu: linearisation, reduction terms, the step, the new
# cost); bytes a feature: its inputs read once, its flow written once
LM_OPS_POINT, LM_OPS_LINE = 435, 1580
LM_BYTES_POINT, LM_BYTES_LINE = 37 + 8, 73 + 16


def lm_phase():
    """The joint LM's body at the chained step's capacities: the kernel
    (``frame_solvers.lm_iteration_cuda``) against the plain PyTorch body
    (``lm_iteration_torch``) on the card, one iteration from the same
    state, each captured as a graph and timed by CUDA events (the state
    put back before each launch, outside the events); then the whole loop
    (``lm_init`` and the WHILE node) captured with each body.  Returns
    one dict a shape."""
    import torch

    from sdpl_slam_torch.solvers import frame_solvers as fs
    from sdpl_slam_torch.utils.cuda_graphs import (GraphRecorder,
                                                   capture_stream,
                                                   host_while, loop_runner,
                                                   run_loop)
    from sdpl_slam_torch.utils.synthetic import flow_pose_lanes

    dev = torch.device("cuda")
    side = capture_stream(dev)
    eye = torch.eye(4, device=dev)
    shapes, rows, after = [], [], []
    for name, B, N, M, prior in LM_SHAPES:
        inp = flow_pose_lanes(0, N, M, LM_MOTIONS[:B], dev)
        shapes.append((inp, prior))
        rows.append(dict(name=name, B=B, N=N, M=M))
        after.append({})

    def capture(fn):
        torch.cuda.synchronize()
        rec = GraphRecorder(counters=[(fs.lm_iteration_cuda, "launches")])
        with torch.cuda.stream(side):
            with rec, loop_runner(rec.loop):
                fn()
        graph = rec.stitch("lm")
        torch.cuda.synchronize()
        return graph

    for kind, body in (("plain", fs.lm_iteration_torch),
                       ("kernel", fs.lm_iteration_cuda)):
        for ((T0, pts, lns, K), prior), row, aft in zip(shapes, rows, after):
            def init():
                return fs.lm_init(T0, eye, pts, lns, K,
                                  flow_prior_info=prior,
                                  line_prior_info=prior, rel_tol=1e-4)

            s = init()
            keep = {k: getattr(s, k).clone() for k in LM_STATE}

            def restore(s=s, keep=keep):
                for k, v in keep.items():
                    getattr(s, k).copy_(v)

            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                body(s)                       # warm-up outside the capture
            torch.cuda.synchronize()
            restore()
            one = capture(lambda: body(s))
            restore()
            one.launch()
            torch.cuda.synchronize()
            aft[kind] = {k: getattr(s, k).clone() for k in LM_STATE}
            row[kind + "_nodes"] = one.node_counts()[0]
            row[kind + "_us"] = _device_ms(one.launch, reps=LM_REPS,
                                           prepare=restore,
                                           median=True) * 1e3
            # the whole loop, as the step captures it
            holder = {}

            def solve(body=body):
                s2 = init()
                assert run_loop(lambda: body(s2), s2.active_any,
                                "flow_pose.lm")
                holder["s"] = s2

            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                with loop_runner(host_while):
                    solve()
            torch.cuda.synchronize()
            loop = capture(solve)
            launches = fs.lm_iteration_cuda.launches
            runs = fs.lm_kernel_runs()
            loop.launch()
            torch.cuda.synchronize()
            iters = int(holder["s"].it.max())
            # a replay counts the captured call once on the host; the
            # kernel counts each body run (the lanes' most iterations)
            got = (fs.lm_iteration_cuda.launches - launches,
                   fs.lm_kernel_runs() - runs)
            if got != ((1, iters) if kind == "kernel" else (0, 0)):
                raise AssertionError("LM phase, %s, %s body: one launch of "
                                     "the loop counted %s (host, kernel) "
                                     "for %d iterations"
                                     % (row["name"], kind, got, iters))
            row[kind + "_iters"] = holder["s"].it.tolist()
            row[kind + "_loop_us"] = _device_ms(loop.launch, reps=20) * 1e3
            row[kind + "_loop_nodes"] = loop.node_counts()
            row[kind + "_us_a_loop_iter"] = row[kind + "_loop_us"] / iters
    for row, aft in zip(rows, after):
        name, B, N, M = row["name"], row["B"], row["N"], row["M"]
        a, b = aft["kernel"], aft["plain"]
        for k in ("nu", "it", "done", "active_any"):
            if not torch.equal(a[k], b[k]):
                raise AssertionError("LM phase, %s: kernel and plain body "
                                     "part on %s after one iteration"
                                     % (name, k))
        row["max_err"] = {k: float((a[k] - b[k]).abs().max())
                          for k in ("T", "f", "g", "cost", "lam")}
        if not (row["max_err"]["T"] < 2e-5 and row["max_err"]["f"] < 2e-3
                and row["max_err"]["g"] < 2e-3):
            raise AssertionError("LM phase, %s: kernel against plain body "
                                 "%s" % (name, row["max_err"]))
        it_k, it_p = row["kernel_iters"], row["plain_iters"]
        if max(abs(x - y) for x, y in zip(it_k, it_p)) > 1:
            raise AssertionError("LM phase, %s: iterations %s against the "
                                 "plain body's %s" % (name, it_k, it_p))
        row["bytes"] = B * (N * LM_BYTES_POINT + M * LM_BYTES_LINE)
        row["ops"] = B * (N * LM_OPS_POINT + M * LM_OPS_LINE)
        row["bound_us"] = max(row["bytes"] / HBM_BYTES_PER_S,
                              row["ops"] / FP32_OPS_PER_S) * 1e6
        row["bound_by"] = ("bytes" if row["bytes"] / HBM_BYTES_PER_S
                           >= row["ops"] / FP32_OPS_PER_S else "operations")
    return rows


def _lba_settings(seq):
    from sdpl_slam_torch.utils.synthetic import lba_settings

    s = lba_settings(seq.cfg)
    s.run_global_ba = True
    return s


def _example(name):
    """A script of ``examples/`` beside this file, as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _compact(seg):
    import torch

    packed = torch.cat([seg.uv4, seg.valid[:, None].float()], 1).cpu().numpy()
    return packed[packed[:, 4] > 0.5, :4]


def _events(prof):
    """(on the card, name, start us, end us) of every event of a finished
    torch.profiler run, read from its raw Kineto results: building the
    profiler's own event list costs ~0.5 ms an event (~100 s for a traced
    window BA), reading the raw results ~100 times less."""
    from torch.autograd import DeviceType

    return [(e.device_type() == DeviceType.CUDA, e.name(), e.start_ns() / 1e3,
             e.end_ns() / 1e3) for e in prof.profiler.kineto_results.events()]


def _launch_calls(events, lo=-math.inf, hi=math.inf):
    """Kernel launches (runtime calls on the host) starting in [lo, hi]."""
    return sum(1 for cuda, name, t0, _ in events
               if not cuda and "LaunchKernel" in name and lo <= t0 <= hi)


def _device_events(events, exclude=(), lo=-math.inf, hi=math.inf):
    """Device events starting in [lo, hi], the names in ``exclude`` left
    out: [(name, us)]."""
    return [(name, t1 - t0) for cuda, name, t0, t1 in events
            if cuda and lo <= t0 <= hi and name not in exclude]


def _match_frac(a, b, tol):
    """Share of segments of ``a`` with a segment of ``b`` whose endpoints
    both lie within ``tol`` px, in either order (a segment is an unordered
    pair: a tile's principal direction can come out with either sign)."""
    import numpy as np

    if len(a) == 0:
        return 1.0
    if len(b) == 0:
        return 0.0
    best = np.inf
    for other in (b, b[:, [2, 3, 0, 1]]):
        d = (a[:, None, :] - other[None, :, :]).reshape(len(a), len(b), 2, 2)
        best = np.minimum(best, np.sqrt((d ** 2).sum(-1)).max(-1))
    return float((best.min(1) < tol).mean())


def _lies_along(a, b, ang_tol=math.radians(10), lat_tol=3.0, min_ov=0.3):
    """The segment match of ``tests/test_lsd_oracle.py``: directions
    within 10 deg, ``a``'s midpoint within 3 px of ``b``'s line, over 30 %
    of ``a``'s length inside ``b``'s extent."""
    def ang(s):
        return math.atan2(s[3] - s[1], s[2] - s[0])

    dx, dy = b[2] - b[0], b[3] - b[1]
    n = max(math.hypot(dx, dy), 1e-9)
    d = abs(ang(a) - ang(b)) % math.pi
    if min(d, math.pi - d) > ang_tol:
        return False
    mid = ((a[0] + a[2]) / 2, (a[1] + a[3]) / 2)
    if abs((mid[0] - b[0]) * dy - (mid[1] - b[1]) * dx) / n > lat_tol:
        return False
    ta = sorted(((a[k] - b[0]) * dx + (a[k + 1] - b[1]) * dy) / n
                for k in (0, 2))
    inside = max(min(ta[1], n) - max(ta[0], 0.0), 0.0)
    return inside / max(math.hypot(a[2] - a[0], a[3] - a[1]), 1e-9) > min_ov


def _along_frac(a, b):
    """Share of segments of ``a`` that lie along some segment of ``b`` or
    have one lying along them."""
    return sum(1 for x in a if any(_lies_along(x, y) or _lies_along(y, x)
                                   for y in b)) / max(len(a), 1)


def lines_phase(seq, line_cfg):
    """``detect_lines`` on the card against the CPU, both modes, on two
    frames; returns one row of figures per (frame, mode) and the gates
    that failed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdpl_slam_torch.ops import lines

    rows, failures = [], []
    for t in (0, 20):
        f = seq.frame(t)
        if f.lines is None or not len(f.lines):
            raise AssertionError("frame %d has no structure lines" % t)
        host = torch.from_numpy(f.gray)
        card = host.cuda()
        for mode in (0, 1):
            cfg = line_cfg._replace(mode=mode)

            def run():
                return lines.detect_lines(card, cfg)

            counts = line_kernel_counts()
            on_card = _compact(run())
            kernel_launches = line_kernel_counts(counts)
            if kernel_launches != (cfg.n_octaves, cfg.n_octaves):
                failures.append("frame %d mode %d: (NFA, merge) kernel "
                                "launches %s for %d octaves" % (
                                    t, mode, kernel_launches, cfg.n_octaves))
            on_cpu = _compact(lines.detect_lines(host, cfg))
            if not len(on_card):
                raise AssertionError(
                    "frame %d mode %d: the detector found no segment on an "
                    "image with %d strokes" % (t, mode, len(f.lines)))
            fwd = _match_frac(on_card, on_cpu, LINE_MATCH_PX)
            back = _match_frac(on_cpu, on_card, LINE_MATCH_PX)
            along = min(_along_frac(on_card, on_cpu),
                        _along_frac(on_cpu, on_card))
            recall = _along_frac(f.lines, on_card)
            if min(fwd, back) < LINE_MATCH_FRAC:
                failures.append(
                    "frame %d mode %d: card and CPU segments match %.3f / "
                    "%.3f, under %.2f" % (t, mode, fwd, back, LINE_MATCH_FRAC))
            if along < LINE_ALONG_FRAC:
                failures.append(
                    "frame %d mode %d: only %.3f of the card's and the "
                    "CPU's segments lie along one another" % (t, mode, along))
            if recall < LINE_RECALL_MIN:
                failures.append("frame %d mode %d: recall %.3f of the "
                                "structure lines" % (t, mode, recall))
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            events = _events(prof)
            launches = _launch_calls(events)
            dev = _device_events(events)
            rows.append(dict(
                frame=t, mode=mode, strokes=len(f.lines), card=len(on_card),
                cpu=len(on_cpu), fwd=fwd, back=back, along=along,
                recall=recall,
                wall_ms=sorted(walls)[2], launches=launches,
                kernel_launches=kernel_launches,
                kernels=len(dev),
                busy_ms=sum(us for _, us in dev) / 1e3))
    return rows, failures


# line kernels phase: the two cells' frame sizes; float ops of the NFA
# kernel a candidate (counted from csrc/line_detect.cu: 72 samples'
# lookups and tests, ~14 each; a subset's prefactor, ~30, and 64 Lentz
# steps of ~34) and its bytes (the candidate's 4 floats, 72 x 2 gathered
# gradients, 15 floats out); the merge kernel's float ops a tile a pass
# at most (the gates, ~71, and the merge, ~75, of an even slot) and its
# bytes (a tile's 4 floats and flag read and written once)
LINE_KERNEL_SHAPES = (("kitti", 1242, 375), ("omd", 640, 480))
NFA_OPS_CAND = 72 * 14 + 7 * (30 + 64 * 34)
NFA_BYTES_CAND = 4 * (4 + 72 * 2 + 15)
MERGE_OPS_TILE_PASS = 71 + 75
MERGE_BYTES_TILE = 2 * 17
LINE_KERNEL_REPS = 200    # events around each launch, median
LINE_PLAIN_REPS = 20      # replays of the plain chain's graph, median


def line_kernel_counts(since=(0, 0)):
    """(NFA, merge) launches of the line detector's two kernels, less
    ``since``."""
    from sdpl_slam_torch.ops import lines

    return (lines.nfa_significance_cuda.launches - since[0],
            lines.merge_rounds_cuda.launches - since[1])


def _check_line_launches(got, cfg, n_detects, what):
    """Raises unless ``got`` (NFA, merge launches) is one launch of each
    kernel an octave of each of ``n_detects`` ``detect_lines(..., cfg)``
    calls (none of a kernel whose stage ``cfg`` turns off)."""
    n = n_detects * max(1, cfg.n_octaves)
    want = (n if cfg.nfa_gate else 0, n if cfg.merge_rounds > 0 else 0)
    if tuple(got) != want:
        raise AssertionError("%s: (NFA, merge) kernel launches %s for %d "
                             "line detections of %d octaves, %s expected"
                             % (what, tuple(got), n_detects, cfg.n_octaves,
                                want))


def line_stage_calls(img, cfg):
    """One ``detect_lines(img, cfg)`` with the plain chains, recording
    what the main path hands the two kernels at each octave: a dict an
    octave of its ``cfg``, the merge's input ``seg`` and ``ok`` and its
    output ``merged`` (seg, ok), and the NFA gate's ``flat`` candidates and
    ``gx``, ``gy`` gradients."""
    from unittest import mock

    from sdpl_slam_torch.ops import lines

    merges, gates = [], []

    def merge(seg, ok, ocfg):
        out = lines._merge_rounds_torch(seg, ok, ocfg)
        merges.append(dict(cfg=ocfg, seg=seg, ok=ok, merged=out))
        return out

    def nfa(uv4, gx, gy, ocfg):
        gates.append(dict(flat=uv4, gx=gx, gy=gy))
        return lines._nfa_significance_torch(uv4, gx, gy, ocfg)

    with mock.patch.object(lines, "_merge_rounds", merge), \
            mock.patch.object(lines, "_nfa_significance", nfa):
        lines.detect_lines(img, cfg)
    if not len(merges) == len(gates) == max(1, cfg.n_octaves):
        raise AssertionError("detect_lines ran %d merges and %d NFA gates "
                             "for %d octaves" % (len(merges), len(gates),
                                                 cfg.n_octaves))
    return [dict(m, **g) for m, g in zip(merges, gates)]


def _graph_of(fn):
    """``fn`` captured into a CUDA graph after one eager warm-up."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph


def _line_stage_program(img, cfg, plain):
    """A captured detector program of the line stage alone over ``img``
    (not the memoized one), built with the plain chains patched in where
    ``plain``; returns it after one replay."""
    import contextlib
    from unittest import mock

    import torch

    from sdpl_slam_torch.models import frame_program as fp
    from sdpl_slam_torch.ops import lines

    dev = img.device
    stream = fp.detector_stream(dev)
    patches = contextlib.ExitStack()
    if plain:
        patches.enter_context(mock.patch.object(
            lines, "_nfa_significance", lines._nfa_significance_torch))
        patches.enter_context(mock.patch.object(
            lines, "_merge_rounds", lines._merge_rounds_torch))
    h, w = img.shape
    with patches, torch.cuda.stream(stream):
        prog = fp.DetectorProgram(
            [fp._line_stage(cfg)], {"img": ((h, w), img.dtype)},
            [5 * lines.n_segments(h, w, cfg)], dev, graph=True,
            stream=stream, kinds=["detector.lines"])
        prog.load({"img": img.cpu().numpy()})
        prog.run_stage(0)                       # capture, then launch
    torch.cuda.synchronize()
    return prog


def line_kernels_phase(line_cfg, kitti_gray):
    """The line detector's two kernels (csrc/line_detect.cu) at both
    cells' frame sizes and both octaves, on a synthetic frame with
    structure lines: against the plain chains on the card (the merge bit
    for bit; the NFA gate's counts equal, its significance within 1e-4),
    each kernel's device time (CUDA events around each of 200 launches,
    median) beside its bound and the plain chain's (one graph of it,
    events around each of 20 replays, median); then the line stage's
    captured graph built with the plain chains and with the kernels:
    nodes, ms a replay (events around each of 20, median), the host's ms
    a launch call (median of 20), the kernels' launches a replay.  Returns (kernel rows, stage rows); raises on a
    mismatch."""
    import torch

    from sdpl_slam_torch.models import frame_program as fp
    from sdpl_slam_torch.ops import lines
    from sdpl_slam_torch.utils.synthetic import SynthConfig, SynthSequence

    dev = torch.device("cuda")
    grays = {"kitti": kitti_gray, "omd": SynthSequence(SynthConfig(
        width=640, height=480, cx=320.0, cy=240.0, n_frames=1,
        n_objects=4)).frame(0).gray}
    rows, stages = [], []
    none = lambda: None                                      # noqa: E731
    for name, w, h in LINE_KERNEL_SHAPES:
        img = torch.from_numpy(grays[name]).to(dev)
        assert tuple(img.shape) == (h, w)
        cfg = line_cfg._replace(min_length=max(8.0, 0.02 * min(w, h)))
        for o, c in enumerate(line_stage_calls(img, cfg)):
            ocfg, seg, ok, ref = c["cfg"], c["seg"], c["ok"], c["merged"]
            flat, gx, gy = c["flat"], c["gx"], c["gy"]
            got = lines.merge_rounds_cuda(seg, ok, ocfg)
            if not (torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1])):
                raise AssertionError("line kernels, %s octave %d: merge "
                                     "kernel != plain chain" % (name, o))
            rb, rk, rn = lines._nfa_significance_torch(flat, gx, gy, ocfg)
            kb, kk, kn = lines.nfa_significance_cuda(flat, gx, gy, ocfg)
            fin = torch.isfinite(rb)
            nfa_err = (float((kb[fin] - rb[fin]).abs().max()) if fin.any()
                       else 0.0)
            if not (torch.equal(kk, rk) and torch.equal(kn, rn)
                    and torch.equal(torch.isfinite(kb), fin)
                    and nfa_err <= 1e-4):
                raise AssertionError("line kernels, %s octave %d: NFA kernel "
                                     "against plain chain (max err %g)"
                                     % (name, o, nfa_err))
            gh, gw = ok.shape
            N, passes = gh * gw, 4 * ocfg.merge_rounds
            merge = (lambda s=seg, k=ok, c=ocfg:
                     lines.merge_rounds_cuda(s, k, c))
            nfa = (lambda f=flat, a=gx, b=gy, c=ocfg:
                   lines.nfa_significance_cuda(f, a, b, c))
            merge_plain = _graph_of(lambda s=seg, k=ok, c=ocfg:
                                    lines._merge_rounds_torch(s, k, c))
            nfa_plain = _graph_of(lambda f=flat, a=gx, b=gy, c=ocfg:
                                  lines._nfa_significance_torch(f, a, b, c))
            for kname, fn, plain, bts, ops in (
                    ("merge_rounds", merge, merge_plain, N * MERGE_BYTES_TILE,
                     N // 2 * passes * MERGE_OPS_TILE_PASS),
                    ("nfa_significance", nfa, nfa_plain, N * NFA_BYTES_CAND,
                     N * NFA_OPS_CAND)):
                dev_ms = _device_ms(fn, reps=LINE_KERNEL_REPS, prepare=none,
                                    median=True)
                plain_ms = _device_ms(plain.replay, reps=LINE_PLAIN_REPS,
                                      prepare=none, median=True)
                bound_ms = max(bts / HBM_BYTES_PER_S,
                               ops / FP32_OPS_PER_S) * 1e3
                rows.append(dict(
                    kernel=kname, shape=name, octave=o, grid=(gh, gw),
                    kept=int(ref[1].sum()), tiles_ok=int(ok.sum()),
                    dev_us=dev_ms * 1e3, plain_us=plain_ms * 1e3,
                    bytes=bts, ops=ops, bound_us=bound_ms * 1e3,
                    bound_by=("bytes" if bts / HBM_BYTES_PER_S
                              >= ops / FP32_OPS_PER_S else "operations"),
                    # the merge is compared bit for bit, else it raised
                    max_err=nfa_err if kname == "nfa_significance" else 0.0))
        for plain in (True, False):
            prog = _line_stage_program(img, cfg, plain)
            stream = fp.detector_stream(dev)
            counts = line_kernel_counts()
            with torch.cuda.stream(stream):
                prog.run_stage(0)
                got = line_kernel_counts(counts)
                # events around each replay: a queue of replays of a
                # graph this size fills the card's launch queue
                ms = _median_ms(lambda p=prog: p.run_stage(0),
                                reps=LINE_PLAIN_REPS)
                # the host's side of a replay (the graph's launch call, as
                # the chained loop's detector dispatch makes it), the card
                # idle before each
                host = []
                for _ in range(LINE_PLAIN_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    prog.run_stage(0)
                    host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            want = (0, 0) if plain else (cfg.n_octaves, cfg.n_octaves)
            if got != want:
                raise AssertionError("line kernels, %s: a replay of the "
                                     "line stage (%s) launched %s (NFA, "
                                     "merge)" % (name, "plain" if plain
                                                 else "kernels", got))
            stages.append(dict(shape=name, plain=plain,
                               nodes=sum(prog.node_counts[0]),
                               capture_s=prog.capture_s, dev_ms=ms,
                               host_ms=sorted(host)[len(host) // 2],
                               launches=got))
    return rows, stages


def write_disk_sequence(seq, root):
    """``seq``'s frames under ``root`` in the reference dataset layout,
    with the bench's configuration as its settings.yaml; returns the
    settings the yaml must load back to."""
    import dataclasses

    from sdpl_slam_torch.utils import config

    mk = _example("make_demo_sequence_torch")
    want = _lba_settings(seq)
    want.depth_map_factor = mk.DEPTH_FACTOR
    mk.write_sequence(root, seq, N_FRAMES + 1, config.format_overrides(want))
    got = config.load_settings(os.path.join(root, "settings.yaml"))
    if dataclasses.asdict(got) != dataclasses.asdict(want):
        raise AssertionError("settings.yaml does not load back to the "
                             "bench's configuration")
    return want


def _track_loaded(system, loaded, i, frame, nxt=None, nxt2=None):
    gray, depth, flow, mask = frame
    return system.track_rgbd(
        gray, depth, flow, mask, loaded.gt_pose(i), loaded.gt_obj_poses(i),
        float(loaded.timestamps[i]), loaded.n_frames,
        next_image=None if nxt is None else nxt[0],
        next_image2=None if nxt2 is None else nxt2[0])


RESULT_FILES = ("obj_mot_stereo_new.txt", "obj_mot_stereo_rf_new.txt",
                "obj_mot_gt.txt", "obj_centre.txt", "initial_stereo_new.txt",
                "refined_stereo_new.txt", "cam_pose_gt_stereo.txt")


def _check_run(system, n_frames, launches, what, t_gate, r_gate,
               refined=True):
    """Gates every tracked path shares: one FAST launch per frame, the
    camera RPE under its gates, an object tracked."""
    from sdpl_slam_torch.utils import metrics

    if launches != n_frames:
        raise AssertionError("%s: FAST kernel launched %d times for %d "
                             "frames (one launch per frame expected)"
                             % (what, launches, n_frames))
    m = system.map
    rpe = {}
    for name, poses in (("primary", m.camera_poses),
                        ("refined", m.camera_poses_rf))[:2 if refined else 1]:
        t_err, r_err = metrics.camera_rpe(poses, m.camera_poses_gt)
        rpe[name] = (t_err, r_err)
        if not (t_err < t_gate and r_err < r_gate):
            raise AssertionError("%s: %s camera RPE %.5f m / %.4f deg over "
                                 "the gates %g m / %g deg"
                                 % (what, name, t_err, r_err, t_gate, r_gate))
    n_obj = sum(len(x) - 1 for x in m.rm_labels)
    if n_obj == 0:
        raise AssertionError("%s: no object was tracked" % what)
    return rpe, n_obj


HOST_COMPARE_FRAMES = range(1, 9)   # disk path: graph programs against eager
MAX_FRAME_CAPTURES = 3   # disk path: camera only, one and two object lanes


class _RecordLoads:
    """Records, in the frames handed to :meth:`frame`, every graph
    program's ``load``: the program and a copy of the host arrays, so the
    same inputs can go through the program's eager twin afterwards."""

    def __init__(self):
        self.rows = []          # (frame, [(program, arrays)])

    def frame(self, t):
        import contextlib

        import numpy as np

        from sdpl_slam_torch.models import frame_program as fp

        if t is None:
            return contextlib.nullcontext()
        loads = []
        self.rows.append((t, loads))
        plain = fp.FrameProgram.load

        def load(prog, arrays):
            if prog.graph:
                loads.append((prog, {k: np.array(a)
                                     for k, a in arrays.items()}))
            return plain(prog, arrays)

        @contextlib.contextmanager
        def patched():
            fp.FrameProgram.load = load
            try:
                yield
            finally:
                fp.FrameProgram.load = plain

        return patched()


def _span_ms(spans, name, outside=None):
    """The ms of every span called ``name``, in order; ``outside``: only
    those whose parent is not called so."""
    return [(s.end_ns - s.start_ns) * 1e-6 for s in spans if s.name == name
            and (outside is None or s.parent < 0
                 or spans[s.parent].name != outside)]


def disk_phase(root, out_dir):
    """The port's main path on the card: the sequence under ``root``
    through the loader, the prefetcher and ``System(settings.yaml)`` with
    nothing injected.  Returns its measurements and, for each window's
    frame, a copy of the system taken just before it with the frame."""
    import copy

    import numpy as np
    import torch

    from sdpl_slam_torch.io.dataset import load_sequence, png_decoder
    from sdpl_slam_torch.io.prefetch import FramePrefetcher
    from sdpl_slam_torch.models import frame_program as fp
    from sdpl_slam_torch.models.system import System
    from sdpl_slam_torch.ops import fast
    from sdpl_slam_torch.solvers import frame_solvers as fs
    from sdpl_slam_torch.utils import trace

    system = System(os.path.join(root, "settings.yaml"), verbose=False)
    if system.device.type != "cuda":
        raise AssertionError("System(settings.yaml) is not on the card")
    loaded = load_sequence(root)
    if loaded.n_frames != N_FRAMES:
        raise AssertionError("the loader sees %d frames" % loaded.n_frames)
    load_ms = []

    def load(i):
        t0 = time.perf_counter()
        frame = loaded.frame(i)
        load_ms.append((time.perf_counter() - t0) * 1e3)
        return frame

    replays = {}
    torch.cuda.reset_peak_memory_stats()
    fast.fast_score_pyramid.launches = 0
    line_launches = line_kernel_counts()
    lm_runs = fs.lm_kernel_runs()
    system.tracker.lm_host_syncs = 0
    captures = (fp.FrameProgram.captures, fp.DetectorProgram.captures)
    frame_ms, wait_ms = [], []
    pf = FramePrefetcher(load, N_FRAMES, lookahead=3)
    try:
        # the span recorder times the synchronous detectors
        with trace.enabled():
            frames = iter(pf)
            loads = _RecordLoads()
            for _ in range(N_FRAMES):
                t0 = time.perf_counter()
                i, frame = next(frames)
                nxt, nxt2 = pf.peek(i + 1), pf.peek(i + 2)
                wait_ms.append((time.perf_counter() - t0) * 1e3)
                if i in LBA_FRAMES:
                    replays[i] = (copy.deepcopy(system), frame)
                t0 = time.perf_counter()
                with loads.frame(i if i in HOST_COMPARE_FRAMES
                                 else None):
                    pose = _track_loaded(system, loaded, i, frame, nxt,
                                         nxt2)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                if not np.all(np.isfinite(pose)) or pose.shape != (4, 4):
                    raise AssertionError("frame %d: pose not a finite 4x4"
                                         % i)
                if i == N_CPU_CHECK - 1:   # before a window rewrites them
                    first = [p.copy() for p in system.map.camera_poses]
                if i == LBA_FRAMES[0] - 1:  # the device loops' reference
                    before_window = [p.copy()
                                     for p in system.map.camera_poses]
                    before_motions = [[x.copy() for x in row]
                                      for row in system.map.rigid_motions]
            spans = trace.collect()["spans"]
    finally:
        pf.close()
    launches = fast.fast_score_pyramid.launches
    line_launches = line_kernel_counts(line_launches)
    lm_runs = fs.lm_kernel_runs() - lm_runs
    syncs = system.tracker.lm_host_syncs
    peak = torch.cuda.max_memory_allocated()
    captures = (fp.FrameProgram.captures - captures[0],
                fp.DetectorProgram.captures - captures[1])

    rpe, n_obj = _check_run(system, N_FRAMES, launches, "disk path",
                            RPE_T_GATE, RPE_R_GATE)
    if syncs:
        raise AssertionError("disk path: %d LM host reads (the frame "
                             "programs end their LMs on the card)" % syncs)
    line_ms = _span_ms(spans, "detector.lines")
    if len(line_ms) != N_FRAMES:
        raise AssertionError("the line detector ran %d times for %d frames"
                             % (len(line_ms), N_FRAMES))
    _check_line_launches(line_launches, system.tracker._line_cfg(), N_FRAMES,
                         "disk path")
    runs = system.tracker.ba_runs
    want = [("local", f) for f in LBA_FRAMES] + [("global", N_FRAMES - 1)]
    if [(r["kind"], r["frame"]) for r in runs] != want:
        raise AssertionError("batch BA runs %s, expected %s" % (
            [(r["kind"], r["frame"]) for r in runs], want))
    m = system.map
    n_lines = [int(v.sum()) for v in m.line_valid]
    if min(n_lines[STEADY_FROM:]) < MIN_STATIC_LINES:
        raise AssertionError("static lines tracked per frame %s: under %d "
                             "from frame %d on" % (n_lines, MIN_STATIC_LINES,
                                                   STEADY_FROM))
    system.save_results(out_dir)
    for name in RESULT_FILES:
        rows = np.loadtxt(os.path.join(out_dir, name), ndmin=2)
        if not len(rows) or not np.all(np.isfinite(rows)):
            raise AssertionError("result file %s: empty or not finite" % name)
        if name.startswith(("initial", "refined", "cam_pose")) and \
                rows.shape != (N_FRAMES, 17):
            raise AssertionError("result file %s: shape %s" % (name, rows.shape))
    return dict(system=system, loaded=loaded, replays=replays, first=first,
                before_window=before_window, before_motions=before_motions,
                frame_ms=frame_ms, wait_ms=wait_ms, load_ms=load_ms,
                line_ms=line_ms, detect_ms=_span_ms(spans, "detector.run"),
                n_lines=n_lines, launches=launches,
                line_launches=line_launches, lm_runs=lm_runs, syncs=syncs,
                peak=peak, rpe=rpe, n_obj=n_obj, ba_runs=runs,
                decoder=png_decoder(), captures=captures, loads=loads.rows)


def _program_kind(prog):
    from sdpl_slam_torch.models import frame_program as fp

    return "detect" if isinstance(prog, fp.DetectorProgram) else "solve"


def _programs_in_turns(rows, what, kinds=("detect", "solve")):
    """Each graph program of ``kinds`` recorded in ``rows`` (frame, [(program,
    arrays)]) against its eager twin (the plain version, on buffers of its
    own) on the inputs it was loaded with: run in turns (eager, graph,
    graph, eager), load to synchronize, the detectors on the detector
    stream; outputs bit for bit, else it raises.  The twins' FAST launches
    are comparisons and are taken back.  -> {kind: [dict(frame, graph=[ms,
    ms], eager=[ms, ms], reads=[LM host reads of each eager run])]}"""
    import torch

    from sdpl_slam_torch.models import frame_program as fp
    from sdpl_slam_torch.ops import fast

    launches = fast.fast_score_pyramid.launches
    dev = torch.device("cuda")
    twins, out = {}, {k: [] for k in kinds}
    bad = []
    for t, loads in rows:
        for prog, arrays in loads:
            kind = _program_kind(prog)
            if kind not in kinds:
                continue
            twin = twins.setdefault(id(prog), prog.eager_twin())
            stream = (fp.detector_stream(dev) if kind == "detect"
                      else torch.cuda.current_stream(dev))
            row = dict(frame=t, graph=[], eager=[], reads=[])
            for who in ("eager", "graph", "graph", "eager"):
                p = twin if who == "eager" else prog
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.cuda.stream(stream):
                    p.load(arrays)
                    reads = p()
                torch.cuda.synchronize()
                row[who].append((time.perf_counter() - t0) * 1e3)
                if who == "eager":
                    row["reads"].append(reads)
                if len(row["graph"]) + len(row["eager"]) in (2, 4) and \
                        not torch.equal(twin.out, prog.out):
                    bad.append((t, kind))
            out[kind].append(row)
    fast.fast_score_pyramid.launches = launches
    if bad:
        raise AssertionError("%s: graph programs differ from their eager "
                             "twins (frame, program): %s" % (what, bad))
    return out


def host_programs_phase(rows):
    """The disk path's graph programs against their eager twins (the plain
    version, on buffers of their own) on the inputs each was loaded with
    in frames ``HOST_COMPARE_FRAMES``: each program run in turns (eager,
    graph, graph, eager), load to synchronize, the detectors on the
    detector stream; outputs bit for bit.  Then the last frame's two graph
    programs once more on one stream under CUDA events and once under
    torch.profiler, a program at a time (host calls, device kernels, idle
    share, the top kernels of each).  The twins' FAST launches are
    comparisons and are taken back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdpl_slam_torch.models import frame_program as fp
    from sdpl_slam_torch.ops import fast

    launches = fast.fast_score_pyramid.launches
    for t, loads in rows:
        kinds = sorted(_program_kind(p) for p, _ in loads)
        if kinds != ["detect", "solve"]:
            raise AssertionError("disk path frame %d: programs loaded %s"
                                 % (t, kinds))
    out = _programs_in_turns(rows, "disk path")
    t, loads = rows[-1]

    def frame():
        # the detectors first, as in a frame
        for prog, arrays in sorted(loads, key=lambda x: not isinstance(
                x[0], fp.DetectorProgram)):
            prog.load(arrays)
            prog()

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    frame()
    torch.cuda.synchronize()
    ev[0].record()
    frame()
    ev[1].record()
    torch.cuda.synchronize()
    ev_ms = ev[0].elapsed_time(ev[1])
    events, wall, top = [], 0.0, {}
    for prog, arrays in loads:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prog.load(arrays)
            prog()
            torch.cuda.synchronize()
        wall += (time.perf_counter() - t0) * 1e3
        ev_prog = _events(prof)
        events += ev_prog
        by_name = {}
        for name, us in _device_events(ev_prog):
            n, tot = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, tot + us)
        kind = "detect" if isinstance(prog, fp.DetectorProgram) else "solve"
        top[kind] = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    trace = _trace_summary(events, wall)
    fast.fast_score_pyramid.launches = launches
    progs = [(kind, p) for kind, memo in (
        ("frame", fp._FRAME_PROGRAMS), ("detector", fp._DETECT_PROGRAMS))
        for p in memo.values() if p.capture_s is not None]
    return dict(rows=out, ev_ms=ev_ms, trace=trace, frame=t, progs=progs,
                top=top)


def _gt_motions_err(m, cfg):
    """Largest difference between the map's GT object motions, parsed from
    the sequence's object rows, and the generator's own (body-frame
    motion of each box between the frames of a pair); and how many were
    compared."""
    import numpy as np

    from sdpl_slam_torch.utils.synthetic import _obj_pose

    err, n = 0.0, 0
    for f in range(1, m.n_frames):
        for j, sem in enumerate(m.sm_labels[f - 1][1:], 1):
            want = (np.linalg.inv(_obj_pose(cfg, sem - 1, f - 1))
                    @ _obj_pose(cfg, sem - 1, f))
            err = max(err, float(np.abs(m.rigid_motions_gt[f - 1][j]
                                        - want).max()))
            n += 1
    return err, n


def _window_sizes(m, settings, f0, f1):
    """The sizes of the window graph over frames [f0, f1) of map ``m`` as
    the window BA builds it: frames, motions, static points and lines,
    dynamic point and line vertices, and the chains of each dynamic
    family (``schur_ba.chains_from_links``)."""
    from sdpl_slam_torch.ops.geometry import Intrinsics
    from sdpl_slam_torch.solvers import ba_builder, schur_ba

    g, _ = ba_builder.build_graph(
        m, Intrinsics.from_config(settings), f0, f1,
        min_track_len=settings.ba_tracklet_min_len,
        motion_init_identity=False, use_lines=settings.use_lines,
        device="cpu")
    F = f1 - f0
    chains = [len(schur_ba.chains_from_links(
        n.shape[0], prev.numpy(), F, valid=valid.numpy()))
        for n, prev, valid in ((g.Xd0, g.tern_prev, g.tern_valid),
                               (g.Ld_U0, g.ltern_prev, g.ltern_valid))]
    return ("%d frames, %d motions (%d dof), %d static points, %d static "
            "lines, %d dynamic point vertices in %d chains, %d dynamic line "
            "vertices in %d chains" % (
                F, g.mot_T0.shape[0], 6 * (F + g.mot_T0.shape[0]),
                g.Xs0.shape[0], g.Ls_U0.shape[0], g.Xd0.shape[0], chains[0],
                g.Ld_U0.shape[0], chains[1]))


def kitti_phase(seq, work):
    """KITTI mode (``ChooseData: 2``) on the card: N_KITTI + 1 frames of the
    disk phase's generator written in the KITTI layout (disparity PNGs,
    KITTI object rows) with ``make_demo_sequence_torch.kitti_settings`` (the
    bench's caps, window BA 20 / 4, the global BA by KITTI's default, the
    dense-Schur step, the reference's boundary shrink), N_KITTI tracked
    through the loader, the prefetcher and ``System(settings.yaml)`` with a
    trajectory canvas, nothing injected.  Checks one FAST launch a frame,
    the window and the global BA at the last frame both by the Schur step,
    the 7 result files, ``examples/evaluate_torch.py``'s scores under the
    RPE gates, the GT object motions parsed from the KITTI rows against the
    generator's, and the canvas drawn.  Then frames 0-3 again with
    ``resident_tracking`` (its KITTI branches: the disparity conversion on
    the card, the boundary shrink in the step, the lagged GT rows) against
    the host run's poses before the BA."""
    import dataclasses

    import numpy as np
    import torch

    from sdpl_slam_torch.io.dataset import load_sequence
    from sdpl_slam_torch.io.prefetch import FramePrefetcher
    from sdpl_slam_torch.models.system import System
    from sdpl_slam_torch.ops import fast
    from sdpl_slam_torch.solvers import schur_ba
    from sdpl_slam_torch.utils import config

    mk = _example("make_demo_sequence_torch")
    root, out_dir = os.path.join(work, "kitti"), os.path.join(work, "kout")
    want = mk.kitti_settings(seq.cfg)
    t0 = time.perf_counter()
    clipped = mk.write_sequence(root, seq, N_KITTI + 1,
                                config.format_overrides(want), kitti=True)
    write_s = time.perf_counter() - t0
    got = config.load_settings(os.path.join(root, "settings.yaml"))
    if dataclasses.asdict(got) != dataclasses.asdict(want):
        raise AssertionError("KITTI settings.yaml does not load back")
    system = System(os.path.join(root, "settings.yaml"), verbose=False)
    loaded = load_sequence(root)
    if loaded.n_frames != N_KITTI:
        raise AssertionError("the loader sees %d KITTI frames"
                             % loaded.n_frames)
    traj = np.full((1000, 1000, 3), 255, np.uint8)
    rs = schur_ba.run_ba_schur
    fast.fast_score_pyramid.launches = 0
    schur_before = (rs.iterations, rs.host_syncs)
    frame_ms, first = [], None
    pf = FramePrefetcher(loaded.frame, N_KITTI, lookahead=3)
    try:
        for i, (gray, depth, flow, mask) in pf:
            if i == N_KITTI - 1:
                # the frame that runs both BAs: its peak is theirs
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pose = system.track_rgbd(
                gray, depth, flow, mask, loaded.gt_pose(i),
                loaded.gt_obj_poses(i), float(loaded.timestamps[i]),
                loaded.n_frames, traj=traj)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if not np.all(np.isfinite(pose)) or pose.shape != (4, 4):
                raise AssertionError("KITTI frame %d: pose not a finite 4x4"
                                     % i)
            if i == 3:
                first = [p.copy() for p in system.map.camera_poses]
    finally:
        pf.close()
    launches = fast.fast_score_pyramid.launches
    ba_peak = torch.cuda.max_memory_allocated()
    schur_its = rs.iterations - schur_before[0]
    rpe, n_obj = _check_run(system, N_KITTI, launches, "KITTI path",
                            RPE_T_GATE, RPE_R_GATE)
    runs = [(r["kind"], r["frame"], r["step"])
            for r in system.tracker.ba_runs]
    want_runs = [("local", N_KITTI - 1, "schur"),
                 ("global", N_KITTI - 1, "schur")]
    if runs != want_runs:
        raise AssertionError("KITTI path: batch BA runs %s, expected %s"
                             % (runs, want_runs))
    if schur_its != sum(r["iterations"] for r in system.tracker.ba_runs):
        raise AssertionError("KITTI path: the Schur counter does not "
                             "count the BAs' LM iterations")
    m = system.map
    system.save_results(out_dir)
    for name in RESULT_FILES:
        rows = np.loadtxt(os.path.join(out_dir, name), ndmin=2)
        if not len(rows) or not np.all(np.isfinite(rows)):
            raise AssertionError("KITTI result file %s: empty or not finite"
                                 % name)
    ev = _example("evaluate_torch").evaluate(out_dir)
    for name, t_err, r_err, _, n in ev["camera"]:
        if n != N_KITTI or not (t_err < RPE_T_GATE and r_err < RPE_R_GATE):
            raise AssertionError(
                "evaluate_torch: %s camera RPE %.5f m / %.4f deg over %d "
                "frames" % (name, t_err, r_err, n))
    if [r[0] for r in ev["camera"]] != ["initial", "refined"]:
        raise AssertionError("evaluate_torch read %s" % ev["camera"])
    gt_err, n_gt = _gt_motions_err(m, seq.cfg)
    if n_gt == 0 or gt_err > 1e-4:
        raise AssertionError("KITTI GT object motions: %d compared, worst "
                             "%.3g (limit 1e-4)" % (n_gt, gt_err))
    drawn = int((traj != 255).any(-1).sum())
    red = int(((traj[:, :, 0] == 255) & (traj[:, :, 1] == 0)
               & (traj[:, :, 2] == 0)).sum())
    if not (drawn and red):
        raise AssertionError("KITTI trajectory canvas: %d pixels drawn, %d "
                             "red" % (drawn, red))

    # frames 0-3 again in the resident mode, no BA
    rset = dataclasses.replace(got, resident_tracking=True,
                               run_local_ba=False, run_global_ba=False)
    resident = System(rset, verbose=False)
    fast.fast_score_pyramid.launches = 0
    for i in range(4):
        gray, depth, flow, mask = loaded.frame(i)
        resident.track_rgbd(gray, depth, flow, mask, loaded.gt_pose(i),
                            loaded.gt_obj_poses(i),
                            float(loaded.timestamps[i]), 4)
    res_launches = fast.fast_score_pyramid.launches
    if res_launches != 4:
        raise AssertionError("KITTI resident: %d FAST launches in 4 frames"
                             % res_launches)
    rm = resident.map
    if rm.rm_labels != m.rm_labels[:3] or rm.obj_stat != m.obj_stat[:3]:
        raise AssertionError("KITTI resident: label streams differ from the "
                             "host run's: %s vs %s" % (rm.rm_labels,
                                                       m.rm_labels[:3]))
    worst_t, worst_r = _pose_gates(first, rm.camera_poses,
                                   m.camera_poses_gt[:4])
    if not (worst_t < 0.01 and worst_r < 0.03):
        raise AssertionError("KITTI resident: camera poses part from the "
                             "host run's by %.4f of the motion / %.4f deg"
                             % (worst_t, worst_r))
    return dict(sizes=_window_sizes(m, got, 0, N_KITTI),
                rpe=rpe, n_obj=n_obj, launches=launches, clipped=clipped,
                write_s=write_s, frame_ms=frame_ms,
                ba_runs=system.tracker.ba_runs, ba_peak=ba_peak, ev=ev,
                gt_err=gt_err, n_gt=n_gt, drawn=drawn, red=red,
                res_launches=res_launches, worst_t=worst_t, worst_r=worst_r,
                res_labels=rm.rm_labels)


def _pose_gates(ref, got, gt):
    """North-star gates between two trajectories (camera-to-world poses):
    per-frame relative motion within 1 % of the GT motion in translation
    and 0.03 deg in rotation (from the antisymmetric part, float64).
    Returns the worst (translation share, rotation deg)."""
    import numpy as np

    motion = np.median([np.linalg.norm(gt[f][:3, 3] - gt[f - 1][:3, 3])
                        for f in range(1, len(gt))])
    worst_t = worst_r = 0.0
    for f in range(1, len(ref)):
        rel = [np.linalg.inv(np.asarray(m[f - 1], np.float64))
               @ np.asarray(m[f], np.float64) for m in (ref, got)]
        d = np.linalg.inv(rel[0]) @ rel[1]
        R = d[:3, :3]
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                            R[1, 0] - R[0, 1]])
        worst_t = max(worst_t, float(np.linalg.norm(d[:3, 3]) / motion))
        worst_r = max(worst_r, float(np.degrees(
            np.arcsin(min(np.linalg.norm(w), 1.0)))))
    return worst_t, worst_r


def _loop_run(system, loaded, frames, hints=False, sync_frame=None,
              trace_frame=None, trace_exclude=(), steady_skip=()):
    """Track ``frames`` (the first ``len(frames)`` of the loaded files)
    through ``system`` on the card, the next frames' images passed as hints
    when ``hints``.  Just before the last frame, the map is read (a reader
    drains and finishes every frame before it): its camera poses and
    motions are the run's snapshot before that frame's window BA.  Frame
    ``sync_frame`` runs under ``torch.cuda.set_sync_debug_mode("warn")``,
    frame ``trace_frame`` under torch.profiler.  The steady median leaves
    out the frames in ``steady_skip``.  Returns the measurements; FAST
    launches and LM reads are counted over this run alone."""
    import warnings

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdpl_slam_torch.ops import fast

    n = len(frames)
    tr = system.tracker

    def track(i):
        gray, depth, flow, mask = frames[i]
        nxt = [frames[k][0] if hints and k < n else None
               for k in (i + 1, i + 2)]
        return system.track_rgbd(
            gray, depth, flow, mask, loaded.gt_pose(i),
            loaded.gt_obj_poses(i), float(loaded.timestamps[i]), n,
            next_image=nxt[0], next_image2=nxt[1])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast.fast_score_pyramid.launches = 0
    tr.lm_host_syncs = 0
    call_ms, reads = [], []
    snap = motions = sync_calls = sync_sites = trace = None
    t_loop = time.perf_counter()
    for i in range(n):
        if i == n - 1:
            m = system.map
            snap = [p.copy() for p in m.camera_poses]
            motions = [[x.copy() for x in row] for row in m.rigid_motions]
        r0 = tr.lm_host_syncs
        t0 = time.perf_counter()
        if i == sync_frame:
            # the mode is switched outside the recording: switching it on
            # reports a warning of its own
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    pose = track(i)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            hits = [w for w in caught if "synchroniz" in str(w.message)]
            sync_calls = len(hits)
            sync_sites = {}
            for w in hits:
                key = "%s:%d" % (os.path.relpath(w.filename), w.lineno)
                sync_sites[key] = sync_sites.get(key, 0) + 1
        elif i == trace_frame:
            t_tr = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                pose = track(i)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t_tr) * 1e3
            events = _events(prof)
            trace = _trace_summary(events, wall,
                                   ("frame",) + tuple(trace_exclude))
            trace["launches"] = _launch_calls(events)
        else:
            pose = track(i)
        call_ms.append((time.perf_counter() - t0) * 1e3)
        reads.append(tr.lm_host_syncs - r0)
        if not np.all(np.isfinite(pose)) or pose.shape != (4, 4):
            raise AssertionError("frame %d: pose not a finite 4x4" % i)
    torch.cuda.synchronize()
    steady = [x for i, x in enumerate(call_ms)
              if 2 <= i < n - 1 and i not in (sync_frame, trace_frame)
              and i not in steady_skip]
    return dict(call_ms=call_ms, reads=reads, snap=snap, motions=motions,
                sync_calls=sync_calls, sync_sites=sync_sites, trace=trace,
                loop_s=time.perf_counter() - t_loop,
                launches=fast.fast_score_pyramid.launches,
                peak=torch.cuda.max_memory_allocated(),
                steady_ms=sorted(steady)[len(steady) // 2])


def _loop_settings(root, **over):
    """The disk phase's settings with the global BA off (the disk phase
    runs it) and ``over`` set."""
    from sdpl_slam_torch.utils import config

    settings = config.load_settings(os.path.join(root, "settings.yaml"))
    settings.run_global_ba = False
    for k, v in over.items():
        setattr(settings, k, v)
    return settings


def _check_loop(system, run, n, what, host_map, host_before_window,
                window=True):
    """Gates every device-loop phase shares: one FAST launch a frame, the
    RPE gates, the window BA at the last frame when ``window``, no more
    synchronising calls in the sync-debug frame than its LM exit reads.
    Returns (rpe, object motions, label streams equal to the host run's,
    the host run's poses before the window it is held to)."""
    rpe, n_obj = _check_run(system, n, run["launches"], what, RPE_T_GATE,
                            RPE_R_GATE, refined=window)
    runs = [(r["kind"], r["frame"]) for r in system.tracker.ba_runs]
    want = [("local", n - 1)] if window else []
    if runs != want:
        raise AssertionError("%s: batch BA runs %s, expected %s"
                             % (what, runs, want))
    if (run["sync_calls"] is not None
            and run["sync_calls"] > run["reads"][SYNC_FRAME]):
        raise AssertionError(
            "%s frame %d: %d synchronising calls for %d LM exit reads (%s)"
            % (what, SYNC_FRAME, run["sync_calls"], run["reads"][SYNC_FRAME],
               run["sync_sites"]))
    m = system.map
    labels = (m.rm_labels == host_map.rm_labels[:n - 1]
              and m.obj_stat == host_map.obj_stat[:n - 1])
    return rpe, n_obj, labels, host_before_window[:n - 1]


SYNC_FRAME, TRACE_FRAME = 10, 11   # device loops: sync debug, profiler
COMPARE_FRAMES = range(1, 9)       # device loops: the graph against the eager step
EAGER_TRACE_FRAME = 8              # resident: one eager step under the profiler


def _alternate(frame):
    """The resident phase's turns: eager first on odd frames."""
    return ("eager", "graph") if frame % 2 else ("graph", "eager")


def _eegg(frame):
    """Eager, graph, graph, eager."""
    return ("eager", "graph", "graph", "eager")


class _GraphAgainstEager:
    """Wraps ``cls.__call__`` (``ResidentProgram`` by default, or
    ``ChainedProgram``) while active: on the frames in ``COMPARE_FRAMES``
    an eager twin of the graph program (the plain version, on buffers of
    its own) runs the same frame from the same carried state and inputs.
    The runs go in the order ``turns(frame)`` gives, each from the state
    the frame started from, each timed with a synchronize on both sides
    and its peak memory read; the carried state (and, for the chained
    step, the provenance) and the output buffers must agree bit for bit.
    The comparisons' FAST launches are taken back from the counter (one
    graph run is the main path's) and the twin's LM reads are not the
    tracker's: they are comparisons, not the main path.  The first eager
    run of frame ``trace_frame`` runs under torch.profiler, and so does the
    last graph run of frame ``graph_trace_frame``."""

    def __init__(self, cls=None, turns=_alternate,
                 trace_frame=EAGER_TRACE_FRAME, graph_trace_frame=None):
        self.rows, self.eager_trace, self.capture_s = [], None, None
        self.graph_trace = None
        self._frame = 0
        self._cls, self._turns, self._trace = cls, turns, trace_frame
        self._graph_trace = graph_trace_frame

    def __enter__(self):
        from sdpl_slam_torch.models import resident as res

        self._res = res
        self._cls = cls = self._cls or res.ResidentProgram
        self._own = "__call__" in vars(cls)
        self._call = cls.__call__
        twins = {}

        def both(prog):
            if not prog.graph:
                return self._call(prog)
            self._frame += 1
            if self._frame not in COMPARE_FRAMES:
                return self._call(prog)
            return self._compare(prog, twins.setdefault(id(prog),
                                                         prog.eager_twin()))

        cls.__call__ = both
        return self

    def __exit__(self, *exc):
        if self._own:
            self._cls.__call__ = self._call
        else:
            del self._cls.__call__
        return False

    def _timed(self, fn, trace=False):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from sdpl_slam_torch.ops import fast

        launches = fast.fast_score_pyramid.launches
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if trace:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                r = fn()
                torch.cuda.synchronize()
        else:
            ev[0].record()
            r = fn()
            ev[1].record()
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        tr = _trace_summary(_events(prof), ms) if trace else None
        return (r, ms, torch.cuda.max_memory_allocated(),
                fast.fast_score_pyramid.launches - launches, tr,
                None if trace else ev[0].elapsed_time(ev[1]))

    def _compare(self, prog, twin):
        import torch

        from sdpl_slam_torch.ops import fast

        start = [t.clone() for t in prog.held()]
        for k, t in prog.inp.items():
            twin.inp[k].copy_(t)
        turns = self._turns(self._frame)
        traced = (turns.index("eager") if self._frame == self._trace
                  else len(turns) - 1 - turns[::-1].index("graph")
                  if self._frame == self._graph_trace else None)
        launches = fast.fast_score_pyramid.launches
        got = {"eager": [], "graph": []}
        for i, who in enumerate(turns):
            p = twin if who == "eager" else prog
            for dst, src in zip(p.held(), start):
                dst.copy_(src)
            got[who].append(self._timed(
                twin if who == "eager" else (lambda: self._call(prog)),
                trace=i == traced))
        fast.fast_score_pyramid.launches = launches + got["graph"][0][3]
        if self.capture_s is None:
            self.capture_s = prog.capture_s
        names = list(self._res.ResidentState._fields) + sorted(
            getattr(prog, "prov", {}))
        bad = [name for name, a, b in zip(names, twin.held(), prog.held())
               if not torch.equal(a, b)]
        if not torch.equal(twin.out, prog.out):
            bad.append("out")

        def mean(who, i):
            v = [r[i] for r in got[who] if r[i] is not None]
            return sum(v) / len(v) if v else None

        self.rows.append(dict(frame=self._frame, bad=bad,
                              eager_ms=mean("eager", 1),
                              graph_ms=mean("graph", 1),
                              eager_all=[r[1] for r in got["eager"]],
                              graph_all=[r[1] for r in got["graph"]],
                              eager_peak=got["eager"][0][2],
                              graph_peak=got["graph"][0][2],
                              eager_ev_ms=mean("eager", 5),
                              graph_ev_ms=mean("graph", 5),
                              eager_reads=got["eager"][0][0]))
        if traced is not None and turns[traced] == "eager":
            self.eager_trace = got["eager"][0][4]
        elif traced is not None:
            self.graph_trace = got["graph"][-1][4]
        return got["graph"][-1][0]


def _trace_summary(events, wall_ms, exclude=()):
    """Host calls that enqueue device work, device kernels and their ms,
    and the device's idle share over a traced call of ``wall_ms``."""
    host = [name for cuda, name, _, _ in events if not cuda]
    graphs = sum("GraphLaunch" in n for n in host)
    kernels = sum("LaunchKernel" in n for n in host)
    copies = sum(("Memcpy" in n or "Memset" in n) for n in host)
    all_dev = _device_events(events, exclude)
    dev = [(name, us) for name, us in all_dev
           if not name.startswith(("Memcpy", "Memset"))]
    busy = sum(us for _, us in dev) / 1e3
    # the device's own span: first kernel start to last kernel end
    spans = [(t0, t1) for cuda, name, t0, t1 in events
             if cuda and name not in exclude
             and not name.startswith(("Memcpy", "Memset"))]
    span = ((max(t1 for _, t1 in spans) - min(t0 for t0, _ in spans)) / 1e3
            if spans else 0.0)
    # host reads of a device value: the host blocks until the card drains
    reads = [t1 - t0 for cuda, name, t0, t1 in events
             if not cuda and name == "aten::_local_scalar_dense"]
    return dict(host_calls=graphs + kernels + copies, graph_launches=graphs,
                kernel_launches=kernels, copies=copies, kernels=len(dev),
                device_copies=len(all_dev) - len(dev),
                busy_ms=busy, wall_ms=wall_ms, span_ms=span,
                idle=max(0.0, 1.0 - busy / wall_ms),
                idle_span=max(0.0, 1.0 - busy / span) if span else 0.0,
                reads=len(reads),
                read_ms=sum(reads) / 1e3)


def resident_phase(root, loaded, host_map, host_before_window):
    """The device-resident loop on the card: the first N_RESIDENT frames of
    the disk phase's files with ``resident_tracking = True`` (KITTI scale,
    reference caps, nothing injected), the window BA at frame 19 (the global
    BA off: the disk phase runs it).  Checks one FAST launch a frame, the
    label streams of the disk phase's host run, the camera poses before
    the window within the North-star gates of that run, the RPE gates; one
    steady frame under ``torch.cuda.set_sync_debug_mode("warn")`` may call
    no synchronising operation but its LM loop-exit reads; one steady frame
    under torch.profiler for its launches."""
    from sdpl_slam_torch.models.system import System

    system = System(_loop_settings(root, resident_tracking=True),
                    verbose=False)
    frames = [loaded.frame(i) for i in range(N_RESIDENT)]
    with _GraphAgainstEager() as cmp:
        run = _loop_run(system, loaded, frames, sync_frame=SYNC_FRAME,
                        trace_frame=TRACE_FRAME,
                        trace_exclude=("resident_step",),
                        steady_skip=COMPARE_FRAMES)
    rpe, n_obj, labels, ref = _check_loop(
        system, run, N_RESIDENT, "resident path", host_map,
        host_before_window)
    if [r["frame"] for r in cmp.rows] != list(COMPARE_FRAMES):
        raise AssertionError("resident path: compared frames %s, expected %s"
                             % ([r["frame"] for r in cmp.rows],
                                list(COMPARE_FRAMES)))
    for r in cmp.rows:
        if r["bad"]:
            raise AssertionError("resident path frame %d: the graph's %s "
                                 "differ from the eager step's"
                                 % (r["frame"], r["bad"]))
    if sum(run["reads"]) or run["sync_calls"]:
        raise AssertionError("resident path: %d LM host reads (%s), %d "
                             "synchronising calls in frame %d (%s)" % (
                                 sum(run["reads"]), run["reads"],
                                 run["sync_calls"], SYNC_FRAME,
                                 run["sync_sites"]))
    if not labels:
        raise AssertionError("resident path: label streams differ from the "
                             "host run's: %s vs %s" % (
                                 system.map.rm_labels,
                                 host_map.rm_labels[:N_RESIDENT - 1]))
    worst_t, worst_r = _pose_gates(ref, run["snap"],
                                   system.map.camera_poses_gt[:len(ref)])
    if not (worst_t < 0.01 and worst_r < 0.03):
        raise AssertionError("resident path: camera poses before the window "
                             "part from the host run's by %.4f of the "
                             "motion / %.4f deg" % (worst_t, worst_r))
    return dict(run, rpe=rpe, n_obj=n_obj, worst_t=worst_t, worst_r=worst_r,
                ba_runs=system.tracker.ba_runs, n_poses=len(ref),
                cmp=cmp.rows, eager_trace=cmp.eager_trace,
                capture_s=cmp.capture_s)


def pipelined_phase(root, loaded, host_map, host_before_window,
                    host_before_motions):
    """The pipelined host path on the card: the resident phase's files and
    settings with ``pipelined_tracking = True`` and the next frames'
    images as hints (the detectors of frame t+1 run during frame t).
    Checks one FAST launch a frame, the window BA at frame 19, the label
    streams of the disk phase's synchronous run, and the camera poses and
    object motions before the window equal to that run's, bit for bit."""
    import numpy as np

    from sdpl_slam_torch.models.system import System
    from sdpl_slam_torch.utils import trace

    system = System(_loop_settings(root, pipelined_tracking=True),
                    verbose=False)
    frames = [loaded.frame(i) for i in range(N_RESIDENT)]
    with trace.enabled():          # the detectors' dispatches and waits
        run = _loop_run(system, loaded, frames, hints=True)
        spans = trace.collect()["spans"]
    rpe, n_obj, labels, ref = _check_loop(
        system, run, N_RESIDENT, "pipelined path", host_map,
        host_before_window)
    if not labels:
        raise AssertionError("pipelined path: label streams differ from "
                             "the synchronous run's")
    got_m, want_m = run["motions"], host_before_motions[:N_RESIDENT - 2]
    same = (len(run["snap"]) == len(ref) and len(got_m) == len(want_m)
            and all(np.array_equal(a, b) for a, b in zip(run["snap"], ref))
            and all(len(x) == len(y) and all(np.array_equal(a, b)
                                             for a, b in zip(x, y))
                    for x, y in zip(got_m, want_m)))
    if not same:
        raise AssertionError("pipelined path: camera poses or object motions "
                             "before the window differ from the synchronous "
                             "run's")
    if sum(run["reads"]):
        raise AssertionError("pipelined path: LM host reads %s"
                             % run["reads"])
    tr = system.tracker
    return dict(run, rpe=rpe, n_obj=n_obj, n_poses=len(ref),
                n_motions=sum(len(x) for x in got_m),
                ba_runs=tr.ba_runs,
                detect_ms=_span_ms(spans, "detector.run"),
                predispatch_ms=_span_ms(spans, "detector.dispatch",
                                        outside="detector.run"),
                det_wait_ms=_span_ms(spans, "detector.take",
                                     outside="detector.run"))


def _abs_pose_worst(ref, got):
    """tests/test_chained.py's comparison: worst per-frame camera position
    (m) and rotation (deg, trace formula) difference."""
    import numpy as np

    dt = dr = 0.0
    for a, b in zip(ref, got):
        dt = max(dt, float(np.linalg.norm(a[:3, 3] - b[:3, 3])))
        dr = max(dr, float(np.degrees(np.arccos(np.clip(
            (np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2, -1, 1)))))
    return dt, dr


# tests/test_chained.py's gates against the host path, by depth
CHAINED_HOST_GATES = {2: (0.02, 0.2), 3: (0.03, 0.3)}
N_CHAINED3 = 14   # frames of the depth-3 run (frames 9-12 steady)


def chained_phase(root, loaded, host_map, host_before_window):
    """The chained loop on the card: the resident phase's files and
    settings with ``chained_tracking = True`` at depth 2, the next two
    frames' images as hints, the window BA at frame 19; then frames 0-13
    at depth 3.  Each step is one launch of the captured chained program.
    Checks one FAST launch a frame, the RPE gates, the camera poses before
    the window within tests/test_chained.py's gates of the disk phase's
    host run, no LM host read, no synchronising call in the sync-debug
    frame; on frames 1-8 the eager twin (the plain version) from the same
    state, provenance and inputs, in turns with the graph (eager, graph,
    graph, eager), gives state, provenance and output bit for bit; the
    profiled frame as in the resident phase; the bytes of the pushed
    bundle."""
    from sdpl_slam_torch.models import chained as tch
    from sdpl_slam_torch.models.chained import bundle_size
    from sdpl_slam_torch.models.system import System
    from sdpl_slam_torch.solvers import frame_solvers as fs

    frames = [loaded.frame(i) for i in range(N_RESIDENT)]
    out = {}
    captures = tch.ChainedProgram.captures
    for depth, n in ((2, N_RESIDENT), (3, N_CHAINED3)):
        system = System(_loop_settings(root, chained_tracking=True,
                                       chained_depth=depth), verbose=False)
        tr = system.tracker
        full = depth == 2
        lm0 = fs.lm_kernel_runs()
        with _GraphAgainstEager(tch.ChainedProgram, _eegg, trace_frame=None,
                                graph_trace_frame=EAGER_TRACE_FRAME) as cmp:
            run = _loop_run(system, loaded, frames[:n], hints=True,
                            sync_frame=SYNC_FRAME,
                            trace_frame=TRACE_FRAME if full else None,
                            trace_exclude=("chained_step",),
                            steady_skip=COMPARE_FRAMES)
        what = "chained path, depth %d" % depth
        lm_runs = fs.lm_kernel_runs() - lm0    # the eager twins' included
        if lm_runs <= 0:
            raise AssertionError("%s: the joint LM's kernel never ran"
                                 % what)
        rpe, n_obj, labels, ref = _check_loop(
            system, run, n, what, host_map, host_before_window, window=full)
        dt, dr = _abs_pose_worst(ref, run["snap"])
        gt, gr = CHAINED_HOST_GATES[depth]
        if not (dt < gt and dr < gr):
            raise AssertionError("%s: camera poses part from the host run's "
                                 "by %.4f m / %.4f deg" % (what, dt, dr))
        if [r["frame"] for r in cmp.rows] != list(COMPARE_FRAMES):
            raise AssertionError("%s: compared frames %s, expected %s" % (
                what, [r["frame"] for r in cmp.rows], list(COMPARE_FRAMES)))
        for r in cmp.rows:
            if r["bad"]:
                raise AssertionError("%s frame %d: the graph's %s differ "
                                     "from the eager step's"
                                     % (what, r["frame"], r["bad"]))
        if sum(run["reads"]) or run["sync_calls"]:
            raise AssertionError("%s: %d LM host reads (%s), %d "
                                 "synchronising calls in frame %d (%s)" % (
                                     what, sum(run["reads"]), run["reads"],
                                     run["sync_calls"], SYNC_FRAME,
                                     run["sync_sites"]))
        caps = dict(NS=tr.NS, NLS=tr.NLS, NO=tr.NO, NLO=tr.NLO)
        out[depth] = dict(run, rpe=rpe, n_obj=n_obj, labels=labels, dt=dt,
                          dr=dr, ba_runs=tr.ba_runs, cmp=cmp.rows,
                          capture_s=cmp.capture_s, lm_runs=lm_runs,
                          graph_trace=cmp.graph_trace,
                          bundle_bytes=4 * bundle_size(caps, depth))
    captures = tch.ChainedProgram.captures - captures
    if captures != 2:
        raise AssertionError("chained phase: %d chained programs captured "
                             "(one a depth expected)" % captures)
    progs = [p for p in tch._CHAINED_PROGRAMS.values()
             if p.capture_s is not None]
    return out, progs


def bench_phase():
    """One pass of ``python -m sdpl_slam_torch.bench`` at its own
    configuration (54 KITTI-scale generator frames, 53 tracked in the
    chained loop, windows at 19 / 35 / 51, nothing injected), through
    ``bench.run``.  Checks the RPE gates and a headline above 0, one FAST
    launch a frame, no LM host read, the joint LM's kernel run (its own
    count), three windows, one entry per chained frame in every section
    of ``ChainedDriver.perf``; the device-exec probe
    checks itself (carried state, provenance, inputs and output put back
    bit for bit, no capture).  Returns the bench's JSON line and its
    counts."""
    import torch

    from sdpl_slam_torch import bench
    from sdpl_slam_torch.ops import fast
    from sdpl_slam_torch.solvers import frame_solvers as fs

    cfg = bench.bench_config()
    settings = bench.bench_settings(cfg)
    n = cfg.n_frames - 1
    systems = []
    before = bench.captures()
    torch.cuda.synchronize()
    fast.fast_score_pyramid.launches = 0
    line_launches = line_kernel_counts()
    lm_runs = fs.lm_kernel_runs()
    t0 = time.perf_counter()
    out = bench.run(cfg, settings, passes=1, device="cuda", systems=systems)
    launches = fast.fast_score_pyramid.launches
    line_launches = line_kernel_counts(line_launches)
    lm_runs = fs.lm_kernel_runs() - lm_runs
    seconds = time.perf_counter() - t0
    system = systems[0]
    tr = system.tracker
    perf = tr._res.perf
    lens = {k: len(v) for k, v in perf.items()}
    failures = []
    if "gate_failed" in out or not (out["rpe_t_m"] < RPE_T_GATE
                                    and out["rpe_r_deg"] < RPE_R_GATE):
        failures.append("camera RPE %s m / %s deg" % (out["rpe_t_m"],
                                                       out["rpe_r_deg"]))
    if not out["value"] > 0 or out["platform"] != "gpu":
        failures.append("value %s on %s" % (out["value"], out["platform"]))
    if launches != n:
        failures.append("%d FAST launches for %d frames" % (launches, n))
    try:
        _check_line_launches(line_launches, tr._line_cfg(), n, "bench")
    except AssertionError as e:
        failures.append(str(e))
    if tr.lm_host_syncs:
        failures.append("%d LM host reads" % tr.lm_host_syncs)
    if len(system.map.lba_times) != 3:
        failures.append("windows %s" % system.map.lba_times)
    if set(lens.values()) != {n - 1} or len(lens) != 7:
        failures.append("sections %s for %d chained frames" % (lens, n - 1))
    if not math.isfinite(out["device_exec_ms_per_frame"]):
        failures.append("no device-exec probe")
    if lm_runs <= 0:
        failures.append("the joint LM's kernel never ran")
    if failures:
        raise AssertionError("bench phase: " + "; ".join(failures))
    sections = {k: float(sorted(v)[len(v) // 2]) for k, v in perf.items()}
    return dict(out=out, n=n, launches=launches, line_launches=line_launches,
                lm_runs=lm_runs, seconds=seconds,
                ba_runs=tr.ba_runs, sections=sections,
                captures={k: v - before[k]
                          for k, v in bench.captures().items()})


def generator_phase(seq, n_frames, what, t_gate, r_gate, record=(),
                    **over):
    """``n_frames`` of the generator straight into ``System(settings)`` on
    the card, lines injected, no BA, ``over`` set on the slice's
    settings; the graph programs' loads of the frames in ``record`` are
    recorded (``_RecordLoads``).  Returns the ms of each tracked frame,
    the median of frames 1 on, FAST launches, LM host reads, the RPE and
    the recorded loads."""
    import torch

    from sdpl_slam_torch.models.system import System
    from sdpl_slam_torch.ops import fast
    from sdpl_slam_torch.utils import trace
    from sdpl_slam_torch.utils.synthetic import slice_settings

    settings = slice_settings(seq.cfg)
    for k, v in over.items():
        setattr(settings, k, v)
    system = System(settings, verbose=False, device="cuda")
    fast.fast_score_pyramid.launches = 0
    loads = _RecordLoads()
    ms = []
    with trace.enabled():              # the line detector's launches
        for t in range(n_frames):
            f = seq.frame(t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with loads.frame(t if t in record else None):
                system.track_rgbd(f.gray, f.depth, f.flow, f.mask,
                                  f.gt_pose, f.obj_rows, t * 0.1, n_frames,
                                  line_detections=f.lines)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        got = trace.collect()
    launches = fast.fast_score_pyramid.launches
    if any(d.kind == "detector.lines" for d in got["device"]):
        raise AssertionError("%s: the line detector ran with lines injected"
                             % what)
    rpe, _ = _check_run(system, n_frames, launches, what, t_gate, r_gate,
                        refined=False)
    return dict(ms=ms, median=sorted(ms[1:])[(n_frames - 1) // 2],
                launches=launches, reads=system.tracker.lm_host_syncs,
                rpe=rpe["primary"], loads=loads.rows)


def nonjoint_phase(seq, smi):
    """The non-joint path on the card (``use_joint_optimization =
    False``): N_NONJOINT generator frames, lines injected; each frame's
    solve one launch of the captured non-joint program.  Checks the RPE
    gates, no LM host read; each tracked frame's non-joint program against
    its eager twin (the plain version) on the inputs it was loaded with,
    in turns, bit for bit."""
    from sdpl_slam_torch.models import frame_program as fp

    captures = fp.FrameProgram.captures
    g = generator_phase(seq, N_NONJOINT, "non-joint path", NONJOINT_T_GATE,
                        NONJOINT_R_GATE, record=range(1, N_NONJOINT),
                        use_joint_optimization=False)
    captures = fp.FrameProgram.captures - captures
    if g["reads"]:
        raise AssertionError("non-joint path: %d LM host reads" % g["reads"])
    rows = _programs_in_turns(g["loads"], "non-joint path",
                              kinds=("solve",))["solve"]
    if [r["frame"] for r in rows] != list(range(1, N_NONJOINT)):
        raise AssertionError("non-joint path: programs compared on frames "
                             "%s" % [r["frame"] for r in rows])
    progs = [(key[4], p) for key, p in fp._FRAME_PROGRAMS.items()
             if key[0] and p.capture_s is not None]
    t_err, r_err = g["rpe"]
    print("non-joint phase: %d frames with use_joint_optimization = False "
          "(camera init, the pose-only camera LM's 130 fixed iterations, "
          "the objects' init and joint LM: one graph launch a frame), lines "
          "injected: median %.2f ms a frame, all %s; %d FAST launches, %d LM "
          "host reads, camera RPE %.6f m / %.5f deg (gates %g m / %g deg)"
          % (N_NONJOINT, g["median"], [round(x, 2) for x in g["ms"]],
             g["launches"], g["reads"], t_err, r_err, NONJOINT_T_GATE,
             NONJOINT_R_GATE))
    print("  [%s] non-joint programs captured in the phase: %d" % (
        smi, captures))
    for mb, p in progs:
        print("    %d object lanes: first call (warm-up, capture, stitch, "
              "launch) %.2f s, %d nodes by segment %s" % (
                  mb, p.capture_s, _nodes(p.node_counts[0]),
                  _nest_summary(p.node_counts)))
    gm = sorted(x for r in rows for x in r["graph"])
    em = sorted(x for r in rows for x in r["eager"])
    print("  [%s] non-joint program, graph against its eager twin on the "
          "inputs of frames %d-%d (eager, graph, graph, eager a frame; load "
          "to synchronize): outputs bit-identical; graph median %.3f ms "
          "(%.3f-%.3f), eager median %.3f ms (%.3f-%.3f), %.1fx; eager LM "
          "host reads %s" % (
              smi, rows[0]["frame"], rows[-1]["frame"], gm[len(gm) // 2],
              gm[0], gm[-1], em[len(em) // 2], em[0], em[-1],
              em[len(em) // 2] / gm[len(gm) // 2],
              [r["reads"][0] for r in rows]))
    _memory("the non-joint phase")


def window_replay(replay, loaded, t):
    """Frame ``t`` again from the copy of the system taken before it, the
    global BA off; returns the replayed window's ``ba_runs`` entry."""
    import torch

    system, frame = replay
    system.tracker.cfg.run_global_ba = False
    _track_loaded(system, loaded, t, frame)
    torch.cuda.synchronize()
    return system.tracker.ba_runs[-1]


def window_trace(replay, loaded):
    """The second window replayed under torch.profiler: kernel launches
    (runtime calls on the host), device kernels and their summed time
    inside the window's ``local_ba`` range."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = window_replay(replay, loaded, LBA_FRAMES[-1])
    events = _events(prof)
    rng = [(t0, t1) for cuda, name, t0, t1 in events
           if name == "local_ba" and not cuda]
    if len(rng) != 1:
        raise AssertionError("the trace holds %d local_ba ranges" % len(rng))
    lo, hi = rng[0]
    dev = _device_events(events, ("local_ba", "frame"), lo, hi)
    kernels = [us for n, us in dev if not n.startswith(("Memcpy", "Memset"))]
    graphs = sum(1 for cuda, name, t0, _ in events
                 if not cuda and "GraphLaunch" in name and lo <= t0 <= hi)
    return dict(launch_calls=_launch_calls(events, lo, hi),
                graph_launches=graphs,
                kernels=len(kernels), copies=len(dev) - len(kernels),
                busy_ms=sum(kernels) / 1e3, wall_ms=(hi - lo) / 1e3, run=run)


def _memory(after):
    """One line of the card's memory: this process's allocated and
    reserved bytes, the BA programs it keeps, the card's free bytes."""
    import torch

    from sdpl_slam_torch.models import chained as tch
    from sdpl_slam_torch.models import frame_program as fp
    from sdpl_slam_torch.models import resident as res
    from sdpl_slam_torch.solvers import batch_ba as bb

    free, total = torch.cuda.mem_get_info()
    print("  memory after %s: %.1f MiB allocated, %.1f MiB reserved by this "
          "process (%d BA, %d fused-frame and non-joint, %d detector, %d "
          "resident and %d chained programs kept); %.1f of %.1f GiB free on "
          "the card"
          % (after, torch.cuda.memory_allocated() / 2 ** 20,
             torch.cuda.memory_reserved() / 2 ** 20, len(bb._PROGRAMS),
             len(fp._FRAME_PROGRAMS), len(fp._DETECT_PROGRAMS),
             len(res._PROGRAMS), len(tch._CHAINED_PROGRAMS),
             free / 2 ** 30, total / 2 ** 30))


def _print_ba_runs(runs, what, smi):
    """One line a BA call (step, wall ms, LM and CG iterations, host reads,
    programs captured); fails unless each call read the device once (one
    graph launch, one read).  Returns the captures made."""
    for r in runs:
        print("  [%s] %s %s BA at frame %d by the %s step: %.1f ms, %d LM / "
              "%d CG iterations, %d host reads, %d programs captured" % (
                  smi, what, r["kind"], r["frame"], r["step"],
                  r["ms"], r["iterations"], r["cg_iterations"],
                  r["host_syncs"], r["captures"]))
    if any(r["host_syncs"] != 1 for r in runs):
        raise AssertionError("%s: a BA call read the device %s times (one "
                             "fused launch, one read expected)" % (
                                 what, [r["host_syncs"] for r in runs]))
    return sum(r["captures"] for r in runs)


MAX_DISK_CAPTURES = 3   # window 1, window 2 if its buckets rose, global BA


def _last_program():
    """The fused BA program of the last fused call."""
    from sdpl_slam_torch.solvers import batch_ba as bb

    return next(reversed(bb._PROGRAMS.values()))


def _nodes(counts):
    """The node count of a program's nested segment counts."""
    return sum(_nodes(c) if isinstance(c, list) else c for c in counts)


def _ba_run(fn, counters):
    """One BA call, synchronized on both sides: (result, wall ms, CUDA
    events ms, peak device memory above what was held before, LM / CG
    iterations and host reads it counted)."""
    import torch

    from sdpl_slam_torch.solvers import batch_ba as bb

    before = (counters.iterations, bb.run_ba.cg_iterations,
              counters.host_syncs)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return dict(out=out, ms=(time.perf_counter() - t0) * 1e3,
                ev_ms=ev[0].elapsed_time(ev[1]),
                peak=torch.cuda.max_memory_allocated() - base, base=base,
                reserved=torch.cuda.memory_reserved(),
                iterations=counters.iterations - before[0],
                cg=bb.run_ba.cg_iterations - before[1],
                reads=counters.host_syncs - before[2])


def _graph_against_eager(m, settings, K, f0, step):
    """The perturbed window's padded graph on the card through the fused
    program (``run_ba_fused`` / ``run_ba_fused_schur``) and through the
    eager plain version (``run_ba`` / ``run_ba_schur``) at the window BA's
    settings: the capture, then four calls in turns (eager, graph, graph,
    eager), each graph call's state, cost and iterations bit for bit the
    eager one's; one graph call under torch.profiler."""
    import torch

    from sdpl_slam_torch.solvers import ba_builder, schur_ba
    from sdpl_slam_torch.solvers import batch_ba as bb

    g, meta = ba_builder.build_graph(
        m, K, f0, m.n_frames, min_track_len=settings.ba_tracklet_min_len,
        motion_init_identity=False, prior_info=1e7,
        use_lines=settings.use_lines, device="cuda")
    g = ba_builder.pad_graph(g, ba_builder.bucket_sizes(g))
    F, M = int(g.cam_T0.shape[0]), int(g.mot_T0.shape[0])
    w = ba_builder._weights_from_cfg(settings)
    kw = dict(max_iters=settings.ba_local_iterations,
              gain_threshold=settings.ba_gain_threshold_partial)
    if step == "cg":
        counters = bb.run_ba
        kw["cg_iters"] = settings.ba_local_cg_iters
        runs = {"eager": lambda: bb.run_ba(g, w, **kw),
                "graph": lambda: bb.run_ba_fused(g, w, **kw)}
    else:
        counters = schur_ba.run_ba_schur
        chains = [ba_builder._padded_chains(int(n), links, F, None, None)
                  for n, links in ((g.Xd0.shape[0], meta["tern_prev"]),
                                   (g.Ld_U0.shape[0], meta["ltern_prev"]))]
        runs = {"eager": lambda: schur_ba.run_ba_schur(g, w, *chains, **kw),
                "graph": lambda: schur_ba.run_ba_fused_schur(
                    g, w, *chains, F, M, **kw)}
    captures = bb.BAProgram.captures
    first = _ba_run(runs["graph"], counters)
    prog = _last_program()
    if bb.BAProgram.captures != captures + 1:
        raise AssertionError("BA phase: the %s program was not captured "
                             "once" % step)
    rows = [dict(_ba_run(runs[who], counters), who=who)
            for who in ("eager", "graph", "graph", "eager")]
    ref = rows[0]["out"]
    bad = []
    for r in rows[1:]:
        st, cost, it = r["out"]
        same = (float(cost) == float(ref[1]) and it == ref[2]
                and r["cg"] == rows[0]["cg"]
                and all(torch.equal(a, b) for a, b in zip(st, ref[0])))
        if not same:
            bad.append(r["who"])
    graph_rows = [r for r in rows if r["who"] == "graph"]
    if any(r["reads"] != 1 for r in graph_rows + [first]):
        raise AssertionError("BA phase: a fused %s call read the device "
                             "%s times" % (step, [r["reads"] for r in
                                                  graph_rows]))
    # the trace: the same program with a budget of one LM iteration (the
    # budgets are inputs), short enough for the profiler to record every
    # kernel; CUDA events around the same call, untraced, for the busy share
    kw["max_iters"] = 1
    ev = _ba_run(runs["graph"], counters)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runs["graph"]()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = _events(prof)
    tr = _trace_summary(events, wall)
    nc = prog.node_counts
    body = nc[1]
    # node runs of one LM iteration: prologue, the LM body's segments,
    # the CG body once a CG iteration, epilogue
    runs_expected = (nc[0] + nc[-1]
                     + sum(c for c in body if not isinstance(c, list))
                     + ev["cg"] * sum(_nodes(c) for c in body
                                      if isinstance(c, list)))
    by_name = {}
    for name, us in _device_events(events):
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(rows=rows, first=first, bad=bad, prog=prog, trace=tr,
                busy=tr["busy_ms"] / ev["ev_ms"], ev=ev, top=top,
                runs_expected=runs_expected,
                sizes=(F, M, tuple(g.Xs0.shape), tuple(g.sp_cam.shape)))


BA_CHECK_ITERS = 2     # BA phase, card against CPU: float64 LM iterations


def ba_phase(cuda_map, settings, smi):
    """One window BA on a perturbed copy of the final map, by the CG step
    and by the dense-Schur step.  Per step: the padded window graph
    through the captured program against the eager plain version on the
    card, bit for bit and timed in turns (:func:`_graph_against_eager`);
    then the entry point ``partial_batch_optimization`` on the card and on
    the CPU in float64 to BA_CHECK_ITERS LM iterations at gain 1e-12 (a
    well-posed stop: float32 runs stopped by the 1e-3 gain rule part by
    rounding, ROADMAP C6): final costs within BA_COST_RTOL and window
    poses within BA_POSE_ATOL, both nearer the ground truth than the
    perturbed start; and the Schur step's final cost at most 1.05 times
    the CG step's on the card (JAX's criterion, tests/test_schur_ba.py).
    Returns, per step, its figures."""
    import copy
    import dataclasses

    import numpy as np

    from sdpl_slam_torch.ops.geometry import Intrinsics
    from sdpl_slam_torch.solvers import ba_builder, schur_ba
    from sdpl_slam_torch.solvers import batch_ba as bb
    from sdpl_slam_torch.utils import metrics

    m = copy.deepcopy(cuda_map)
    rng = np.random.default_rng(3)
    for i in range(2, m.n_frames):
        d = np.eye(4, dtype=np.float32)
        d[:3, 3] = rng.normal(0, 0.05, 3)
        m.camera_poses[i] = (m.camera_poses[i] @ d).astype(np.float32)
    f0 = m.n_frames - BA_WINDOW
    gt = m.camera_poses_gt[f0:]
    t_before, _ = metrics.camera_rpe(m.camera_poses[f0:], gt)
    K = Intrinsics.from_config(settings)
    print("BA phase: window graph %s; camera poses perturbed by 5 cm (RPE "
          "%.5f m)" % (_window_sizes(m, settings, f0, m.n_frames), t_before))
    out = {}
    for step in ("cg", "schur"):
        ge = _graph_against_eager(m, settings, K, f0, step)
        prog, tr, first = ge["prog"], ge["trace"], ge["first"]
        med = lambda who, key: sorted(  # noqa: E731
            r[key] for r in ge["rows"] if r["who"] == who)[0]
        eager = ge["rows"][0]
        print("  [%s] %s step, padded window (%d frames, %d motions, static "
              "points %s, their edges %s), window settings: LM %d / CG %d "
              "iterations; graph against eager on the card: state, cost and "
              "iterations %s; wall ms in turns (eager, graph, graph, eager) "
              "%s, CUDA events ms %s; graph %.1fx faster; host reads a call "
              "graph %d, eager %d; peak device memory above the %.1f MiB "
              "held before: graph %.1f MiB, eager %.1f MiB, the capturing "
              "call %.1f MiB" % (
                  smi, step, ge["sizes"][0], ge["sizes"][1], ge["sizes"][2],
                  ge["sizes"][3], eager["iterations"], eager["cg"],
                  "bit-identical" if not ge["bad"] else
                  "DIFFERENT in %s" % ge["bad"],
                  [round(r["ms"], 2) for r in ge["rows"]],
                  [round(r["ev_ms"], 2) for r in ge["rows"]],
                  med("eager", "ms") / med("graph", "ms"),
                  ge["rows"][1]["reads"], eager["reads"],
                  eager["base"] / 2 ** 20, med("graph", "peak") / 2 ** 20,
                  med("eager", "peak") / 2 ** 20, first["peak"] / 2 ** 20))
        ev = ge["ev"]
        print("  after the capturing call %.1f MiB reserved by this "
              "process, after the four calls in turns %.1f MiB" % (
                  first["reserved"] / 2 ** 20,
                  ge["rows"][-1]["reserved"] / 2 ** 20))
        print("  [%s] %s program: capture %.1f ms wall (warm-up %.2f s, "
              "capture %.2f s, stitch %.2f s); captured nodes %d, nested "
              "as %s (a list is a WHILE body); the program with a budget of "
              "one LM iteration (%d CG iterations): CUDA events %.2f ms; "
              "under torch.profiler %d host calls enqueueing device work (%d "
              "graph launches, %d kernel launches, %d copies), %d device "
              "kernels and %d copies (of %d node runs) summing %.2f ms of "
              "kernels, so the device is busy %.1f %% of the call" % (
                  smi, step, first["ms"], prog.warmup_s, prog.capture_s,
                  prog.stitch_s, _nodes(prog.node_counts),
                  _nest_summary(prog.node_counts), ev["cg"], ev["ev_ms"],
                  tr["host_calls"], tr["graph_launches"],
                  tr["kernel_launches"], tr["copies"], tr["kernels"],
                  tr["device_copies"], ge["runs_expected"], tr["busy_ms"],
                  100 * ge["busy"]))
        print("    top kernels by device time in that call: %s" % "; ".join(
            "%s x%d %.2f ms" % (_kernel_name(name), n, us / 1e3)
            for name, (n, us) in ge["top"]))
        if ge["bad"]:
            raise AssertionError("BA phase: the %s program differs from the "
                                 "eager plain version" % step)
        nc = prog.node_counts
        loops = [c for c in nc if isinstance(c, list)]
        nested = [c for body in loops for c in body if isinstance(c, list)]
        if len(loops) != 1 or len(nested) != (1 if step == "cg" else 0):
            raise AssertionError("BA phase: the %s program's loops are %s"
                                 % (step, _nest_summary(nc)))

        cfg = dataclasses.replace(
            settings, ba_schur=step == "schur", ba_dtype="float64",
            ba_gain_threshold_partial=1e-12,
            ba_local_iterations=BA_CHECK_ITERS)
        runs = {}
        for dev in ("cuda", "cpu"):
            mm = copy.deepcopy(m)
            counters = bb.run_ba if step == "cg" else schur_ba.run_ba_schur
            r = _ba_run(lambda: ba_builder.partial_batch_optimization(
                mm, K, BA_WINDOW, cfg, use_lines=cfg.use_lines, device=dev),
                counters)
            r.update(poses=np.stack(mm.camera_poses[f0:]),
                     rpe=metrics.camera_rpe(mm.camera_poses[f0:], gt)[0])
            runs[dev] = r
        _memory("the %s step's float64 runs" % step)
        a, b = runs["cuda"], runs["cpu"]
        pose_err = float(np.abs(a["poses"] - b["poses"]).max())
        cost_err = abs(a["out"] - b["out"]) / max(abs(b["out"]), 1e-20)
        print("  [%s] %s step, partial_batch_optimization in float64 to %d "
              "LM iterations (gain 1e-12): card cost %.12g in %d LM / %d CG "
              "iterations, %d host reads, %.1f ms (RPE %.6f m; its capture "
              "included; peak %.1f MiB allocated above the %.1f MiB held "
              "before, %.1f MiB reserved after); CPU cost %.12g in %d LM / "
              "%d CG iterations, %.1f ms (RPE %.6f m); cost rel diff %.3g "
              "(limit %g), window pose max diff %.3g (limit %g)" % (
                  smi, step, BA_CHECK_ITERS, a["out"], a["iterations"],
                  a["cg"], a["reads"], a["ms"], a["rpe"], a["peak"] / 2 ** 20,
                  a["base"] / 2 ** 20, a["reserved"] / 2 ** 20, b["out"],
                  b["iterations"], b["cg"], b["ms"], b["rpe"], cost_err,
                  BA_COST_RTOL, pose_err, BA_POSE_ATOL))
        if a["iterations"] != BA_CHECK_ITERS or a["reads"] != 1:
            raise AssertionError("BA phase: the %s step's float64 card run "
                                 "ran %d LM iterations with %d reads"
                                 % (step, a["iterations"], a["reads"]))
        if not (np.isfinite(a["out"]) and cost_err <= BA_COST_RTOL):
            raise AssertionError("BA phase: card and CPU costs of the %s "
                                 "step differ" % step)
        if pose_err > BA_POSE_ATOL:
            raise AssertionError("BA phase: card and CPU window poses of the "
                                 "%s step differ" % step)
        if not (a["rpe"] < t_before and b["rpe"] < t_before):
            raise AssertionError("BA phase: the %s step did not pull the "
                                 "perturbed poses back" % step)
        out[step] = dict(ge=ge, check=runs)
    ratio = (out["schur"]["ge"]["rows"][1]["out"][1]
             / out["cg"]["ge"]["rows"][1]["out"][1])
    print("BA phase: Schur final cost / CG final cost on the card (window "
          "settings, float32) %.6f (limit 1.05)" % ratio)
    if not ratio <= 1.05:
        raise AssertionError("BA phase: the Schur step's final cost is %.4f "
                             "times the CG step's" % ratio)
    return out


def _kernel_name(name):
    """A kernel's name, short: PyTorch's element-wise kernels by their
    functor."""
    import re

    name = re.sub(r"^void |at::native::|\(anonymous namespace\)::|"
                  r"at::cuda::|c10::", "", name)
    return name[:110]


def _nest_summary(counts):
    """A program's nested node counts, short: [segment, [body ...], ...]."""
    return json.dumps(counts).replace(" ", "")


def cpu_check(root, loaded, first, cuda_map):
    """The first frames of the same files on the CPU (plain FAST, both
    detectors on the CPU, same RANSAC draws): poses within CPU_POSE_ATOL
    of the card's (``first``, as they were before the first window),
    identical label streams."""
    import numpy as np

    from sdpl_slam_torch.models.system import System

    system = System(os.path.join(root, "settings.yaml"), verbose=False,
                    device="cpu")
    for i in range(N_CPU_CHECK):
        _track_loaded(system, loaded, i, loaded.frame(i))
    m = system.map
    err = max(float(np.abs(a - b).max())
              for a, b in zip(m.camera_poses, first))
    print("  card vs CPU, first %d frames: max camera pose difference %g"
          % (N_CPU_CHECK, err))
    if err > CPU_POSE_ATOL:
        raise AssertionError("card vs CPU camera poses differ by %g" % err)
    if m.rm_labels != cuda_map.rm_labels[:N_CPU_CHECK - 1]:
        raise AssertionError("card vs CPU label streams differ")
    return err


N_DESC = 4             # disk-phase frames of the descriptor phase
DESC_TIE = 1e-5        # two compared values this close may order either way
SHARD_LAM = 1e-4
SHARD_CG = 10
# the JAX package's 500-frame sharded test graph (tests/test_sharded_ba.py)
SHARD_BIG = dict(F=500, stat_per_frame=44, obs_per_stat=3, dyn_per_frame=28)
SHARD_WORLD = 4
# one step against the single-device step: tests/test_sharded_ba.py's
# single-step bounds (cost rtol, camera / motion / point deltas atol)
SHARD_COST_RTOL, SHARD_DELTA_ATOL = 1e-4, 5e-4


def _wall_ms(fn, reps=5):
    """Median wall ms of ``reps`` synchronised calls (after one warm-up)."""
    import torch

    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[len(walls) // 2]


def _traced_launches(fn):
    """Kernel launches of one call of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _launch_calls(_events(prof))


def descriptor_phase(loaded, tracker):
    """ORB (IC angle, rBRIEF) for the selected keypoints and LBD for the
    detected lines of the first N_DESC disk-phase frames, on the card and
    on the CPU on the same keypoints and segments; Hamming matrix and
    mutual matches of frame t against t+1 on both from the same bits."""
    import numpy as np
    import torch

    from sdpl_slam_torch.models import frame_host as fh
    from sdpl_slam_torch.models.tracking import _np_preprocess_depth
    from sdpl_slam_torch.ops import fast, lbd, lines, orb

    cfg = tracker.cfg
    fast.fast_score_pyramid.launches = 0
    frames = []
    for t in range(N_DESC):
        gray, depth_raw, flow, mask = loaded.frame(t)
        depth = _np_preprocess_depth(np.asarray(depth_raw, np.float32),
                                     cfg.choose_data, cfg.depth_map_factor,
                                     cfg.bf)
        flow = np.ascontiguousarray(flow, np.float32)
        host = torch.from_numpy(np.ascontiguousarray(gray))
        card = host.cuda()
        uv, _, va = fast.detect_keypoints(card, tracker._fast_cfg())
        uv, va = uv.cpu().numpy(), va.cpu().numpy()
        bg, _, _, _, bg_ok = fh.select_static_points(
            uv, va, depth, flow, mask, cfg.th_depth_bg, tracker.NS)
        kps = [bg[bg_ok]]
        for lab in np.unique(mask[mask > 0]):
            o, _, _, _, _, o_ok = fh.select_object_points(
                depth, flow, np.where(mask == lab, mask, 0),
                cfg.th_depth_obj, tracker.P_OBJ)
            kps.append(o[o_ok])
        kp = np.concatenate(kps).astype(np.float32)
        seg = _compact(lines.detect_lines(card, tracker._line_cfg()))
        seg = np.ascontiguousarray(seg[:tracker.NLS], np.float32)
        frames.append((host, card, kp, seg, len(kps) - 1))
    launches = fast.fast_score_pyramid.launches

    rows, orb_bits, lbd_bits = [], [], []
    for host, card, kp, seg, n_obj in frames:
        kp_c, seg_c = torch.from_numpy(kp).cuda(), torch.from_numpy(seg).cuda()
        got = {}
        for name, img, k, s in (("cuda", card, kp_c, seg_c),
                                ("cpu", host, torch.from_numpy(kp),
                                 torch.from_numpy(seg))):
            blur = orb._gaussian_blur_7x7(img)
            ang = orb.ic_angle(blur, k)
            patches = orb._gather_patches(blur, k, radius=orb.R_EXT)
            v1, v2 = orb.descriptor_samples_at_angle(patches, ang)
            got[name] = dict(
                bits=orb.brief_descriptors(img, k).cpu().numpy(),
                ang=ang.cpu().numpy(), v1=v1.cpu().numpy(),
                v2=v2.cpu().numpy(),
                lbd=lbd.lbd_descriptors(img, s).cpu().numpy(),
                lbdf=lbd.lbd_float_descriptors(img, s).cpu().numpy())
        a, b = got["cuda"], got["cpu"]
        # a bit may differ only where its two samples tie on either side
        diff = a["bits"] != b["bits"]
        tie = ((np.abs(a["v1"] - a["v2"]) < DESC_TIE)
               | (np.abs(b["v1"] - b["v2"]) < DESC_TIE))
        orb_bad = int((diff & ~tie).sum())
        c = lbd._COMBINATIONS
        lgap = np.minimum(*(np.abs(f.reshape(-1, 9, 8)[:, c[:, 0]]
                                   - f.reshape(-1, 9, 8)[:, c[:, 1]])
                            .reshape(-1, 256) for f in (a["lbdf"], b["lbdf"])))
        ldiff = a["lbd"] != b["lbd"]
        lbd_bad = int((ldiff & (lgap >= DESC_TIE)).sum())
        rows.append(dict(
            kp=len(kp), n_obj=n_obj, seg=len(seg),
            orb_diff=int(diff.sum()), orb_tie=int((diff & tie).sum()),
            orb_bad=orb_bad,
            ang_diff=int((a["ang"] != b["ang"]).sum()),
            ang_err=float(np.abs(a["ang"] - b["ang"]).max()),
            lbd_diff=int(ldiff.sum()), lbd_bad=lbd_bad,
            lbd_err=float(np.abs(a["lbdf"] - b["lbdf"]).max())))
        orb_bits.append(a["bits"])
        lbd_bits.append(a["lbd"])
        if orb_bad or lbd_bad:
            raise AssertionError(
                "descriptor phase: card and CPU bits differ away from ties: "
                "ORB %d, LBD %d" % (orb_bad, lbd_bad))

    # matching: the card's bits, frame t against t+1, on both devices
    match = []
    for t in range(N_DESC - 1):
        for kind, bits in (("orb", orb_bits), ("lbd", lbd_bits)):
            A, B = (torch.from_numpy(x) for x in (bits[t], bits[t + 1]))
            ham_c = orb.hamming_distance_matrix(A.cuda(), B.cuda()).cpu()
            idx_c, ok_c = (x.cpu() for x in orb.match_descriptors(A.cuda(),
                                                                  B.cuda()))
            ham_h = orb.hamming_distance_matrix(A, B)
            idx_h, ok_h = orb.match_descriptors(A, B)
            same = (torch.equal(ham_c, ham_h) and torch.equal(idx_c, idx_h)
                    and torch.equal(ok_c, ok_h))
            if not same:
                raise AssertionError("descriptor phase: %s Hamming matrix "
                                     "or matches differ, card vs CPU" % kind)
            match.append((t, kind, tuple(ham_c.shape), int(ok_c.sum())))

    host, card, kp, seg, _ = frames[0]
    kp_c, seg_c = torch.from_numpy(kp).cuda(), torch.from_numpy(seg).cuda()
    A = torch.from_numpy(orb_bits[0]).cuda()
    B = torch.from_numpy(orb_bits[1]).cuda()
    calls = dict(
        brief=lambda: orb.brief_descriptors(card, kp_c),
        lbd=lambda: lbd.lbd_descriptors(card, seg_c),
        match=lambda: orb.match_descriptors(A, B))
    timing = {k: (_wall_ms(f), _traced_launches(f)) for k, f in calls.items()}
    return dict(rows=rows, match=match, timing=timing, launches=launches)


def _max_abs_diff(a, b):
    """max |a - b| of two arrays or tensors (0 when empty)."""
    import numpy as np

    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()) if d.size else 0.0


def _sharded_worker(rank, world, port, out_dir):
    """A rank of the gloo world on the one card: the 500-frame graph's
    step in both layouts (rank 0 also the single-device step), each timed
    on its second call, then the partitioned LM run; rank 0 writes the
    figures."""
    import numpy as np
    import torch

    from sdpl_slam_torch.parallel import sharded_ba
    from sdpl_slam_torch.solvers import batch_ba as bb
    from sdpl_slam_torch.utils.synthetic import synth_big_graph

    dev = sharded_ba.init_world(rank, world, port, "cuda")
    try:
        mesh = sharded_ba.make_mesh(world)
        graph, n_edges = synth_big_graph(**SHARD_BIG, device=dev)
        w = bb.BAWeights()
        out = dict(n_edges=n_edges, backend=torch.distributed.get_backend())
        if rank == 0:
            d, cost, _, _ = bb.ba_gn_step(graph, bb.initial_state(graph), w,
                                          SHARD_LAM, cg_iters=SHARD_CG)
            ref = {k: v.cpu().numpy() for k, v in d.items()}
            out["single_cost"] = float(cost)
            out["cost0"] = float(bb._cost_only(graph, bb.initial_state(graph),
                                               w))
        for name, shard in (("replicated", sharded_ba.shard_graph),
                            ("partitioned",
                             sharded_ba.shard_graph_partitioned)):
            sg = shard(graph, mesh)

            def step():
                return sharded_ba.sharded_ba_step(
                    sg, sharded_ba.state_from_graph(sg), w, SHARD_LAM, mesh,
                    cg_iters=SHARD_CG)

            step()          # first use (and the other ranks' start-up)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d, cost, _, _ = step()
            torch.cuda.synchronize()
            r = dict(ms=(time.perf_counter() - t0) * 1e3, cost=float(cost),
                     bytes=sharded_ba.variable_bytes_per_device(sg))
            if rank == 0:
                r["delta_err"] = {k: _max_abs_diff(d[k].cpu(), ref[k])
                                  for k in ("cam", "mot", "xs", "xd")}
            out[name] = r
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, cost = sharded_ba.run_sharded_ba(
            graph, w, mesh, max_iters=3, cg_iters=SHARD_CG, partitioned=True)
        torch.cuda.synchronize()
        out["run"] = dict(ms=(time.perf_counter() - t0) * 1e3, cost=cost,
                          finite=bool(torch.isfinite(state.cam_T).all()))
        if rank == 0:
            with open(os.path.join(out_dir, "sharded.json"), "w") as f:
                json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


ENTRY_R_DEG, ENTRY_T_M = 0.03, 1e-4   # card vs CPU pose (North-star floor)
ENTRY_INLIER_FLIPS = 6                # of 1200: gate ties may round apart


def entry_phase():
    """``sdpl_slam_torch.entry.entry()`` (the twin of the JAX package's
    ``__graft_entry__.entry``) on the card, once warm and once timed,
    against the same entry on the CPU."""
    import torch

    from sdpl_slam_torch.entry import entry
    from sdpl_slam_torch.ops import lie

    fn, args = entry()
    if not all(a.is_cuda for a in args):
        raise AssertionError("entry(): the inputs are not on the card")
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pose, inl = fn(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    fn_c, args_c = entry("cpu")
    pose_c, inl_c = fn_c(*args_c)
    pose = pose.cpu()
    r_deg = float(lie.rotation_angle_deg(pose_c[:3, :3].T @ pose[:3, :3]))
    t_m = float((pose_c[:3, 3] - pose[:3, 3]).abs().max())
    flips = int((inl.cpu() != inl_c).sum())
    out = dict(ms=ms, r_deg=r_deg, t_m=t_m, flips=flips,
               inliers=int(inl.sum()), n=inl.numel())
    if (not torch.isfinite(pose).all() or r_deg > ENTRY_R_DEG
            or t_m > ENTRY_T_M or flips > ENTRY_INLIER_FLIPS):
        raise AssertionError("entry phase: the card's solve differs from "
                             "the CPU's: %r" % out)
    return out


def sharded_phase(cuda_map, settings):
    """(a) a world of one under NCCL on the card: the sharded step on the
    disk phase's global graph against the single-device step; (b) a gloo
    world of SHARD_WORLD ranks on the one card: both layouts' steps on the
    500-frame graph against the single-device step, and the partitioned LM
    run; (c) the dryrun twin in a gloo world of SHARD_WORLD on the card."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from sdpl_slam_torch.ops.geometry import Intrinsics
    from sdpl_slam_torch.parallel import dryrun, sharded_ba
    from sdpl_slam_torch.solvers import ba_builder
    from sdpl_slam_torch.solvers import batch_ba as bb

    out = {}
    graph, _ = ba_builder.build_graph(
        cuda_map, Intrinsics.from_config(settings), 0, cuda_map.n_frames,
        motion_init_identity=True, prior_info=1e5, device="cuda")
    w = ba_builder._weights_from_cfg(settings)
    state = bb.initial_state(graph)
    d1, c1, _, _ = bb.ba_gn_step(graph, state, w, SHARD_LAM,
                                 cg_iters=SHARD_CG)
    sharded_ba.init_world(0, 1, dryrun.free_port(), "cuda")
    try:
        mesh = sharded_ba.make_mesh(1)
        sg = sharded_ba.shard_graph(graph, mesh)
        t0 = time.perf_counter()
        d2, c2, _, _ = sharded_ba.sharded_ba_step(
            sg, sharded_ba.state_from_graph(sg), w, SHARD_LAM, mesh,
            cg_iters=SHARD_CG)
        torch.cuda.synchronize()
        out["one"] = dict(
            backend=dist.get_backend(), ms=(time.perf_counter() - t0) * 1e3,
            edges=sum(int(getattr(graph, f).sum()) for f in graph._fields
                      if f.endswith("_valid") and f[:-6] in (
                          "odo", "smo", "sp", "sl", "dp", "tern", "dl",
                          "ltern")),
            frames=cuda_map.n_frames, cost=float(c2), single=float(c1),
            delta_err={k: _max_abs_diff(d1[k].cpu(), d2[k].cpu())
                       for k in ("cam", "mot", "xs", "xd")})
    finally:
        dist.destroy_process_group()
    one = out["one"]
    if (one["backend"] != "nccl"
            or abs(one["cost"] - one["single"]) > SHARD_COST_RTOL
            * abs(one["single"])
            or max(one["delta_err"].values()) > SHARD_DELTA_ATOL):
        raise AssertionError("sharded phase: the world-1 step differs from "
                             "the single-device step: %r" % one)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(_sharded_worker, args=(SHARD_WORLD, dryrun.free_port(), tmp),
                 nprocs=SHARD_WORLD, join=True)
        with open(os.path.join(tmp, "sharded.json")) as f:
            big = json.load(f)
    big["wall_s"] = time.perf_counter() - t0
    out["big"] = big
    for name in ("replicated", "partitioned"):
        r = big[name]
        if (abs(r["cost"] - big["single_cost"]) > SHARD_COST_RTOL
                * abs(big["single_cost"])
                or max(r["delta_err"].values()) > SHARD_DELTA_ATOL):
            raise AssertionError("sharded phase: the %s step of the world of "
                                 "%d differs from the single-device step: %r"
                                 % (name, SHARD_WORLD, r))
    if big["backend"] != "gloo" or big["n_edges"] < 40_000:
        raise AssertionError("sharded phase: %s world, %d edges"
                             % (big["backend"], big["n_edges"]))
    run = big["run"]
    if not (run["finite"] and np.isfinite(run["cost"])
            and run["cost"] < big["cost0"]):
        raise AssertionError("sharded phase: the partitioned LM run did not "
                             "lower the cost: %r" % run)

    t0 = time.perf_counter()
    out["dryrun_cost"] = dryrun.dryrun_multichip(SHARD_WORLD, device="cuda")
    out["dryrun_s"] = time.perf_counter() - t0
    return out


def main():
    import numpy as np
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import sdpl_slam_torch  # noqa: F401  (fails outside a checkout)
    from sdpl_slam_torch.utils import cuda_build
    from sdpl_slam_torch.utils.synthetic import SynthSequence, kitti_config

    print("python %s, torch %s, CUDA %s" % (
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    device_name = torch.cuda.get_device_name(0)
    print("device:", device_name)
    smi = _nvidia_smi()
    print("nvidia-smi:", smi)

    t0 = time.perf_counter()
    # one nvcc a source, all started together
    with concurrent.futures.ThreadPoolExecutor(len(CUDA_SOURCES)) as ex:
        libs = list(ex.map(cuda_build.build, CUDA_SOURCES))
    print("build: %s in %.1f s" % (", ".join(os.path.relpath(x) for x in libs),
                                   time.perf_counter() - t0))
    lib = libs[0]
    ptxas = lib.with_suffix(".ptxas.txt")
    if ptxas.exists():
        for ln in ptxas.read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                print("  ptxas:", ln.strip())
    sass = _sass_sections(lib)
    ptxas = libs[2].with_suffix(".ptxas.txt")
    if ptxas.exists():
        for ln in ptxas.read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                print("  ptxas (flow_pose_lm.cu):", ln.strip())

    t0 = time.perf_counter()
    seq = SynthSequence(kitti_config(n_frames=N_FRAMES + 1))
    print("synthetic KITTI-scale sequence: %d frames in %.1f s"
          % (N_FRAMES + 1, time.perf_counter() - t0))

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

    lm = lm_phase()
    print("LM phase: the joint flow+pose LM's body, the kernel "
          "(csrc/flow_pose_lm.cu) against the plain PyTorch body on the "
          "card, one iteration from the same state (seeded lanes, rel_tol "
          "1e-4); each captured as a graph, CUDA events around each of %d "
          "launches (median), the state put back between them; then the "
          "whole loop (lm_init and its WHILE node) captured with each body, "
          "events around 20 launches" % LM_REPS)
    for r in lm:
        print("  [%s] %s: %d lanes x %d points, %d lines: an iteration %.2f "
              "us kernel (%s nodes) against %.2f us plain (%s nodes), %.1fx; "
              "the loop %.1f us kernel (%s iterations, %.2f us each, nodes "
              "%s) against %.1f us plain (%s, %.2f us each, nodes %s); bound "
              "%d B, ~%d float ops = %.4f us (by %s); max |kernel - plain| "
              "after one iteration %s" % (
                  smi, r["name"], r["B"], r["N"], r["M"], r["kernel_us"],
                  r["kernel_nodes"], r["plain_us"], r["plain_nodes"],
                  r["plain_us"] / r["kernel_us"], r["kernel_loop_us"],
                  r["kernel_iters"], r["kernel_us_a_loop_iter"],
                  _nest_summary(r["kernel_loop_nodes"]), r["plain_loop_us"],
                  r["plain_iters"], r["plain_us_a_loop_iter"],
                  _nest_summary(r["plain_loop_nodes"]), r["bytes"],
                  r["ops"], r["bound_us"], r["bound_by"],
                  {k: "%.3g" % v for k, v in r["max_err"].items()}))

    from sdpl_slam_torch.models.system import System

    line_cfg = System(_lba_settings(seq), verbose=False,
                      device="cuda").tracker._line_cfg()
    print("lines phase: detect_lines (%d octaves, cap %d, min length %.1f "
          "px) on the card vs the CPU; match = both endpoints within %.1f "
          "px; wall = median of 5 calls, launches and device ms from one "
          "call under torch.profiler" % (
              line_cfg.n_octaves, line_cfg.max_lines, line_cfg.min_length,
              LINE_MATCH_PX))
    print("  frame mode strokes card cpu  card->cpu cpu->card along recall  "
          "wall_ms launches kernels device_ms (NFA, merge) launches")
    rows, failures = lines_phase(seq, line_cfg)
    for r in rows:
        print("  %5d %4d %7d %4d %3d  %9.3f %9.3f %5.3f %6.3f  %7.2f %8d %7d "
              "%9.3f %s" % (r["frame"], r["mode"], r["strokes"], r["card"],
                            r["cpu"], r["fwd"], r["back"], r["along"],
                            r["recall"], r["wall_ms"], r["launches"],
                            r["kernels"], r["busy_ms"], r["kernel_launches"]))
    if failures:
        raise AssertionError("lines phase: " + "; ".join(failures))
    t0 = time.perf_counter()
    krows, stages = line_kernels_phase(line_cfg, seq.frame(0).gray)
    print("line kernels (csrc/line_detect.cu) against the plain chains on "
          "the card, frame 0 of each cell's size: merge == plain bit for "
          "bit, NFA counts equal; device = CUDA events around each of %d "
          "launches, median; plain = one graph of the chain, events around "
          "each of %d replays, median; %s (%.1f s)" % (
              LINE_KERNEL_REPS, LINE_PLAIN_REPS, smi,
              time.perf_counter() - t0))
    print("  kernel            shape oct  grid     ok->kept  kernel_us  "
          "plain_us  speed-up  bound_us (by)  max err")
    for r in krows:
        print("  %-17s %-5s %3d  %3dx%-4d %4d->%-4d %9.2f %9.1f %8.1fx "
              "%9.4f (%s) %.3g" % (
                  r["kernel"], r["shape"], r["octave"], r["grid"][0],
                  r["grid"][1], r["tiles_ok"], r["kept"], r["dev_us"],
                  r["plain_us"], r["plain_us"] / r["dev_us"], r["bound_us"],
                  r["bound_by"], r["max_err"]))
    for r in stages:
        print("  line stage graph, %s, %s: %d nodes, captured in %.2f s, "
              "%.3f ms a replay (events around each), %.3f ms of the host's "
              "a launch (median of %d), (NFA, merge) launches a replay %s"
              % (r["shape"], "plain chains" if r["plain"] else "kernels",
                 r["nodes"], r["capture_s"], r["dev_ms"], r["host_ms"],
                 LINE_PLAIN_REPS, r["launches"]))

    with tempfile.TemporaryDirectory() as work:
        root, out_dir = os.path.join(work, "seq"), os.path.join(work, "out")
        t0 = time.perf_counter()
        write_disk_sequence(seq, root)
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(root) for f in fs)
        print("disk phase: %d frames written in the reference layout in "
              "%.1f s (%.1f MB)" % (N_FRAMES + 1, time.perf_counter() - t0,
                                    size / 1e6))
        res = disk_phase(root, out_dir)
        loaded = res["loaded"]
        # frame 0 initialises only; the window frames carry a BA
        fm = sorted(x for t, x in enumerate(res["frame_ms"])
                    if t and t not in LBA_FRAMES)
        print("  %d frames from files through load_sequence, FramePrefetcher "
              "and System(settings.yaml), nothing injected, window BA "
              "(window 20, overlap 4) and global BA; PNG decoder: %s; %d "
              "object motions" % (N_FRAMES, res["decoder"], res["n_obj"]))
        for name, (t_err, r_err) in res["rpe"].items():
            print("  camera RPE, %s poses: %.6f m / %.5f deg (gates %g m / "
                  "%g deg)" % (name, t_err, r_err, RPE_T_GATE, RPE_R_GATE))
        print("  tracking ms per frame: median %.2f over the %d frames "
              "without a BA (frames 1-%d but %s); all %s" % (
                  fm[len(fm) // 2], len(fm), N_FRAMES - 1, LBA_FRAMES,
                  [round(x, 2) for x in res["frame_ms"]]))
        slots = np.median(np.asarray(res["system"].map.frame_times[1:]),
                          axis=0)
        print("  host-clock slots, median ms (prep+detect, solve, grouping, "
              "commit, renew): %s" % " ".join("%.2f" % x for x in slots))
        print("  line detector alone (in slot 0, between two "
              "synchronisations): median %.2f ms, first frame %.2f ms; "
              "static lines tracked per frame %s" % (
                  float(np.median(res["line_ms"][1:])), res["line_ms"][0],
                  res["n_lines"]))
        print("  loader: median %.2f ms to read a frame's four files (in "
              "the prefetch threads), median %.2f ms of the loop waiting "
              "for frames t..t+2" % (float(np.median(res["load_ms"])),
                                     float(np.median(res["wait_ms"][1:]))))
        caps = _print_ba_runs(res["ba_runs"], "disk phase", smi)
        _memory("the disk phase")
        if caps > MAX_DISK_CAPTURES:
            raise AssertionError("disk phase: %d BA programs captured "
                                 "(at most %d expected)"
                                 % (caps, MAX_DISK_CAPTURES))
        print("  FAST kernel launches %d (%d per frame), line kernels' "
              "(NFA, merge) launches %s (one an octave a frame), joint-LM "
              "kernel runs %d (its own count), LM host syncs %d, peak "
              "device memory %.1f MiB" % (
                  res["launches"], res["launches"] // N_FRAMES,
                  res["line_launches"], res["lm_runs"], res["syncs"],
                  res["peak"] / 2 ** 20))
        hp = host_programs_phase(res["loads"])
        print("  [%s] host-path programs captured in the phase: %d fused "
              "frame (one per object-lane count and line mode), %d detector"
              % (smi, *res["captures"]))
        for what, p in hp["progs"]:
            print("    %s program: first call (warm-up, capture, stitch, "
                  "launch) %.2f s, nodes by stage %s" % (
                      what, p.capture_s, _nest_summary(p.node_counts)))
        if res["captures"][0] > MAX_FRAME_CAPTURES or res["captures"][1] != 1:
            raise AssertionError("disk phase: %d fused-frame and %d "
                                 "detector programs captured (at most %d "
                                 "and 1 expected)" % (*res["captures"],
                                                      MAX_FRAME_CAPTURES))

        def spread(rows, who):
            v = sorted(x for r in rows for x in r[who])
            return v[len(v) // 2], v[0], v[-1]

        for what, name in (("solve", "fused frame"),
                           ("detect", "detector")):
            rows = hp["rows"][what]
            g, e = spread(rows, "graph"), spread(rows, "eager")
            print("  [%s] %s program, graph against its eager twin on the "
                  "inputs of disk frames %d-%d (eager, graph, graph, eager "
                  "a frame; load to synchronize): outputs bit-identical; "
                  "graph median %.3f ms (%.3f-%.3f), eager median %.3f ms "
                  "(%.3f-%.3f), %.1fx%s" % (
                      smi, name, rows[0]["frame"], rows[-1]["frame"], *g,
                      *e, e[0] / g[0],
                      "; eager LM host reads %s" % [r["reads"][0]
                                                   for r in rows]
                      if what == "solve" else ""))
        t = hp["trace"]
        print("  [%s] frame %d's two graph programs (detectors, then the "
              "solve) on one stream: %.3f ms by CUDA events; under "
              "torch.profiler (a program at a time) %d host calls "
              "enqueueing device work (%d "
              "graph launches, %d kernel launches, %d copies), %d device "
              "kernels summing %.2f ms, so the card is idle %.1f %% of the "
              "events' span" % (
                  smi, hp["frame"], hp["ev_ms"], t["host_calls"],
                  t["graph_launches"], t["kernel_launches"], t["copies"],
                  t["kernels"], t["busy_ms"],
                  100 * max(0.0, 1 - t["busy_ms"] / hp["ev_ms"])))
        for what, name in (("detect", "detector"), ("solve", "fused frame")):
            print("    top kernels by device time, %s graph: %s" % (
                name, "; ".join("%s x%d %.2f ms" % (_kernel_name(k), n,
                                                   us / 1e3)
                                for k, (n, us) in hp["top"][what])))
        warm = window_replay(res["replays"][LBA_FRAMES[0]], loaded,
                             LBA_FRAMES[0])
        first = res["ba_runs"][0]
        print("  [%s] first window replayed (its program now captured): "
              "%.1f ms, %d LM iterations, %d CG iterations, %d BA host "
              "reads, %d captures (the run's own: %.1f ms, %d / %d / %d, %d)"
              % (smi, warm["ms"], warm["iterations"], warm["cg_iterations"],
                 warm["host_syncs"], warm["captures"], first["ms"],
                 first["iterations"], first["cg_iterations"],
                 first["host_syncs"], first["captures"]))
        tr = window_trace(res["replays"][LBA_FRAMES[-1]], loaded)
        run = tr["run"]
        print("  [%s] second window replayed under torch.profiler: %.1f ms "
              "wall, %d LM / %d CG iterations, %d graph launches and %d "
              "kernel launches (runtime calls), %d device kernels summing "
              "%.2f ms (device busy %.1f %% of the traced window), %d copies"
              % (smi, tr["wall_ms"], run["iterations"], run["cg_iterations"],
                 tr["graph_launches"], tr["launch_calls"], tr["kernels"],
                 tr["busy_ms"], 100 * tr["busy_ms"] / tr["wall_ms"],
                 tr["copies"]))
        err = cpu_check(root, loaded, res["first"], res["system"].map)
        print("  reference check: the first %d frames of the same files on "
              "the CPU, max camera pose difference %g (limit %g)"
              % (N_CPU_CHECK, err, CPU_POSE_ATOL))

        t0 = time.perf_counter()
        rs = resident_phase(root, loaded, res["system"].map,
                            res["before_window"])
        print("resident phase: the first %d of those files with "
              "resident_tracking = True, nothing injected, window BA at "
              "frame %d (%.1f s); %d object motions"
              % (N_RESIDENT, N_RESIDENT - 1, time.perf_counter() - t0,
                 rs["n_obj"]))
        for name, (t_err, r_err) in rs["rpe"].items():
            print("  camera RPE, %s poses: %.6f m / %.5f deg (gates %g m / "
                  "%g deg)" % (name, t_err, r_err, RPE_T_GATE, RPE_R_GATE))
        print("  label streams identical to the disk phase's host run; "
              "camera poses of frames 0-%d against that run: worst %.5f of "
              "the per-frame motion, %.5f deg (gates 0.01, 0.03 deg)"
              % (rs["n_poses"] - 1, rs["worst_t"], rs["worst_r"]))
        print("  [%s] wall ms per track_rgbd call (the map stream lags 2 "
              "frames, so a call ends before its frame's copy lands): median "
              "%.2f over the steady frames past the compared ones; all %s "
              "(frames %d-%d also run the eager step); loop %.1f s"
              % (smi, rs["steady_ms"], [round(x, 2) for x in rs["call_ms"]],
                 COMPARE_FRAMES[0], COMPARE_FRAMES[-1], rs["loop_s"]))
        print("  LM host reads per frame %s; FAST launches %d (1 a frame, "
              "counted per graph replay); peak device memory %.1f MiB" % (
                  rs["reads"], rs["launches"], rs["peak"] / 2 ** 20))
        print("  sync debug mode over frame %d: %d synchronising calls, %d "
              "LM exit reads (%s)" % (SYNC_FRAME, rs["sync_calls"],
                                      rs["reads"][SYNC_FRAME],
                                      rs["sync_sites"]))
        cm = rs["cmp"]
        steady = [r for r in cm if r["frame"] >= 2]

        def med(key):
            v = sorted(r[key] for r in steady)
            return v[len(v) // 2]

        print("  [%s] graph against eager step on frames %d-%d, from the "
              "same state and inputs: state and output buffers bit-identical "
              "on %d of %d frames; first capture (warm-up, capture, stitch) "
              "%.2f s" % (smi, cm[0]["frame"], cm[-1]["frame"],
                          sum(not r["bad"] for r in cm), len(cm),
                          rs["capture_s"]))
        print("  [%s] wall ms a step call (synchronized), in turns on frames "
              "%d-%d: graph median %.3f, eager median %.3f (%.1fx); graph "
              "%s; eager %s; eager LM host reads %s; peak MiB during the "
              "call: graph %.1f, eager %.1f" % (
                  smi, steady[0]["frame"], steady[-1]["frame"],
                  med("graph_ms"), med("eager_ms"),
                  med("eager_ms") / med("graph_ms"),
                  [round(r["graph_ms"], 3) for r in cm],
                  [round(r["eager_ms"], 3) for r in cm],
                  [r["eager_reads"] for r in cm],
                  med("graph_peak") / 2 ** 20, med("eager_peak") / 2 ** 20))
        t, e = rs["trace"], rs["eager_trace"]
        ev = sorted(r["graph_ev_ms"] for r in steady
                    if r["graph_ev_ms"] is not None)
        ev_med = ev[len(ev) // 2]
        print("  [%s] frame %d under torch.profiler (whole track_rgbd call, "
              "graph): %d host calls enqueueing device work (%d graph "
              "launches, %d kernel launches, %d copies), %d device kernels "
              "summing %.2f ms; their span on the device %.2f ms (idle %.1f "
              "%% of it), the traced call %.2f ms wall (idle %.1f %% of it); "
              "CUDA events around a graph step on frames %d-%d: median %.3f "
              "ms, so the card is idle %.1f %% of a graph step" % (
                  smi, TRACE_FRAME, t["host_calls"], t["graph_launches"],
                  t["kernel_launches"], t["copies"], t["kernels"],
                  t["busy_ms"], t["span_ms"], 100 * t["idle_span"],
                  t["wall_ms"], 100 * t["idle"], steady[0]["frame"],
                  steady[-1]["frame"], ev_med,
                  100 * max(0.0, 1 - t["busy_ms"] / ev_med)))
        print("  [%s] frame %d's eager step under torch.profiler: %d host "
              "calls (%d kernel launches, %d copies), %d device kernels "
              "summing %.2f ms in %.2f ms wall, device idle %.1f %%; %d host "
              "reads of a device value (aten::_local_scalar_dense) blocking "
              "the host %.2f ms (graph frame: %d reads, %.2f ms)" % (
                  smi, EAGER_TRACE_FRAME, e["host_calls"],
                  e["kernel_launches"], e["copies"], e["kernels"],
                  e["busy_ms"], e["wall_ms"], 100 * e["idle"], e["reads"],
                  e["read_ms"], t["reads"], t["read_ms"]))
        _print_ba_runs(rs["ba_runs"], "resident phase", smi)
        _memory("the resident phase")

        t0 = time.perf_counter()
        pp = pipelined_phase(root, loaded, res["system"].map,
                             res["before_window"], res["before_motions"])
        print("pipelined phase: the first %d files with pipelined_tracking = "
              "True and the next frames' images as hints, window BA at frame "
              "%d (%.1f s); %d object motions" % (
                  N_RESIDENT, N_RESIDENT - 1, time.perf_counter() - t0,
                  pp["n_obj"]))
        for name, (t_err, r_err) in pp["rpe"].items():
            print("  camera RPE, %s poses: %.6f m / %.5f deg (gates %g m / "
                  "%g deg)" % (name, t_err, r_err, RPE_T_GATE, RPE_R_GATE))
        print("  label streams identical to the disk phase's synchronous "
              "run; camera poses of frames 0-%d and %d object motions before "
              "the window equal to that run's, bit for bit"
              % (pp["n_poses"] - 1, pp["n_motions"]))
        sync_fm = sorted(x for t, x in enumerate(res["frame_ms"][:N_RESIDENT])
                         if 2 <= t < N_RESIDENT - 1)
        print("  wall ms per track_rgbd call: median %.2f over frames 2-%d "
              "(the disk phase's synchronous frames 2-%d: median %.2f); all "
              "%s; loop %.1f s" % (
                  pp["steady_ms"], N_RESIDENT - 2, N_RESIDENT - 2,
                  sync_fm[len(sync_fm) // 2],
                  [round(x, 2) for x in pp["call_ms"]], pp["loop_s"]))
        med = lambda v: float(np.median(v)) if len(v) else float("nan")
        print("  detector ms on the calling thread per frame: synchronous "
              "(the disk phase, dispatch to results home) median %.2f; "
              "pipelined: predispatch of the next frame median %.2f + wait "
              "for this frame's results median %.2f = %.2f (%d "
              "predispatches, %d waits, %d synchronous runs)" % (
                  med(res["detect_ms"][1:N_RESIDENT]),
                  med(pp["predispatch_ms"]), med(pp["det_wait_ms"]),
                  med(pp["predispatch_ms"]) + med(pp["det_wait_ms"]),
                  len(pp["predispatch_ms"]), len(pp["det_wait_ms"]),
                  len(pp["detect_ms"])))
        print("  LM host reads per frame %s; FAST launches %d (1 a frame); "
              "peak device memory %.1f MiB" % (
                  pp["reads"], pp["launches"], pp["peak"] / 2 ** 20))
        _print_ba_runs(pp["ba_runs"], "pipelined phase", smi)

        t0 = time.perf_counter()
        ch, ch_progs = chained_phase(root, loaded, res["system"].map,
                                     res["before_window"])
        g0 = loaded.frame(0)
        dense = sum(np.asarray(a, dt).nbytes for a, dt in (
            (g0[1], np.float32), (g0[2], np.float32), (g0[3], np.int32)))
        print("chained phase: the first %d files with chained_tracking = "
              "True at depth 2, the next two frames' images as hints, window "
              "BA at frame %d; then frames 0-%d at depth 3 (%.1f s); each "
              "step one launch of the captured chained program" % (
                  N_RESIDENT, N_RESIDENT - 1, N_CHAINED3 - 1,
                  time.perf_counter() - t0))
        for p in ch_progs:
            print("  [%s] chained program at depth %d: first call (warm-up, "
                  "capture, stitch, launch) %.2f s, %d nodes by segment %s"
                  % (smi, 3 if p.prov else 2, p.capture_s,
                     _nodes(p.node_counts), _nest_summary(p.node_counts)))
        for depth, c in sorted(ch.items()):
            gt, gr = CHAINED_HOST_GATES[depth]
            print("  depth %d: %d object motions; camera RPE %s; camera poses "
                  "against the disk phase's host run: worst %.5f m / %.5f deg "
                  "(gates %g m / %g deg); label streams %s the host run's; "
                  "FAST launches %d (1 a frame); joint-LM kernel runs %d "
                  "(its own count: every LM iteration of the graphs and of "
                  "the eager twins)" % (
                      depth, c["n_obj"], ", ".join(
                          "%s %.6f m / %.5f deg" % (k, *v)
                          for k, v in c["rpe"].items()),
                      c["dt"], c["dr"], gt, gr,
                      "equal to" if c["labels"] else "differ from",
                      c["launches"], c["lm_runs"]))
            print("    [%s] wall ms per track_rgbd call: median %.2f over the "
                  "steady frames past the compared ones (resident phase: "
                  "%.2f); all %s; loop %.1f s; LM reads per frame %s; sync "
                  "debug mode over frame %d: %d synchronising calls; peak "
                  "device memory %.1f MiB" % (
                      smi, c["steady_ms"], rs["steady_ms"],
                      [round(x, 2) for x in c["call_ms"]], c["loop_s"],
                      c["reads"], SYNC_FRAME, c["sync_calls"],
                      c["peak"] / 2 ** 20))
            cm = c["cmp"]
            gm = sorted(x for r in cm for x in r["graph_all"])
            em = sorted(x for r in cm for x in r["eager_all"])
            print("    [%s] graph against eager step on frames %d-%d, from "
                  "the same state, provenance and inputs (eager, graph, "
                  "graph, eager a frame): state, provenance and output "
                  "bit-identical on %d of %d frames; wall ms a step call "
                  "(synchronized): graph median %.3f (%.3f-%.3f), eager "
                  "median %.3f (%.3f-%.3f), %.1fx; eager LM host reads %s" % (
                      smi, cm[0]["frame"], cm[-1]["frame"],
                      sum(not r["bad"] for r in cm), len(cm),
                      gm[len(gm) // 2], gm[0], gm[-1], em[len(em) // 2],
                      em[0], em[-1], em[len(em) // 2] / gm[len(gm) // 2],
                      [r["eager_reads"] for r in cm]))
            print("    bytes pushed a frame: the bundle %d B, against the "
                  "resident mode's dense depth, flow and mask planes %d B "
                  "(%.2fx); the grey image %d B in both" % (
                      c["bundle_bytes"], dense, dense / c["bundle_bytes"],
                      np.asarray(g0[0]).nbytes))
        for depth, c in sorted(ch.items()):
            t = c["graph_trace"]
            ev = sorted(r["graph_ev_ms"] for r in c["cmp"]
                        if r["frame"] >= 2 and r["graph_ev_ms"] is not None)
            # the traced frame's other graph run: the same LM iterations
            ev_own = [r["graph_ev_ms"] for r in c["cmp"]
                      if r["frame"] == EAGER_TRACE_FRAME][0]
            print("  [%s] depth %d, frame %d's step graph: under "
                  "torch.profiler %d host calls enqueueing device work (%d "
                  "graph launches, %d kernel launches, %d copies), %d device "
                  "kernels summing %.2f ms; CUDA events around its other "
                  "graph run %.3f ms, so the card is idle %.1f %% of a graph "
                  "step (CUDA events around a graph step on frames 2-%d: "
                  "median %.3f ms)" % (
                      smi, depth, EAGER_TRACE_FRAME, t["host_calls"],
                      t["graph_launches"], t["kernel_launches"], t["copies"],
                      t["kernels"], t["busy_ms"], ev_own,
                      100 * max(0.0, 1 - t["busy_ms"] / ev_own),
                      COMPARE_FRAMES[-1], ev[len(ev) // 2]))
        c = ch[2]
        t = c["trace"]
        print("  [%s] depth 2, frame %d under torch.profiler (the whole "
              "track_rgbd call: the step graph, and the detector graphs of "
              "the frame two ahead): %d host calls enqueueing device work "
              "(%d graph launches, %d kernel launches, %d copies), %d device "
              "kernels summing %.2f ms (resident, whose step holds the "
              "detectors: %d host calls, %d kernels, %.2f ms); peak %.1f MiB "
              "(resident %.1f MiB)" % (
                  smi, TRACE_FRAME, t["host_calls"], t["graph_launches"],
                  t["kernel_launches"], t["copies"], t["kernels"],
                  t["busy_ms"], rs["trace"]["host_calls"],
                  rs["trace"]["kernels"], rs["trace"]["busy_ms"],
                  c["peak"] / 2 ** 20, rs["peak"] / 2 ** 20))
        _print_ba_runs(c["ba_runs"], "chained phase, depth 2", smi)
        _memory("the chained phase")

        bp = bench_phase()
        print("bench phase: python -m sdpl_slam_torch.bench's run for one "
              "pass (%d KITTI-scale frames in the chained loop, windows at "
              "19 / 35 / 51, nothing injected) in %.1f s; FAST launches %d (1 "
              "a frame), line kernels' (NFA, merge) launches %s (one an "
              "octave a frame), joint-LM kernel runs %d (its own count, the "
              "probe's included), 0 LM host reads, captures %s; the "
              "device-exec probe put the chained program back bit for bit "
              "and captured nothing" % (
                  bp["n"], bp["seconds"], bp["launches"],
                  bp["line_launches"], bp["lm_runs"], bp["captures"]))
        print("  [%s] section medians over %d chained frames (ms): %s" % (
            smi, bp["n"] - 1, ", ".join("%s %.3f" % kv
                                        for kv in bp["sections"].items())))
        _print_ba_runs(bp["ba_runs"], "bench phase", smi)
        print("  bench line: " + json.dumps(bp["out"]))
        _memory("the bench phase")

        t0 = time.perf_counter()
        kt = kitti_phase(seq, work)
        fm = sorted(kt["frame_ms"][1:-1])
        print("KITTI phase: %d frames written in the KITTI layout (disparity "
              "PNGs at factor 256, %d pixels clipped to 16 bits; KITTI object "
              "rows) in %.1f s; %d tracked through load_sequence, "
              "FramePrefetcher and System(settings.yaml) with ChooseData 2, "
              "ba_schur 1, the reference's boundary shrink and a trajectory "
              "canvas, nothing injected (%.1f s); %d object motions" % (
                  N_KITTI + 1, kt["clipped"], kt["write_s"], N_KITTI,
                  time.perf_counter() - t0, kt["n_obj"]))
        for name, (t_err, r_err) in kt["rpe"].items():
            print("  camera RPE, %s poses: %.6f m / %.5f deg (gates %g m / "
                  "%g deg)" % (name, t_err, r_err, RPE_T_GATE, RPE_R_GATE))
        for name, t_err, r_err, ate, n in kt["ev"]["camera"]:
            print("  evaluate_torch.py on the result files: camera %s RPE "
                  "%.6f m / %.5f deg, ATE %.6f m (%d frames)"
                  % (name, t_err, r_err, ate, n))
        for name, (t_err, r_err, per) in kt["ev"]["objects"].items():
            print("  evaluate_torch.py: objects %s motion error %.6f m / "
                  "%.5f deg over %d observations" % (
                      name, t_err, r_err, sum(v[2] for v in per.values())))
        print("  tracking ms per frame: median %.2f over frames 1-%d; FAST "
              "launches %d (1 a frame)" % (
                  fm[len(fm) // 2], N_KITTI - 2, kt["launches"]))
        print("  window graph at frame %d: %s" % (N_KITTI - 1, kt["sizes"]))
        _print_ba_runs(kt["ba_runs"], "KITTI phase", smi)
        _memory("the KITTI phase")
        print("  peak device memory over frame %d (its window and global "
              "Schur BAs included): %.1f MiB" % (N_KITTI - 1,
                                                 kt["ba_peak"] / 2 ** 20))
        print("  GT object motions parsed from the KITTI rows against the "
              "generator's: worst %.3g over %d (limit 1e-4); trajectory "
              "canvas: %d pixels drawn, %d red" % (
                  kt["gt_err"], kt["n_gt"], kt["drawn"], kt["red"]))
        print("  frames 0-3 again with resident_tracking: %d FAST launches, "
              "labels %s identical to the host run's, camera poses worst "
              "%.5f of the per-frame motion, %.5f deg (gates 0.01, 0.03 deg)"
              % (kt["res_launches"], kt["res_labels"], kt["worst_t"],
                 kt["worst_r"]))

        t0 = time.perf_counter()
        ds = descriptor_phase(loaded, res["system"].tracker)
        print("descriptor phase: ORB (IC angle, rBRIEF) for the selected "
              "keypoints and LBD for the detected lines (cap %d) of the "
              "first %d disk-phase frames, on the card and on the CPU on "
              "the same keypoints and segments (%.1f s); FAST launches %d "
              "(1 a frame)" % (res["system"].tracker.NLS, N_DESC,
                               time.perf_counter() - t0, ds["launches"]))
        print("  frame keypoints objects segments  ORB: bits differ (at a "
              "sample tie / elsewhere), angles differ, max angle diff  LBD: "
              "bits differ (elsewhere), max float diff")
        for t, r in enumerate(ds["rows"]):
            print("  %5d %9d %7d %8d  %d (%d / %d), %d, %.3g  %d (%d), "
                  "%.3g" % (t, r["kp"], r["n_obj"], r["seg"], r["orb_diff"],
                            r["orb_tie"], r["orb_bad"],
                            r["ang_diff"], r["ang_err"], r["lbd_diff"],
                            r["lbd_bad"], r["lbd_err"]))
        print("  Hamming matrix and mutual matches (max distance 64), frame "
              "t against t+1 from the card's bits: identical on the card and "
              "the CPU; %s" % ", ".join(
                  "%d %s %dx%d %d matched" % (t, kind, sh[0], sh[1], n)
                  for t, kind, sh, n in ds["match"]))
        for name, (ms, n) in ds["timing"].items():
            print("  %s on the card, frame 0: %.2f ms wall a call (median of "
                  "5), %d kernel launches" % (name, ms, n))
        if ds["launches"] != N_DESC:
            raise AssertionError("descriptor phase: %d FAST launches for %d "
                                 "frames" % (ds["launches"], N_DESC))

    g = generator_phase(seq, N_INJECTED, "injected path", RPE_T_GATE,
                        RPE_R_GATE)
    print("injected phase: %d generator frames, lines injected, no BA: "
          "median %.2f ms a frame, %d FAST launches, camera RPE %.6f m / "
          "%.5f deg" % (N_INJECTED, g["median"], g["launches"], *g["rpe"]))
    nonjoint_phase(seq, smi)
    ba_phase(res["system"].map, res["system"].settings, smi)
    _memory("the BA phase")
    # the sharded phase starts processes of its own on the card: give back
    # what the captured BA programs and the allocator's cache hold
    from sdpl_slam_torch.solvers import batch_ba as bb

    bb._PROGRAMS.clear()
    torch.cuda.empty_cache()
    _memory("dropping the BA programs and emptying the cache")

    en = entry_phase()
    print("entry phase: sdpl_slam_torch.entry.entry() (the joint flow+pose "
          "camera LM, 1200 points, 400 lines) on the card: [%s] %.2f ms "
          "wall; %d of %d point inliers; against the CPU: pose %.2g deg / "
          "%.2g m (gates %g deg / %g m), %d inlier flags differ (at most %d)"
          % (smi, en["ms"], en["inliers"], en["n"], en["r_deg"], en["t_m"],
             ENTRY_R_DEG, ENTRY_T_M, en["flips"], ENTRY_INLIER_FLIPS))

    t0 = time.perf_counter()
    sh = sharded_phase(res["system"].map, res["system"].settings)
    one, big = sh["one"], sh["big"]
    print("sharded BA phase (%.1f s): one damped GN step, %d CG iterations, "
          "lambda %g; cost rtol %g and camera / motion / point deltas atol "
          "%g against batch_ba.ba_gn_step on one device" % (
              time.perf_counter() - t0, SHARD_CG, SHARD_LAM, SHARD_COST_RTOL,
              SHARD_DELTA_ATOL))
    print("  world of 1 (%s) on the disk phase's global graph (%d frames, "
          "%d edges): cost %.9g against %.9g, max delta diff %s; %.1f ms"
          % (one["backend"], one["frames"], one["edges"], one["cost"],
             one["single"], {k: "%.3g" % v for k, v in
                             one["delta_err"].items()}, one["ms"]))
    print("  world of %d (%s, %d ranks on the one card) on synth_big_graph "
          "F=%d (%d edges); single-device cost %.9g:" % (
              SHARD_WORLD, big["backend"], SHARD_WORLD, SHARD_BIG["F"],
              big["n_edges"], big["single_cost"]))
    for name in ("replicated", "partitioned"):
        r = big[name]
        print("    %s: cost %.9g, max delta diff %s, %.1f ms a step, "
              "variable bytes a rank %d" % (
                  name, r["cost"], {k: "%.3g" % v for k, v in
                                    r["delta_err"].items()}, r["ms"],
                  r["bytes"]))
    run = big["run"]
    print("    run_sharded_ba(partitioned=True), 3 LM iterations: cost %.9g "
          "-> %.9g in %.1f ms; variable bytes a rank %d partitioned against "
          "%d replicated (%.2fx); the world's call %.1f s" % (
              big["cost0"], run["cost"], run["ms"],
              big["partitioned"]["bytes"], big["replicated"]["bytes"],
              big["replicated"]["bytes"] / big["partitioned"]["bytes"],
              big["wall_s"]))
    print("  dryrun twin (above): %.1f s, cost %.6g" % (sh["dryrun_s"],
                                                       sh["dryrun_cost"]))
    print("total: %.1f s" % (time.perf_counter() - t_start))

    print(json.dumps({"kernels": [{
        "name": "fast_score_pyramid",
        "route": "cuda",
        "source": "sdpl_slam_torch/csrc/fast_score.cu",
        "replaces": "sdpl_slam_tpu/ops/fast.py:119",
        "launches": res["launches"] + bp["launches"],
        "max_abs_err": k["max_err"],
        "ms": k["dev_ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,            # no PyTorch call computes FAST-9/16
    }] + [{
        "name": "flow_pose_lm_iteration.%s" % r["name"],
        "route": "cuda",
        "source": "sdpl_slam_torch/csrc/flow_pose_lm.cu",
        "replaces": None,              # XLA in the JAX package
        # the kernel's own count of its runs (one an LM iteration) over
        # the main path's runs that FAST's entry counts: the disk path and
        # the bench phase (its device-exec probe's 10 step replays in it)
        "launches": res["lm_runs"] + bp["lm_runs"],
        "max_abs_err": r["max_err"]["T"],
        "ms": r["kernel_us"] / 1e3,
        "plain_ms": r["plain_us"] / 1e3,
        "bound_ms": r["bound_us"] / 1e3,
        "bound_by": r["bound_by"],
        "library_ms": None,            # no PyTorch call computes it
    } for r in lm] + [{
        "name": r["kernel"],
        "route": "cuda",
        "source": "sdpl_slam_torch/csrc/line_detect.cu",
        "replaces": None,              # XLA in the JAX package
        # the launches of the main path's runs that FAST's entry counts:
        # the disk path and the bench phase, a detector replay counting
        # its captured launches
        "launches": (res["line_launches"][r["kernel"] == "merge_rounds"]
                     + bp["line_launches"][r["kernel"] == "merge_rounds"]),
        "max_abs_err": r["max_err"],
        "ms": r["dev_us"] / 1e3,
        "plain_ms": r["plain_us"] / 1e3,
        "bound_ms": r["bound_us"] / 1e3,
        "bound_by": r["bound_by"],
        "library_ms": None,            # no PyTorch call computes it
    } for r in krows if r["shape"] == "kitti" and r["octave"] == 0]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
