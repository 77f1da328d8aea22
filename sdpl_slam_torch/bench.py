"""Benchmark: KITTI-scale tracking FPS on one CUDA card (+ window BA and
device use), the port of the JAX package's ``bench.py``.

    python -m sdpl_slam_torch.bench            # on the card
    SDPL_BENCH_ALLOW_CPU=1 python -m sdpl_slam_torch.bench   # CPU smoke run
    python -m sdpl_slam_torch.bench --cpu      # the same

Prints ONE JSON line on standard output, on every exit path (everything
else goes to standard error), with ``bench.py``'s keys and meanings and
one more, ``device``: the card's name and power limit as ``nvidia-smi``
gives them.

Measured configuration, as ``bench.py``'s: the chained loop
(``models/chained.py``) over the generator's KITTI-scale sequence
(1242x375, KITTI intrinsics, 2 moving objects, 0.2 px flow noise, 54
frames), the reference caps (1200 background points, 800 per object, 400
lines), FAST and the line detector in the loop, nothing injected, the
window BA at the reference cadence (window 20, overlap 4: windows at
frames 19, 35 and 51).  Three passes, each a new ``System``: pass 0 pays
every capture, passes 1-2 replay the memoized programs.  The headline is
the median pass's median frame over the frames that hold no window (a
chained driver runs frame f's window at the start of f + 1), zeroed
unless the camera RPE holds its gates (t < 5 mm, r < 0.1 deg).

The keys on the card:

- ``value``: tracking frames per second (1000 / ``median_frame_ms``);
  ``vs_baseline`` over the reference C++'s CPU estimate of 2.0 FPS;
- ``median_frame_ms``, ``pass_median_ms``: host wall ms around each
  ``track_rgbd`` call (no synchronisation added: the chained loop's lag
  drain is its back-pressure), the median pass's and each pass's;
- ``device_exec_ms_per_frame``: CUDA events around 10 back-to-back replays
  of the last frame's bundle through the captured chained step, over 10;
  ``device_busy_frac`` that over ``median_frame_ms``;
- ``stage_ms``: the median of ``Map.frame_times``' 5 slots past frame 4
  (slot 0 host prep, slot 1 dispatch);
- ``host_ms``: the sum of the chained driver's section medians but
  ``drain``; ``transport_wait_ms``: the ``drain`` section's median, where
  the host waits for the card's output of ``depth - 1`` frames before;
- ``lba_warm_window_ms``: the fastest window of the median pass;
  ``lba_first_window_ms``: pass 0's first window, its captures included;
  ``tracking_plus_lba_fps``: frames per second from the second window's
  frame on, the third window included;
- ``gate_failed``: why the headline is 0; ``cpu_smoke_fps``: the FPS of a
  CPU run (whose ``value`` is 0: never a headline).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

BASELINE_REF_FPS = 2.0     # the reference C++ on a CPU (BASELINE.md)
N_PASSES = 3
WARMUP = 4                 # frames left out of each pass's times
PROBE_REPS = 10            # back-to-back replays in the device-exec probe
METRIC = "kitti_scale_tracking_fps_per_chip"
_T0 = time.time()


def _progress(msg):
    print("[bench %6.1fs] %s" % (time.time() - _T0, msg), file=sys.stderr,
          flush=True)


def _fail(error, **extra) -> dict:
    out = {"metric": METRIC, "value": 0.0, "unit": "frames/s",
           "vs_baseline": 0.0, "error": str(error)[:2000]}
    out.update(extra)
    return out


def _card_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "%s, power limit not read" % torch.cuda.get_device_name(0)


def _settings(cfg):
    """``bench.py``'s settings over the port's ``synth_settings``."""
    from .utils.synthetic import synth_settings

    settings = synth_settings(cfg)
    settings.fx, settings.fy = cfg.fx, cfg.fy
    settings.cx, settings.cy = cfg.cx, cfg.cy
    settings.width, settings.height = cfg.width, cfg.height
    settings.max_track_point_bg = 1200
    settings.max_track_point_obj = 800
    settings.max_static_lines = 400
    settings.max_objects = 8
    settings.th_depth_bg = 40.0
    settings.th_depth_obj = 25.0
    settings.min_object_points = 150
    settings.use_sample_fea = 0        # FAST detector in the loop
    settings.chained_tracking = True
    return settings


def _run_tracking(seq, settings, n, warmup=WARMUP, device="cuda"):
    """Frames 0..n-1 through a new ``System``, the next two frames' images
    as hints; the wall seconds of each call past ``warmup``."""
    from .models.system import System

    system = System(settings, verbose=False, device=device)
    times = []
    for t in range(n):
        f = seq.frame(t)
        nxt = seq.frame(t + 1) if t + 1 < n else None
        nxt2 = seq.frame(t + 2) if t + 2 < n else None
        t0 = time.perf_counter()
        system.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            t * 0.1, n + 1,              # stop frame beyond n: driver stays
            next_image=None if nxt is None else nxt.gray,
            next_image2=None if nxt2 is None else nxt2.gray)
        dt = time.perf_counter() - t0
        if t >= warmup:
            times.append(dt)
        if t % 10 == 0:
            _progress("frame %d (%.2fs)" % (t, dt))
    return system, times


def _device_exec_probe(system, m=PROBE_REPS):
    """Device ms of one chained step: the last frame's bundle replayed ``m``
    times back to back through the chained program (empty GT tables, the
    RANSAC draws of frames 0..m-1), over ``m``; CUDA events on the card,
    the host clock on the CPU.  The program's carried state, provenance,
    inputs and output are put back after, and checked; no program is
    captured.  NaN when the tracker has no chained driver."""
    from .models.chained import ChainedProgram, _numel, chained_aux_spec
    from .models.resident import _unpack_aux, gt_sem_table, n_hypotheses

    drv = getattr(system.tracker, "_res", None)
    if drv is None or getattr(drv, "last_bundle", None) is None:
        return float("nan")
    drv.drain_all()
    tr = drv.tr
    spec = chained_aux_spec(drv.caps, *n_hypotheses(tr.cfg))
    auxes = []
    for i in range(m):
        aux = np.zeros(sum(_numel(shape) for _, shape in spec), np.float32)
        a = _unpack_aux(aux, spec)
        drv._labels_and_draws(a, [], i)
        a["gt_prev"][:] = gt_sem_table([])
        auxes.append(aux)
    captures = ChainedProgram.captures
    prog = drv._step_program({k: (a.shape, torch.float32) for k, a in
                              dict(bundle=drv.last_bundle, aux=auxes[0])
                              .items()})
    kept = [prog.held(), [prog.out], list(prog.inp.values())]
    keep = [[t.clone() for t in ts] for ts in kept]

    def put_back():
        for ts, ks in zip(kept, keep):
            for t, k in zip(ts, ks):
                t.copy_(k)

    def replay(i):
        prog.load(dict(bundle=drv.last_bundle, aux=auxes[i]))
        prog()

    replay(0)                             # warm
    put_back()
    if prog.device.type == "cuda":
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for i in range(m):
            replay(i)
        end.record()
        end.synchronize()
        total_ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        for i in range(m):
            replay(i)
        total_ms = (time.perf_counter() - t0) * 1e3
    put_back()
    if not all(torch.equal(t, k) for ts, ks in zip(kept, keep)
               for t, k in zip(ts, ks)):
        raise AssertionError("device-exec probe: the chained program's "
                             "buffers were not put back")
    if ChainedProgram.captures != captures:
        raise AssertionError("device-exec probe: %d chained programs "
                             "captured" % (ChainedProgram.captures - captures))
    return total_ms / m


def _non_lba_times(times, settings, n, warmup):
    stride = settings.window_size - settings.overlap_size
    # the chained driver runs frame f's window at the START of frame f + 1
    # (the refined pose feeds that frame's solve), so the wall-time spike
    # lands on trigger + 1
    lba_frames = {
        f + 1 for f in range(n)
        if f >= settings.window_size - 1
        and (f - settings.overlap_size + 1) % stride == 0
    }
    return [dt for t, dt in enumerate(times, start=warmup)
            if t not in lba_frames]


@contextlib.contextmanager
def _chained_perf():
    """``SDPL_CHAINED_PERF`` set inside the block: chained drivers made
    there time their sections (perf_counter only, no synchronisation)."""
    prev = os.environ.get("SDPL_CHAINED_PERF")
    os.environ["SDPL_CHAINED_PERF"] = "1"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["SDPL_CHAINED_PERF"]
        else:
            os.environ["SDPL_CHAINED_PERF"] = prev


def captures() -> dict:
    """Programs captured in this process so far, by class."""
    from .models.chained import ChainedProgram
    from .models.frame_program import DetectorProgram, FrameProgram
    from .solvers.batch_ba import BAProgram

    return {c.__name__: c.captures for c in (
        ChainedProgram, FrameProgram, DetectorProgram, BAProgram)}


def run(cfg, settings, passes=N_PASSES, device="cuda", warmup=WARMUP,
        systems=None) -> dict:
    """``passes`` tracking passes of ``SynthSequence(cfg)`` (all frames but
    the last) with ``settings``, the device-exec probe on the median pass,
    and the output dict.  ``systems``, a list, receives each pass's
    ``System``."""
    from .utils import metrics
    from .utils.synthetic import SynthSequence

    dev = torch.device(device)
    seq = SynthSequence(cfg)
    n = seq.n_frames - 1

    done = []                 # (median_ms, times, system)
    for p in range(passes):
        _progress("tracking pass %d (%d frames)" % (p, n))
        before = captures()
        with _chained_perf():
            system, times = _run_tracking(seq, settings, n, warmup, dev)
        system.tracker.flush()        # drain pending device work
        med_ms = float(np.median(_non_lba_times(times, settings, n,
                                                warmup))) * 1e3
        _progress("pass %d done: median %.1f ms; lba windows: %s; "
                  "captures: %s" % (
                      p, med_ms, [round(x) for x in system.map.lba_times],
                      {k: v - before[k] for k, v in captures().items()}))
        done.append((med_ms, times, system))
        if systems is not None:
            systems.append(system)

    # the median pass is the headline (steady state, not best-of)
    order = sorted(range(len(done)), key=lambda i: done[i][0])
    med_ms, times, system = done[order[len(order) // 2]]
    fps = 1e3 / med_ms

    t_err, r_err = metrics.camera_rpe(system.map.camera_poses,
                                      system.map.camera_poses_gt)
    gate_failed = []
    if not t_err < 0.005:
        gate_failed.append("rpe_t_m=%.5f (gate < 0.005)" % t_err)
    if not r_err < 0.1:
        gate_failed.append("rpe_r_deg=%.5f (gate < 0.1)" % r_err)
    headline = fps if not gate_failed and dev.type == "cuda" else 0.0

    _progress("exec probe")
    exec_ms = _device_exec_probe(system)
    _progress("probe done")
    busy = exec_ms / med_ms if np.isfinite(exec_ms) else float("nan")
    # the 5 slots of the reference's timing contract, past the first frames
    stages = np.asarray(system.map.frame_times, np.float64)
    stage_ms = ([round(float(x), 2) for x in np.median(stages[4:], axis=0)]
                if len(stages) > 6 else [])

    # the chained driver's sections: host work against the wait for the card
    host_ms = wait_ms = None
    perf = getattr(getattr(system.tracker, "_res", None), "perf", None)
    if perf:
        med = {k: float(np.median(np.asarray(v[4:] if len(v) > 8 else v)))
               for k, v in perf.items() if v}
        _progress("section medians (ms): %s" % ", ".join(
            "%s %.3f" % kv for kv in med.items()))
        wait_ms = med.pop("drain", 0.0)
        host_ms = sum(med.values())

    out = {
        "metric": METRIC,
        "value": round(headline, 3),
        "unit": "frames/s",
        "vs_baseline": round(headline / BASELINE_REF_FPS, 3),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "median_frame_ms": round(med_ms, 1),
        "pass_median_ms": [round(p[0], 1) for p in done],
        "device_exec_ms_per_frame": round(exec_ms, 1),
        "device_busy_frac": round(busy, 3),
        "stage_ms": stage_ms,
        "rpe_t_m": round(float(t_err), 5),
        "rpe_r_deg": round(float(r_err), 5),
    }
    if host_ms is not None:
        out["host_ms"] = round(host_ms, 1)
        out["transport_wait_ms"] = round(wait_ms, 1)
    if gate_failed:
        out["gate_failed"] = "; ".join(gate_failed)
    lbas = list(system.map.lba_times)
    if lbas:
        out["lba_warm_window_ms"] = round(float(min(lbas)), 1)
        # frames after the second window's trigger + 1, the third
        # window's time included
        stride = settings.window_size - settings.overlap_size
        second_w = 2 * stride + settings.overlap_size - 1
        tail = times[max(second_w + 2 - warmup, 0):]
        if len(lbas) >= 3 and tail:
            out["tracking_plus_lba_fps"] = round(len(tail) / sum(tail), 3)
    lbas0 = list(done[0][2].map.lba_times)
    if lbas0:
        out["lba_first_window_ms"] = round(float(lbas0[0]), 1)
    if dev.type != "cuda":
        out["cpu_smoke_fps"] = round(fps, 3)   # pipeline check, not headline
    out["device"] = _card_label(dev)
    return out


def bench_config():
    """``bench.py``'s sequence: 54 KITTI-scale frames, 2 moving objects,
    0.2 px flow noise."""
    from .utils.synthetic import kitti_config

    return kitti_config(n_frames=54, noise_flow=0.2)


def bench_settings(cfg):
    """``bench.py``'s settings: :func:`_settings` with the window BA at the
    reference cadence (window 20, overlap 4)."""
    settings = _settings(cfg)
    settings.run_local_ba = True
    settings.window_size, settings.overlap_size = 20, 4
    return settings


def main(argv=None) -> int:
    """Run the bench and print its JSON line; 0 when the run met its gates,
    1 otherwise (no card, a failed gate, an error)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU: a smoke run whose value is 0 "
                         "(as SDPL_BENCH_ALLOW_CPU=1)")
    args = ap.parse_args(argv)
    stdout = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        try:
            if args.cpu or os.environ.get("SDPL_BENCH_ALLOW_CPU"):
                device = "cpu"
            elif torch.cuda.is_available():
                device = "cuda"
            else:
                out = _fail("no CUDA device is available (set "
                            "SDPL_BENCH_ALLOW_CPU=1 or pass --cpu for a CPU "
                            "smoke run)", device=None)
                device = None
            if device is not None:
                _progress("device: %s" % _card_label(device))
                cfg = bench_config()
                out = run(cfg, bench_settings(cfg), device=device)
        except Exception as e:         # always print the JSON line
            traceback.print_exc()
            out = _fail("%s: %s" % (type(e).__name__, e))
    print(json.dumps(out), file=stdout, flush=True)
    return 1 if "error" in out or "gate_failed" in out else 0


if __name__ == "__main__":
    sys.exit(main())
