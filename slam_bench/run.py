"""Run one cell of the benchmark of ``sdpl_slam_torch`` once.

    python3 -m slam_bench.run --workload kitti.track --seed 7 --seconds 20 --trace 0

Set-up (counted in ``setup_s`` from the start of this process): imports,
the card, the scene's noise-free frames (rendered into ``slam_bench/.cache``
on a checkout's first run), the flow-noise bank, and warm-up sequences of
the cell's own traffic: the first captures every program the window runs,
and more follow while the one before grew the card's caching allocators.
The window then runs whole sequences, each a new ``System``, until
``--seconds`` have passed, and ends when the sequence in flight ends.
After it: the peak memory, with ``--trace 1`` the per-layer readers and a
short profiled stretch, then the comparison that decides ``correct``
(``reference.py``).

The last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit); the same numbers are the last lines on standard error.  It exits
non-zero and prints no result without enough CUDA cards, or when a JAX
module is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from . import probes, reference, scene, spec  # noqa: E402
from .stream import Stream  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sdpl_slam_tpu")
CACHE = os.path.join(spec.HERE, ".cache")
STRETCH_FRAMES = (2, 6)       # the profiled frames of the traced run
# warm-up sequences: until one makes no new device segment or pinned host
# block, at most this many
WARMUP_MAX = 6
WARMUP_INDEX = 2 * 10 ** 6    # the warm-up sequences' noise indices


def forbidden_modules(names=None) -> list:
    """The JAX modules among ``names`` (``sys.modules`` by default),
    compared by whole top-level name."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def captures() -> dict:
    """The program's captured programs so far, by class."""
    from sdpl_slam_torch.models.chained import ChainedProgram
    from sdpl_slam_torch.models.frame_program import (DetectorProgram,
                                                      FrameProgram)
    from sdpl_slam_torch.solvers.batch_ba import BAProgram

    return {c.__name__: c.captures for c in (
        ChainedProgram, FrameProgram, DetectorProgram, BAProgram)}


def end_to_end(recs, window_s: float, setup_s: float) -> dict:
    """The end-to-end metrics of a window of sequence records: every frame
    over all of the window's time, the 95th percentile of every frame's
    pose latency, and the set-up time."""
    lat_ms = np.asarray([x * 1e3 for r in recs for x in r["latency_s"]])
    return {"fps": sum(r["n"] for r in recs) / window_s,
            "pose_latency_ms.p95": float(np.percentile(lat_ms, 95)),
            "setup_s": setup_s}


def _card_label() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def _records(recs, log, device_ms, stretch) -> dict:
    """What the per-layer readers read (``metrics/<name>.py``)."""
    perf = {}
    for r in recs:
        for k, v in (r["perf"] or {}).items():
            perf.setdefault(k, []).extend(v)
    return dict(frames=sum(r["n"] for r in recs), perf=perf,
                launches=log.intervals(), device_window_ms=device_ms,
                ba_runs=[b for r in recs for b in r["ba_runs"]
                         if b["kind"] == "local"],
                stretch=stretch)


def prepare(bench, cell, seed, device, trace=0, t0=_T0, cache_dir=CACHE):
    """Set-up of a run of ``cell``: imports, the frames, the seed's flow
    noise and the warm-up sequences (the first captures every program;
    the next run while the one before made device segments or pinned host
    blocks); -> a dict of what the window needs."""
    import torch

    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    values = dict(cfg["settings"], **traffic.get("settings", {}))
    cuda = torch.device(device).type == "cuda"
    if trace:       # the chained driver's section timers
        os.environ["SDPL_CHAINED_PERF"] = "1"
    import sdpl_slam_torch.models.system  # noqa: F401
    marks = [("imports", time.perf_counter())]
    seq = scene.Sequence(cfg["scene"], cfg["sequence_frames"], cache_dir)
    noise = scene.FlowNoise(seed, seq.flow.shape[1:],
                            cfg["scene"]["noise_flow"], device)
    marks.append(("frames and noise", time.perf_counter()))
    stream = Stream(values, seq, noise, device, seed)
    warm = [stream.run(WARMUP_INDEX)]
    while (len(warm) < WARMUP_MAX and (warm[-1]["host"]["segments"]
                                       or warm[-1]["host"]["pinned"])):
        warm.append(stream.run(WARMUP_INDEX + len(warm)))
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    print("set-up %.3f s: %s (%s)" % (
        setup_s, ", ".join("%s %.3f" % (k, t - p) for (k, t), p in zip(
            marks, [t0] + [t for _, t in marks])),
        _card_label() if cuda else "cpu"), file=sys.stderr, flush=True)
    report_sequences(warm, "warm-up")
    return dict(cfg=cfg, values=values, seq=seq, stream=stream,
                setup_s=setup_s, cuda=cuda)


def window(stream, seconds):
    """Whole sequences of ``stream`` until ``seconds`` have passed;
    -> (their records, the window's wall seconds)."""
    recs = []
    w0 = time.perf_counter()
    while not recs or time.perf_counter() - w0 < seconds:
        recs.append(stream.run(len(recs)))
    return recs, time.perf_counter() - w0


def report_sequences(recs, what="sequences"):
    """Each sequence's wall and host CPU seconds, and the device segments
    and pinned host blocks its allocators made, on standard error."""
    print("%s (wall s / host cpu s / segments / pinned): %s"
          % (what, " ".join("%.3f/%.3f/%d/%d" % (
              r["wall_s"], r["host"]["cpu_s"], r["host"]["segments"],
              r["host"]["pinned"]) for r in recs)),
          file=sys.stderr, flush=True)
    perf = [r["perf"] for r in recs if r["perf"] and r["perf"].get("drain")]
    if perf:
        print("sequences (host ms / wait ms a frame): %s" % " ".join(
            "%.2f/%.2f" % (sum(sum(v) for k, v in p.items() if k != "drain")
                           / len(p["drain"]),
                           sum(p["drain"]) / len(p["drain"])) for p in perf),
              file=sys.stderr, flush=True)


def run(bench, cell, seed, seconds, trace, device, t0=_T0, cache_dir=CACHE):
    """One run of ``cell``; -> (the result line's object, its numbers)."""
    import torch

    ctx = prepare(bench, cell, seed, device, trace, t0, cache_dir)
    seq, stream, cuda = ctx["seq"], ctx["stream"], ctx["cuda"]
    limits = bench.limits(cell["name"])

    log = probes.LaunchLog()
    before = captures()
    with log.recording(device) if trace else contextlib.nullcontext():
        recs, window_s = window(stream, seconds)
        device_ms = None
        if cuda and trace:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            device_ms = log.anchor.elapsed_time(end)
    frames = sum(r["n"] for r in recs)
    print("window %.3f s, %d sequences, %d frames; programs captured in it: "
          "%s" % (window_s, len(recs), frames,
                  {k: v - before[k] for k, v in captures().items()}),
          file=sys.stderr, flush=True)
    report_sequences(recs)
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name() if cuda else "cpu",
               count=1,
               memory_peak_bytes=(torch.cuda.max_memory_allocated()
                                  if cuda else 0))
    metrics = {}
    if not trace:
        values_e2e = end_to_end(recs, window_s, ctx["setup_s"])
        for m in bench.metrics("end_to_end", cell["name"]):
            metrics[m["name"]] = dict(value=values_e2e[m["name"]],
                                      unit=m["unit"])
    breakdown = None
    if trace:
        stretch = None
        if cuda:
            lo, hi = STRETCH_FRAMES
            prof = probes.Stretch()
            stream.run(10 ** 6, stop=hi, hook=lambda t: t == lo and prof.start())
            stretch = prof.stop(device)
            dev.update(busy_s=stretch["busy_s"], window_s=stretch["window_s"])
            breakdown = dict(device_ops=stretch["device_ops"],
                             idle_gaps=stretch.get("idle_gaps", []))
        rec = _records(recs, log, device_ms, stretch)
        rec["device_kind"] = dev["kind"]
        rec["frame_shape"] = seq.gray.shape[1:]
        rec["fast_cfg"] = stream.fast_cfg
        for m in bench.metrics("per_layer", cell["name"]):
            v = bench.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])

    numbers = reference.window_numbers(recs, seq)
    correct, checks = reference.judge(numbers, limits)
    out = dict(correct=correct, attempted=frames,
               failed=int(numbers.get("frames_missing", frames)),
               metrics=metrics, device=dev)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: dict(value=v, limit=lim)
                     for k, (v, lim) in checks.items()}
    return out, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    bench = spec.Benchmark()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print("slam_bench: %s needs %d CUDA card(s); this machine has %d" % (
            cell["name"], cell["chips"],
            torch.cuda.device_count() if torch.cuda.is_available() else 0),
            file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        out, numbers = run(bench, cell, args.seed, args.seconds, args.trace,
                           "cuda")
    found = forbidden_modules()
    if found:
        print("slam_bench: loaded in this process: %s" % ", ".join(found),
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    print("numbers %s" % json.dumps(numbers), file=sys.stderr)
    print("correct %s" % out["correct"], file=sys.stderr)
    for name, c in out["checks"].items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
