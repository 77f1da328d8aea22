#!/usr/bin/env python
"""chip_smoke.py's disk phase (36 KITTI-scale frames from disk through
``System(settings.yaml)``, window BAs at frames 19 and 35, global BA at
35) run from one checkout of the repo, with what it detected and what its
BAs did kept for a comparison across checkouts.  Needs a CUDA card.

``run`` tracks the sequence once from the checkout ``--tree`` and writes,
under ``--out``, ``<tag>.npz`` (the line detector's segments, frame by
frame) and ``<tag>.json`` (each batch BA's LM and CG iterations, wall ms
and final cost).  ``--grad-mag plain`` swaps the detector's gradient
magnitude for ``sqrt(gx * gx + gy * gy)`` in float32, as the port computed
it before ``lines._grad_mag``.  ``--perturb N`` then runs the global BA N
more times on the map it started from, each camera translation moved by
one float32 ulp in a random direction (seeds 0..N-1).  The sequence is
written once under ``--seq`` and read by every run.  ``compare`` prints the
runs side by side: segments per frame and their largest endpoint shift
against the first run, and each BA's iterations and cost.

Usage (one command on the card, parent checkout unpacked under
chip_archive/parent):
  python examples/disk_phase_compare.py run --tree chip_archive/parent --tag parent
  python examples/disk_phase_compare.py run --tree . --tag change --perturb 3
  python examples/disk_phase_compare.py compare
"""

import argparse
import copy
import glob
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args):
    tree = os.path.abspath(args.tree)
    out, seq_dir = os.path.abspath(args.out), os.path.abspath(args.seq)
    os.makedirs(out, exist_ok=True)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from sdpl_slam_torch.ops import lines
    from sdpl_slam_torch.solvers import ba_builder, batch_ba, schur_ba
    from sdpl_slam_torch.utils.synthetic import SynthSequence, kitti_config

    if not os.path.exists(os.path.join(seq_dir, "settings.yaml")):
        os.makedirs(seq_dir, exist_ok=True)
        cs.write_disk_sequence(
            SynthSequence(kitti_config(n_frames=cs.N_FRAMES + 1)), seq_dir)
    if args.grad_mag == "plain":
        lines._grad_mag = lambda gx, gy: torch.sqrt(gx * gx + gy * gy)

    segs = []
    detect = lines.detect_lines

    def recording_detect(img, cfg):
        seg = detect(img, cfg)
        segs.append(cs._compact(seg))
        return seg

    lines.detect_lines = recording_detect
    costs, start = [], {}

    def recording(kind, entry):
        def wrapped(map_state, *a, **kw):
            if kind == "global":
                start["map"] = copy.deepcopy(map_state)
                start["args"] = (a, kw)
            cost = entry(map_state, *a, **kw)
            costs.append(float(cost))
            return cost
        return wrapped

    fbo = ba_builder.full_batch_optimization
    ba_builder.full_batch_optimization = recording("global", fbo)
    ba_builder.partial_batch_optimization = recording(
        "local", ba_builder.partial_batch_optimization)

    t0 = time.perf_counter()
    res = cs.disk_phase(seq_dir, os.path.join(out, args.tag + "_results"))
    runs = [dict(r, cost=c) for r, c in zip(res["ba_runs"], costs)]
    rec = dict(tag=args.tag, tree=args.tree, grad_mag=args.grad_mag,
               seconds=time.perf_counter() - t0,
               frame_ms_median=float(np.median(res["frame_ms"])),
               n_lines=res["n_lines"], ba_runs=runs, perturbed=[])
    for seed in range(args.perturb):
        m = copy.deepcopy(start["map"])
        rng = np.random.default_rng(seed)
        for p in m.camera_poses:
            t = p[:3, 3]
            p[:3, 3] = np.nextafter(
                t, np.where(rng.random(3) < 0.5, -np.inf, np.inf)
            ).astype(t.dtype)
        before = batch_ba.run_ba.iterations + schur_ba.run_ba_schur.iterations
        t1 = time.perf_counter()
        a, kw = start["args"]
        cost = fbo(m, *a, **kw)
        torch.cuda.synchronize()
        rec["perturbed"].append(dict(
            seed=seed, cost=float(cost),
            ms=(time.perf_counter() - t1) * 1e3,
            iterations=batch_ba.run_ba.iterations
            + schur_ba.run_ba_schur.iterations - before))
    np.savez(os.path.join(out, args.tag + ".npz"),
             **{"f%02d" % i: s for i, s in enumerate(segs)})
    with open(os.path.join(out, args.tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


def _shift(a, b):
    """Largest distance from a segment of ``a`` to its nearest segment of
    ``b`` (endpoints, either orientation), px; inf if ``b`` is empty."""
    if not len(a):
        return 0.0
    if not len(b):
        return float("inf")
    d1 = np.abs(a[:, None] - b[None]).max(-1)
    d2 = np.abs(a[:, None] - b[None][..., [2, 3, 0, 1]]).max(-1)
    return float(np.minimum(d1, d2).min(1).max())


def _compare(args):
    out = os.path.abspath(args.out)
    recs = [json.load(open(p)) for p in
            sorted(glob.glob(os.path.join(out, "*.json")),
                   key=os.path.getmtime)]
    segs = {r["tag"]: np.load(os.path.join(out, r["tag"] + ".npz"))
            for r in recs}
    ref = recs[0]["tag"]
    print("runs, in order: %s; shifts against %s"
          % (", ".join(r["tag"] for r in recs), ref))
    print("frame  segments (each run)  identical to %s  largest endpoint "
          "shift px (each run, both ways)" % ref)
    for k in sorted(segs[ref].files):
        a = segs[ref][k]
        row = []
        for r in recs:
            b = segs[r["tag"]][k]
            same = a.shape == b.shape and np.array_equal(a, b)
            row.append((len(b), same, max(_shift(a, b), _shift(b, a))))
        print("%5s  %s  %s  %s" % (
            k[1:], " ".join("%3d" % n for n, _, _ in row),
            "".join("y" if s else "n" for _, s, _ in row),
            " ".join("%.3g" % d for _, _, d in row)))
    for r in recs:
        print("%s (%s, grad-mag %s): %.1f s, median frame %.2f ms" % (
            r["tag"], r["tree"], r["grad_mag"], r["seconds"],
            r["frame_ms_median"]))
        for b in r["ba_runs"]:
            print("  %s BA at frame %d (%s step): %d LM / %d CG iterations, "
                  "%.1f ms, final cost %.9g" % (
                      b["kind"], b["frame"], b["step"], b["iterations"],
                      b["cg_iterations"], b["ms"], b["cost"]))
        for p in r["perturbed"]:
            print("  global BA again, camera translations moved 1 ulp (seed "
                  "%d): %d LM iterations, %.1f ms, final cost %.9g" % (
                      p["seed"], p["iterations"], p["ms"], p["cost"]))
    return 0


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run")
    run.add_argument("--tree", default=".")
    run.add_argument("--tag", required=True)
    run.add_argument("--grad-mag", choices=("port", "plain"), default="port")
    run.add_argument("--perturb", type=int, default=0)
    for p in (run, sub.add_parser("compare")):
        p.add_argument("--out", default=os.path.join(
            HERE, "chiprun_out", "disk_compare"))
    run.add_argument("--seq", default=os.path.join(
        HERE, "build", "disk_compare_seq"))
    args = ap.parse_args(argv[1:])
    return _run(args) if args.cmd == "run" else _compare(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
