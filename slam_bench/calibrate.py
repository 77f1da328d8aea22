"""Readings for the limits of ``limits/<cell>.json``: the numbers that the
comparison (``reference.py``) gives over several seeds in one process, for
the control of a cell or for a fault planted in its timed path.

    python3 -m slam_bench.calibrate --workload kitti.track --seeds 3 \\
        --first-seed 5000 --seconds 51 --control tf32 > readings.jsonl

The set-up and the window are ``run.py``'s (``run.prepare`` and its warm-up,
then ``run.window`` for each seed on a new stream of that seed's
noise) and print one JSON line of numbers a seed.  The sound program's
readings come from the benchmark's own runs, which print the same numbers.
``--control tf32`` switches TF32 on for matmuls and cuDNN before anything
is captured: the nearest precision below the float32 that the
configurations state.  ``--fault object_identity`` reports every object's
motion as the identity where the tracker hands it to the map.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def identity_object_motions(set_attr=setattr):
    """Plant the fault: the tracker hands the map the identity for every
    object's motion."""
    from sdpl_slam_torch.models.tracking import Tracking

    orig = Tracking._push_map

    def push(self, st, pose_np, pose_gt, prev_pose_gt, velocity, obj_meta,
             timing):
        obj_meta = [dict(om, H=np.eye(4, dtype=np.float32))
                    for om in obj_meta]
        return orig(self, st, pose_np, pose_gt, prev_pose_gt, velocity,
                    obj_meta, timing)

    set_attr(Tracking, "_push_map", push)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", choices=("tf32",), default=None)
    ap.add_argument("--fault", choices=("object_identity",), default=None)
    args = ap.parse_args(argv)

    import torch

    import sdpl_slam_torch  # noqa: F401  (sets the program's precision)

    from . import reference, run, scene, spec
    from .stream import Stream

    if args.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    if args.fault == "object_identity":
        identity_object_motions()
    bench = spec.Benchmark()
    cell = bench.cell(args.workload)
    ctx = run.prepare(bench, cell, args.first_seed - 1, "cuda")
    seq, values = ctx["seq"], ctx["values"]
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        noise = scene.FlowNoise(seed, seq.flow.shape[1:],
                                ctx["cfg"]["scene"]["noise_flow"], "cuda")
        stream = Stream(values, seq, noise, "cuda", seed)
        recs, _ = run.window(stream, args.seconds)
        numbers = reference.window_numbers(recs, seq)
        print(json.dumps(dict(cell=cell["name"], seed=seed,
                              control=args.control, fault=args.fault,
                              sequences=len(recs),
                              numbers={k: float(v)
                                       for k, v in numbers.items()})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
