#!/usr/bin/env python
"""Sequence runner of the PyTorch port: the reference's example program
(reference example/sdpl_slam.cc), twin of ``examples/run_sequence.py``.

Usage: python examples/run_sequence_torch.py [--cpu] <settings.yaml> <sequence_dir> [out_dir]

Loads a sequence in the reference on-disk layout (times.txt, image_0/,
depth/, semantic/, flow/, pose_gt.txt, object_pose.txt), tracks every
frame with background-prefetched I/O and both detectors in the loop, and
writes the 7 reference-format result files + metric report.

The tracker runs on the CUDA card and raises when there is none;
``--cpu`` runs it on the CPU instead.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv):
    device = "cuda"
    if "--cpu" in argv:
        argv = [a for a in argv if a != "--cpu"]
        device = "cpu"
    if len(argv) < 3:
        print(__doc__)
        return 1
    from sdpl_slam_torch.io.dataset import load_sequence, png_decoder
    from sdpl_slam_torch.io.prefetch import FramePrefetcher
    from sdpl_slam_torch.models.system import System

    settings, seq_dir = argv[1], argv[2]
    out_dir = argv[3] if len(argv) > 3 else "results"

    system = System(settings, device=device)
    seq = load_sequence(seq_dir)
    n = seq.n_frames
    print(f"Images in the sequence: {n} (PNG decoder: {png_decoder()}; "
          f"tracker on {system.device})")

    pf = FramePrefetcher(seq.frame, n, lookahead=3)
    try:
        for i, (gray, depth, flow, mask) in pf:
            print(f"Processing Frame: {i}")
            nxt = pf.peek(i + 1)
            nxt2 = pf.peek(i + 2)
            system.track_rgbd(
                gray, depth, flow, mask, seq.gt_pose(i), seq.gt_obj_poses(i),
                float(seq.timestamps[i]), n,
                next_image=None if nxt is None else nxt[0],
                next_image2=None if nxt2 is None else nxt2[0],
            )
    finally:
        pf.close()
    system.save_results(out_dir, plots=True)
    print(system.metric_error())
    if any(len(m) > 1 for m in system.map.rigid_motions):
        est, gt, per = system.velocity_error()
        print(f"avg object speed est/gt: {est:.2f}/{gt:.2f} km/h")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
