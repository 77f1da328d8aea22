#!/usr/bin/env python
"""One KITTI-scale sequence on disk through the JAX package or the PyTorch
port on the CPU, as ``run_sequence.py`` / ``run_sequence_torch.py`` loop
over it, nothing injected: the figures the port's card-side gates of the
disk path are decided from (PERF.md).

Usage: python examples/disk_run_reference.py jax|torch <sequence_dir> [n_frames]

If ``<sequence_dir>`` holds no sequence yet, ``n_frames`` + 1 frames
(default 12 + 1) of the bench's synthetic sequence (1242x375, 2 objects,
0.2 px flow noise) are written there first by the port's demo writer, with
the bench's caps and no batch BA in settings.yaml.  Prints one JSON line:
camera RPE, per-frame translation errors, static lines and points tracked
per frame, object motion errors, the label stream.
"""

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def write_sequence(root, n_frames):
    from sdpl_slam_torch.utils import config
    from sdpl_slam_torch.utils.synthetic import (SynthSequence, kitti_config,
                                                 slice_settings)

    spec = importlib.util.spec_from_file_location(
        "make_demo_sequence_torch",
        ROOT / "examples" / "make_demo_sequence_torch.py")
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    seq = SynthSequence(kitti_config(n_frames=n_frames + 1))
    settings = slice_settings(seq.cfg)
    settings.depth_map_factor = mk.DEPTH_FACTOR
    mk.write_sequence(root, seq, n_frames + 1,
                      config.format_overrides(settings))


def main(argv):
    if len(argv) < 3 or argv[1] not in ("jax", "torch"):
        print(__doc__)
        return 1
    which, root = argv[1], Path(argv[2])
    if not (root / "times.txt").exists():
        write_sequence(root, int(argv[3]) if len(argv) > 3 else 12)
    if which == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from sdpl_slam_tpu.io.dataset import load_sequence
        from sdpl_slam_tpu.io.prefetch import FramePrefetcher
        from sdpl_slam_tpu.models.system import System
        from sdpl_slam_tpu.utils import metrics

        system = System(root / "settings.yaml", verbose=False)
    else:
        from sdpl_slam_torch.io.dataset import load_sequence
        from sdpl_slam_torch.io.prefetch import FramePrefetcher
        from sdpl_slam_torch.models.system import System
        from sdpl_slam_torch.utils import metrics

        system = System(root / "settings.yaml", verbose=False, device="cpu")
    seq = load_sequence(root)
    n = seq.n_frames
    t0 = time.perf_counter()
    for i, (gray, depth, flow, mask) in FramePrefetcher(seq.frame, n):
        system.track_rgbd(gray, depth, flow, mask, seq.gt_pose(i),
                          seq.gt_obj_poses(i), float(seq.timestamps[i]), n)
    if which == "jax":
        system.tracker.flush()
    m = system.map
    t_err, r_err = metrics.camera_rpe(m.camera_poses, m.camera_poses_gt)
    per_frame = []
    for i in range(1, m.n_frames):
        est = np.linalg.inv(m.camera_poses[i - 1]) @ m.camera_poses[i]
        gt = np.linalg.inv(m.camera_poses_gt[i - 1]) @ m.camera_poses_gt[i]
        per_frame.append(float(np.linalg.norm((np.linalg.inv(est) @ gt)[:3, 3])))
    t_obj, r_obj, _ = metrics.object_motion_error(
        m.rigid_motions, m.obj_pose_pre, m.rigid_motions_gt, m.obj_stat,
        m.rm_labels)
    print(json.dumps(dict(
        which=which, frames=n, seconds=time.perf_counter() - t0,
        t_err=float(t_err), r_err=float(r_err), per_frame_t=per_frame,
        static_lines=[int(v.sum()) for v in m.line_valid],
        static_points=[int(v.sum()) for v in m.stat_valid],
        t_obj=float(t_obj), r_obj=float(r_obj),
        labels=[list(map(int, x)) for x in m.rm_labels])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
