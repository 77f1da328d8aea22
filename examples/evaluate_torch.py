#!/usr/bin/env python
"""Offline evaluation over the reference-format result files: the twin
of ``examples/evaluate.py`` on ``sdpl_slam_torch.utils.metrics``, so a
machine without JAX can score a run.

Usage: python examples/evaluate_torch.py <results_dir> [other_results_dir]

Consumes the txt files written by ``System.save_results`` (the formats
of the reference's System.cc:66-244):

  initial_stereo_new.txt / refined_stereo_new.txt / cam_pose_gt_stereo.txt
      frame_id + 16 floats (row-major 4x4 T_wc)
  obj_mot_stereo_new.txt / obj_mot_stereo_rf_new.txt / obj_mot_gt.txt
      frame_id label + 16 floats (body-frame SE(3) motion)

and reports camera RPE (the reference's GetMetricError definitions --
clamped-trace rotation, plain means) plus ATE, and per-object body-frame
motion errors, for both the initial and the BA-refined estimates.  With
a second directory, also prints the pose-by-pose difference between the
two runs (regression diffing).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from sdpl_slam_torch.utils import metrics


def read_pose_file(path):
    """frame_id + 16 floats per row -> (ids, (N,4,4))."""
    ids, mats = [], []
    with open(path) as f:
        for line in f:
            v = line.split()
            if len(v) < 17:
                continue
            ids.append(int(float(v[0])))
            mats.append(np.asarray(v[1:17], np.float64).reshape(4, 4))
    return ids, mats


def read_obj_file(path):
    """frame_id label + 16 floats -> {(frame, label): 4x4}."""
    out = {}
    with open(path) as f:
        for line in f:
            v = line.split()
            if len(v) < 18:
                continue
            out[(int(float(v[0])), int(float(v[1])))] = np.asarray(
                v[2:18], np.float64
            ).reshape(4, 4)
    return out


def ate(poses, poses_gt):
    """Absolute trajectory error after first-pose alignment (the
    reference reports only RPE; ATE added as standard eval tooling)."""
    if not poses:
        return 0.0
    A = np.linalg.inv(poses[0]) if np.ndim(poses[0]) else np.eye(4)
    G = np.linalg.inv(poses_gt[0])
    errs = []
    for T, Tg in zip(poses, poses_gt):
        d = (A @ T)[:3, 3] - (G @ Tg)[:3, 3]
        errs.append(np.linalg.norm(d))
    return float(np.sqrt(np.mean(np.square(errs))))


def object_errors(est, gt):
    """Per-row body-frame motion error over matching (frame, label)."""
    t_e, r_e, per = [], [], {}
    for key, H in est.items():
        Hg = gt.get(key)
        if Hg is None:
            continue
        E = np.linalg.inv(H) @ Hg
        te = float(np.linalg.norm(E[:3, 3]))
        re = metrics._clamped_trace_rot_deg(E)
        t_e.append(te)
        r_e.append(re)
        per.setdefault(key[1], []).append((te, re))
    if not t_e:
        return None
    out_per = {
        lab: (float(np.mean([x[0] for x in v])),
              float(np.mean([x[1] for x in v])), len(v))
        for lab, v in per.items()
    }
    return float(np.mean(t_e)), float(np.mean(r_e)), out_per


def evaluate(d: Path):
    """Print the scores of the run in ``d``; returns {"camera": [(name,
    RPE m, RPE deg, ATE m, frames)], "objects": {name: (m, deg, per
    object)}}."""
    d = Path(d)
    _, gt = read_pose_file(d / "cam_pose_gt_stereo.txt")
    rows = []
    for name, fn in (("initial", "initial_stereo_new.txt"),
                     ("refined", "refined_stereo_new.txt")):
        p = d / fn
        if not p.exists():
            continue
        _, est = read_pose_file(p)
        n = min(len(est), len(gt))
        t, r = metrics.camera_rpe(est[:n], gt[:n])
        rows.append((name, t, r, ate(est[:n], gt[:n]), n))
    print(f"== {d}")
    for name, t, r, a, n in rows:
        print(f"  camera {name:8s}: RPE {t:.4f} m / {r:.4f} deg, "
              f"ATE {a:.4f} m   ({n} frames)")

    objects = {}
    gt_obj = (read_obj_file(d / "obj_mot_gt.txt")
              if (d / "obj_mot_gt.txt").exists() else {})
    for name, fn in (("initial", "obj_mot_stereo_new.txt"),
                     ("refined", "obj_mot_stereo_rf_new.txt")):
        p = d / fn
        if not p.exists() or not gt_obj:
            continue
        res = object_errors(read_obj_file(p), gt_obj)
        if res is None:
            continue
        t, r, per = res
        objects[name] = res
        print(f"  objects {name:7s}: motion err {t:.4f} m / {r:.4f} deg "
              f"({sum(v[2] for v in per.values())} obs)")
        for lab in sorted(per):
            pt, pr, c = per[lab]
            print(f"    object {lab}: {pt:.4f} m / {pr:.4f} deg  ({c})")
    return dict(camera=rows, objects=objects)


def diff_runs(a: Path, b: Path):
    _, pa = read_pose_file(a / "initial_stereo_new.txt")
    _, pb = read_pose_file(b / "initial_stereo_new.txt")
    n = min(len(pa), len(pb))
    dt = [np.linalg.norm(pa[i][:3, 3] - pb[i][:3, 3]) for i in range(n)]
    print(f"== diff {a} vs {b}: mean |dt| {np.mean(dt):.6f} m, "
          f"max {np.max(dt):.6f} m over {n} frames")


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 1
    evaluate(Path(argv[1]))
    if len(argv) > 2:
        evaluate(Path(argv[2]))
        diff_runs(Path(argv[1]), Path(argv[2]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
