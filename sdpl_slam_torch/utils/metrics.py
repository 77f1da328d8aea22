"""Metric evaluation: the ``GetMetricError`` equivalent
(reference src/Tracking.cc:4985-5135).

Definitions preserved exactly:
* Camera RPE per frame pair: E = (T_wc[i] @ inv(T_wc[i-1])) @
  (T_wc_gt[i-1]... in the reference's storage convention,
  CamPose holds T_wc and E = CamPose[i]*inv(CamPose[i-1]) *
  CamPose_gt[i-1]*inv(CamPose_gt[i]).  t error = ||E[:3,3]||, rotation via
  the CLAMPED-trace formula: diag entries > 1 are folded back as
  1-(d-1) before acos((tr-1)/2).
* Object motion RPE in the BODY frame: RigMotBody =
  inv(ObjPosePre) @ RigMot @ ObjPosePre; E = inv(RigMotBody) @ RigMot_gt.
* Averages are plain means (bRMSError=false in the reference).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _clamped_trace_rot_deg(E: np.ndarray) -> float:
    trace = 0.0
    for j in range(3):
        d = float(E[j, j])
        trace += (1.0 - (d - 1.0)) if d > 1.0 else d
    c = (trace - 1.0) / 2.0
    c = min(max(c, -1.0), 1.0)
    return float(np.arccos(c) * 180.0 / 3.1415926)


def camera_rpe(cam_poses: List[np.ndarray],
               cam_poses_gt: List[np.ndarray]) -> Tuple[float, float]:
    """Average camera relative pose error (t in m, R in deg)."""
    t_sum, r_sum = 0.0, 0.0
    n = len(cam_poses)
    for i in range(1, n):
        T_lc_inv = cam_poses[i] @ np.linalg.inv(cam_poses[i - 1])
        T_lc_gt = cam_poses_gt[i - 1] @ np.linalg.inv(cam_poses_gt[i])
        E = T_lc_inv @ T_lc_gt
        t_sum += float(np.linalg.norm(E[:3, 3]))
        r_sum += _clamped_trace_rot_deg(E)
    denom = max(n - 1, 1)
    return t_sum / denom, r_sum / denom


def object_motion_error(
    rigid_motions: List[List[np.ndarray]],
    obj_pose_pre: List[List[np.ndarray]],
    rigid_motions_gt: List[List[np.ndarray]],
    obj_stat: List[List[bool]],
    rm_labels: List[List[int]],
) -> Tuple[float, float, Dict[int, Tuple[float, float, int]]]:
    """Overall and per-object average body-frame motion error."""
    t_sum, r_sum, count = 0.0, 0.0, 0
    per_obj: Dict[int, List[float]] = {}
    for i in range(len(rigid_motions)):
        if len(rigid_motions[i]) <= 1:
            continue
        for j in range(1, len(rigid_motions[i])):
            if not obj_stat[i][j]:
                continue
            pre = obj_pose_pre[i][j]
            body = np.linalg.inv(pre) @ rigid_motions[i][j] @ pre
            E = np.linalg.inv(body) @ rigid_motions_gt[i][j]
            t_err = float(np.linalg.norm(E[:3, 3]))
            r_err = _clamped_trace_rot_deg(E)
            t_sum += t_err
            r_sum += r_err
            count += 1
            lab = rm_labels[i][j]
            per_obj.setdefault(lab, [0.0, 0.0, 0])
            per_obj[lab][0] += t_err
            per_obj[lab][1] += r_err
            per_obj[lab][2] += 1
    overall_t = t_sum / count if count else 0.0
    overall_r = r_sum / count if count else 0.0
    per = {
        k: (v[0] / v[2], v[1] / v[2], v[2]) for k, v in per_obj.items() if v[2]
    }
    return overall_t, overall_r, per


def velocity_error(map_state) -> Tuple[float, float, Dict[int, Tuple[float, float, int]]]:
    """``GetVelocityError`` (reference src/Tracking.cc:5395-...):
    per-object speed from the estimated world motion H and the object
    centre c:  v = ||t_H - (I - R_H) c|| * 3.6 * fps  (km/h with fps=10
    folded into the reference's *36 constant), compared to the GT speeds
    recorded at tracking time.  Returns (avg_est, avg_gt, per-object)."""
    m = map_state
    s_sum, sgt_sum, cnt = 0.0, 0.0, 0
    per: Dict[int, list] = {}
    for i in range(len(m.rigid_motions)):
        if len(m.rigid_motions[i]) <= 1:
            continue
        for j in range(1, len(m.rigid_motions[i])):
            if not m.obj_stat[i][j]:
                continue
            H = m.rigid_motions[i][j]
            c = m.rigid_centres[i][j]
            v = H[:3, 3] - (np.eye(3) - H[:3, :3]) @ c[:3]
            sp = float(np.linalg.norm(v)) * 36.0
            sp_gt = (
                float(m.speeds_gt[i][j]) if j < len(m.speeds_gt[i]) else 0.0
            )
            s_sum += sp
            sgt_sum += sp_gt
            cnt += 1
            lab = m.rm_labels[i][j]
            per.setdefault(lab, [0.0, 0.0, 0])
            per[lab][0] += sp
            per[lab][1] += sp_gt
            per[lab][2] += 1
    if cnt == 0:
        return 0.0, 0.0, {}
    return (
        s_sum / cnt, sgt_sum / cnt,
        {k: (v[0] / v[2], v[1] / v[2], v[2]) for k, v in per.items()},
    )


def object_track_time(map_state) -> Dict[int, int]:
    """``GetObjTrackTime`` (Tracking.cc:3722-3790): frames each tracking
    label has been observed."""
    count: Dict[int, int] = {}
    for labels in map_state.rm_labels:
        for lab in labels[1:]:
            count[lab] = count.get(lab, 0) + 1
    return count


def tracklet_histogram(tracks, max_len: int = 20) -> np.ndarray:
    """Track-length histogram (dumped by the reference to
    track_distribution_static(.line).txt, Tracking.cc:3480-3506)."""
    hist = np.zeros(max_len + 1, np.int64)
    for tr in tracks:
        hist[min(len(tr), max_len)] += 1
    return hist


def write_metric_error(map_state, out_path, refined: bool = False) -> None:
    """Append the metric report like the reference's
    Results/Metrix_error.txt (Tracking.cc:4992-4993, ios::app)."""
    from pathlib import Path

    p = Path(out_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "a") as f:
        f.write(metric_error_report(map_state, refined=refined) + "\n")


def metric_error_report(map_state, refined: bool = False) -> str:
    """Formatted like the reference's Results/Metrix_error.txt appends."""
    poses = map_state.camera_poses_rf if refined else map_state.camera_poses
    motions = (
        map_state.rigid_motions_rf if refined else map_state.rigid_motions
    )
    t_cam, r_cam = camera_rpe(poses, map_state.camera_poses_gt)
    t_obj, r_obj, per = object_motion_error(
        motions, map_state.obj_pose_pre, map_state.rigid_motions_gt,
        map_state.obj_stat, map_state.rm_labels,
    )
    lines = [
        "CAMERA:",
        f"average error (Camera): t: {t_cam:.6f} R: {r_cam:.6f}",
        "OBJECTS:",
        f"average error (Over All Objects): t: {t_obj:.6f} R: {r_obj:.6f}",
    ]
    for lab in sorted(per):
        t, r, c = per[lab]
        if c >= 3:
            lines.append(
                f"average error of Object {lab}:  t: {t:.6f} R: {r:.6f} "
                f"TrackCount: {c}"
            )
    return "\n".join(lines)
