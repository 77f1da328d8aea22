"""Output writers: the 7 result txt files, formats bit-compatible with the
reference's ``System::SaveResults`` (reference src/System.cc:66-244).

Row formats (fixed 9-decimal precision like ``std::fixed<<setprecision(9)``):

* obj_mot_stereo_new.txt / obj_mot_stereo_rf_new.txt / obj_mot_gt.txt:
  ``frame_id label r00 r01 r02 t0 r10 r11 r12 t1 r20 r21 r22 t2 0 0 0 1``
  where the estimated motions are converted to the BODY frame:
  ``inv(ObjPosePre) @ RigMot @ ObjPosePre`` (System.cc:92-99).
* obj_centre.txt: ``frame_id label cx cy cz``
* initial_stereo_new.txt / refined_stereo_new.txt / cam_pose_gt_stereo.txt:
  ``frame_id  16 floats of the row-major 4x4 pose``
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _fmt(x: float) -> str:
    return f"{x:.9f}"


def _pose_row(prefix: str, T: np.ndarray) -> str:
    vals = " ".join(_fmt(float(v)) for v in np.asarray(T, np.float64)[:3].ravel())
    return f"{prefix} {vals} " + " ".join(
        _fmt(v) for v in (0.0, 0.0, 0.0, 1.0)
    )


def save_results(out_dir: str | Path, map_state) -> None:
    """Write all result files from a MapState (models.map_state.MapState)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    start_frame = 0
    f_mot = open(out / "obj_mot_stereo_new.txt", "w")
    f_mot_rf = open(out / "obj_mot_stereo_rf_new.txt", "w")
    f_mot_gt = open(out / "obj_mot_gt.txt", "w")
    f_centre = open(out / "obj_centre.txt", "w")
    try:
        for i in range(len(map_state.rigid_motions)):
            motions = map_state.rigid_motions[i]
            if len(motions) <= 1:
                continue
            for j in range(1, len(motions)):
                pre = map_state.obj_pose_pre[i][j]
                pre_inv = np.linalg.inv(pre)
                body = pre_inv @ motions[j] @ pre
                body_rf = pre_inv @ map_state.rigid_motions_rf[i][j] @ pre
                label = map_state.rm_labels[i][j]
                pref = f"{start_frame + i + 1} {label}"
                f_mot.write(_pose_row(pref, body) + "\n")
                f_mot_rf.write(_pose_row(pref, body_rf) + "\n")
                f_mot_gt.write(
                    _pose_row(pref, map_state.rigid_motions_gt[i][j]) + "\n"
                )
                c = map_state.rigid_centres[i][j]
                f_centre.write(
                    f"{pref} " + " ".join(_fmt(float(v)) for v in c[:3]) + "\n"
                )
    finally:
        for f in (f_mot, f_mot_rf, f_mot_gt, f_centre):
            f.close()

    for name, poses in (
        ("initial_stereo_new.txt", map_state.camera_poses),
        ("refined_stereo_new.txt", map_state.camera_poses_rf),
        ("cam_pose_gt_stereo.txt", map_state.camera_poses_gt),
    ):
        with open(out / name, "w") as f:
            for i, T in enumerate(poses):
                f.write(_pose_row(str(start_frame + i), T) + "\n")


def format_timing_summary(map_state) -> str:
    """The timing printout of SaveResults (System.cc:204-237): average of the
    five per-frame slots (slot 3 averaged only over frames with objects) and
    the average local-BA time."""
    all_t = np.asarray(map_state.frame_times, np.float64)  # (F, 5)
    lines = ["Time of all components: "]
    if all_t.size:
        parts = []
        for j in range(all_t.shape[1]):
            if j == 3:
                nz = all_t[:, 3] != 0
                denom = max(int(nz.sum()), 1)
                parts.append(f"({j}): {all_t[:, j].sum() / denom} ")
            else:
                parts.append(f"({j}): {all_t[:, j].mean()} ")
        lines.append("".join(parts))
    lba = np.asarray(map_state.lba_times, np.float64)
    if lba.size:
        lines.append(f"Time of local bundle adjustment: {lba.mean()}")
    return "\n".join(lines)
