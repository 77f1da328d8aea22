"""The comparison that decides ``correct``: what the timed path produced
against the scene's exact ground truth and the plain detector reference.

It reads the port's outputs only to judge them (camera poses, object
motions and labels as the map holds them after each sequence, the
detector's keypoints as the tracker took them, the window BAs run) and
works every expected value out from the scene (``scene.py``) and the
configuration.  NumPy only; nothing of the program is imported.

Numbers over the window's sequences (counts summed, errors at their worst
and, as ``<name>_mean_<unit>``, their mean):

- ``frames_missing``: frames handed in whose pose the map lacks, or holds
  as a non-finite matrix (exact: 0);
- ``cam_t_mm`` / ``cam_r_deg``: the camera's relative pose error between
  consecutive frames (inv(GT motion) @ estimated motion, in the camera
  frame), translation in mm and rotation in degrees;
- ``obj_t_mm`` / ``obj_r_deg``: each object motion against the ground
  truth's: the error in where it moves the object's centre, in mm, and
  its rotation error in degrees;
- ``obj_label_err``: object entries whose label names no object present
  in both frames, plus the times one object changed its track label or one
  track label passed to another object, within a sequence (exact: 0);
- ``obj_missed``: (frame, object) pairs where an object covers at least
  ``MIN_OBJ_PIXELS`` of both frames' masks and no motion was reported;
- ``fast_mismatch``: keypoints in the detector's output or in the plain
  reference's and not in both, on the frames sampled from the seed.
"""

from __future__ import annotations

import numpy as np

from . import fast_ref, scene

MIN_OBJ_PIXELS = 2000


def _angle_deg(R) -> float:
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.degrees(np.arccos(min(max(c, -1.0), 1.0))))


def sequence_errors(rec: dict, seq: scene.Sequence) -> dict:
    """One sequence's counts, and its lists of errors: ``cam_t`` /
    ``cam_r`` a frame pair, ``obj_t`` / ``obj_r`` an object motion,
    ``fast`` a sampled frame."""
    g = seq.g
    n = rec["n"]
    poses = [np.asarray(p, np.float64) for p in rec["poses"]]
    ok = [np.all(np.isfinite(p)) for p in poses]
    out = dict(frames_missing=n - sum(ok[:n]))
    gt = [seq.pose[t].astype(np.float64) for t in range(n)]
    cam_t, cam_r = [], []
    for i in range(1, min(n, len(poses))):
        if not (ok[i] and ok[i - 1]):
            continue
        E = np.linalg.inv(np.linalg.inv(gt[i - 1]) @ gt[i]) @ (
            np.linalg.inv(poses[i - 1]) @ poses[i])
        cam_t.append(1e3 * float(np.linalg.norm(E[:3, 3])))
        cam_r.append(_angle_deg(E[:3, :3]))
    out.update(cam_t=cam_t, cam_r=cam_r)

    # the map's world is the first frame's camera: T_wc(0) takes it to
    # the scene's world
    A = gt[0]
    A_inv = np.linalg.inv(A)
    n_obj = g["n_objects"]
    obj_t, obj_r, bad = [], [], 0
    labels_of = {}             # object -> track labels seen
    objects_of = {}            # track label -> objects seen
    reported = set()
    # the map holds one entry a frame pair: motions[f - 1] takes frame
    # f - 1 to frame f
    for f in range(1, min(n, len(rec["motions"]) + 1)):
        for j in range(1, len(rec["motions"][f - 1])):
            k = int(rec["sm_labels"][f - 1][j]) - 1
            if not (0 <= k < n_obj and seq.object_pixels(f - 1, k)
                    and seq.object_pixels(f, k)):
                bad += 1
                continue
            reported.add((f, k))
            lab = int(rec["rm_labels"][f - 1][j])
            labels_of.setdefault(k, set()).add(lab)
            objects_of.setdefault(lab, set()).add(k)
            H = A @ np.asarray(rec["motions"][f - 1][j], np.float64) @ A_inv
            L0 = scene.obj_pose(g, k, f - 1).astype(np.float64)
            H_gt = scene.obj_pose(g, k, f).astype(np.float64) @ np.linalg.inv(L0)
            c = L0[:3, 3]
            moved = H[:3, :3] @ c + H[:3, 3]
            moved_gt = H_gt[:3, :3] @ c + H_gt[:3, 3]
            obj_t.append(1e3 * float(np.linalg.norm(moved - moved_gt)))
            obj_r.append(_angle_deg(H_gt[:3, :3].T @ H[:3, :3]))
    out.update(obj_t=obj_t, obj_r=obj_r)
    out["obj_label_err"] = bad + sum(len(v) - 1 for v in labels_of.values()) \
        + sum(len(v) - 1 for v in objects_of.values())
    out["obj_missed"] = sum(
        1 for f in range(1, n) for k in range(n_obj)
        if (f, k) not in reported
        and seq.object_pixels(f - 1, k) >= MIN_OBJ_PIXELS
        and seq.object_pixels(f, k) >= MIN_OBJ_PIXELS)

    if rec.get("fast"):
        fcfg = rec["fast_cfg"]
        out["fast"] = [
            fast_ref.mismatch(*fast_ref.detect(seq.gray[t], **fcfg), uv, va)
            for t, (uv, va) in rec["fast"].items()]
    return out


COUNTS = ("frames_missing", "obj_label_err", "obj_missed")
ERRORS = (("cam_t", "mm"), ("cam_r", "deg"), ("obj_t", "mm"), ("obj_r", "deg"))


def window_numbers(recs, seq) -> dict:
    """The numbers of a window's sequences: the counts summed, each error's
    worst (``cam_t_mm``) and mean (``cam_t_mean_mm``) over all of them,
    and the worst ``fast_mismatch``."""
    counts, lists = {}, {}
    for rec in recs:
        for k, v in sequence_errors(rec, seq).items():
            if k in COUNTS:
                counts[k] = counts.get(k, 0.0) + float(v)
            else:
                lists.setdefault(k, []).extend(v)
    out = dict(counts)
    for k, unit in ERRORS:
        v = lists.get(k, [])
        out["%s_%s" % (k, unit)] = float(max(v, default=0.0))
        out["%s_mean_%s" % (k, unit)] = float(np.mean(v)) if v else 0.0
    if "fast" in lists:
        out["fast_mismatch"] = float(max(lists["fast"], default=0))
    return out


def judge(numbers: dict, limits: dict):
    """(correct, {name: (value, limit)}) over the numbers that have a
    limit; a number that is missing or not finite fails."""
    checks = {}
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        checks[name] = (v, limit)
    correct = bool(checks) and all(
        np.isfinite(v) and v <= lim for v, lim in checks.values())
    return correct, checks
