"""Offline trajectory/error plotting: the cvplot replacement.

The reference renders error curves with the vendored cvplot library inside
``PlotMetricError`` (reference src/Tracking.cc:5137-5394) and draws a
live trajectory canvas.  Headless hosts have no display; this module
saves the same curves as PNGs with matplotlib when available (a no-op
otherwise -- plotting is observability, not pipeline).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _mpl():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def plot_metric_error(map_state, out_dir) -> bool:
    """Per-frame camera RPE curves + per-object motion error curves
    (PlotMetricError equivalent).  Returns False when matplotlib is
    unavailable."""
    plt = _mpl()
    if plt is None:
        return False
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    m = map_state
    t_err, r_err = [], []
    for i in range(1, len(m.camera_poses)):
        E = (
            m.camera_poses[i] @ np.linalg.inv(m.camera_poses[i - 1])
            @ m.camera_poses_gt[i - 1] @ np.linalg.inv(m.camera_poses_gt[i])
        )
        t_err.append(float(np.linalg.norm(E[:3, 3])))
        c = np.clip((min(np.trace(E[:3, :3]), 3.0) - 1.0) / 2.0, -1, 1)
        r_err.append(float(np.degrees(np.arccos(c))))

    fig, ax = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    ax[0].plot(t_err)
    ax[0].set_ylabel("camera t RPE [m]")
    ax[1].plot(r_err)
    ax[1].set_ylabel("camera R RPE [deg]")
    ax[1].set_xlabel("frame")
    fig.savefig(out / "camera_rpe.png", dpi=110)
    plt.close(fig)

    # per-object body-frame motion errors over time
    curves = {}
    for i in range(len(m.rigid_motions)):
        for j in range(1, len(m.rigid_motions[i])):
            if not m.obj_stat[i][j]:
                continue
            pre = m.obj_pose_pre[i][j]
            body = np.linalg.inv(pre) @ m.rigid_motions[i][j] @ pre
            E = np.linalg.inv(body) @ m.rigid_motions_gt[i][j]
            lab = m.rm_labels[i][j]
            curves.setdefault(lab, ([], [], []))
            curves[lab][0].append(i)
            curves[lab][1].append(float(np.linalg.norm(E[:3, 3])))
            c = np.clip((min(np.trace(E[:3, :3]), 3.0) - 1.0) / 2.0, -1, 1)
            curves[lab][2].append(float(np.degrees(np.arccos(c))))
    if curves:
        fig, ax = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
        for lab, (xs, ts, rs) in sorted(curves.items()):
            ax[0].plot(xs, ts, label=f"obj {lab}")
            ax[1].plot(xs, rs, label=f"obj {lab}")
        ax[0].set_ylabel("object t err [m]")
        ax[1].set_ylabel("object R err [deg]")
        ax[1].set_xlabel("frame")
        ax[0].legend(fontsize=8)
        fig.savefig(out / "object_motion_error.png", dpi=110)
        plt.close(fig)

    # bird's-eye trajectory (the imTraj canvas equivalent)
    xs = [p[0, 3] for p in m.camera_poses]
    zs = [p[2, 3] for p in m.camera_poses]
    xg = [p[0, 3] for p in m.camera_poses_gt]
    zg = [p[2, 3] for p in m.camera_poses_gt]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(xs, zs, label="estimated")
    ax.plot(xg, zg, "--", label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    fig.savefig(out / "trajectory.png", dpi=110)
    plt.close(fig)
    return True


def write_tracklet_histograms(map_state, out_dir) -> None:
    """track_distribution_static(.line).txt equivalents
    (Tracking.cc:3480-3506)."""
    from ..models import tracklets as tk
    from .metrics import tracklet_histogram

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    sta = tk.build_tracklets(map_state.stat_asso)
    lin = tk.build_tracklets(map_state.line_asso)
    np.savetxt(out / "track_distribution_static.txt",
               tracklet_histogram(sta)[None], fmt="%d")
    np.savetxt(out / "track_distribution_static_line.txt",
               tracklet_histogram(lin)[None], fmt="%d")
