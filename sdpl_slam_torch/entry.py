"""The flagship step's entry point (counterpart of the JAX package's
``__graft_entry__.entry``): the joint flow+pose camera LM at KITTI
capacities (1200 points, 400 lines), the per-frame hot path of the SLAM
pipeline.

    fn, args = entry()             # on the card; entry("cpu") on the CPU
    pose, point_inliers = fn(*args)
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import geometry, lie
from .solvers import frame_solvers as fs
from .utils.device import checked_device

N_POINTS, N_LINES = 1200, 400
PRIOR_INFO = 0.3               # flow and line prior information


def entry(device="cuda"):
    """(fn, example_args) on ``device``: the JAX entry's inputs, drawn from
    ``np.random.default_rng(0)`` in the same order and built by this
    package's ``geometry`` and ``lie`` in float32 (KITTI intrinsics, a
    true motion of 0.3 / 0.05 / 0.6 m and ~1.3 deg, flows by exact
    reprojection); ``fn`` runs ``frame_solvers.solve_flow_pose`` from the
    identity with prior information 0.3 and returns (pose, point
    inliers)."""
    dev = checked_device(device, "entry")
    K = geometry.Intrinsics(721.5377, 721.5377, 609.5593, 172.8540)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    uv = t(rng.uniform([50, 50], [1192, 325], size=(N_POINTS, 2)))
    z = t(rng.uniform(3, 40, size=N_POINTS))
    T_true = lie.se3_exp(t([0.01, -0.02, 0.005, 0.3, 0.05, 0.6]))
    X = geometry.backproject(K, uv, z)
    flow = geometry.project(K, lie.transform_point(T_true, X)) - uv
    s_uv = t(rng.uniform([80, 60], [1162, 315], size=(N_LINES, 2)))
    e_uv = s_uv + t(rng.uniform(-80, 80, size=(N_LINES, 2)))
    zs = t(rng.uniform(4, 30, size=N_LINES))
    ze = t(rng.uniform(4, 30, size=N_LINES))
    Xs = geometry.backproject(K, s_uv, zs)
    Xe = geometry.backproject(K, e_uv, ze)
    lf = torch.cat([
        geometry.project(K, lie.transform_point(T_true, Xs)) - s_uv,
        geometry.project(K, lie.transform_point(T_true, Xe)) - e_uv], 1)

    def fn(obs, flow0, depth, lobs, lflow0, ldepth):
        eye = torch.eye(4, dtype=torch.float32, device=obs.device)
        pts = fs.PointBundle(obs=obs, flow0=flow0, depth=depth,
                             valid=torch.ones(obs.shape[0], dtype=torch.bool,
                                              device=obs.device))
        lns = fs.LineBundle(obs=lobs, flow0=lflow0, depth=ldepth,
                            valid=torch.ones(lobs.shape[0], dtype=torch.bool,
                                             device=obs.device))
        res = fs.solve_flow_pose(eye, eye, pts, lns, K,
                                 flow_prior_info=PRIOR_INFO,
                                 line_prior_info=PRIOR_INFO)
        return res.pose, res.point_inlier

    example_args = (uv, flow, z, torch.cat([s_uv, e_uv], 1), lf,
                    torch.stack([zs, ze], 1))
    return fn, example_args
