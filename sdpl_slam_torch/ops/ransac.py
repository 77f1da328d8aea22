"""Batched RANSAC rigid-pose initialisation (the cv::solvePnPRansac stand-in).

Counterpart of the JAX package's ``ops.ransac``: every hypothesis is a minimal
3-point 3D-3D alignment by orthonormal triads, all solved at once, scored
by reprojection of last-frame 3D through the candidate pose against the
current 2D position (inlier at < 0.4 px, the reference's criterion).

The sample draws are an input (``u``, uniforms in [0, 1)) rather than a
key: no torch generator reproduces ``jax.random``, so the tracker draws
them from a seeded ``torch.Generator`` and the parity tests feed JAX's own
draws.  Everything else is as in JAX: the stable valid-first compaction,
the sample index ``min(int(u * n_valid), n_valid - 1)``, and the first
maximum of the inlier counts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry
from .geometry import Intrinsics


class RansacResult(NamedTuple):
    pose: torch.Tensor        # (..., 4, 4) best world->camera candidate
    inliers: torch.Tensor     # (..., N) bool under the best candidate
    n_inliers: torch.Tensor   # (...,) int32


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)


def _triad_align(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Rigid T with Q ~= R P + t for minimal samples (..., 3, 3) (rows are
    points), via the frames (u, v, u x v) of the two triangles:
    R = F_Q F_P^T.  Degenerate samples give a garbage rotation that the
    inlier scoring rejects."""

    def frame(A):
        u = _unit(A[..., 1, :] - A[..., 0, :])
        v = A[..., 2, :] - A[..., 0, :]
        v = _unit(v - torch.sum(v * u, -1, keepdim=True) * u)
        return torch.stack([u, v, torch.linalg.cross(u, v)], -1)

    R = frame(Q) @ frame(P).transpose(-1, -2)
    t = Q.mean(-2) - (R @ P.mean(-2)[..., None])[..., 0]
    T = torch.zeros(P.shape[:-2] + (4, 4), dtype=P.dtype, device=P.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def ransac_rigid_init(
    X_last: torch.Tensor,     # (B, N, 3) last-frame 3D in WORLD
    uv_cur: torch.Tensor,     # (B, N, 2) current 2D positions
    X_cur: torch.Tensor,      # (B, N, 3) current-frame 3D in CAMERA coords
    valid: torch.Tensor,      # (B, N) bool (usable for sampling & scoring)
    K: Intrinsics,
    u: torch.Tensor,          # (B, S, 3) uniform draws in [0, 1)
    reproj_thresh: float = 0.4,
) -> RansacResult:
    """All-hypotheses-parallel RANSAC over B independent problems (lanes):
    sample S 3-point subsets per lane, align, score by reprojection, and
    return each lane's best pose and its inlier set.  Unbatched inputs
    ((N, 3), ..., u (S, 3)) are accepted and give unbatched results."""
    if X_last.dim() == 2:
        r = ransac_rigid_init(X_last[None], uv_cur[None], X_cur[None],
                              valid[None], K, u[None], reproj_thresh)
        return RansacResult(r.pose[0], r.inliers[0], r.n_inliers[0])
    B, N, _ = X_last.shape
    lanes = torch.arange(B, device=X_last.device)[:, None, None]

    # compact valid rows to a prefix so uniform sampling hits only them
    order = torch.argsort((~valid).to(torch.int32), dim=-1, stable=True)
    n_valid = torch.clamp(valid.sum(-1, dtype=torch.int32), min=3)[:, None, None]
    rows = torch.minimum((u * n_valid).to(torch.int32), n_valid - 1)
    idx = torch.gather(order, 1, rows.reshape(B, -1).long()).reshape(rows.shape)
    P = X_last[lanes, idx]                      # (B, S, 3, 3)
    Q = X_cur[lanes, idx]
    T = _triad_align(P, Q)                      # (B, S, 4, 4)

    # score: reproject all last-3D through each candidate
    Xc_all = (torch.einsum("bsij,bnj->bsni", T[..., :3, :3], X_last)
              + T[..., None, :3, 3])
    proj = geometry.project(K, Xc_all)                      # (B, S, N, 2)
    err = torch.linalg.norm(proj - uv_cur[:, None], dim=-1)
    inl = valid[:, None] & (Xc_all[..., 2] > 0) & (err < reproj_thresh)
    counts = inl.sum(-1, dtype=torch.int32)                 # (B, S)
    best = torch.argmax(counts, dim=-1)                     # first maximum
    b = torch.arange(B, device=X_last.device)
    return RansacResult(pose=T[b, best], inliers=inl[b, best],
                        n_inliers=counts[b, best])
