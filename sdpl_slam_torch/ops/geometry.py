"""Projective and line geometry on batched torch tensors: pinhole camera,
Pluecker lines, image-space infinite lines.

Counterpart of ``sdpl_slam_tpu.ops.geometry``; everything broadcasts over
leading batch dimensions.  The orthonormal 4-dof line parameterisation
belongs to batch BA and is ported with it.
"""

from __future__ import annotations

import numpy as np
import torch


class Intrinsics:
    """Pinhole intrinsics (fx, fy, cx, cy) -- yaml keys ``Camera.*``.

    Stored as Python floats rounded to float32, the values the JAX
    package's ``jnp.float32`` scalars hold, so f32 arithmetic on tensors
    sees identical constants.
    """

    __slots__ = ("fx", "fy", "cx", "cy")

    def __init__(self, fx, fy, cx, cy):
        self.fx = float(np.float32(fx))
        self.fy = float(np.float32(fy))
        self.cx = float(np.float32(cx))
        self.cy = float(np.float32(cy))

    @staticmethod
    def from_config(cfg) -> "Intrinsics":
        return Intrinsics(cfg.fx, cfg.fy, cfg.cx, cfg.cy)


def project(K: Intrinsics, X: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pinhole projection of camera-frame points (..., 3) -> pixels (..., 2);
    near-zero depths are guarded, callers gate validity separately."""
    z = X[..., 2]
    safe_z = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    u = K.fx * X[..., 0] / safe_z + K.cx
    v = K.fy * X[..., 1] / safe_z + K.cy
    return torch.stack([u, v], -1)


def backproject(K: Intrinsics, uv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Unproject pixels (..., 2) at depth z (...,) to camera-frame (..., 3)
    (``Frame::UnprojectStereoStat``)."""
    x = (uv[..., 0] - K.cx) * z / K.fx
    y = (uv[..., 1] - K.cy) * z / K.fy
    return torch.stack([x, y, z], -1)


# ---------------------------------------------------------------------------
# Pluecker lines.  L = [n(3), d(3)]: d = unit direction, n = p x d.
# ---------------------------------------------------------------------------


def plucker_from_endpoints(p_start: torch.Tensor, p_end: torch.Tensor,
                           eps: float = 1e-12) -> torch.Tensor:
    """Pluecker coordinates (..., 6) from two 3D endpoints (..., 3)
    (``Frame::CalculatePlucker``)."""
    d = p_end - p_start
    norm = torch.linalg.norm(d, dim=-1, keepdim=True)
    d = d / torch.clamp(norm, min=eps)
    return torch.cat([torch.linalg.cross(p_start, d), d], -1)


def transform_plucker(T: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Transform Pluecker lines (..., N, 6) by poses (..., 4, 4):
    n' = R n + t x (R d), d' = R d."""
    R = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3].unsqueeze(-2)
    Rd = L[..., 3:] @ R
    Rn = L[..., :3] @ R
    n_new = Rn + torch.linalg.cross(t.expand_as(Rd), Rd)
    return torch.cat([n_new, Rd], -1)


def point_to_plucker_distance(p: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """||p x d - n||: distance of 3D points to unit-direction Pluecker lines
    (the ``EdgeSE3OrthoLine`` residual primitive)."""
    return torch.linalg.norm(
        torch.linalg.cross(p, L[..., 3:]) - L[..., :3], dim=-1)


# ---------------------------------------------------------------------------
# Image-space infinite lines.
# ---------------------------------------------------------------------------


def infinite_line_image(p: torch.Tensor, q: torch.Tensor,
                        eps: float = 1e-12) -> torch.Tensor:
    """Normalised homogeneous line through pixels p, q (..., 2) -> (..., 3):
    (p_h x q_h) / ||p_h x q_h||, eps inside the root for p == q."""
    ones = torch.ones(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)
    l = torch.linalg.cross(torch.cat([p, ones], -1), torch.cat([q, ones], -1))
    return l / torch.sqrt(torch.sum(l * l, -1, keepdim=True) + eps)


def point_to_image_line(pix: torch.Tensor, line: torch.Tensor) -> torch.Tensor:
    """Dot of homogeneous pixels with line coefficients: line . [u, v, 1]."""
    return line[..., 0] * pix[..., 0] + line[..., 1] * pix[..., 1] + line[..., 2]


def undistort_points_np(uv, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0,
                        p2=0.0, k3=0.0, iterations=5):
    """Iterative radial-tangential keypoint undistortion on host numpy
    (``Frame::UndistortKeyPoints``).  Identity (no copy) when all
    coefficients are zero.  ``uv``: (N, 2) pixel coordinates."""
    if k1 == 0.0 and k2 == 0.0 and p1 == 0.0 and p2 == 0.0 and k3 == 0.0:
        return uv
    uv = np.asarray(uv, np.float64)
    x = (uv[:, 0] - cx) / fx
    y = (uv[:, 1] - cy) / fy
    x_u, y_u = x.copy(), y.copy()
    for _ in range(iterations):
        r2 = x_u * x_u + y_u * y_u
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x_u * y_u + p2 * (r2 + 2.0 * x_u * x_u)
        dy = p1 * (r2 + 2.0 * y_u * y_u) + 2.0 * p2 * x_u * y_u
        x_u = (x - dx) / radial
        y_u = (y - dy) / radial
    out = np.stack([x_u * fx + cx, y_u * fy + cy], axis=1)
    return out.astype(np.float32)
