"""Projective and line geometry on batched torch tensors: pinhole camera,
Pluecker lines, the orthonormal 4-dof line parameterisation and the line
residual primitives of batch BA, image-space infinite lines.

Counterpart of ``sdpl_slam_tpu.ops.geometry``; everything broadcasts over
leading batch dimensions.
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


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of 3-vectors (..., 3) whose leading dims broadcast
    (``torch.linalg.cross`` wants equal ranks)."""
    return torch.linalg.cross(*torch.broadcast_tensors(a, b))


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs`` with JAX's derivative, which is +1 at 0 (torch's is 0):
    a zero line distance is where the BA Jacobians are taken."""
    return torch.where(x >= 0, x, -x)


def plucker_line_distance(L1: torch.Tensor, L2: torch.Tensor,
                          eps: float = 1e-6) -> torch.Tensor:
    """Reciprocal-product distance between Pluecker lines (..., 6).

    Non-parallel: |d1.n2 + d2.n1| / ||d1 x d2||.  Collinear
    (||d1 x d2|| < eps): ||d1 x (n1 - n2/s)|| / ||d1||^2 with the
    least-squares direction scale s = (d1.d2)/(d1.d1), the JAX package's
    NaN-free form of the ``LineLandmarkMotionTernaryEdge`` branch
    (types_dyn_slam3d.cpp:226-315).  Both branches are evaluated and
    selected with ``where``, so neither leaks NaN into a derivative."""
    def safe_norm(x):
        return torch.sqrt(torch.sum(x * x, -1) + 1e-20)

    n1, d1 = L1[..., :3], L1[..., 3:]
    n2, d2 = L2[..., :3], L2[..., 3:]
    cross_norm = safe_norm(cross(d1, d2))
    parallel = cross_norm < eps
    gen = abs_jax(torch.sum(d1 * n2, -1) + torch.sum(d2 * n1, -1))
    gen = gen / torch.where(parallel, torch.ones_like(cross_norm), cross_norm)
    d11 = torch.sum(d1 * d1, -1, keepdim=True)
    s = torch.sum(d1 * d2, -1, keepdim=True) / torch.maximum(
        d11, torch.full_like(d11, 1e-12))
    s = torch.where(torch.abs(s) < 1e-12, torch.full_like(s, 1e-12), s)
    col = safe_norm(cross(d1, n1 - n2 / s))
    col = col / torch.maximum(d11[..., 0], torch.full_like(col, 1e-12))
    return torch.where(parallel, col, gen)


def plucker_angle_error(L1: torch.Tensor, L2: torch.Tensor) -> torch.Tensor:
    """1 - |cos(angle)| of the line directions, the second component of the
    line-motion ternary residual (types_dyn_slam3d.cpp:309-312)."""
    d1, d2 = L1[..., 3:], L2[..., 3:]
    n1 = torch.linalg.norm(d1, dim=-1)
    n2 = torch.linalg.norm(d2, dim=-1)
    n1 = torch.maximum(n1, torch.full_like(n1, 1e-12))
    n2 = torch.maximum(n2, torch.full_like(n2, 1e-12))
    return 1.0 - abs_jax(torch.sum(d1 * d2, -1) / (n1 * n2))


# ---------------------------------------------------------------------------
# Orthonormal 4-dof lines (U in SO(3), W in SO(2)), stored as U (..., 3, 3)
# and w = (w00, w10), the first column of W (cos, sin).
# ---------------------------------------------------------------------------


def plucker_to_orthonormal(L: torch.Tensor, eps: float = 1e-12):
    """(n, d) -> (U, w): U = [n/|n|, d/|d|, (n x d)/|n x d|] (columns),
    w = (|n|, |d|) / sqrt(|n|^2 + |d|^2)."""
    n, d = L[..., :3], L[..., 3:]
    nn = torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=eps)
    nd = torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=eps)
    c = torch.linalg.cross(n, d)
    nc = torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True), min=eps)
    U = torch.stack([n / nn, d / nd, c / nc], -1)
    scale = torch.sqrt(nn * nn + nd * nd)
    return U, torch.cat([nn / scale, nd / scale], -1)


def orthonormal_to_plucker(U: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(U, w) -> Pluecker [n, d]: n = w0 U[:, 0], d = w1 U[:, 1]
    (``orthonormal2plucker``, edge_se3_ortho_line.cpp:314-319)."""
    n = w[..., 0:1] * U[..., :, 0]
    d = w[..., 1:2] * U[..., :, 1]
    return torch.cat(torch.broadcast_tensors(n, d), -1)


def _rot(t: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """Rotations (..., 3, 3) by angles t (...,) in the (i, j) plane:
    entries (i, i), (i, j), (j, i), (j, j) are c, -s, s, c."""
    c, s = torch.cos(t), torch.sin(t)
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    rows = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    rows[i][i], rows[i][j], rows[j][i], rows[j][j] = c, -s, s, c
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rot_x(t):
    return _rot(t, 1, 2)


def _rot_y(t):
    return _rot(t, 2, 0)


def _rot_z(t):
    return _rot(t, 0, 1)


def orthonormal_retract(U: torch.Tensor, w: torch.Tensor, delta: torch.Tensor):
    """4-dof update U <- U Rx(d0) Ry(d1) Rz(d2), W <- W R(d3)
    (``VertexLine::oplusImpl``, vertex_line.h:32-58); batched over leading
    dims of U (..., 3, 3), w (..., 2) and delta (..., 4)."""
    U_new = (U @ _rot_x(delta[..., 0]) @ _rot_y(delta[..., 1])
             @ _rot_z(delta[..., 2]))
    c, s = torch.cos(delta[..., 3]), torch.sin(delta[..., 3])
    w0, w1 = w[..., 0], w[..., 1]
    return U_new, torch.stack([w0 * c - w1 * s, w1 * c + w0 * s], -1)


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
