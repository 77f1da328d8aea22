"""SO(3)/SE(3) Lie-group operations on batched torch tensors.

Same conventions as ``sdpl_slam_tpu.ops.lie`` (the g2o math the reference
relies on):

* A pose is a 4x4 homogeneous matrix ``T``; batches carry leading dims
  ``(..., 4, 4)``.
* A twist is ``xi = [omega(3), v(3)]``, rotation first (g2o ``SE3Quat::exp``).
* Retraction is left multiplication ``T <- exp(xi) @ T``.

The JAX functions are scalar-pose and batched with ``vmap``; here every
function broadcasts over leading dimensions instead.
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix (..., 3, 3) of 3-vectors (..., 3)."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: a maximum, then a minimum.  At a bound the derivative
    is 1/2, as JAX's is; ``torch.clamp`` would pass all of it."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def _safe_norm(w: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(w * w, -1) + 1e-24)


def _sinc(theta: torch.Tensor) -> torch.Tensor:
    """sin(theta)/theta with a Taylor branch at 0."""
    small = torch.abs(theta) < 1e-5
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(safe) / safe)


def _cosc(theta: torch.Tensor) -> torch.Tensor:
    """(1-cos(theta))/theta^2 with a Taylor branch at 0."""
    small = torch.abs(theta) < 1e-5
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 0.5 - theta * theta / 24.0,
                       (1.0 - torch.cos(safe)) / (safe * safe))


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: R = I + sinc(t) hat(w) + cosc(t) hat(w)^2."""
    theta = _safe_norm(w)[..., None, None]
    W = hat(w)
    return _eye(3, w) + _sinc(theta) * W + _cosc(theta) * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3), (..., 3, 3) -> (..., 3); valid for angles < pi.
    The trace and cos(theta) are clipped, and a Taylor branch takes
    theta < 1e-5, exactly as in the JAX package."""
    trace = clip(R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], -1.0, 3.0)
    cos_t = clip(0.5 * (trace - 1.0), -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    w_hat = 0.5 * (R - R.transpose(-1, -2))
    small = theta < 1e-5
    safe_t = torch.where(small, torch.ones_like(theta), theta)
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        safe_t / torch.sin(safe_t))
    return scale[..., None] * vee(w_hat)


def rotation_angle_deg(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle in degrees by the clamped-trace acos formula of the
    reference metrics (Tracking.cc:5026-5040)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.rad2deg(torch.arccos(clip(0.5 * (trace - 1.0), -1.0, 1.0)))


def _left_jacobian_v(w: torch.Tensor) -> torch.Tensor:
    """The V matrix in se(3) exp: t = V @ v."""
    theta = _safe_norm(w)[..., None, None]
    W = hat(w)
    theta2 = theta * theta
    small = theta < 1e-5
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - _sinc(theta)) / safe2)
    return _eye(3, w) + _cosc(theta) * W + c * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3); xi (..., 6) -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = so3_exp(w)
    T[..., :3, 3] = (_left_jacobian_v(w) @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map SE(3) -> se(3): (..., 4, 4) -> (..., 6) = [omega, v].
    ``solve_ex`` rather than ``solve``: no error check, so no device sync."""
    w = so3_log(T[..., :3, :3])
    v = torch.linalg.solve_ex(_left_jacobian_v(w), T[..., :3, 3])[0]
    return torch.cat([w, v], -1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Ti = torch.zeros_like(T)
    Rt = R.transpose(-1, -2)
    Ti[..., :3, :3] = Rt
    Ti[..., :3, 3] = -(Rt @ t[..., None])[..., 0]
    Ti[..., 3, 3] = 1.0
    return Ti


def se3_retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction ``exp(xi) @ T`` (g2o SE3 oplus)."""
    return se3_exp(xi) @ T


def so3_orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """One Newton step of the polar decomposition, ``R (3I - R^T R) / 2``:
    projects a near-rotation back onto SO(3) so chained f32 compositions do
    not drift from orthonormality, which the clamped-trace rotation metric
    would read as phantom rotation error (``sdpl_slam_tpu.ops.lie``)."""
    RtR = R.transpose(-1, -2) @ R
    return 0.5 * (R @ (3.0 * _eye(3, R) - RtR))


def se3_orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """``so3_orthonormalize`` on the rotation block of (..., 4, 4) poses."""
    out = T.clone()
    out[..., :3, :3] = so3_orthonormalize(T[..., :3, :3])
    return out


def transform_point(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply poses (..., 4, 4) to point sets (..., N, 3) -> (..., N, 3).

    The leading dims of ``x`` (before N) broadcast against those of ``T``;
    a single point is a set of one.  Full f32: the package turns TF32 off.
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return x @ R.transpose(-1, -2) + t.unsqueeze(-2)


def line_transform_6x6(T: torch.Tensor) -> torch.Tensor:
    """The 6x6 Pluecker-line motion matrix [[R, hat(t) R], [0, R]] of poses
    (..., 4, 4), acting on L = [n, d] (the reference's
    ``LineTransformation``, edge_se3_ortho_line.cpp:100-109)."""
    R = T[..., :3, :3]
    top = torch.cat([R, hat(T[..., :3, 3]) @ R], -1)
    bot = torch.cat([torch.zeros_like(R), R], -1)
    return torch.cat([top, bot], -2)
