"""Per-frame solvers: the joint flow+pose / flow+object-motion LM, batched
over lanes, and the pose-only LM of the non-joint path.

Counterpart of the JAX package's ``solvers.frame_solvers.solve_flow_pose``
(reference Optimizer.cc:6409 ``PoseOptimizationFlow2CamWithLines`` and
:7603 ``PoseOptimizationFlow2withLines``): one SE(3) vertex plus one
marginalised 2-dof flow per point and 4-dof flow per line.  Every flow
touches only the pose, so each feature's block is eliminated in closed
form (2x2 points, 4x4 lines) and reduced into one damped 6x6 system.

Edge semantics are the JAX package's, quirks included: the flow-line
edge's second residual component is identically zero in the error while
both Jacobian rows contribute curvature; info 0.1 / prior 0.3 (camera) or
0.5 (object); Huber sqrt(rp_thres) for points and sqrt(W*7.815) for lines
with W = 2^-(n_points // 100); post-solve chi2 gating.

Batching: the JAX solver is single-problem and ``vmap``-ed over objects,
with ``lax.while_loop`` stopping each lane on its own condition.  Here the
lanes are a leading batch dim and the loop freezes every finished lane
(its state is kept with ``torch.where``), so each lane follows exactly the
iterations its JAX counterpart runs, and iterations past the exit change
nothing.  The loop is state plus body: :func:`lm_init` makes the
fixed-shape :class:`LMState` with the device bool ``active_any`` (some
lane still active), :func:`lm_iteration` updates it in place, and
:func:`lm_finish` gates the outliers.  Run eagerly, the loop reads
``active_any`` on the host before every iteration (one host sync each,
counted in ``FlowPoseResult.host_syncs``).  Under a
``utils.cuda_graphs.loop_runner`` a caller takes the loop instead:
``models.resident`` captures the body into a CUDA graph and ends the loop
on the device (a conditional WHILE node).

The flow Jacobian of the line residual (``jax.jacfwd`` in JAX) is written
in closed form: with c = p_h x q_h, n = sqrt(c.c + eps), l = c / n and
e_k = l . h_k, de_k/dc = (h_k - l e_k) / n, and dc/dP, dc/dQ are cross
products with q_h and p_h.

:func:`solve_pose_only` is the non-joint solver (``bJoint = false``;
reference Optimizer.cc:5742 / :5900 ``PoseOptimizationNew(WithLines)``):
pose-only LM on fixed 3D structure, four gating rounds of a fixed
100 / 10 / 10 / 10 iterations, no host read inside.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import geometry, lie
from ..ops.geometry import Intrinsics
from ..utils.cuda_graphs import run_loop


class PointBundle(NamedTuple):
    """Fixed-capacity tracked points for one solve (leading lane dims
    allowed): obs (..., N, 2) last-frame pixels, flow0 (..., N, 2) measured
    flow (the prior), depth (..., N) last-frame depth, valid (..., N)."""

    obs: torch.Tensor
    flow0: torch.Tensor
    depth: torch.Tensor
    valid: torch.Tensor


class LineBundle(NamedTuple):
    """Fixed-capacity tracked segments: obs (..., M, 4) last-frame
    endpoints (sx, sy, ex, ey), flow0 (..., M, 4), depth (..., M, 2),
    valid (..., M)."""

    obs: torch.Tensor
    flow0: torch.Tensor
    depth: torch.Tensor
    valid: torch.Tensor


class FlowPoseResult(NamedTuple):
    pose: torch.Tensor           # (..., 4, 4) optimised T (camera T_cw or object G)
    flow: torch.Tensor           # (..., N, 2) optimised point flows
    line_flow: torch.Tensor      # (..., M, 4) optimised line endpoint flows
    point_inlier: torch.Tensor   # (..., N) bool
    line_inlier: torch.Tensor    # (..., M) bool
    n_iters: torch.Tensor        # (...,) LM iterations executed per lane
    final_cost: torch.Tensor     # (...,) robustified total chi2
    host_syncs: int              # loop-exit tests read on the host


def _huber_weight(chi2, delta):
    """g2o RobustKernelHuber rho'(chi2): 1 inside, delta/sqrt(chi2) outside."""
    safe = torch.clamp(chi2, min=1e-20)
    return torch.where(chi2 <= delta * delta, torch.ones_like(chi2),
                       delta / torch.sqrt(safe))


def _huber_rho(chi2, delta):
    """g2o RobustKernelHuber rho(chi2)."""
    safe = torch.clamp(chi2, min=1e-20)
    return torch.where(chi2 <= delta * delta, chi2,
                       2.0 * delta * torch.sqrt(safe) - delta * delta)


def _point_proj_jacobian(xyz: torch.Tensor, fx: float, fy: float) -> torch.Tensor:
    """d[(obs+f) - pi(T X)]/d(delta_xi) at 0, [omega, v] order
    (EdgeSE3ProjectFlow2::linearizeOplus).  (..., 3) -> (..., 2, 6)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    z2 = z * z
    zero = torch.zeros_like(x)
    row_u = torch.stack([x * y / z2 * fx, -(1.0 + x * x / z2) * fx, y / z * fx,
                         -1.0 / z * fx, zero, x / z2 * fx], -1)
    row_v = torch.stack([(1.0 + y * y / z2) * fy, -x * y / z2 * fy, -x / z * fy,
                         zero, -1.0 / z * fy, y / z2 * fy], -1)
    return torch.stack([row_u, row_v], -2)


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def line_flow_jacobian(g, obs4, ps, pe, eps: float = 1e-12):
    """d[l(P, Q) . (ps, pe)_h]/d g, P = obs[:2] + g[:2], Q = obs[2:] + g[2:]
    -- ``jax.jacfwd(_line_flow_part)`` in closed form.  (..., 4) flows and
    (..., 2) projections -> (..., 2, 4)."""
    ph = _homog(obs4[..., :2] + g[..., :2])
    qh = _homog(obs4[..., 2:] + g[..., 2:])
    c = torch.linalg.cross(ph, qh)
    n = torch.sqrt(torch.sum(c * c, -1, keepdim=True) + eps)
    l = c / n
    rows = []
    for p in (ps, pe):
        h = _homog(p)
        v = (h - l * torch.sum(l * h, -1, keepdim=True)) / n
        dP = torch.linalg.cross(qh, v)[..., :2]
        dQ = torch.linalg.cross(v, ph)[..., :2]
        rows.append(torch.cat([dP, dQ], -1))
    return torch.stack(rows, -2)


def inject_depth_noise(z: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """Gaussian depth-noise injection of the non-joint solvers
    (``addnoise=1``, Frame::UnprojectStereoStat, reference
    src/Frame.cc:1140-1150): sigma = z^2 / (725 * 0.5) * 0.15.  ``draws``
    are standard-normal samples of ``z``'s shape, an argument because no
    torch generator reproduces ``jax.random.normal``."""
    sigma = z * z / (725.0 * 0.5) * 0.15
    return z + sigma * draws


class PoseOnlyResult(NamedTuple):
    pose: torch.Tensor
    point_inlier: torch.Tensor
    line_inlier: torch.Tensor
    final_cost: torch.Tensor


def pose_only_line_parts(T, line_Xs, line_Xe, line_coeffs, K: Intrinsics):
    """Residual (M, 2) and Jacobian (M, 2, 6) of the pose-only line edge
    r = [l . h(pi(T Xs)), l . h(pi(T Xe))] for a left perturbation
    exp(dxi) T, [omega, v] order: row k is l_2d . d pi / d xi, the negative
    of :func:`_point_proj_jacobian` (which carries the (obs - pi) sign) --
    ``jax.jacfwd`` of the residual in the JAX package, in closed form.
    Non-finite entries (padded lines) become zeros."""
    l2 = line_coeffs[..., :2]
    r, J = [], []
    for X in (line_Xs, line_Xe):
        xyz = lie.transform_point(T, X)
        r.append(geometry.point_to_image_line(geometry.project(K, xyz),
                                              line_coeffs))
        J.append(torch.einsum("mk,mki->mi", l2,
                              -_point_proj_jacobian(xyz, K.fx, K.fy)))
    return (torch.nan_to_num(torch.stack(r, -1)),
            torch.nan_to_num(torch.stack(J, -2)))


def solve_pose_only(
    T_init: torch.Tensor,
    X_w: torch.Tensor,          # (N, 3) fixed 3D (world) from the last frame
    obs_uv: torch.Tensor,       # (N, 2) current 2D observations
    valid: torch.Tensor,
    line_Xs: torch.Tensor,      # (M, 3) line endpoint 3D (world)
    line_Xe: torch.Tensor,
    line_coeffs: torch.Tensor,  # (M, 3) measured infinite-line coefficients
    line_valid: torch.Tensor,
    K: Intrinsics,
    rp_thres: float = 0.01,
    line_weight_thr: int = 50,
    use_lines: bool = True,
) -> PoseOnlyResult:
    """Pose-only (or motion-only) LM on fixed 3D structure.

    Residuals: r_p = obs - pi(T X_w) (info I, Huber sqrt(rp_thres));
    r_l = [l . h(pi(T Xs)), l . h(pi(T Xe))] with the measured current
    infinite line l (info I, Huber sqrt(W*7.815), W = 2^-(n//50)).
    Four gating rounds of {100,10,10,10} iterations with chi2 thresholds
    {rp_thres, 5.991, 5.991, 5.991} (Optimizer.cc:5832,6080); outliers are
    excluded per round and may re-enter.  Every round runs its full count
    (a rejected step only raises the damping), so the solve reads nothing
    on the host.  A round is a loop body over in-place state with a
    counter on the device: without a ``utils.cuda_graphs.loop_runner`` the
    host runs it its fixed count; under one (the captured non-joint frame,
    ``models.frame_program.nonjoint_program``) it becomes a WHILE node, so
    the graph holds each body once, not 130 unrolled iterations.
    """
    dtype, dev = X_w.dtype, X_w.device
    n_valid0 = valid.sum(dtype=torch.int32)
    weight = torch.pow(2.0, -(n_valid0 // line_weight_thr).to(dtype))
    delta_line = torch.sqrt(weight * 7.815)
    delta_mono = float(np.sqrt(np.float32(rp_thres)))
    lvalid0 = line_valid & bool(use_lines)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def residuals(T):
        xyz = lie.transform_point(T, X_w)
        r_p = obs_uv - geometry.project(K, xyz)
        r_l, J_l = pose_only_line_parts(T, line_Xs, line_Xe, line_coeffs, K)
        return (r_p, torch.sum(r_p * r_p, -1), r_l, torch.sum(r_l * r_l, -1),
                xyz, J_l)

    def lm_round(T, active_p, active_l, iters):
        pv = (valid & active_p).to(dtype)
        lv = (lvalid0 & active_l).to(dtype)

        def cost_of(chi2_p, chi2_l):
            return (torch.sum(pv * _huber_rho(chi2_p, delta_mono))
                    + torch.sum(lv * _huber_rho(chi2_l, delta_line)))

        def cost_fn(Tc):
            _, chi2_p, _, chi2_l, _, _ = residuals(Tc)
            return cost_of(chi2_p, chi2_l)

        # the round's state, written in place by the body; device fills,
        # not copies from host memory: capturable
        T = T.clone()
        lam = torch.full((), 1e-4, dtype=dtype, device=dev)
        cost = cost_fn(T)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        more = torch.full((), iters > 0, dtype=torch.bool, device=dev)

        def body():
            r_p, chi2_p, r_l, chi2_l, xyz, Jl = residuals(T)
            w_p = pv * _huber_weight(chi2_p, delta_mono)
            w_l = lv * _huber_weight(chi2_l, delta_line)
            Jp = _point_proj_jacobian(xyz, K.fx, K.fy)
            H = (torch.einsum("nki,nkj,n->ij", Jp, Jp, w_p)
                 + torch.einsum("mki,mkj,m->ij", Jl, Jl, w_l))
            b = -(torch.einsum("nki,nk,n->i", Jp, r_p, w_p)
                  + torch.einsum("mki,mk,m->i", Jl, r_l, w_l))
            dxi = torch.linalg.solve_ex(H + lam * eye6, b)[0]
            T_new = lie.se3_retract(T, dxi)
            new_cost = cost_fn(T_new)
            accept = (new_cost < cost) & torch.isfinite(new_cost)
            lam.copy_(torch.where(accept, lam * 0.5, lam * 4.0))
            T.copy_(torch.where(accept, T_new, T))
            cost.copy_(torch.where(accept, new_cost, cost))
            it.add_(1)
            more.copy_(it < iters)

        if not run_loop(body, more):
            for _ in range(iters):          # a fixed count: nothing to read
                body()
        return T, cost

    T = T_init
    active_p = torch.ones_like(valid)
    active_l = torch.ones_like(line_valid)
    for gate, iters in zip((rp_thres, 5.991, 5.991, 5.991),
                           (100, 10, 10, 10)):
        T, cost = lm_round(T, active_p, active_l, iters)
        _, chi2_p, _, chi2_l, _, _ = residuals(T)
        active_p = chi2_p <= gate
        active_l = chi2_l <= weight * 7.815
    return PoseOnlyResult(
        # SE(3) projection of the LM composition chain (lie.so3_orthonormalize)
        pose=lie.se3_orthonormalize(T),
        point_inlier=valid & active_p,
        line_inlier=lvalid0 & active_l,
        final_cost=cost,
    )


class _FlowPoseProblem:
    """The constant part of one batched joint LM: the inputs, the
    unprojected points and the residual and step functions."""

    def __init__(self, T_init, T_wl, points: PointBundle, lines: LineBundle,
                 K: Intrinsics, rp_thres, proj_info, flow_prior_info,
                 line_proj_info, line_prior_info, line_weight_thr,
                 max_iterations, use_lines, rel_tol):
        dtype = points.obs.dtype
        dev = points.obs.device
        self.points, self.lines, self.K = points, lines, K
        self.rp_thres, self.proj_info = rp_thres, proj_info
        self.flow_prior_info = flow_prior_info
        self.line_proj_info, self.line_prior_info = line_proj_info, line_prior_info
        self.line_weight_thr, self.max_iterations = line_weight_thr, max_iterations
        self.use_lines, self.rel_tol = use_lines, rel_tol
        self.dtype, self.dev = dtype, dev
        self.eye4 = torch.eye(4, dtype=dtype, device=dev)
        self.eye6 = torch.eye(6, dtype=dtype, device=dev)
        self.T_init = T_init

        self.pvalid = points.valid.to(dtype)
        self.lvalid = lines.valid.to(dtype) * (1.0 if use_lines else 0.0)
        self.lmask = lines.valid[..., None, None]

        # constant unprojections through the last pose
        self.Xw = lie.transform_point(
            T_wl, geometry.backproject(K, points.obs, points.depth))
        self.Xw_s = lie.transform_point(
            T_wl, geometry.backproject(K, lines.obs[..., :2], lines.depth[..., 0]))
        self.Xw_e = lie.transform_point(
            T_wl, geometry.backproject(K, lines.obs[..., 2:], lines.depth[..., 1]))

        self.delta_mono = float(np.sqrt(np.float32(rp_thres)))
        # W = 2^-(n_initial_points // thr), integer division (Optimizer.cc:6540)
        n_init_pts = points.valid.sum(-1, dtype=torch.int32)
        weight0 = torch.pow(2.0, -(n_init_pts // line_weight_thr).to(dtype))
        self.delta_line = torch.sqrt(weight0 * 7.815)[:, None]   # (B, 1)

    def line_parts(self, T, g):
        K, lines = self.K, self.lines
        xyz_s = lie.transform_point(T, self.Xw_s)
        xyz_e = lie.transform_point(T, self.Xw_e)
        ps = geometry.project(K, xyz_s)
        pe = geometry.project(K, xyz_e)
        l = geometry.infinite_line_image(lines.obs[..., :2] + g[..., :2],
                                         lines.obs[..., 2:] + g[..., 2:])
        e0 = geometry.point_to_image_line(ps, l)
        return xyz_s, xyz_e, ps, pe, l, e0

    def residuals_and_cost(self, T, f, g):
        points, lines, K = self.points, self.lines, self.K
        xyz = lie.transform_point(T, self.Xw)
        r_p = (points.obs + f) - geometry.project(K, xyz)
        chi2_p = self.proj_info * torch.sum(r_p * r_p, -1)
        r_f = f - points.flow0
        chi2_f = self.flow_prior_info * torch.sum(r_f * r_f, -1)
        cost = torch.sum(
            self.pvalid * (_huber_rho(chi2_p, self.delta_mono) + chi2_f), -1)
        if not self.use_lines:
            return cost, (xyz, r_p, r_f, chi2_p, None, None, None)
        # second component identically zero in the error (reference quirk);
        # invalid padded lines hard-zeroed (0 * NaN would poison the cost)
        e0 = self.line_parts(T, g)[5]
        r_l = torch.stack([e0, torch.zeros_like(e0)], -1)
        r_l = torch.where(lines.valid[..., None], torch.nan_to_num(r_l),
                          torch.zeros_like(r_l))
        chi2_l = self.line_proj_info * torch.sum(r_l * r_l, -1)
        r_g = g - lines.flow0
        chi2_g = self.line_prior_info * torch.sum(r_g * r_g, -1)
        cost = cost + torch.sum(
            self.lvalid * (_huber_rho(chi2_l, self.delta_line) + chi2_g), -1)
        return cost, (xyz, r_p, r_f, chi2_p, r_l, r_g, chi2_l)

    def build_and_solve(self, T, f, g, lam):
        """One damped Gauss-Newton (LM trial) step per lane."""
        points, lines, K = self.points, self.lines, self.K
        fx, fy = K.fx, K.fy
        pvalid, lvalid, lmask = self.pvalid, self.lvalid, self.lmask
        proj_info, flow_prior_info = self.proj_info, self.flow_prior_info
        eye4, eye6 = self.eye4, self.eye6
        cost, (xyz, r_p, r_f, chi2_p, r_l, r_g, chi2_l) = \
            self.residuals_and_cost(T, f, g)
        lam_ = lam[:, None]
        # --- points: J_f = I2; Hff_i = (w_p + w_f + lam) I2 ---
        Jx = _point_proj_jacobian(xyz, fx, fy)                   # (B,N,2,6)
        w_p = pvalid * _huber_weight(chi2_p, self.delta_mono) * proj_info
        w_f = pvalid * flow_prior_info
        Hxx = torch.einsum("bnki,bnkj,bn->bij", Jx, Jx, w_p)
        bx = -torch.einsum("bnki,bnk,bn->bi", Jx, r_p, w_p)
        hff = torch.where(points.valid, w_p + w_f + lam_,
                          torch.ones_like(w_p))
        inv_hff = 1.0 / hff
        bf = -(w_p[..., None] * r_p + w_f[..., None] * r_f)
        Hxf = Jx.transpose(-1, -2) * w_p[..., None, None]         # (B,N,6,2)
        Hxx = Hxx - torch.einsum("bnik,bnjk,bn->bij", Hxf, Hxf, inv_hff)
        bx = bx - torch.einsum("bnik,bnk,bn->bi", Hxf, bf, inv_hff)

        if self.use_lines:
            xyz_s, xyz_e, ps, pe, l_img, _ = self.line_parts(T, g)
            l2 = l_img[..., :2]
            Jlx = torch.stack([
                torch.einsum("bmk,bmki->bmi", l2, -_point_proj_jacobian(xyz_s, fx, fy)),
                torch.einsum("bmk,bmki->bmi", l2, -_point_proj_jacobian(xyz_e, fx, fy)),
            ], -2)                                                # (B,M,2,6)
            Jlg = line_flow_jacobian(g, lines.obs, ps, pe)        # (B,M,2,4)
            zero = torch.zeros((), dtype=self.dtype, device=self.dev)
            Jlx = torch.where(lmask, torch.nan_to_num(Jlx), zero)
            Jlg = torch.where(lmask, torch.nan_to_num(Jlg), zero)
            w_l = lvalid * _huber_weight(chi2_l, self.delta_line) * self.line_proj_info
            w_g = lvalid * self.line_prior_info
            Hxx = Hxx + torch.einsum("bmki,bmkj,bm->bij", Jlx, Jlx, w_l)
            bx = bx - torch.einsum("bmki,bmk,bm->bi", Jlx, r_l, w_l)
            Hgg = (torch.einsum("bmki,bmkj,bm->bmij", Jlg, Jlg, w_l)
                   + (w_g + lam_)[..., None, None] * eye4)
            Hgg = torch.where(lmask, Hgg, eye4)
            bg = -(torch.einsum("bmki,bmk,bm->bmi", Jlg, r_l, w_l)
                   + w_g[..., None] * r_g)
            Hxg = torch.einsum("bmki,bmkj,bm->bmij", Jlx, Jlg, w_l)
            inv_Hgg = torch.linalg.inv_ex(Hgg)[0]
            Hxx = Hxx - torch.einsum("bmik,bmkl,bmjl->bij", Hxg, inv_Hgg, Hxg)
            bx = bx - torch.einsum("bmik,bmkl,bml->bi", Hxg, inv_Hgg, bg)

        Hxx = Hxx + lam[:, None, None] * eye6
        dxi = torch.linalg.solve_ex(Hxx, bx)[0]
        df = inv_hff[..., None] * (bf - torch.einsum("bnik,bi->bnk", Hxf, dxi))
        gain_den = (torch.sum(dxi * (lam_ * dxi + bx), -1)
                    + torch.sum(pvalid[..., None] * df * (lam_[..., None] * df + bf),
                                (-1, -2)))
        if self.use_lines:
            dg = torch.einsum("bmij,bmj->bmi", inv_Hgg,
                              bg - torch.einsum("bmik,bi->bmk", Hxg, dxi))
            gain_den = gain_den + torch.sum(
                lvalid[..., None] * dg * (lam_[..., None] * dg + bg), (-1, -2))
        else:
            dg = torch.zeros_like(g)
        return cost, dxi, df, dg, gain_den

    def initial_lambda(self):
        """g2o: lambda0 = 1e-5 * max(diag(H)) with the Huber-weighted H."""
        points, K = self.points, self.K
        xyz = lie.transform_point(self.T_init, self.Xw)
        r_p = (points.obs + points.flow0) - geometry.project(K, xyz)
        chi2_p = self.proj_info * torch.sum(r_p * r_p, -1)
        w_p = (self.pvalid * _huber_weight(chi2_p, self.delta_mono)
               * self.proj_info)
        Jx = _point_proj_jacobian(xyz, K.fx, K.fy)
        diag = torch.einsum("bnki,bnki,bn->bi", Jx, Jx, w_p)
        return 1e-5 * torch.clamp(diag.max(-1).values, min=1e-3)


class LMState:
    """The joint LM's loop state: fixed-shape tensors that
    :func:`lm_iteration` updates in place, so a captured iteration reads
    and writes the same memory every time.  ``T`` (B, 4, 4), ``f``
    (B, N, 2), ``g`` (B, M, 4), ``cost`` / ``lam`` / ``nu`` (B,), ``it``
    (B,) int32, ``done`` (B,) bool, ``active_any`` () bool; ``problem`` the
    constant inputs; ``host_syncs`` the exit tests read on the host."""

    def __init__(self, problem, T, f, g, cost, lam, nu, it, done):
        self.problem = problem
        self.T, self.f, self.g, self.cost = T, f, g, cost
        self.lam, self.nu, self.it, self.done = lam, nu, it, done
        self.active_any = _any_active(done, it, problem.max_iterations)
        self.host_syncs = 0


def _active(done, it, max_iterations):
    return (~done) & (it < max_iterations)


def _any_active(done, it, max_iterations):
    return _active(done, it, max_iterations).any()


def lm_init(T_init, T_wl, points: PointBundle, lines: LineBundle,
            K: Intrinsics, rp_thres: float = 0.04, proj_info: float = 0.1,
            flow_prior_info: float = 0.5, line_proj_info: float = 0.1,
            line_prior_info: float = 0.5, line_weight_thr: int = 100,
            max_iterations: int = 100, use_lines: bool = True,
            rel_tol: float = 1e-7) -> LMState:
    """The batched joint LM's initial state (arguments as
    :func:`solve_flow_pose`, with a leading lane dim)."""
    p = _FlowPoseProblem(T_init, T_wl, points, lines, K, rp_thres,
                         proj_info, flow_prior_info, line_proj_info,
                         line_prior_info, line_weight_thr, max_iterations,
                         use_lines, rel_tol)
    T, f, g = T_init, points.flow0, lines.flow0
    cost, _ = p.residuals_and_cost(T, f, g)
    lam = p.initial_lambda()
    nu = torch.full_like(lam, 2.0)
    it = torch.zeros(T.shape[0], dtype=torch.int32, device=p.dev)
    # an empty lane (all padding) can never accept a step: done at once
    done = (p.pvalid.sum(-1) + p.lvalid.sum(-1)) < 1.0
    # the loop's own copies: lm_iteration writes them in place
    return LMState(p, T.clone(), f.clone(), g.clone(), cost, lam, nu, it, done)


def lm_iteration(s: LMState) -> None:
    """One lane-masked LM iteration, in place: lanes that are done or out
    of iterations keep their state, so running it after the exit changes
    nothing.  Ends by updating ``s.active_any``."""
    p = s.problem
    active = _active(s.done, s.it, p.max_iterations)
    c, dxi, df, dg, gain_den = p.build_and_solve(s.T, s.f, s.g, s.lam)
    T_new = lie.se3_retract(s.T, dxi)
    f_new, g_new = s.f + df, s.g + dg
    new_cost, _ = p.residuals_and_cost(T_new, f_new, g_new)
    rho = (c - new_cost) / torch.clamp(gain_den, min=1e-12)
    accept = (rho > 0) & torch.isfinite(new_cost)
    lam, nu = s.lam, s.nu
    lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam_n = torch.where(accept, lam_acc, lam * nu)
    nu_n = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
    step_sq = torch.sum(dxi * dxi, -1)
    done_n = ((accept & ((c - new_cost) < p.rel_tol * torch.clamp(c, min=1.0)))
              | (accept & (step_sq < 1e-16)) | (lam_n > 1e30))
    # finished lanes keep their state (lax.while_loop under vmap)
    take = active & accept
    s.T.copy_(torch.where(take[:, None, None], T_new, s.T))
    s.f.copy_(torch.where(take[:, None, None], f_new, s.f))
    s.g.copy_(torch.where(take[:, None, None], g_new, s.g))
    s.cost.copy_(torch.where(take, new_cost, s.cost))
    s.lam.copy_(torch.where(active, lam_n, lam))
    s.nu.copy_(torch.where(active, nu_n, nu))
    s.it.copy_(s.it + active.to(torch.int32))
    s.done.copy_(torch.where(active, done_n, s.done))
    s.active_any.copy_(_any_active(s.done, s.it, p.max_iterations))


def lm_run(s: LMState) -> LMState:
    """The loop: on the host (``while active_any``, one read an
    iteration and one at the exit) unless a ``loop_runner`` takes it."""
    if run_loop(lambda: lm_iteration(s), s.active_any):
        return s
    while True:
        s.host_syncs += 1
        if not bool(s.active_any):
            break
        lm_iteration(s)
    return s


def lm_finish(s: LMState) -> FlowPoseResult:
    """Outlier gating after the loop (Optimizer.cc:6681-6782)."""
    p = s.problem
    _, (_, _, _, chi2_p, _, _, chi2_l) = p.residuals_and_cost(s.T, s.f, s.g)
    point_inlier = p.points.valid & (chi2_p <= p.rp_thres)
    if p.use_lines:
        n_inl = point_inlier.sum(-1, dtype=torch.int32)
        weight1 = torch.pow(2.0, -(n_inl // p.line_weight_thr).to(p.dtype))
        line_inlier = p.lines.valid & (chi2_l <= (weight1 * 7.815)[:, None])
    else:
        line_inlier = torch.zeros_like(p.lines.valid)
    return FlowPoseResult(
        # SE(3) projection of the LM composition chain (lie.so3_orthonormalize)
        pose=lie.se3_orthonormalize(s.T), flow=s.f, line_flow=s.g,
        point_inlier=point_inlier, line_inlier=line_inlier,
        n_iters=s.it, final_cost=s.cost, host_syncs=s.host_syncs)


def solve_flow_pose(
    T_init: torch.Tensor,
    T_wl: torch.Tensor,
    points: PointBundle,
    lines: LineBundle,
    K: Intrinsics,
    rp_thres: float = 0.04,
    proj_info: float = 0.1,
    flow_prior_info: float = 0.5,
    line_proj_info: float = 0.1,
    line_prior_info: float = 0.5,
    line_weight_thr: int = 100,
    max_iterations: int = 100,
    use_lines: bool = True,
    rel_tol: float = 1e-7,
) -> FlowPoseResult:
    """Joint flow+pose LM with closed-form Schur elimination of the flows,
    over B independent lanes: :func:`lm_init`, the loop, :func:`lm_finish`.

    ``T_init`` (B, 4, 4) or (4, 4): initial T_cw (camera) or motion model
    G (object); ``T_wl`` (4, 4) or (B, 4, 4): inverse of the last camera
    pose; bundles with the matching leading lane dim.  ``use_lines`` is a
    Python bool: False drops the line terms entirely (their values would
    all be exact zeros).  Unbatched inputs give unbatched results.
    """
    if T_init.dim() == 2:
        r = solve_flow_pose(
            T_init[None], T_wl, PointBundle(*(a[None] for a in points)),
            LineBundle(*(a[None] for a in lines)), K, rp_thres, proj_info,
            flow_prior_info, line_proj_info, line_prior_info,
            line_weight_thr, max_iterations, use_lines, rel_tol)
        return FlowPoseResult(*(a[0] for a in r[:7]), r.host_syncs)
    s = lm_init(T_init, T_wl, points, lines, K, rp_thres, proj_info,
                flow_prior_info, line_proj_info, line_prior_info,
                line_weight_thr, max_iterations, use_lines, rel_tol)
    return lm_finish(lm_run(s))
