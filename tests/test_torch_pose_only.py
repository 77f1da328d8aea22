"""``solve_pose_only`` and ``inject_depth_noise`` of the port against the
JAX package, on a seeded synthetic problem (300 points, 40 lines, gross
outliers among both, padded rows).  In float64 the two solvers agree to
1e-9 (the same algorithm); in float32, as both run it, the inlier sets are
identical and the pose agrees to 5e-5 (measured 2.2e-5 m without lines,
3e-6 with): near the optimum the accept test ``new_cost < cost`` compares
costs that differ by float32 rounding, so the two runs take different
last steps of ~1e-5 m.  The line Jacobian in float64 is within 1e-6 of the
largest entry of ``jax.jacfwd``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpl_slam_tpu.ops import geometry as jg
from sdpl_slam_tpu.ops import lie as jlie
from sdpl_slam_tpu.solvers import frame_solvers as jfs
from sdpl_slam_torch.ops import geometry as tg
from sdpl_slam_torch.solvers import frame_solvers as tfs

torch.set_num_threads(2)
N, M = 300, 40
KW = dict(fx=360.0, fy=360.0, cx=320.0, cy=96.0)
KJ, KT = jg.Intrinsics(**KW), tg.Intrinsics(**KW)


def _project(T, X):
    Xc = X @ T[:3, :3].T + T[:3, 3]
    return np.stack([KW["fx"] * Xc[:, 0] / Xc[:, 2] + KW["cx"],
                     KW["fy"] * Xc[:, 1] / Xc[:, 2] + KW["cy"]], -1).astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    xi = np.array([0.01, 0.02, -0.01, 0.1, 0.02, 0.5], np.float32)
    T_true = np.array(jlie.se3_exp(jnp.asarray(xi)))

    def cloud(n):
        return np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                         rng.uniform(6, 40, n)], -1).astype(np.float32)

    X = cloud(N)
    obs = _project(T_true, X) + rng.normal(0, 0.05, (N, 2)).astype(np.float32)
    obs[:30] += 20 + rng.normal(0, 8, (30, 2)).astype(np.float32)  # gross outliers
    valid = np.ones(N, bool)
    valid[-20:] = False
    Xs = cloud(M)
    Xe = Xs + rng.uniform(-2, 2, (M, 3)).astype(np.float32)
    ps = _project(T_true, Xs) + rng.normal(0, 0.1, (M, 2)).astype(np.float32)
    pe = _project(T_true, Xe) + rng.normal(0, 0.1, (M, 2)).astype(np.float32)
    ps[:4] += 15                                               # outlier lines
    lco = np.array(jg.infinite_line_image(jnp.asarray(ps), jnp.asarray(pe)))
    lval = np.ones(M, bool)
    lval[-5:] = False                                          # padded rows
    Xs[-5:] = 0
    Xe[-5:] = 0
    lco[-5:] = 0
    args = (np.eye(4, dtype=np.float32), X, obs, valid, Xs, Xe, lco, lval)
    return args, T_true


@pytest.mark.parametrize("use_lines", [True, False])
def test_solve_pose_only_float64_matches_jax(problem, use_lines):
    args, _ = problem
    wide = [a if a.dtype == bool else a.astype(np.float64) for a in args]
    with jax.enable_x64():
        rj = jax.jit(lambda *a: jfs.solve_pose_only(*a, KJ, use_lines=use_lines))(
            *(jnp.asarray(a) for a in wide))
        pose_j = np.asarray(rj.pose)
        inl_j = np.asarray(rj.point_inlier), np.asarray(rj.line_inlier)
    rt = tfs.solve_pose_only(*(torch.from_numpy(a) for a in wide), KT,
                             use_lines=use_lines)
    assert rt.pose.dtype == torch.float64
    np.testing.assert_allclose(rt.pose.numpy(), pose_j, atol=1e-9)
    np.testing.assert_array_equal(rt.point_inlier.numpy(), inl_j[0])
    np.testing.assert_array_equal(rt.line_inlier.numpy(), inl_j[1])


@pytest.mark.parametrize("use_lines", [True, False])
def test_solve_pose_only_matches_jax(problem, use_lines):
    args, T_true = problem
    rj = jax.jit(lambda *a: jfs.solve_pose_only(*a, KJ, use_lines=use_lines))(
        *(jnp.asarray(a) for a in args))
    rt = tfs.solve_pose_only(*(torch.from_numpy(a) for a in args), KT,
                             use_lines=use_lines)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=5e-5)
    np.testing.assert_array_equal(rt.point_inlier.numpy(),
                                  np.asarray(rj.point_inlier))
    np.testing.assert_array_equal(rt.line_inlier.numpy(),
                                  np.asarray(rj.line_inlier))
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost),
                               rtol=1e-3)
    # the gross outliers and the padded rows are gated out, the rest kept
    inl = rt.point_inlier.numpy()
    assert not inl[:30].any() and not inl[-20:].any() and inl[30:-20].mean() > 0.9
    linl = rt.line_inlier.numpy()
    if use_lines:
        # (line coefficients are normalised as 3-vectors, so a line
        # residual is far below a pixel and its gate rarely bites)
        assert not linl[-5:].any() and linl[4:-5].all()
    else:
        assert not linl.any()
    assert np.abs(rt.pose.numpy() - T_true).max() < 2e-3


def test_line_jacobian_matches_jacfwd(problem):
    """Closed form against ``jax.jacfwd`` of the JAX residual, float64."""
    args, T_true = problem
    _, _, _, _, Xs, Xe, lco, _ = args
    Xs, Xe, lco = Xs[:-5], Xe[:-5], lco[:-5]
    with jax.enable_x64():
        Xs64, Xe64, l64 = (jnp.asarray(a, jnp.float64) for a in (Xs, Xe, lco))
        T64 = jnp.asarray(T_true, jnp.float64)

        def res(dxi):
            T2 = jlie.se3_exp(dxi) @ T64
            ps = jg.project(KJ, jlie.transform_point(T2, Xs64))
            pe = jg.project(KJ, jlie.transform_point(T2, Xe64))
            return jnp.stack([jg.point_to_image_line(ps, l64),
                              jg.point_to_image_line(pe, l64)], -1)

        J_j = np.asarray(jax.jacfwd(res)(jnp.zeros(6, jnp.float64)))
        r_j = np.asarray(res(jnp.zeros(6, jnp.float64)))
    r_t, J_t = tfs.pose_only_line_parts(
        torch.from_numpy(T_true).double(), torch.from_numpy(Xs).double(),
        torch.from_numpy(Xe).double(), torch.from_numpy(lco).double(), KT)
    assert J_j.shape == (M - 5, 2, 6)
    np.testing.assert_allclose(J_t.numpy(), J_j, atol=1e-6 * np.abs(J_j).max())
    np.testing.assert_allclose(r_t.numpy(), r_j, atol=1e-9)


def test_line_parts_zero_padded_rows():
    """Padded lines (zero endpoints, zero coefficients) give zero residual
    and Jacobian rows, not NaN, also at the identity pose where their
    depth is zero."""
    z3 = torch.zeros(2, 3)
    r, J = tfs.pose_only_line_parts(torch.eye(4), z3, z3, z3, KT)
    assert torch.equal(r, torch.zeros(2, 2)) and torch.equal(J, torch.zeros(2, 2, 6))


def test_inject_depth_noise_with_jax_draws():
    rng = np.random.default_rng(1)
    z = rng.uniform(1, 60, 500).astype(np.float32)
    key = jax.random.PRNGKey(42)
    want = np.asarray(jfs.inject_depth_noise(key, jnp.asarray(z)))
    draws = np.array(jax.random.normal(key, z.shape, jnp.float32))
    got = tfs.inject_depth_noise(torch.from_numpy(z), torch.from_numpy(draws))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert np.abs(want - z).max() > 0.1            # sigma = z^2/362.5*0.15
