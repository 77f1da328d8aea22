"""ransac_rigid_init and solve_flow_pose against the JAX package.

RANSAC takes JAX's own draws (``jax.random.uniform(key, (S, 3))``), so
both sides align the same samples.  The LM runs on the flagship inputs of
``__graft_entry__.entry()`` (1200 points / 400 lines) and on a 2-lane
object batch in which one lane converges early, against ``jax.vmap`` of
the JAX solver.  Tolerances: pose atol 1e-4 (f32 LM on unit-scale poses);
inlier sets equal except for features whose chi2 lies within 1e-4 of the
gate, where the two f32 reduction orders may fall on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sdpl_slam_tpu.ops import geometry as jg
from sdpl_slam_tpu.ops import lie as jl
from sdpl_slam_tpu.ops import ransac as jr
from sdpl_slam_tpu.solvers import frame_solvers as jfs
from sdpl_slam_torch.ops import geometry as tg
from sdpl_slam_torch.ops import ransac as tr
from sdpl_slam_torch.solvers import frame_solvers as tfs

torch.set_num_threads(2)

KJ = jg.Intrinsics(jnp.float32(721.5377), jnp.float32(721.5377),
                   jnp.float32(609.5593), jnp.float32(172.8540))
KT = tg.Intrinsics(721.5377, 721.5377, 609.5593, 172.8540)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ransac_problem(seed, n=400):
    rng = np.random.default_rng(seed)
    T_true = np.asarray(jl.se3_exp(jnp.asarray(
        rng.normal(size=6).astype(np.float32) * [0.02, 0.02, 0.02, 0.3, 0.1, 0.6])))
    uv_last = rng.uniform([40, 40], [1200, 335], size=(n, 2)).astype(np.float32)
    z = rng.uniform(4, 30, size=n).astype(np.float32)
    X_w = np.asarray(jg.backproject(KJ, jnp.asarray(uv_last), jnp.asarray(z)))
    X_c = np.asarray(jl.transform_point(jnp.asarray(T_true), jnp.asarray(X_w)))
    uv = np.asarray(jg.project(KJ, jnp.asarray(X_c)))
    uv = uv + rng.normal(0, 0.03, uv.shape).astype(np.float32)
    out = rng.random(n) < 0.25                       # 25 % gross outliers
    uv[out] += rng.uniform(5, 40, (out.sum(), 2)).astype(np.float32)
    valid = rng.random(n) > 0.1
    return X_w, uv.astype(np.float32), X_c, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_matches_jax_with_its_draws(seed):
    X_w, uv, X_c, valid = _ransac_problem(seed)
    key = jax.random.PRNGKey(seed)
    ref = jr.ransac_rigid_init(jnp.asarray(X_w), jnp.asarray(uv),
                               jnp.asarray(X_c), jnp.asarray(valid), KJ, key,
                               n_hypotheses=128, reproj_thresh=0.4)
    u = _t(jax.random.uniform(key, (128, 3)))
    got = tr.ransac_rigid_init(_t(X_w), _t(uv), _t(X_c), _t(valid), KT, u, 0.4)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=1e-5)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) > 200


def test_ransac_lanes_are_independent():
    probs = [_ransac_problem(s) for s in (3, 4)]
    keys = [jax.random.PRNGKey(10 + s) for s in range(2)]
    u = torch.stack([_t(jax.random.uniform(k, (64, 3))) for k in keys])
    got = tr.ransac_rigid_init(*(torch.stack([_t(p[i]) for p in probs])
                                 for i in range(4)), KT, u, 0.4)
    for lane, (p, k) in enumerate(zip(probs, keys)):
        ref = jr.ransac_rigid_init(*(jnp.asarray(a) for a in p), KJ, k,
                                   n_hypotheses=64, reproj_thresh=0.4)
        np.testing.assert_allclose(got.pose[lane].numpy(), np.asarray(ref.pose),
                                   atol=1e-5)
        np.testing.assert_array_equal(got.inliers[lane].numpy(),
                                      np.asarray(ref.inliers))


def test_line_flow_jacobian_matches_jacfwd():
    rng = np.random.default_rng(5)
    g = rng.normal(size=(200, 4)).astype(np.float32)
    o4 = rng.uniform(0, 1242, size=(200, 4)).astype(np.float32)
    ps = rng.uniform(0, 1242, size=(200, 2)).astype(np.float32)
    pe = rng.uniform(0, 1242, size=(200, 2)).astype(np.float32)
    ref = jax.vmap(jax.jacfwd(jfs._line_flow_part))(
        jnp.asarray(g), jnp.asarray(o4), jnp.asarray(ps), jnp.asarray(pe))
    got = tfs.line_flow_jacobian(_t(g), _t(o4), _t(ps), _t(pe))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def entry_inputs():
    _, args = graft.entry()
    return [np.array(a) for a in args]


def _bundles(obs, flow0, depth, lobs, lflow0, ldepth, lib):
    mk = (lambda a: jnp.asarray(a)) if lib == "jax" else _t
    P = jfs.PointBundle if lib == "jax" else tfs.PointBundle
    L = jfs.LineBundle if lib == "jax" else tfs.LineBundle
    return (P(mk(obs), mk(flow0), mk(depth), mk(np.ones(obs.shape[:-1], bool))),
            L(mk(lobs), mk(lflow0), mk(ldepth), mk(np.ones(lobs.shape[:-1], bool))))


def _chi2_p(pose, flow, obs, depth, T_wl=np.eye(4, dtype=np.float64)):
    """Point chi2 (info 0.1) at a JAX solution, in float64."""
    K = [float(x) for x in KJ]
    x = (obs[:, 0] - K[2]) * depth / K[0]
    y = (obs[:, 1] - K[3]) * depth / K[1]
    X = np.stack([x, y, depth], 1) @ T_wl[:3, :3].T + T_wl[:3, 3]
    Xc = X @ np.asarray(pose, np.float64)[:3, :3].T + np.asarray(pose, np.float64)[:3, 3]
    proj = np.stack([K[0] * Xc[:, 0] / Xc[:, 2] + K[2],
                     K[1] * Xc[:, 1] / Xc[:, 2] + K[3]], 1)
    r = obs + flow - proj
    return 0.1 * (r * r).sum(1)


def _assert_inliers(got, ref, chi2_ref, thr):
    diff = np.nonzero(got != ref)[0]
    assert np.all(np.abs(chi2_ref[diff] - thr) < 1e-4), (diff, chi2_ref[diff])


def test_solve_flow_pose_flagship_step(entry_inputs):
    obs, flow0, depth, lobs, lflow0, ldepth = entry_inputs
    pj, lj = _bundles(*entry_inputs, "jax")
    ref = jax.jit(lambda p, l: jfs.solve_flow_pose(
        jnp.eye(4, dtype=jnp.float32), jnp.eye(4, dtype=jnp.float32), p, l, KJ,
        flow_prior_info=0.3, line_prior_info=0.3))(pj, lj)
    pt, lt = _bundles(*entry_inputs, "torch")
    got = tfs.solve_flow_pose(torch.eye(4), torch.eye(4), pt, lt, KT,
                              flow_prior_info=0.3, line_prior_info=0.3)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=1e-4)
    assert int(got.n_iters) == int(ref.n_iters)
    assert got.host_syncs == int(got.n_iters) + 1
    chi2 = _chi2_p(ref.pose, np.asarray(ref.flow), obs, depth)
    _assert_inliers(got.point_inlier.numpy(), np.asarray(ref.point_inlier),
                    chi2, 0.04)
    np.testing.assert_array_equal(got.line_inlier.numpy(),
                                  np.asarray(ref.line_inlier))
    np.testing.assert_allclose(got.flow.numpy(), np.asarray(ref.flow), atol=1e-3)


@pytest.mark.parametrize("use_lines", [True, False])
def test_solve_flow_pose_lanes_stop_on_their_own(entry_inputs, use_lines):
    """Lane 0 starts at identity and iterates; lane 1 starts near its own
    solution and stops after a few steps.  Each lane must follow its JAX
    counterpart under vmap, including its iteration count, and the early
    lane must end exactly where it ends when solved alone (a finished lane
    is frozen, not stepped)."""
    obs, flow0, depth, lobs, lflow0, ldepth = entry_inputs
    sl = slice(0, 800)
    lo = slice(0, 100)
    a = [obs[sl], flow0[sl], depth[sl], lobs[lo], lflow0[lo], ldepth[lo]]
    b = [obs[sl][::-1].copy(), flow0[sl][::-1].copy(), depth[sl][::-1].copy(),
         lobs[lo], lflow0[lo], ldepth[lo]]
    stacked = [np.stack([x, y]) for x, y in zip(a, b)]
    T_wl = jnp.eye(4, dtype=jnp.float32)

    def one(T, p, l):
        return jfs.solve_flow_pose(T, T_wl, p, l, KJ, flow_prior_info=0.5,
                                   line_prior_info=0.5, use_lines=use_lines,
                                   rel_tol=1e-4)

    pj, lj = _bundles(*b, "jax")
    warm = jax.jit(one)(jnp.eye(4, dtype=jnp.float32), pj, lj).pose
    nudge = jl.se3_exp(jnp.asarray([2e-3, -1e-3, 1e-3, 0.02, -0.01, 0.03],
                                   jnp.float32))
    T0 = np.stack([np.eye(4, dtype=np.float32), np.asarray(nudge @ warm)])
    pj, lj = _bundles(*stacked, "jax")
    ref = jax.jit(jax.vmap(one))(jnp.asarray(T0), pj, lj)
    pt, lt = _bundles(*stacked, "torch")
    got = tfs.solve_flow_pose(_t(T0), torch.eye(4), pt, lt, KT,
                              flow_prior_info=0.5, line_prior_info=0.5,
                              use_lines=use_lines, rel_tol=1e-4)
    it_ref = np.asarray(ref.n_iters)
    assert it_ref[1] < it_ref[0]
    np.testing.assert_array_equal(got.n_iters.numpy(), it_ref)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=1e-4)
    for lane in range(2):
        chi2 = _chi2_p(np.asarray(ref.pose[lane]), np.asarray(ref.flow[lane]),
                       stacked[0][lane], stacked[2][lane])
        _assert_inliers(got.point_inlier[lane].numpy(),
                        np.asarray(ref.point_inlier[lane]), chi2, 0.04)
        np.testing.assert_array_equal(got.line_inlier[lane].numpy(),
                                      np.asarray(ref.line_inlier[lane]))
    alone = tfs.solve_flow_pose(_t(T0[1]), torch.eye(4),
                                *_bundles(*b, "torch"), KT,
                                flow_prior_info=0.5, line_prior_info=0.5,
                                use_lines=use_lines, rel_tol=1e-4)
    assert int(alone.n_iters) == int(got.n_iters[1])
    np.testing.assert_allclose(got.pose[1].numpy(), alone.pose.numpy(),
                               atol=1e-6)
