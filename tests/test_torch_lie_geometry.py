"""sdpl_slam_torch.ops.{lie, geometry} and models.frame against the JAX
package on random batches.  f32 on both sides; atol 1e-5 on unit-scale
values (the f32 tolerance of the JAX package's own on-chip checks), scaled
by the magnitude where values are pixels or metres."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpl_slam_tpu.models import frame as jfr
from sdpl_slam_tpu.ops import geometry as jg
from sdpl_slam_tpu.ops import lie as jl
from sdpl_slam_torch.models import frame as tfr
from sdpl_slam_torch.ops import geometry as tg
from sdpl_slam_torch.ops import lie as tl

torch.set_num_threads(2)

KJ = jg.Intrinsics(jnp.float32(721.5377), jnp.float32(721.5377),
                   jnp.float32(609.5593), jnp.float32(172.854))
KT = tg.Intrinsics(721.5377, 721.5377, 609.5593, 172.854)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _xi(n, rng, scale=0.5):
    xi = rng.normal(size=(n, 6)).astype(np.float32) * scale
    xi[:3] = 1e-7 * xi[:3]                  # the small-angle branch too
    return xi


def _poses(n, rng):
    return np.array(jax.vmap(jl.se3_exp)(jnp.asarray(_xi(n, rng))))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), atol=atol, rtol=rtol)


def case_so3_exp(rng):
    w = _xi(64, rng)[:, :3]
    return jax.vmap(jl.so3_exp)(jnp.asarray(w)), tl.so3_exp(_t(w)), 1e-5


def case_se3_exp(rng):
    xi = _xi(64, rng)
    return jax.vmap(jl.se3_exp)(jnp.asarray(xi)), tl.se3_exp(_t(xi)), 1e-5


def case_se3_inv(rng):
    T = _poses(64, rng)
    return jax.vmap(jl.se3_inv)(jnp.asarray(T)), tl.se3_inv(_t(T)), 1e-5


def case_se3_retract(rng):
    T, xi = _poses(64, rng), _xi(64, rng, 0.05)
    return (jax.vmap(jl.se3_retract)(jnp.asarray(T), jnp.asarray(xi)),
            tl.se3_retract(_t(T), _t(xi)), 1e-5)


def case_se3_orthonormalize(rng):
    T = _poses(64, rng)
    T[:, :3, :3] += rng.normal(size=(64, 3, 3)).astype(np.float32) * 1e-4
    return (jax.vmap(jl.se3_orthonormalize)(jnp.asarray(T)),
            tl.se3_orthonormalize(_t(T)), 1e-5)


def case_transform_point(rng):
    T = _poses(8, rng)
    x = rng.normal(size=(8, 100, 3)).astype(np.float32)
    return (jax.vmap(jl.transform_point)(jnp.asarray(T), jnp.asarray(x)),
            tl.transform_point(_t(T), _t(x)), 1e-5)


def case_project(rng):
    X = rng.uniform([-10, -3, 2], [10, 3, 40], size=(500, 3)).astype(np.float32)
    # pixels ~1e3: the unit-scale tolerance at their magnitude
    return jg.project(KJ, jnp.asarray(X)), tg.project(KT, _t(X)), 1e-5 * 1e3


def case_backproject(rng):
    uv = rng.uniform([0, 0], [1242, 375], size=(500, 2)).astype(np.float32)
    z = rng.uniform(1, 40, size=500).astype(np.float32)
    return (jg.backproject(KJ, jnp.asarray(uv), jnp.asarray(z)),
            tg.backproject(KT, _t(uv), _t(z)), 1e-5 * 40)


def case_infinite_line_image(rng):
    p = rng.uniform(0, 1242, size=(500, 2)).astype(np.float32)
    q = rng.uniform(0, 1242, size=(500, 2)).astype(np.float32)
    return (jg.infinite_line_image(jnp.asarray(p), jnp.asarray(q)),
            tg.infinite_line_image(_t(p), _t(q)), 1e-5)


def case_point_to_image_line(rng):
    pix = rng.uniform(0, 1242, size=(500, 2)).astype(np.float32)
    l = rng.normal(size=(500, 3)).astype(np.float32)
    l /= np.linalg.norm(l, axis=1, keepdims=True)
    return (jg.point_to_image_line(jnp.asarray(pix), jnp.asarray(l)),
            tg.point_to_image_line(_t(pix), _t(l)), 1e-5 * 1e3)


def case_plucker_from_endpoints(rng):
    p = rng.normal(size=(500, 3)).astype(np.float32)
    q = rng.normal(size=(500, 3)).astype(np.float32)
    return (jg.plucker_from_endpoints(jnp.asarray(p), jnp.asarray(q)),
            tg.plucker_from_endpoints(_t(p), _t(q)), 1e-5)


def case_transform_plucker(rng):
    T = _poses(1, rng)[0]
    p = rng.normal(size=(200, 3)).astype(np.float32)
    L = np.asarray(jg.plucker_from_endpoints(
        jnp.asarray(p), jnp.asarray(p + rng.normal(size=(200, 3)).astype(np.float32))))
    return (jg.transform_plucker(jnp.asarray(T), jnp.asarray(L)),
            tg.transform_plucker(_t(T), _t(L)), 1e-5)


def case_point_to_plucker_distance(rng):
    p = rng.normal(size=(200, 3)).astype(np.float32)
    L = np.asarray(jg.plucker_from_endpoints(
        jnp.asarray(rng.normal(size=(200, 3)).astype(np.float32)),
        jnp.asarray(rng.normal(size=(200, 3)).astype(np.float32))))
    return (jg.point_to_plucker_distance(jnp.asarray(p), jnp.asarray(L)),
            tg.point_to_plucker_distance(_t(p), _t(L)), 1e-5)


def case_world_points(rng):
    T = _poses(1, rng)[0]
    uv = rng.uniform([0, 0], [1242, 375], size=(300, 2)).astype(np.float32)
    z = rng.uniform(1, 20, size=300).astype(np.float32)
    return (jfr.world_points(KJ, jnp.asarray(T), jnp.asarray(uv), jnp.asarray(z)),
            tfr.world_points(KT, _t(T), _t(uv), _t(z)), 1e-5 * 20)


def case_grid_sample_uv(rng):
    return (jfr.grid_sample_uv(375, 1242, n_points=3000),
            tfr.grid_sample_uv(375, 1242, n_points=3000, device="cpu"), 0.0)


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_matches_jax(case):
    ref, got, atol = case(_rng())
    assert tuple(got.shape) == tuple(np.shape(ref))
    assert got.dtype == torch.float32
    _close(ref, got.numpy(), atol=atol)


def test_orthonormalize_restores_rotation():
    rng = _rng(1)
    T = _poses(16, rng)
    T[:, :3, :3] += rng.normal(size=(16, 3, 3)).astype(np.float32) * 1e-4
    R = tl.se3_orthonormalize(_t(T))[:, :3, :3].double()
    err = (R.transpose(1, 2) @ R - torch.eye(3, dtype=torch.float64)).abs().max()
    assert err < 1e-6


# ---------------------------------------------------------------------------
# The Lie and line functions of batch BA, in float32 and float64.  float64
# runs JAX with x64 on; the f64 tolerance is 1e-12 on unit-scale values.
# ---------------------------------------------------------------------------


class _x64:
    def __enter__(self):
        self.prev = bool(jax.config.jax_enable_x64)
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", self.prev)


def _rotations(n, rng, dt, scale=1.0):
    w = rng.normal(size=(n, 3)) * scale
    w[: n // 4] *= 1e-6                      # near the identity
    return np.array(jax.vmap(jl.so3_exp)(jnp.asarray(w.astype(dt))))


def _lines(n, rng, dt):
    p = rng.normal(size=(n, 3)) * 5.0
    q = p + rng.normal(size=(n, 3))
    return np.array(jg.plucker_from_endpoints(jnp.asarray(p.astype(dt)),
                                              jnp.asarray(q.astype(dt))))


def ba_vee(rng, dt):
    W = rng.normal(size=(64, 3, 3)).astype(dt)
    return jax.vmap(jl.vee)(jnp.asarray(W)), tl.vee(_t(W))


def ba_so3_log(rng, dt):
    R = _rotations(64, rng, dt)
    return jax.vmap(jl.so3_log)(jnp.asarray(R)), tl.so3_log(_t(R))


def ba_se3_log(rng, dt):
    T = np.array(jax.vmap(jl.se3_exp)(jnp.asarray(
        (rng.normal(size=(64, 6)) * 0.7).astype(dt))))
    T[:16, :3, :3] = _rotations(16, rng, dt, 1e-6)
    return jax.vmap(jl.se3_log)(jnp.asarray(T)), tl.se3_log(_t(T))


def ba_rotation_angle_deg(rng, dt):
    R = _rotations(64, rng, dt)
    # degrees of a near-identity rotation from acos: 1e-3 deg of rounding
    return (jax.vmap(jl.rotation_angle_deg)(jnp.asarray(R)),
            tl.rotation_angle_deg(_t(R)), 1e3)


def ba_line_transform_6x6(rng, dt):
    T = np.array(jax.vmap(jl.se3_exp)(jnp.asarray(
        rng.normal(size=(64, 6)).astype(dt))))
    return jax.vmap(jl.line_transform_6x6)(jnp.asarray(T)), \
        tl.line_transform_6x6(_t(T))


def ba_plucker_line_distance(rng, dt):
    L1 = _lines(96, rng, dt)
    L2 = _lines(96, rng, dt)
    # parallel and coincident lines take the collinear branch
    L2[:32, 3:] = L1[:32, 3:] * np.where(np.arange(32) % 2, 1, -1)[:, None]
    L2[:16, :3] = L1[:16, :3] + np.cross(L1[:16, 3:], rng.normal(size=(16, 3)))
    L2[16:24] = -L1[16:24]
    return (jg.plucker_line_distance(jnp.asarray(L1), jnp.asarray(L2)),
            tg.plucker_line_distance(_t(L1), _t(L2)))


def ba_plucker_angle_error(rng, dt):
    L1, L2 = _lines(64, rng, dt), _lines(64, rng, dt)
    L2[:8] = L1[:8]
    return (jg.plucker_angle_error(jnp.asarray(L1), jnp.asarray(L2)),
            tg.plucker_angle_error(_t(L1), _t(L2)))


def ba_plucker_to_orthonormal(rng, dt):
    L = _lines(64, rng, dt)
    return (jg.plucker_to_orthonormal(jnp.asarray(L)),
            tg.plucker_to_orthonormal(_t(L)))


def ba_orthonormal_to_plucker(rng, dt):
    U = _rotations(64, rng, dt)
    a = rng.uniform(0, np.pi / 2, 64)
    w = np.stack([np.cos(a), np.sin(a)], -1).astype(dt)
    return (jg.orthonormal_to_plucker(jnp.asarray(U), jnp.asarray(w)),
            tg.orthonormal_to_plucker(_t(U), _t(w)))


def ba_rot_xyz(rng, dt):
    t = rng.uniform(-3, 3, 64).astype(dt)
    ref = [jax.vmap(f)(jnp.asarray(t)) for f in (jg._rot_x, jg._rot_y, jg._rot_z)]
    got = [f(_t(t)) for f in (tg._rot_x, tg._rot_y, tg._rot_z)]
    return ref, got


def ba_orthonormal_retract(rng, dt):
    U = _rotations(64, rng, dt)
    a = rng.uniform(0, np.pi / 2, 64)
    w = np.stack([np.cos(a), np.sin(a)], -1).astype(dt)
    d = (rng.normal(size=(64, 4)) * 0.3).astype(dt)
    return (jax.vmap(jg.orthonormal_retract)(jnp.asarray(U), jnp.asarray(w),
                                             jnp.asarray(d)),
            tg.orthonormal_retract(_t(U), _t(w), _t(d)))


BA_CASES = [v for k, v in sorted(globals().items()) if k.startswith("ba_")]
BA_ATOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.mark.parametrize("dt", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", BA_CASES, ids=lambda c: c.__name__[3:])
def test_ba_functions_match_jax(case, dt):
    with _x64():
        out = case(_rng(), dt)
        ref, got = out[0], out[1]
        atol = BA_ATOL[dt] * (out[2] if len(out) > 2 else 1.0)
        ref = [np.asarray(r) for r in (ref if isinstance(ref, (tuple, list))
                                       else [ref])]
    got = got if isinstance(got, (tuple, list)) else [got]
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert g.dtype == torch.from_numpy(np.zeros(1, dt)).dtype
        assert tuple(g.shape) == r.shape
        _close(r, g.numpy(), atol=atol)
