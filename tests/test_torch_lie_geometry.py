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
            tfr.grid_sample_uv(375, 1242, n_points=3000), 0.0)


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
