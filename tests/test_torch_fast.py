"""sdpl_slam_torch.ops.fast against the JAX package's FAST pyramid.

The level-0 score map is bit-exact against both the XLA version and the
Pallas kernel (run in interpret mode, as the JAX suite runs it on the
CPU): its values are integer sums, so no order of summation can differ.
The CUDA kernel against the plain version is in test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpl_slam_tpu.ops import fast as jf
from sdpl_slam_torch.ops import fast as tf
from sdpl_slam_torch.utils.synthetic import SynthSequence, kitti_config

torch.set_num_threads(2)

H, W = 375, 1242


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (H, W)).astype(np.uint8)
    synth = SynthSequence(kitti_config(n_frames=1)).frame(0).gray
    return {"noise": noise, "synth": synth}


@pytest.mark.parametrize("name", ["noise", "synth"])
@pytest.mark.parametrize("t", [20.0, 7.0])
def test_level0_score_map_bit_exact(images, name, t):
    img = images[name]
    ref_xla = np.asarray(jf.fast_score_map(jnp.asarray(img), t))
    got = tf.fast_score_map_torch(torch.from_numpy(img), t).numpy()
    assert (got > 0).sum() > 1000
    np.testing.assert_array_equal(got, ref_xla)
    ref_pallas = np.asarray(
        jf.fast_score_map_pallas(jnp.asarray(img), t, interpret=True))
    np.testing.assert_array_equal(got, ref_pallas)


def _jax_levels(img):
    out = {}
    for lvl, s, lh, lw in tf.pyramid_shapes(H, W):
        if lvl:
            out[lvl] = np.asarray(jax.image.resize(
                jnp.asarray(img, jnp.float32), (lh, lw), "linear"))
    return out


def test_resized_levels_score_maps(images):
    """Levels 1-7 from the same resized image: identical corner masks,
    scores at rtol 1e-6."""
    levels = _jax_levels(images["noise"])
    assert sorted(levels) == list(range(1, 8))
    for lvl, img in levels.items():
        for t in (20.0, 7.0):
            ref = np.asarray(jf.fast_score_map(jnp.asarray(img), t))
            got = tf.fast_score_map_torch(torch.from_numpy(img), t).numpy()
            np.testing.assert_array_equal(got > 0, ref > 0)
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_resize_weights_match_jax():
    """The separable weights are JAX's own (``compute_weight_mat`` as it
    evaluates under jit) to 1e-5: XLA's optimisation flags change whether
    a sample position is rounded once or twice (measured up to 3.5e-6)."""
    from jax._src.image import scale as S

    for lvl, s, lh, lw in tf.pyramid_shapes(H, W)[1:]:
        for n_in, n_out in ((H, lh), (W, lw)):
            sc, tr = S.promote_dtypes_inexact(n_out / n_in, 0.0)
            ref = np.asarray(jax.jit(lambda: S.compute_weight_mat(
                n_in, n_out, sc, tr, S._fill_triangle_kernel, True))())
            got = tf._resize_weights_np(n_in, n_out)
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_resize_matches_jax(images):
    """The resize itself.  Against the same weights evaluated in float64,
    the port's two float32 matmuls are within 1e-4 grey levels.  Against
    ``jax.image.resize`` the bound is 0.05: XLA:CPU's own float32
    evaluation is up to 2e-2 grey levels from that float64 value (measured
    0.0185 on this image, and it changes with XLA's optimisation flags);
    the corner masks downstream are held exactly by
    test_resized_levels_score_maps and the keypoints by
    test_detect_keypoints_all_levels."""
    img = images["noise"]
    levels = _jax_levels(img)
    for lvl, s, lh, lw in tf.pyramid_shapes(H, W)[1:]:
        got = tf.resize_linear(torch.from_numpy(img).float(), lh, lw).numpy()
        wy = tf._resize_weights_np(H, lh).astype(np.float64)
        wx = tf._resize_weights_np(W, lw).astype(np.float64)
        exact = wy.T @ img.astype(np.float64) @ wx
        assert np.abs(got - exact).max() <= 1e-4, lvl
        assert np.abs(got - levels[lvl]).max() <= 5e-2, lvl


@pytest.mark.parametrize("name", ["noise", "synth"])
def test_detect_keypoints_level0_identical(images, name):
    cfg = jf.FastPyramidConfig(n_levels=1, n_features=1500)
    tcfg = tf.FastPyramidConfig(n_levels=1, n_features=1500)
    img = images[name]
    uj, sj, vj = (np.asarray(a) for a in jf.detect_keypoints(jnp.asarray(img), cfg))
    ut, st, vt = (a.numpy() for a in tf.detect_keypoints(torch.from_numpy(img), tcfg))
    assert vj.sum() > 100
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ut[vt], uj[vj])
    np.testing.assert_array_equal(st, sj)


@pytest.mark.parametrize("name", ["noise", "synth"])
def test_detect_keypoints_all_levels(images, name):
    img = images[name]
    uj, _, vj = (np.asarray(a) for a in jf.detect_keypoints(jnp.asarray(img)))
    ut, _, vt = (a.numpy() for a in tf.detect_keypoints(torch.from_numpy(img)))
    ref = set(map(tuple, uj[vj]))
    got = set(map(tuple, ut[vt]))
    assert len(ref) > 500
    assert len(ref & got) >= 0.99 * len(ref), (len(ref & got), len(ref))


def test_tie_order_matches_top_k():
    """Equal scores inside one cell: both keep the lower flat index."""
    score = np.zeros((64, 64), np.float32)
    for v, u in [(3, 5), (3, 9), (7, 2), (10, 10), (20, 4), (1, 30)]:
        score[v, u] = 40.0                    # six equal maxima in cell 0
    score[40, 40] = 12.0
    uj, sj, vj = (np.asarray(a) for a in jf._grid_topk(jnp.asarray(score), 32, 4))
    ut, st, vt = (a.numpy() for a in tf._grid_topk(torch.from_numpy(score), 32, 4))
    np.testing.assert_array_equal(ut, uj)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(vt, vj)
    # global top-k over a vector of ties
    x = np.array([3.0, 5.0, 5.0, -1.0, 5.0, 3.0], np.float32)
    _, ij = jax.lax.top_k(jnp.asarray(x), 4)
    _, it = tf._topk_stable(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_nms3_matches_jax():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 4, (50, 70)).astype(np.float32)
    np.testing.assert_array_equal(
        tf._nms3(torch.from_numpy(s)).numpy(),
        np.asarray(jf._nms3(jnp.asarray(s))))


def test_wrapper_dispatches_on_device_and_checks_inputs(images):
    img = torch.from_numpy(images["synth"]).float()
    before = tf.fast_score_maps.launches
    hi, lo = tf.fast_score_maps(img, 20.0, 7.0)
    assert tf.fast_score_maps.launches == before     # CPU: no kernel
    assert torch.equal(hi, tf.fast_score_map_torch(img, 20.0))
    assert torch.equal(lo, tf.fast_score_map_torch(img, 7.0))
    with pytest.raises(ValueError):
        tf.fast_score_maps(img.double(), 20.0, 7.0)
    with pytest.raises(ValueError):
        tf.fast_score_maps(img[None], 20.0, 7.0)
    with pytest.raises(ValueError):
        tf.fast_score_maps(img.t(), 20.0, 7.0)
