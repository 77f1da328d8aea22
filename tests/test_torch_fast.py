"""sdpl_slam_torch.ops.fast against the JAX package's FAST pyramid.

The level-0 score map is bit-exact against both the XLA version and the
Pallas kernel (run in interpret mode, as the JAX suite runs it on the
CPU): its values are integer sums, so no order of summation can differ.
The CUDA kernel against the plain version is in test_torch_gpu.py; here a
numpy mirror of its arithmetic is held against the plain version.
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
    before = tf.fast_score_pyramid.launches
    [(hi, lo)] = tf.fast_score_pyramid([img], 20.0, 7.0)
    assert tf.fast_score_pyramid.launches == before     # CPU: no kernel
    assert torch.equal(hi, tf.fast_score_map_torch(img, 20.0))
    assert torch.equal(lo, tf.fast_score_map_torch(img, 7.0))
    with pytest.raises(ValueError):
        tf.fast_score_pyramid([img.double()], 20.0, 7.0)
    with pytest.raises(ValueError):
        tf.fast_score_pyramid([img[None]], 20.0, 7.0)
    with pytest.raises(ValueError):
        tf.fast_score_pyramid([img.t()], 20.0, 7.0)
    with pytest.raises(ValueError):                     # kernel's premise
        tf.fast_score_pyramid([img], 7.0, 20.0)
    meta = torch.empty((16, 16), device="meta")
    with pytest.raises(ValueError):
        tf.fast_score_pyramid([meta], 20.0, 7.0)
    with pytest.raises(ValueError):
        tf.fast_score_pyramid([img, meta], 20.0, 7.0)
    assert tf.fast_score_pyramid([], 20.0, 7.0) == []


# --- the CUDA kernel's shortcuts, checked where the kernel cannot run ---

_COMPASS = (1 << 0) | (1 << 4) | (1 << 8) | (1 << 12)


def _circular_run9(m):
    """Direct definition: some 9 circularly consecutive ring bits set."""
    run = np.zeros(m.shape, bool)
    for start in range(16):
        bits = sum(1 << ((start + k) % 16) for k in range(9))
        run |= (m & bits) == bits
    return run


def _best_arc(r):
    """``best_arc`` of csrc/fast_score.cu over axis 0 (the 16 ring
    samples): the largest minimum of the 16 circular windows of 9, built
    by doubling."""
    a = np.minimum(r, np.roll(r, -1, 0))
    a = np.minimum(a, np.roll(a, -2, 0))
    a = np.minimum(np.minimum(a, np.roll(a, -4, 0)), np.roll(r, -8, 0))
    return a.max(0)


def test_run9_covers_two_compass_entries_all_masks():
    """Over all 2^16 masks: every mask with a circular 9-run has at least 2
    of the compass bits {0, 4, 8, 12} set (the kernel's early exit), and
    the kernel's window minima, on the mask's bits as samples and on the
    bits negated, find exactly the circular 9-runs of ones and of zeros."""
    m = np.arange(1 << 16, dtype=np.uint32)
    run = _circular_run9(m)
    assert 0 < run.sum() < m.size
    compass = np.array([bin(x).count("1") for x in m & _COMPASS])
    assert np.all(compass[run] >= 2)
    bits = ((m[None] >> np.arange(16, dtype=np.uint32)[:, None]) & 1)
    bits = bits.astype(np.float32)
    np.testing.assert_array_equal(_best_arc(bits) > 0.5, run)
    np.testing.assert_array_equal(_best_arc(-bits) > -0.5,
                                  _circular_run9(~m & 0xFFFF))


def _kernel_mirror(img, t_hi, t_lo):
    """csrc/fast_score.cu's arithmetic in float32 numpy: the compass test
    on the second largest / smallest raw compass sample; for candidates
    the window-minimum margin of the polarity (or both) the compass allows,
    on the samples or their negation; the t_lo-then-t_hi order and the
    in-order SADs.  Returns (hi, lo, candidates)."""
    f32 = np.float32
    img = np.asarray(img, f32)
    h, w = img.shape
    p = np.pad(img, 3)
    ring = np.stack([p[3 + dv:3 + dv + h, 3 + du:3 + du + w]
                     for du, dv in tf._CIRCLE])
    a, b, e, f = ring[0], ring[4], ring[8], ring[12]
    u = np.minimum(np.maximum(a, b), np.maximum(e, f))
    v = np.maximum(np.minimum(a, b), np.minimum(e, f))
    bright = (np.maximum(u, v) - img) > f32(t_lo)
    dark = (np.minimum(u, v) - img) < -f32(t_lo)
    cand = bright | dark
    flip = np.where(bright, f32(1), f32(-1))
    m = _best_arc(ring * flip) - img * flip
    both = bright & dark
    m[both] = np.maximum(m, _best_arc(-ring) - (-img))[both]
    lo_c = cand & (m > f32(t_lo))
    hi_c = lo_c & (m > f32(t_hi))
    d = np.abs(ring - img[None])

    def sad(t):
        s = np.maximum(d[0] - f32(t), f32(0))
        for i in range(1, 16):
            s = s + np.maximum(d[i] - f32(t), f32(0))
        return s

    lo = np.where(lo_c, sad(t_lo), f32(0))
    hi = np.where(hi_c, sad(t_hi), f32(0))
    return hi, lo, cand


def _torch_levels(img):
    img = torch.from_numpy(np.asarray(img)).float()
    return [(img if lvl == 0 else tf.resize_linear(img, lh, lw)).contiguous()
            for lvl, s, lh, lw in tf.pyramid_shapes(*img.shape)]


@pytest.mark.parametrize("name", ["noise", "synth"])
def test_kernel_shortcuts_reproduce_plain(images, name):
    """The kernel's arithmetic, mirrored in numpy, equals the plain version
    bit for bit at every pyramid level; t_hi corners lie inside t_lo
    corners, and those inside the compass candidates."""
    for lv in _torch_levels(images[name]):
        hi_ref = tf.fast_score_map_torch(lv, 20.0).numpy()
        lo_ref = tf.fast_score_map_torch(lv, 7.0).numpy()
        hi, lo, cand = _kernel_mirror(lv.numpy(), 20.0, 7.0)
        np.testing.assert_array_equal(hi, hi_ref)
        np.testing.assert_array_equal(lo, lo_ref)
        assert np.all(lo_ref[hi_ref > 0] > 0)
        assert np.all(cand[lo_ref > 0])
    if name == "synth":                  # the early exit does skip pixels
        assert cand.mean() < 0.5


@pytest.mark.parametrize("name", ["noise", "synth"])
def test_pyramid_on_cpu_is_plain_per_level(images, name):
    """fast_score_pyramid on CPU tensors is the plain version per level; at
    level 0 it is JAX's XLA and interpret-mode Pallas maps bit for bit."""
    levels = _torch_levels(images[name])
    maps = tf.fast_score_pyramid(levels, 20.0, 7.0)
    assert len(maps) == len(levels) == 8
    for lv, (hi, lo) in zip(levels, maps):
        assert hi.shape == lo.shape == lv.shape
        assert torch.equal(hi, tf.fast_score_map_torch(lv, 20.0))
        assert torch.equal(lo, tf.fast_score_map_torch(lv, 7.0))
        assert bool(torch.all(lo[hi > 0] > 0))       # t_hi within t_lo
    img0 = jnp.asarray(levels[0].numpy())
    for got, t in zip(maps[0], (20.0, 7.0)):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jf.fast_score_map(img0, t)))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jf.fast_score_map_pallas(
                img0, t, interpret=True)))


def _detect_keypoints_per_level(img, cfg):
    """detect_keypoints as it ran before the pyramid kernel: one score-map
    pair per level, in a loop."""
    img_f = img.to(torch.float32)
    all_uv, all_sc, all_va = [], [], []
    for lvl, s, lh, lw in tf.pyramid_shapes(*img.shape, cfg):
        li = img_f if lvl == 0 else tf.resize_linear(img_f, lh, lw)
        score = tf.fast_score_map_torch(li, cfg.ini_threshold)
        score_min = tf.fast_score_map_torch(li, cfg.min_threshold)
        score = tf._nms3(torch.where(score > 0, score, 0.25 * score_min))
        uv, sc, va = tf._grid_topk(score, max(cfg.cell // int(round(s)), 8),
                                   cfg.per_cell)
        all_uv.append(torch.round(uv * s))
        all_sc.append(sc)
        all_va.append(va)
    uv, sc, va = torch.cat(all_uv), torch.cat(all_sc), torch.cat(all_va)
    _, order = tf._topk_stable(torch.where(va, sc, torch.full_like(sc, -1.0)),
                               cfg.n_features)
    return uv[order], sc[order], va[order] & (sc[order] > 0)


@pytest.mark.parametrize("name", ["noise", "synth"])
def test_detect_keypoints_same_as_per_level_loop(images, name):
    img = torch.from_numpy(images[name])
    cfg = tf.FastPyramidConfig()
    for got, ref in zip(tf.detect_keypoints(img, cfg),
                        _detect_keypoints_per_level(img, cfg)):
        assert torch.equal(got, ref)


def test_detect_keypoints_batch_matches_jax():
    """B = 2 small frames: the port's batch is its per-frame detection
    exactly, and JAX's vmapped batch exactly at level 0 and to 99 % of the
    keypoint set over all 8 levels (the resize, as above)."""
    seq = SynthSequence(kitti_config(n_frames=2))
    imgs = np.stack([seq.frame(t).gray[100:292, 300:940] for t in range(2)])
    timgs = torch.from_numpy(imgs)
    for cfg_kw in ({"n_levels": 1, "n_features": 400}, {"n_features": 400}):
        tcfg = tf.FastPyramidConfig(**cfg_kw)
        ut, st, vt = tf.detect_keypoints_batch(timgs, tcfg)
        assert ut.shape == (2, 400, 2) and st.shape == vt.shape == (2, 400)
        uj, sj, vj = (np.asarray(a) for a in jf.detect_keypoints_batch(
            jnp.asarray(imgs), jf.FastPyramidConfig(**cfg_kw)))
        for b in range(2):
            for got, ref in zip((ut[b], st[b], vt[b]),
                                tf.detect_keypoints(timgs[b], tcfg)):
                assert torch.equal(got, ref)
            ref_set = set(map(tuple, uj[b][vj[b]]))
            got_set = set(map(tuple, ut[b].numpy()[vt[b].numpy()]))
            assert len(ref_set) > 100
            if cfg_kw.get("n_levels") == 1:
                np.testing.assert_array_equal(vt[b].numpy(), vj[b])
                np.testing.assert_array_equal(st[b].numpy(), sj[b])
                assert got_set == ref_set
            else:
                assert len(ref_set & got_set) >= 0.99 * len(ref_set)
