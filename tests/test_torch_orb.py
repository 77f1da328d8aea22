"""sdpl_slam_torch.ops.orb: twins of tests/test_orb.py and
tests/test_orb_pattern.py on the port, and the port against the JAX
package's ``ops.orb`` on the same inputs.

The JAX functions run as the suite runs them on the CPU.  Tolerances, as
stated at each test: the rBRIEF bits against the scalar oracle are equal,
and against JAX equal but where the angles' rounding moves a sample; the
IC angle within 1e-5 rad of JAX's where JAX's float32 moments are exact,
and within 1e-6 rad of the float64 angle; the Hamming matrix and the
mutual matches are equal (integer sums under 2^24 in float32).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpl_slam_tpu.ops import orb as jorb
from sdpl_slam_torch.ops import orb
from sdpl_slam_torch.ops.orb_pattern import BIT_PATTERN_31

torch.set_num_threads(2)

# the canonical ORB circular-patch bounds for HALF_PATCH_SIZE=15
UMAX_EXPECTED = [15, 15, 15, 15, 14, 14, 14, 13, 13, 12, 11, 10, 9, 8, 6, 3]


def _t(a):
    return torch.from_numpy(np.array(a))


def textured_image(rng, h=128, w=160):
    return rng.integers(0, 255, (h, w)).astype(np.uint8)


# ------------------------ twins of tests/test_orb.py -----------------------
def test_descriptor_invariance_to_translation(rng):
    """The same patch content at different positions gives the same bits."""
    img = textured_image(rng)
    big = np.zeros((256, 256), np.uint8)
    big[20:148, 30:190] = img
    big2 = np.zeros((256, 256), np.uint8)
    big2[60:188, 50:210] = img
    uv1 = np.array([[30 + 80, 20 + 64]], np.float32)
    uv2 = np.array([[50 + 80, 60 + 64]], np.float32)
    d1 = orb.brief_descriptors(_t(big), _t(uv1)).numpy()
    d2 = orb.brief_descriptors(_t(big2), _t(uv2)).numpy()
    assert (d1 != d2).mean() < 0.05


def test_matching_under_translation(rng):
    img = textured_image(rng, 192, 256)
    shift = 7
    img2 = np.roll(img, (0, shift), (0, 1))
    uv = rng.uniform([40, 40], [216, 152], size=(60, 2)).astype(np.float32)
    uv2 = (uv + [shift, 0]).astype(np.float32)
    d1 = orb.brief_descriptors(_t(img), _t(uv))
    d2 = orb.brief_descriptors(_t(img2), _t(uv2))
    idx, valid = orb.match_descriptors(d1, d2)
    correct = (idx.numpy() == np.arange(60)) & valid.numpy()
    assert correct.mean() > 0.9, correct.mean()


def test_hamming_matmul_matches_bitcount(rng):
    a = rng.integers(0, 2, (17, 256)).astype(np.uint8)
    b = rng.integers(0, 2, (23, 256)).astype(np.uint8)
    d = orb.hamming_distance_matrix(_t(a), _t(b)).numpy()
    ref = (a[:, None, :] != b[None, :, :]).sum(-1)
    np.testing.assert_array_equal(d.astype(np.int32), ref)


def test_ic_angle_rotates():
    """A gradient patch rotated by 90 degrees rotates the IC angle."""
    ys, xs = np.mgrid[0:64, 0:64]
    img = (xs * 4).astype(np.float32)        # gradient along +x
    img90 = (ys * 4).astype(np.float32)      # gradient along +y
    uv = np.array([[32, 32]], np.float32)
    a1 = float(orb.ic_angle(_t(img), _t(uv))[0])
    a2 = float(orb.ic_angle(_t(img90), _t(uv))[0])
    assert abs(a1) < 0.1
    assert abs(a2 - np.pi / 2) < 0.1


# -------------------- twins of tests/test_orb_pattern.py -------------------
def _oracle_bits(patch: np.ndarray, angle: float) -> np.ndarray:
    """computeOrbDescriptor (ORBextractor.cc:97-137) on a (37, 37) patch
    centred at (18, 18), scalar Python."""
    a, b = math.cos(angle), math.sin(angle)
    c0 = orb.R_EXT

    def val(x, y):
        col = int(np.rint(x * a - y * b))
        row = int(np.rint(x * b + y * a))
        return patch[c0 + row, c0 + col]

    bits = np.zeros(256, np.uint8)
    for i, (x1, y1, x2, y2) in enumerate(BIT_PATTERN_31.astype(int)):
        bits[i] = 1 if val(x1, y1) < val(x2, y2) else 0
    return bits


def _oracle_ic_angle(patch31: np.ndarray) -> float:
    """IC_Angle (ORBextractor.cc:66-95) over a (31, 31) patch centred at
    (15, 15), in integers."""
    h = 15
    m01 = 0
    m10 = 0
    for u in range(-h, h + 1):
        m10 += u * int(patch31[h, h + u])
    for v in range(1, h + 1):
        v_sum = 0
        d = UMAX_EXPECTED[v]
        for u in range(-d, d + 1):
            vp = int(patch31[h + v, h + u])
            vm = int(patch31[h - v, h + u])
            v_sum += vp - vm
            m10 += u * (vp + vm)
        m01 += v * v_sum
    return math.atan2(m01, m10)


def test_umax_matches_reference():
    assert list(orb._umax()) == UMAX_EXPECTED


def test_descriptor_bits_exact():
    rng = np.random.default_rng(7)
    n = 16
    patches = rng.integers(0, 256, size=(n, 37, 37)).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, size=n).astype(np.float32)
    got = orb.descriptor_bits_at_angle(_t(patches), _t(angles)).numpy()
    for i in range(n):
        want = _oracle_bits(patches[i], float(angles[i]))
        np.testing.assert_array_equal(got[i], want, err_msg=f"kp {i}")


def test_ic_angle_exact():
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, size=(64, 64)).astype(np.float32)
    uv = np.array([[31, 31], [20, 40], [40, 20]], np.float32)
    got = orb.ic_angle(_t(img), _t(uv)).numpy()
    for i, (u, v) in enumerate(uv.astype(int)):
        patch = img[v - 15:v + 16, u - 15:u + 16]
        want = _oracle_ic_angle(patch)
        assert abs(float(got[i]) - want) < 1e-5, (i, float(got[i]), want)


def test_full_descriptor_pipeline_runs():
    """brief_descriptors end to end: smoothing + angle + bits; the bits
    equal the oracle applied to the same smoothed image."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(96, 128)).astype(np.float32)
    uv = np.array([[40, 40], [60, 50], [80, 30]], np.float32)
    d = orb.brief_descriptors(_t(img), _t(uv)).numpy()
    assert d.shape == (3, 256) and set(np.unique(d)) <= {0, 1}
    img_s = orb._gaussian_blur_7x7(_t(img))
    ang = orb.ic_angle(img_s, _t(uv)).numpy()
    img_s = img_s.numpy()
    for i, (u, v) in enumerate(uv.astype(int)):
        patch = img_s[v - 18:v + 19, u - 18:u + 19]
        np.testing.assert_array_equal(d[i], _oracle_bits(patch, float(ang[i])))


# ------------------------- against the JAX package -------------------------
H, W, N_KP = 240, 320, 500


@pytest.fixture(scope="module")
def scene():
    """A 240x320 textured image, its 2-px shift, and 500 keypoints (some
    on the border, where the patches clamp)."""
    rng = np.random.default_rng(21)
    base = rng.integers(0, 256, (H // 4, W // 4)).astype(np.float32)
    img = np.kron(base, np.ones((4, 4), np.float32))
    img = np.clip(img + rng.normal(0, 12, (H, W)), 0, 255).astype(np.uint8)
    img2 = np.roll(img, (0, 2), (0, 1))
    uv = rng.uniform([0, 0], [W, H], (N_KP, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0],
              [2.5, 100], [100, 3.5], [W - 2.5, 50], [60, H - 1.5]]
    return img, img2, uv


def test_blur_matches_jax_at_the_border(scene):
    """The reflect-101 blur equals JAX's, border rows and columns too."""
    img = scene[0]
    got = orb._gaussian_blur_7x7(_t(img)).numpy()
    want = np.asarray(jorb._gaussian_blur_7x7(jnp.asarray(img)))
    np.testing.assert_array_equal(got, want)


def _wrap(d):
    return np.abs(np.angle(np.exp(1j * d)))


def test_ic_angle_matches_jax(scene):
    """On the raw image every moment term is an integer and every sum is
    under 2^24, so JAX's float32 sums are exact too: the angles agree
    within 1e-5 rad (wrapped, so +pi and -pi agree).  On the smoothed
    image the port's angle is within 1e-6 rad of the float64 angle of the
    same patches, and JAX's within 1e-5 rad plus what its float32 sums can
    move it: (n - 1) 2^-24 sum|terms| / |m|, n = 961 terms (measured: JAX
    1.85e-5 rad from the float64 angle, the port 1.2e-7)."""
    img, _, uv = scene
    im = img.astype(np.float32)
    got = orb.ic_angle(_t(im), _t(uv)).numpy().astype(np.float64)
    want = np.asarray(jorb.ic_angle(jnp.asarray(im), jnp.asarray(uv)))
    assert _wrap(got - want).max() < 1e-5, _wrap(got - want).max()

    ims = np.asarray(jorb._gaussian_blur_7x7(jnp.asarray(img)))
    got = orb.ic_angle(_t(ims), _t(uv)).numpy().astype(np.float64)
    want = np.asarray(jorb.ic_angle(jnp.asarray(ims), jnp.asarray(uv)))
    p = orb._gather_patches(_t(ims), _t(uv)).reshape(N_KP, -1).double()
    wts = orb._device_consts(torch.device("cpu"))[0]
    m = (p @ wts).numpy()
    exact = np.arctan2(m[:, 0], m[:, 1])
    assert _wrap(got - exact).max() < 1e-6, _wrap(got - exact).max()
    sum_abs = (p.abs() @ wts.abs()).sum(1).numpy()
    bound = 1e-5 + 960 * 2.0 ** -24 * sum_abs / np.hypot(m[:, 0], m[:, 1])
    assert (_wrap(got - want) < bound).all()


def test_brief_descriptors_match_jax(scene):
    """The bits equal JAX's wherever both put every sample at the same
    pixel.  The angles differ by what test_ic_angle_matches_jax allows, so
    a bit may differ only where one of its rotated sample coordinates
    (radius under 18.4 px) lies within 18.4 |d angle| + 1e-6 px of a
    rounding half; under 0.1 % of the bits do."""
    img, img2, uv = scene
    for im in (img, img2):
        got = orb.brief_descriptors(_t(im), _t(uv)).numpy()
        want = np.asarray(jorb.brief_descriptors(jnp.asarray(im),
                                                 jnp.asarray(uv)))
        assert got.dtype == np.uint8 and got.shape == (N_KP, 256)
        ims = orb._gaussian_blur_7x7(_t(im))
        ang = orb.ic_angle(ims, _t(uv)).numpy().astype(np.float64)
        jang = np.asarray(jorb.ic_angle(jnp.asarray(ims.numpy()),
                                        jnp.asarray(uv)))
        xy = orb.rotated_pattern(_t(jang)).numpy()
        gap = np.abs(np.abs(xy - np.floor(xy)) - 0.5)
        at_half = (gap < 18.4 * _wrap(ang - jang)[:, None, None]
                   + 1e-6).any(-1)
        diff = got != want
        assert not (diff & ~at_half).any()
        assert diff.mean() < 1e-3, diff.mean()


def test_hamming_and_matches_match_jax(scene):
    """Frame against its shift: the Hamming matrix and the mutual matches
    equal JAX's (the bits are JAX's on both sides), ties included."""
    img, img2, uv = scene
    a = np.array(jorb.brief_descriptors(jnp.asarray(img), jnp.asarray(uv)))
    b = np.array(jorb.brief_descriptors(jnp.asarray(img2),
                                        jnp.asarray(uv + [2, 0])))
    # a duplicated row makes ties in both directions
    b[5] = b[4]
    got = orb.hamming_distance_matrix(_t(a), _t(b)).numpy()
    want = np.asarray(jorb.hamming_distance_matrix(jnp.asarray(a),
                                                   jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    idx, valid = orb.match_descriptors(_t(a), _t(b))
    jidx, jvalid = jorb.match_descriptors(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0.5 < valid.numpy().mean() < 1.0
