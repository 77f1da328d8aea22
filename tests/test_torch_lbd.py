"""sdpl_slam_torch.ops.lbd: twins of tests/test_lbd.py on the port, and the
port against the JAX package's ``ops.lbd`` on the same inputs.

Tolerances, as stated at each test: the float descriptors within atol 1e-5
of JAX's (float32 sums of 32 samples and band products in two orders);
the bits equal, except where JAX's two compared values lie within 1e-6 of
each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpl_slam_tpu.ops import lbd as jlbd
from sdpl_slam_torch.ops import lbd, orb

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------ twins of tests/test_lbd.py -----------------------
def test_lbd_translation_stability(rng):
    img = rng.integers(0, 255, (192, 320)).astype(np.uint8)
    img2 = np.roll(img, (0, 5), (0, 1))
    segs = rng.uniform([40, 40, 40, 40], [260, 150, 260, 150],
                       (20, 4)).astype(np.float32)
    segs2 = (segs + [5, 0, 5, 0]).astype(np.float32)
    d1 = lbd.lbd_descriptors(_t(img), _t(segs))
    d2 = lbd.lbd_descriptors(_t(img2), _t(segs2))
    same = orb.hamming_distance_matrix(d1, d2).numpy()
    # the matching line has the smallest distance for most lines
    correct = (same.argmin(axis=1) == np.arange(20)).mean()
    assert correct > 0.8, correct


def test_lbd_shapes(rng):
    img = rng.integers(0, 255, (96, 128)).astype(np.uint8)
    segs = np.array([[10, 10, 100, 80]], np.float32)
    d = lbd.lbd_descriptors(_t(img), _t(segs)).numpy()
    assert d.shape == (1, 256) and d.dtype == np.uint8
    assert set(np.unique(d)) <= {0, 1}


def test_lbd_float_descriptor_structure(rng):
    img = rng.integers(0, 255, (96, 128)).astype(np.uint8)
    segs = rng.uniform([10, 10, 10, 10], [110, 80, 110, 80],
                       (8, 4)).astype(np.float32)
    des = lbd.lbd_float_descriptors(_t(img), _t(segs)).numpy()
    assert des.shape == (8, 72)          # 9 bands x 8 stats
    assert (des >= 0).all()
    # clamped at 0.4 then renormalised to unit length
    # (binary_descriptor_custom.cpp:1316-1340)
    np.testing.assert_allclose(np.linalg.norm(des, axis=1), 1.0, atol=1e-5)
    assert des.max() <= 0.4 / 0.4 + 1e-6


def test_lbd_binarization_is_band_pair_comparison(rng):
    """Bits are elementwise comparisons over the reference's 32 band-pair
    combinations table (binaryConversion, :401-412)."""
    img = rng.integers(0, 255, (96, 128)).astype(np.uint8)
    segs = rng.uniform([10, 10, 10, 10], [110, 80, 110, 80],
                       (5, 4)).astype(np.float32)
    des = lbd.lbd_float_descriptors(_t(img), _t(segs)).numpy()
    bits = lbd.lbd_descriptors(_t(img), _t(segs)).numpy()
    per_band = des.reshape(-1, 9, 8)
    expect = np.zeros((len(segs), 256), np.uint8)
    for c, (b1, b2) in enumerate(lbd._COMBINATIONS):
        for i in range(8):
            expect[:, c * 8 + i] = (
                per_band[:, b1, i] > per_band[:, b2, i]).astype(np.uint8)
    np.testing.assert_array_equal(bits, expect)


def test_lbd_combinations_table_is_reference():
    # pin the table (binary_descriptor_custom.cpp:74-106), the JAX copy too
    np.testing.assert_array_equal(lbd._COMBINATIONS, jlbd._COMBINATIONS)
    assert lbd._COMBINATIONS.shape == (32, 2)
    assert (lbd._COMBINATIONS[:, 0] < lbd._COMBINATIONS[:, 1]).all()
    assert list(lbd._COMBINATIONS[0]) == [0, 1]
    assert list(lbd._COMBINATIONS[-1]) == [7, 8]
    assert lbd._COMBINATIONS[lbd._COMBINATIONS[:, 0] <= 1, 1].max() == 6


# ------------------------- against the JAX package -------------------------
@pytest.fixture(scope="module")
def scene():
    """A 240x320 image of bars on noise and 150 segments: along the bars,
    random, partly outside the image, and two of zero length."""
    rng = np.random.default_rng(5)
    img = rng.normal(110.0, 8.0, (240, 320))
    yy, xx = np.mgrid[0:240, 0:320]
    segs = []
    for _ in range(12):
        x0, y0 = rng.uniform([30, 30], [290, 210])
        ang, ln = rng.uniform(0, np.pi), rng.uniform(40, 120)
        dx, dy = np.cos(ang), np.sin(ang)
        along = (xx - x0) * dx + (yy - y0) * dy
        across = -(xx - x0) * dy + (yy - y0) * dx
        img[(np.abs(along) < ln / 2) & (np.abs(across) < 4)] += 60
        segs.append([x0 - dx * ln / 2, y0 - dy * ln / 2,
                     x0 + dx * ln / 2, y0 + dy * ln / 2])
    img = np.clip(img, 0, 255).astype(np.uint8)
    segs = np.concatenate([
        np.asarray(segs),
        rng.uniform([0, 0, 0, 0], [320, 240, 320, 240], (134, 4)),
        rng.uniform([-40, -40, 280, 200], [40, 40, 360, 280], (2, 4)),
        [[50, 60, 50, 60], [0, 0, 0, 0]]]).astype(np.float32)
    return img, segs


def test_lbd_float_matches_jax(scene):
    img, segs = scene
    got = lbd.lbd_float_descriptors(_t(img), _t(segs)).numpy()
    want = np.asarray(jlbd.lbd_float_descriptors(jnp.asarray(img),
                                                 jnp.asarray(segs)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_lbd_bits_match_jax(scene):
    img, segs = scene
    got = lbd.lbd_descriptors(_t(img), _t(segs)).numpy()
    want = np.asarray(jlbd.lbd_descriptors(jnp.asarray(img),
                                           jnp.asarray(segs)))
    des = np.asarray(jlbd.lbd_float_descriptors(
        jnp.asarray(img), jnp.asarray(segs))).reshape(-1, 9, 8)
    c = jlbd._COMBINATIONS
    gap = np.abs(des[:, c[:, 0], :] - des[:, c[:, 1], :]).reshape(-1, 256)
    differ = got != want
    assert np.all(gap[differ] < 1e-6), gap[differ]
    assert differ.sum() <= (gap < 1e-6).sum()
