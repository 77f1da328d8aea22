"""The port's keypoint retention (``sdpl_slam_torch.ops.fast._grid_topk``,
per-cell top-k and a global response top-k) against the octree oracle
(``sdpl_slam_torch.ops.octree_oracle``, ORB-SLAM2's DistributeOctTree,
ORBextractor.cc:528-754): twins of tests/test_octree_parity.py, and the
oracle copy against the JAX package's on the same score maps.

The bounds are tests/test_octree_parity.py's, stated at each test.
"""

import numpy as np
import pytest
import torch

from sdpl_slam_tpu.ops import octree_oracle as joracle
from sdpl_slam_torch.ops import fast
from sdpl_slam_torch.ops.octree_oracle import (
    distribute_octree, features_per_level, retain_reference,
)

torch.set_num_threads(2)

H, W = 200, 608
N_TARGET = 250


def _corner_field(seed, n=2000, clustered=False):
    """Sparse response map of isolated corner responses."""
    rng = np.random.default_rng(seed)
    score = np.zeros((H, W), np.float32)
    if clustered:
        # half the corners inside one 100x80 hotspot
        xs1 = rng.integers(200, 300, n // 2)
        ys1 = rng.integers(60, 140, n // 2)
        xs2 = rng.integers(3, W - 3, n - n // 2)
        ys2 = rng.integers(3, H - 3, n - n // 2)
        xs = np.concatenate([xs1, xs2])
        ys = np.concatenate([ys1, ys2])
    else:
        xs = rng.integers(3, W - 3, n)
        ys = rng.integers(3, H - 3, n)
    score[ys, xs] = rng.uniform(5.0, 200.0, n).astype(np.float32)
    return score


def _grid_retain(score, n_target, cell=32, per_cell=4):
    """The port's retention policy on one level's response map."""
    uv, sc, va = fast._grid_topk(torch.from_numpy(score), cell, per_cell)
    uv, sc, va = uv.numpy(), sc.numpy(), va.numpy()
    order = np.argsort(-np.where(va, sc, -1.0), kind="stable")[:n_target]
    keep = order[va[order] & (sc[order] > 0)]
    return np.concatenate([uv[keep], sc[keep, None]], axis=1)


def _occupancy(rows, bx=8, by=4):
    hgrid = np.zeros((by, bx))
    for x, y, _ in rows:
        hgrid[min(int(y * by / H), by - 1), min(int(x * bx / W), bx - 1)] += 1
    return hgrid / max(len(rows), 1)


@pytest.fixture(scope="module", params=[False, True],
                ids=["uniform", "clustered"])
def retained(request):
    score = _corner_field(7, clustered=request.param)
    ref = retain_reference(score, N_TARGET)
    prod = _grid_retain(score, N_TARGET)
    return score, ref, prod


def test_retention_counts_match(retained):
    _, ref, prod = retained
    assert len(ref) > 0 and len(prod) > 0
    # the octree stops at >= N leaves (one keypoint each); the grid caps at N
    assert abs(len(prod) - len(ref)) <= 0.25 * len(ref), (len(ref), len(prod))


def test_spatial_occupancy_matches(retained):
    _, ref, prod = retained
    # total-variation distance between block histograms
    tv = 0.5 * np.abs(_occupancy(ref) - _occupancy(prod)).sum()
    assert tv <= 0.25, tv


def test_response_preference_matches(retained):
    _, ref, prod = retained
    # both policies keep locally strongest corners
    m_ref, m_prod = ref[:, 2].mean(), prod[:, 2].mean()
    assert m_prod >= 0.85 * m_ref, (m_ref, m_prod)


def test_point_overlap(retained):
    _, ref, prod = retained
    # a majority of octree-retained keypoints are also grid-retained
    ps = {(int(x), int(y)) for x, y, _ in prod}
    hits = sum(1 for x, y, _ in ref if (int(x), int(y)) in ps)
    assert hits / len(ref) >= 0.5, hits / len(ref)


def test_features_per_level_series():
    """mnFeaturesPerLevel: geometric split with the remainder on the last
    level (ORBextractor.cc:409-424)."""
    fpl = features_per_level(2500, 1.2, 8)
    assert len(fpl) == 8
    assert sum(fpl) == 2500
    assert fpl[0] > fpl[1] > fpl[6]
    assert abs(fpl[1] / fpl[0] - 1 / 1.2) < 0.02


def test_octree_keeps_best_per_leaf():
    """In a field with one dominant corner per area, the octree keeps
    exactly the dominant ones."""
    score = np.zeros((64, 128), np.float32)
    strong = [(10, 10), (100, 20), (40, 50), (80, 55)]
    for i, (x, y) in enumerate(strong):
        score[y, x] = 100.0 + i
        score[y + 2, x + 2] = 1.0       # weak shadow nearby
    rows = retain_reference(score, 4)
    assert {(int(x), int(y)) for x, y, _ in rows} == set(strong)


@pytest.mark.parametrize("clustered", [False, True])
def test_oracle_copy_is_the_jax_packages(clustered):
    """The same score map through both copies of the oracle: the same
    retained rows, the same leaf indices at several budgets, the same
    per-level series."""
    score = _corner_field(11, clustered=clustered)
    np.testing.assert_array_equal(retain_reference(score, N_TARGET),
                                  joracle.retain_reference(score, N_TARGET))
    ys, xs = np.nonzero(score > 0)
    xy, resp = np.stack([xs, ys], -1), score[ys, xs]
    for n in (1, 37, 400, 5000):
        np.testing.assert_array_equal(
            distribute_octree(xy, resp, W, H, n),
            joracle.distribute_octree(xy, resp, W, H, n))
    assert (features_per_level(1200, 1.2, 8)
            == joracle.features_per_level(1200, 1.2, 8))
