"""Host-side oracle of ORB-SLAM2's octree keypoint distribution.

The reference retains FAST keypoints per pyramid level with
``ORBextractor::DistributeOctTree`` (ORBextractor.cc:528-754):
a quadtree over the detection area is subdivided breadth-first (largest
nodes first once the node budget nears N) until there are >= N leaves or
no leaf is divisible, then the SINGLE highest-response keypoint of each
leaf is kept.  Per-level budgets follow the geometric series
``mnFeaturesPerLevel`` (ORBextractor.cc:409-424: nfeatures * (1-1/s) /
(1-(1/s)^L) * (1/s)^level, remainder to the last level).

The production path (ops/fast.py) replaces this data-dependent tree with a
fixed-shape per-cell top-k + global response top-k.  This module is the
behavioral oracle: tests/test_torch_octree.py quantifies how close the
grid policy's retained-keypoint distribution is (per-cell occupancy,
per-level counts, response ordering, point overlap).  It is this
package's copy of the JAX package's ``ops.octree_oracle`` (numpy only).

Written from the reference's behavior, not copied; scalar python,
test-only performance.
"""

from __future__ import annotations

import math

import numpy as np


def features_per_level(n_features: int, scale_factor: float,
                       n_levels: int) -> list:
    """mnFeaturesPerLevel (ORBextractor.cc:409-424)."""
    factor = 1.0 / scale_factor
    n_desired = n_features * (1 - factor) / (1 - factor ** n_levels)
    out = []
    total = 0
    for _ in range(n_levels - 1):
        k = int(round(n_desired))
        out.append(k)
        total += k
        n_desired *= factor
    out.append(max(n_features - total, 0))
    return out


class _Node:
    __slots__ = ("ulx", "uly", "brx", "bry", "keys", "no_more")

    def __init__(self, ulx, uly, brx, bry):
        self.ulx, self.uly, self.brx, self.bry = ulx, uly, brx, bry
        self.keys = []
        self.no_more = False

    def divide(self):
        """DivideNode (ORBextractor.cc:497-527): ceil-half splits."""
        half_x = int(math.ceil((self.brx - self.ulx) / 2.0))
        half_y = int(math.ceil((self.bry - self.uly) / 2.0))
        n1 = _Node(self.ulx, self.uly, self.ulx + half_x, self.uly + half_y)
        n2 = _Node(self.ulx + half_x, self.uly, self.brx, self.uly + half_y)
        n3 = _Node(self.ulx, self.uly + half_y, self.ulx + half_x, self.bry)
        n4 = _Node(self.ulx + half_x, self.uly + half_y, self.brx, self.bry)
        for (x, y, r, i) in self.keys:
            if x < n1.brx:
                (n1 if y < n1.bry else n3).keys.append((x, y, r, i))
            else:
                (n2 if y < n1.bry else n4).keys.append((x, y, r, i))
        for n in (n1, n2, n3, n4):
            if len(n.keys) == 1:
                n.no_more = True
        return n1, n2, n3, n4


def distribute_octree(xy: np.ndarray, response: np.ndarray,
                      width: int, height: int, n_target: int) -> np.ndarray:
    """DistributeOctTree (ORBextractor.cc:528-754).

    ``xy``: (K, 2) keypoint positions relative to the detection area
    origin; ``response``: (K,); area ``width`` x ``height``; keep about
    ``n_target`` keypoints (one per final leaf).  Returns indices into
    the input arrays of the retained keypoints."""
    n_ini = max(int(round(width / float(height))), 1)
    hx = width / float(n_ini)
    nodes = [
        _Node(int(hx * i), 0, int(hx * (i + 1)), height)
        for i in range(n_ini)
    ]
    for i, ((x, y), r) in enumerate(zip(np.asarray(xy), response)):
        nodes[min(int(x / hx), n_ini - 1)].keys.append(
            (float(x), float(y), float(r), i)
        )
    nodes = [n for n in nodes if n.keys]
    for n in nodes:
        if len(n.keys) == 1:
            n.no_more = True

    while True:
        prev_size = len(nodes)
        expandable = []
        new_nodes = []
        for n in nodes:
            if n.no_more:
                new_nodes.append(n)
                continue
            for c in n.divide():
                if c.keys:
                    new_nodes.append(c)
                    if len(c.keys) > 1:
                        expandable.append(c)
        nodes = new_nodes
        if len(nodes) >= n_target or len(nodes) == prev_size:
            break
        # near the budget: expand the largest nodes first and stop as
        # soon as the leaf count reaches the target (:664-725)
        if len(nodes) + 3 * len(expandable) > n_target:
            while True:
                prev_size = len(nodes)
                todo = sorted(
                    [n for n in nodes if not n.no_more and len(n.keys) > 1],
                    key=lambda n: len(n.keys),
                )
                done = False
                for n in reversed(todo):
                    nodes.remove(n)
                    for c in n.divide():
                        if c.keys:
                            nodes.append(c)
                    if len(nodes) >= n_target:
                        done = True
                        break
                if done or len(nodes) >= n_target or len(nodes) == prev_size:
                    break
            break

    keep = []
    for n in nodes:
        best = max(n.keys, key=lambda k: k[2])
        keep.append(best[3])
    return np.asarray(sorted(keep), np.int64)


def retain_reference(score_map: np.ndarray, n_target: int) -> np.ndarray:
    """Run the octree retention on all positive-score pixels of a
    response map (the per-level candidate set).  Returns (M, 3) rows of
    [x, y, response]."""
    ys, xs = np.nonzero(score_map > 0)
    resp = score_map[ys, xs]
    if len(xs) == 0:
        return np.zeros((0, 3), np.float32)
    h, w = score_map.shape
    idx = distribute_octree(
        np.stack([xs, ys], -1), resp, w, h, n_target
    )
    return np.stack(
        [xs[idx], ys[idx], resp[idx]], -1
    ).astype(np.float32)
