"""Plain NumPy reference of the tracking path's keypoint detector, and the
bytes its score kernel must move.

The detector as the configuration states it (ORB-SLAM's FAST-9/16 on an
8-level pyramid of scale 1.2, the ini / min thresholds, 3x3 non-maximum
suppression, a per-cell top-k on a regular grid, then the global top
``n_features`` by response): the pyramid is resized with the weights of
``jax.image.resize(..., "linear")`` (antialiased on downscale), every sum
runs in float32, and equal responses keep the lower index first.  It
imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC = 9
CELL, PER_CELL = 32, 4


def pyramid_shapes(h, w, n_levels=8, scale=1.2):
    """(level, scale, lh, lw) of every level, down to 32 px."""
    out = []
    for lvl in range(n_levels):
        s = scale ** lvl
        lh, lw = int(round(h / s)), int(round(w / s))
        if min(lh, lw) < 32:
            break
        out.append((lvl, s, lh, lw))
    return out


def pyramid_bytes(h, w, n_levels=8, scale=1.2) -> int:
    """The least bytes the score kernel moves for one frame: each level's
    float32 image read once and its two float32 score maps (one a
    threshold) written once."""
    return sum(12 * lh * lw for _, _, lh, lw in pyramid_shapes(h, w, n_levels,
                                                                scale))


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) linear-resize weights, antialiased on downscale, in
    float32 (the sample position rounded once, as a fused multiply-add
    gives it)."""
    f32 = np.float32
    scale = f32(n_out / n_in)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    centres = np.arange(n_out, dtype=f32) + f32(0.5)
    sample = (centres.astype(np.float64) * np.float64(inv_scale)
              - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    wts = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = wts.sum(axis=0, keepdims=True, dtype=f32)
    wts = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                   wts / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], wts, f32(0.0)).astype(f32)


def score_map(img: np.ndarray, threshold: float) -> np.ndarray:
    """FAST-9/16 response of every pixel (0: no corner): a run of 9 of the
    16 ring pixels all brighter or all darker than the centre by more
    than ``threshold``; the response sums max(|diff| - threshold, 0) over
    the ring in order."""
    h, w = img.shape
    thr = np.float32(threshold)
    p = np.pad(img, 3)
    diff = np.stack([p[3 + dv:3 + dv + h, 3 + du:3 + du + w]
                     for du, dv in CIRCLE]) - img[None]

    def run9(m):
        m2 = np.concatenate([m, m[:ARC - 1]], 0)
        acc = m2[:16].copy()
        for k in range(1, ARC):
            acc &= m2[k:16 + k]
        return acc.any(0)

    corner = run9(diff > thr) | run9(diff < -thr)
    terms = np.maximum(np.abs(diff) - thr, np.float32(0.0))
    sad = terms[0].copy()
    for i in range(1, 16):
        sad += terms[i]
    return np.where(corner, sad, np.float32(0.0))


def _nms3(score):
    h, w = score.shape
    p = np.pad(score, 1, constant_values=-np.inf)
    mx = np.max(np.stack([p[dy:dy + h, dx:dx + w] for dy in range(3)
                          for dx in range(3)]), 0)
    return np.where((score >= mx) & (score > 0), score, np.float32(0.0))


def _desc_stable(x, axis=-1):
    """Indices that sort descending, equal values lower index first."""
    return np.argsort(-x, axis=axis, kind="stable")


def _grid_topk(score, cell, per_cell):
    h, w = score.shape
    gh, gw = h // cell, w // cell
    tiles = score[:gh * cell, :gw * cell].reshape(gh, cell, gw, cell)
    tiles = tiles.transpose(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    idx = _desc_stable(tiles)[:, :per_cell]
    val = np.take_along_axis(tiles, idx, 1)
    cells = np.arange(gh * gw)
    v = ((cells // gw) * cell)[:, None] + idx // cell
    u = ((cells % gw) * cell)[:, None] + idx % cell
    uv = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)
    sc = val.reshape(-1)
    return uv, sc, sc > 0


def detect(gray: np.ndarray, n_features: int, ini_th: float, min_th: float,
           n_levels: int = 8, scale: float = 1.2):
    """Keypoints of a grey image: (uv (n, 2) float32 in level-0 pixels,
    valid (n,)), at most ``n_features`` rows, ordered by response."""
    img = gray.astype(np.float32)
    h, w = img.shape
    all_uv, all_sc, all_va = [], [], []
    for lvl, s, lh, lw in pyramid_shapes(h, w, n_levels, scale):
        lv = img
        if lvl:
            lv = resize_weights(h, lh).T @ img
            lv = np.ascontiguousarray(lv @ resize_weights(w, lw))
        hi, lo = score_map(lv, ini_th), score_map(lv, min_th)
        sc_map = _nms3(np.where(hi > 0, hi, np.float32(0.25) * lo))
        cell = max(CELL // int(round(s)), 8)
        uv, sc, va = _grid_topk(sc_map, cell, PER_CELL)
        all_uv.append(np.round(uv * np.float32(s)))
        all_sc.append(sc)
        all_va.append(va)
    uv, sc, va = (np.concatenate(x) for x in (all_uv, all_sc, all_va))
    order = _desc_stable(np.where(va, sc, np.float32(-1.0)))[:n_features]
    return uv[order], va[order] & (sc[order] > 0)


def mismatch(uv_a, valid_a, uv_b, valid_b) -> int:
    """Keypoints in one set and not the other (each a multiset of whole
    pixel positions of its valid rows)."""
    from collections import Counter

    def bag(uv, valid):
        pts = np.asarray(uv)[np.asarray(valid, bool)]
        return Counter(map(tuple, np.rint(pts).astype(np.int64).tolist()))

    a, b = bag(uv_a, valid_a), bag(uv_b, valid_b)
    return sum(((a - b) + (b - a)).values())
