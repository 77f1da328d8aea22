"""Vectorised FAST corner detection + pyramid + grid distribution.

Counterpart of the JAX package's ``ops.fast``: an 8-level image pyramid (scale
1.2), the FAST-9/16 segment test with the ini/min two-pass thresholds, and
spatially even retention by per-cell top-k on a regular grid.

The per-pixel score map is the one kernel of the tracking path: on CUDA
tensors :func:`fast_score_pyramid` launches ``csrc/fast_score.cu`` once for
every level of a pyramid (or of several frames' pyramids) at both
thresholds; on CPU tensors it runs the plain PyTorch version
:func:`fast_score_map_torch`, which the tests hold against the JAX package
and the card holds the kernel against.

Ties: ``jax.lax.top_k`` puts equal values at the lower index first, so the
top-k steps here use a stable descending sort (``torch.topk`` gives no tie
order).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (OpenCV FAST_9_16 order): (du, dv)
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
_ARC = 9  # FAST-9


def fast_score_map_torch(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9/16 corner response for every pixel (0 = not a corner), plain
    PyTorch: 16 zero-padded shifted planes, the circular 9-run test on the
    bright and dark masks, and the SAD score summed over the ring in order
    (the order of the Pallas kernel and of the CUDA kernel)."""
    img = img.to(torch.float32)
    h, w = img.shape
    p = F.pad(img, (3, 3, 3, 3))
    rings = torch.stack([p[3 + dv:3 + dv + h, 3 + du:3 + du + w]
                         for du, dv in _CIRCLE])
    diff = rings - img[None]

    def contiguous(mask):
        m2 = torch.cat([mask, mask[:_ARC - 1]], 0)
        acc = m2[:16]
        for k in range(1, _ARC):
            acc = acc & m2[k:16 + k]
        return acc.any(0)

    is_corner = contiguous(diff > threshold) | contiguous(diff < -threshold)
    terms = torch.clamp(torch.abs(diff) - threshold, min=0.0)
    sad = terms[0]
    for i in range(1, 16):
        sad = sad + terms[i]
    return torch.where(is_corner, sad, torch.zeros_like(sad))


class _Level(ctypes.Structure):
    """``SdplFastLevel`` of csrc/fast_score.cu."""
    _fields_ = [("src", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("h", ctypes.c_int), ("w", ctypes.c_int)]


@functools.lru_cache(maxsize=1)
def _pyramid_kernel():
    """(``sdpl_fast_score_pyramid``, levels it takes per launch) from
    csrc/fast_score.cu, built at first use."""
    from ..utils import cuda_build

    lib = cuda_build.load("fast_score.cu")
    fn = lib.sdpl_fast_score_pyramid
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_Level), ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    lib.sdpl_fast_max_levels.restype = ctypes.c_int
    return fn, lib.sdpl_fast_max_levels()


def _fast_pyramid_cuda(levels, t_hi: float, t_lo: float):
    fn, max_levels = _pyramid_kernel()
    dev = levels[0].device
    buf = torch.empty(2 * sum(lv.numel() for lv in levels),
                      dtype=torch.float32, device=dev)
    maps, table, off = [], [], 0
    for lv in levels:                  # level i: its t_hi map, then t_lo
        h, w = lv.shape
        maps.append((buf.as_strided((h, w), (w, 1), off),
                     buf.as_strided((h, w), (w, 1), off + h * w)))
        table.append(_Level(lv.data_ptr(), buf.data_ptr() + 4 * off, h, w))
        off += 2 * h * w
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i in range(0, len(table), max_levels):
            chunk = table[i:i + max_levels]
            err = fn((_Level * len(chunk))(*chunk), len(chunk), float(t_hi),
                     float(t_lo), stream)
            if err != 0:
                raise RuntimeError(
                    "fast_score.cu launch failed: cudaError_t %d (levels "
                    "%s)" % (err, [(c.h, c.w) for c in chunk]))
            fast_score_pyramid.launches += 1
    return maps


def fast_score_pyramid(levels, t_hi: float, t_lo: float):
    """FAST-9/16 score maps of every image in ``levels`` at two
    thresholds: a list of ``(score at t_hi, score at t_lo)``, one pair per
    level, each map of its level's shape.

    ``levels`` are contiguous 2-D float32 tensors on one device (the
    levels of one pyramid or of several; on the card each side at most
    8192, else the launch raises).  On a CUDA device one kernel
    launch computes all of them (counted in
    ``fast_score_pyramid.launches``; a launch takes up to 64 levels) and
    the maps are views into one allocation; on the CPU each level goes
    through :func:`fast_score_map_torch`.  Anything else raises.
    """
    levels = list(levels)
    if not t_hi >= t_lo:
        raise ValueError("fast_score_pyramid needs t_hi >= t_lo, got %r < %r"
                         % (t_hi, t_lo))
    for lv in levels:
        if (lv.dtype != torch.float32 or lv.dim() != 2
                or not lv.is_contiguous()):
            raise ValueError("fast_score_pyramid takes contiguous 2-D "
                             "float32 images, got %s %s contiguous=%s"
                             % (lv.dtype, tuple(lv.shape), lv.is_contiguous()))
    if not levels:
        return []
    dev = levels[0].device
    if any(lv.device != dev for lv in levels):
        raise ValueError("fast_score_pyramid: levels on several devices: %s"
                         % sorted({str(lv.device) for lv in levels}))
    if dev.type == "cuda":
        return _fast_pyramid_cuda(levels, t_hi, t_lo)
    if dev.type == "cpu":
        return [(fast_score_map_torch(lv, t_hi), fast_score_map_torch(lv, t_lo))
                for lv in levels]
    raise ValueError("fast_score_pyramid: unsupported device %s" % dev)


fast_score_pyramid.launches = 0


@functools.lru_cache(maxsize=64)
def _resize_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) linear-resize weights, antialiased when downscaling:
    ``jax.image.resize(..., "linear")``'s ``compute_weight_mat`` in
    float32 (triangle kernel widened by 1/scale, columns normalised,
    samples outside the input zeroed).  Inside ``jit`` XLA evaluates the
    sample position ``(i + 0.5) / scale - 0.5`` as one fused multiply-add;
    rounding it once, as here, instead of twice moves a position by up to
    one float32 ulp (~3e-5 px at 1242 px), which is 1e-2 grey levels in
    the resized image."""
    f32 = np.float32
    scale = f32(n_out / n_in)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    centres = np.arange(n_out, dtype=f32) + f32(0.5)
    sample_f = (centres.astype(np.float64) * np.float64(inv_scale)
                - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """:func:`_resize_weights_np` on ``device``, copied there once."""
    return torch.from_numpy(_resize_weights_np(n_in, n_out)).to(device)


def resize_linear(img: torch.Tensor, lh: int, lw: int) -> torch.Tensor:
    """``jax.image.resize(img, (lh, lw), "linear")`` (antialiased on
    downscale) as two small matmuls with the same separable weights.
    ``F.interpolate`` differs by far more than a FAST threshold tolerates."""
    h, w = img.shape
    out = img
    if lh != h:
        out = _resize_weights(h, lh, img.device).T @ out
    if lw != w:
        out = out @ _resize_weights(w, lw, img.device)
    return out


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression (-inf padding, like reduce_window)."""
    mx = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= mx) & (score > 0), score,
                       torch.zeros_like(score))


def _topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last dim with ``jax.lax.top_k``'s tie order (equal
    values: lower index first)."""
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _grid_topk(score: torch.Tensor, cell: int, per_cell: int):
    """Top-``per_cell`` corners per (cell x cell) tile.  Returns flat
    (uv, score, valid) of size n_cells*per_cell."""
    h, w = score.shape
    gh, gw = h // cell, w // cell
    s = score[:gh * cell, :gw * cell]
    tiles = s.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3)
    tiles = tiles.reshape(gh * gw, cell * cell)
    val, idx = _topk_stable(tiles, per_cell)
    cells = torch.arange(gh * gw, device=score.device)
    cy = (cells // gw) * cell
    cx = (cells % gw) * cell
    v = cy[:, None] + idx // cell
    u = cx[:, None] + idx % cell
    uv = torch.stack([u, v], -1).reshape(-1, 2).to(torch.float32)
    sc = val.reshape(-1)
    return uv, sc, sc > 0


class FastPyramidConfig(NamedTuple):
    n_features: int = 2500
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_threshold: float = 20.0
    min_threshold: float = 7.0
    cell: int = 32
    per_cell: int = 4


def pyramid_shapes(h: int, w: int, cfg: FastPyramidConfig = FastPyramidConfig()):
    """(level, scale, lh, lw) of every pyramid level detect_keypoints runs."""
    out = []
    for lvl in range(cfg.n_levels):
        s = cfg.scale_factor ** lvl
        lh, lw = int(round(h / s)), int(round(w / s))
        if min(lh, lw) < 32:
            break
        out.append((lvl, s, lh, lw))
    return out


def n_keypoints(h: int, w: int, cfg: FastPyramidConfig = FastPyramidConfig()):
    """The rows :func:`detect_keypoints` returns for an (h, w) image: every
    level's grid candidates, at most ``n_features``."""
    n = 0
    for lvl, s, lh, lw in pyramid_shapes(h, w, cfg):
        cell = max(cfg.cell // int(round(s)), 8)
        n += (lh // cell) * (lw // cell) * cfg.per_cell
    return min(n, cfg.n_features)


def _detect_frames(imgs, cfg: FastPyramidConfig):
    """:func:`detect_keypoints` of each (H, W) image in ``imgs`` (one
    shape): every frame's pyramid, one :func:`fast_score_pyramid` call for
    all their levels, then the per-level selection of each frame."""
    h, w = imgs[0].shape
    shapes = pyramid_shapes(h, w, cfg)
    levels = []
    for img in imgs:
        img_f = img.to(torch.float32)
        for lvl, s, lh, lw in shapes:
            lvl_img = img_f if lvl == 0 else resize_linear(img_f, lh, lw)
            levels.append(lvl_img.contiguous())
    maps = fast_score_pyramid(levels, cfg.ini_threshold, cfg.min_threshold)
    out = []
    for f in range(len(imgs)):
        all_uv, all_sc, all_va = [], [], []
        frame_maps = maps[f * len(shapes):(f + 1) * len(shapes)]
        for (lvl, s, lh, lw), (score, score_min) in zip(shapes, frame_maps):
            # two-pass thresholds (ORBextractor.cc:790-810): where the
            # strict threshold found nothing, the weak one fills in
            score = _nms3(torch.where(score > 0, score, 0.25 * score_min))
            cell = max(cfg.cell // int(round(s)), 8)
            uv, sc, va = _grid_topk(score, cell, cfg.per_cell)
            all_uv.append(torch.round(uv * s))
            all_sc.append(sc)
            all_va.append(va)
        uv = torch.cat(all_uv)
        sc = torch.cat(all_sc)
        va = torch.cat(all_va)
        # global top-n_features by response among valid
        _, order = _topk_stable(
            torch.where(va, sc, torch.full_like(sc, -1.0)), cfg.n_features)
        sc_out = sc[order]
        out.append((uv[order], sc_out, va[order] & (sc_out > 0)))
    return out


def detect_keypoints(img: torch.Tensor,
                     cfg: FastPyramidConfig = FastPyramidConfig()):
    """Multi-scale FAST detection with even spatial distribution.

    Returns (uv, score, valid), at most ``n_features`` rows; uv in level-0
    pixel coordinates (integral, like the reference's keypoints).  On a
    CUDA tensor the score maps of the whole pyramid are one kernel launch.
    """
    return _detect_frames([img], cfg)[0]


def detect_keypoints_batch(imgs: torch.Tensor, cfg: FastPyramidConfig = None):
    """:func:`detect_keypoints` of every frame of ``imgs`` (B, H, W):
    (uv (B, n, 2), score (B, n), valid (B, n)).  On a CUDA tensor the score
    maps of all B pyramids are one kernel launch (up to 8 frames of 8
    levels; more take one launch per 64 levels)."""
    cfg = cfg or FastPyramidConfig()
    per_frame = _detect_frames(list(imgs), cfg)
    return tuple(torch.stack(x) for x in zip(*per_frame))
