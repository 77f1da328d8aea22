"""Vectorised FAST corner detection + pyramid + grid distribution.

Counterpart of ``sdpl_slam_tpu.ops.fast``: an 8-level image pyramid (scale
1.2), the FAST-9/16 segment test with the ini/min two-pass thresholds, and
spatially even retention by per-cell top-k on a regular grid.

The per-pixel score map is the one kernel of the tracking path: on a CUDA
tensor :func:`fast_score_maps` launches ``csrc/fast_score.cu`` (both
thresholds in one launch); on a CPU tensor it runs the plain PyTorch
version :func:`fast_score_map_torch`, which the tests hold against the JAX
package and the card holds the kernel against.

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


@functools.lru_cache(maxsize=1)
def _fast_score_fn():
    """``sdpl_fast_score2`` from csrc/fast_score.cu, built at first use."""
    from ..utils import cuda_build

    fn = cuda_build.load("fast_score.cu").sdpl_fast_score2
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    return fn


def _fast_score_cuda(img: torch.Tensor, t_hi: float, t_lo: float):
    fn = _fast_score_fn()
    h, w = img.shape
    out_hi = torch.empty_like(img)
    out_lo = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), out_hi.data_ptr(), out_lo.data_ptr(),
                 h, w, float(t_hi), float(t_lo), stream)
    if err != 0:
        raise RuntimeError("fast_score.cu launch failed: cudaError_t %d "
                           "(image %dx%d)" % (err, h, w))
    fast_score_maps.launches += 1
    return out_hi, out_lo


def fast_score_maps(img: torch.Tensor, t_hi: float, t_lo: float):
    """FAST-9/16 score maps of ``img`` (H, W) float32 at two thresholds.

    A CUDA tensor goes through the CUDA kernel (one launch for both maps,
    counted in ``fast_score_maps.launches``); a CPU tensor through
    :func:`fast_score_map_torch`.  Anything else raises.
    """
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError("fast_score_maps takes a contiguous 2-D float32 "
                         "image, got %s %s contiguous=%s"
                         % (img.dtype, tuple(img.shape), img.is_contiguous()))
    if img.device.type == "cuda":
        return _fast_score_cuda(img, t_hi, t_lo)
    if img.device.type == "cpu":
        return fast_score_map_torch(img, t_hi), fast_score_map_torch(img, t_lo)
    raise ValueError("fast_score_maps: unsupported device %s" % img.device)


fast_score_maps.launches = 0


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


def detect_keypoints(img: torch.Tensor,
                     cfg: FastPyramidConfig = FastPyramidConfig()):
    """Multi-scale FAST detection with even spatial distribution.

    Returns (uv, score, valid), at most ``n_features`` rows; uv in level-0
    pixel coordinates (integral, like the reference's keypoints).
    """
    h, w = img.shape
    img_f = img.to(torch.float32)
    all_uv, all_sc, all_va = [], [], []
    for lvl, s, lh, lw in pyramid_shapes(h, w, cfg):
        lvl_img = img_f if lvl == 0 else resize_linear(img_f, lh, lw)
        score, score_min = fast_score_maps(
            lvl_img.contiguous(), cfg.ini_threshold, cfg.min_threshold)
        # two-pass thresholds (ORBextractor.cc:790-810): where the strict
        # threshold found nothing, the weak one fills in
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
    _, order = _topk_stable(torch.where(va, sc, torch.full_like(sc, -1.0)),
                            cfg.n_features)
    sc_out = sc[order]
    return uv[order], sc_out, va[order] & (sc_out > 0)
