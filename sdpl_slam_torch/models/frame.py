"""Frame feature ops on tensors (counterpart of the JAX package's ``models.frame``).

Every feature family lives in a fixed-capacity tensor with a validity
mask, so a frame's selections are gathers and wheres on its device with
no data-dependent shape: the device-resident loop (:mod:`.resident`) runs
them inside its step.  The host tracking path runs the same selections in
numpy (:mod:`.frame_host`).

Object and static features are index-aligned between adjacent frames
(``cur.uv = last.corres``, reference Tracking.cc:273-276, :334), so
frame-to-frame correspondence is the identity.  Lookups truncate pixel
coordinates with ``floor``, replicating the reference's
``.at<T>((int)y, (int)x)`` on the positive image domain.
"""

from __future__ import annotations

import torch

from ..ops import geometry, lie
from ..ops.geometry import Intrinsics


def grid_sample_uv(height: int, width: int, n_points: int = 3000, *,
                   device) -> torch.Tensor:
    """Uniform integral pixel lattice, the ``SampleKeyPoints`` equivalent
    (reference Frame.cc:1494-1562: 3000 points on a 20x20 grid)."""
    n = int(round(n_points ** 0.5))
    us = torch.linspace(2.0, width - 3.0, max(n, 2), dtype=torch.float32,
                        device=device)
    vs = torch.linspace(2.0, height - 3.0, max((n_points + n - 1) // n, 2),
                        dtype=torch.float32, device=device)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    pts = torch.stack([uu.reshape(-1), vv.reshape(-1)], -1)
    return torch.round(pts[:n_points])


def lookup_nearest(img: torch.Tensor, uv: torch.Tensor):
    """img[(int)v, (int)u] with clamped indices, and the in-bounds mask of
    the reference's open interval (0 < u < W-1, 0 < v < H-1,
    Tracking.cc:305-311)."""
    h, w = img.shape[0], img.shape[1]
    u = torch.floor(uv[..., 0]).to(torch.int64)
    v = torch.floor(uv[..., 1]).to(torch.int64)
    inb = (u > 0) & (u < w - 1) & (v > 0) & (v < h - 1)
    return img[v.clamp(0, h - 1), u.clamp(0, w - 1)], inb


def compact_by_mask(arrays, keep: torch.Tensor, cap: int):
    """Rows where ``keep`` holds, in order, into ``cap`` rows (the
    fixed-shape erase/push_back).  The padding rows are the rows that were
    not kept, in order, as JAX's stable argsort gives them.

    Returns (compacted arrays, valid mask, gather index used)."""
    order = torch.argsort((~keep).to(torch.int32), stable=True)[:cap]
    count = keep.sum()
    valid = torch.arange(cap, device=keep.device) < count.clamp(max=cap)
    return tuple(a[order] for a in arrays), valid, order


def stride_grid_uv(height: int, width: int, step: int = 4, *,
                   device) -> torch.Tensor:
    """The stride-``step`` pixel lattice of the semi-dense object sampling
    (Frame.cc:769-809, step 4, row-major)."""
    vs = torch.arange(0, height, step, device=device)
    us = torch.arange(0, width, step, device=device)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    return torch.stack([uu.reshape(-1), vv.reshape(-1)], -1).to(torch.float32)


def _flow_at(flow, uv):
    fu, _ = lookup_nearest(flow[..., 0], uv)
    fv, _ = lookup_nearest(flow[..., 1], uv)
    return torch.stack([fu, fv], -1)


def _corres_inside(corres, h, w):
    """Every (u, v) pair of ``corres`` (..., 2k) strictly inside the image."""
    u, v = corres[..., 0::2], corres[..., 1::2]
    return ((u < w) & (u > 0) & (v < h) & (v > 0)).all(-1)


def select_static_points(cand_uv, cand_valid, depth, flow, mask,
                         th_depth_bg: float, cap: int):
    """Static-point selection (Frame.cc:491-515): mask == 0, depth in
    (0, ThDepthBG], nonzero flow, warped position inside the image.
    Returns (uv, depth, flow, corres, valid)."""
    h, w = mask.shape
    d, inb = lookup_nearest(depth, cand_uv)
    m, _ = lookup_nearest(mask, cand_uv)
    f = _flow_at(flow, cand_uv)
    corres = cand_uv + f
    keep = (cand_valid & inb & (m == 0) & (d > 0) & (d <= th_depth_bg)
            & (f[:, 0] != 0) & (f[:, 1] != 0) & _corres_inside(corres, h, w))
    (uv, d, f, corres), valid, _ = compact_by_mask((cand_uv, d, f, corres),
                                                   keep, cap)
    return uv, d, f, corres, valid


def select_object_points(depth, flow, mask, th_depth_obj: float, cap: int,
                         step: int = 4):
    """Semi-dense object sampling on the stride-``step`` grid inside the
    mask (Frame.cc:769-809).  Returns (uv, depth, flow, corres, sem,
    valid)."""
    h, w = mask.shape
    uv = stride_grid_uv(h, w, step, device=mask.device)
    d, _ = lookup_nearest(depth, uv)
    m, _ = lookup_nearest(mask, uv)
    f = _flow_at(flow, uv)
    corres = uv + f
    keep = ((m != 0) & (d > 0) & (d < th_depth_obj)
            & _corres_inside(corres, h, w))
    (uv, d, f, corres, m), valid, _ = compact_by_mask(
        (uv, d, f, corres, m), keep, cap)
    return uv, d, f, corres, m.to(torch.int32), valid


def _line_samples(cand_uv4, depth, flow, mask):
    s_uv, e_uv = cand_uv4[:, :2], cand_uv4[:, 2:]
    ds, inb_s = lookup_nearest(depth, s_uv)
    de, inb_e = lookup_nearest(depth, e_uv)
    ms, _ = lookup_nearest(mask, s_uv)
    me, _ = lookup_nearest(mask, e_uv)
    f4 = torch.cat([_flow_at(flow, s_uv), _flow_at(flow, e_uv)], -1)
    degenerate = ((torch.abs(s_uv[:, 0] - e_uv[:, 0]) < 1e-6)
                  & (torch.abs(s_uv[:, 1] - e_uv[:, 1]) < 1e-6))
    return ds, de, inb_s & inb_e & ~degenerate, ms, me, f4


def select_static_lines(cand_uv4, cand_valid, depth, flow, mask,
                        th_depth_bg: float, cap: int):
    """Static-line selection (Frame.cc:516-603): both endpoints mask == 0,
    depths in (0, ThDepthBG], the midpoint depth-discontinuity test
    (|d_mid - (d_s+d_e)/2| <= 10*len/1000, Frame.cc:349-380), nonzero
    endpoint flows, warped endpoints inside the image."""
    h, w = mask.shape
    ds, de, ok, ms, me, f4 = _line_samples(cand_uv4, depth, flow, mask)
    s_uv, e_uv = cand_uv4[:, :2], cand_uv4[:, 2:]
    dm, _ = lookup_nearest(depth, 0.5 * (s_uv + e_uv))
    length = torch.linalg.norm(e_uv - s_uv, dim=-1)
    disc_ok = torch.abs(dm - 0.5 * (ds + de)) <= 10.0 * length / 1000.0
    corres = cand_uv4 + f4
    keep = (cand_valid & ok & (ms == 0) & (me == 0)
            & (ds > 0) & (ds <= th_depth_bg) & (de > 0) & (de <= th_depth_bg)
            & disc_ok & (f4 != 0).all(-1) & _corres_inside(corres, h, w))
    d2 = torch.stack([ds, de], -1)
    (uv4, d2, f4, corres), valid, _ = compact_by_mask(
        (cand_uv4, d2, f4, corres), keep, cap)
    return uv4, d2, f4, corres, valid


def select_object_lines(cand_uv4, cand_valid, depth, flow, mask,
                        th_depth_obj: float, cap: int):
    """Object-line selection: both endpoints on the same nonzero mask label
    (Frame.cc:529-534, :814-875), depths in (0, ThDepthObj), warped
    endpoints inside the image."""
    h, w = mask.shape
    ds, de, ok, ms, me, f4 = _line_samples(cand_uv4, depth, flow, mask)
    corres = cand_uv4 + f4
    keep = (cand_valid & ok & (ms != 0) & (ms == me)
            & (ds > 0) & (ds < th_depth_obj) & (de > 0) & (de < th_depth_obj)
            & _corres_inside(corres, h, w))
    d2 = torch.stack([ds, de], -1)
    (uv4, d2, f4, corres, ms), valid, _ = compact_by_mask(
        (cand_uv4, d2, f4, corres, ms), keep, cap)
    return uv4, d2, f4, corres, ms.to(torch.int32), valid


def world_points(K: Intrinsics, T_cw: torch.Tensor, uv: torch.Tensor,
                 depth: torch.Tensor) -> torch.Tensor:
    """Unproject pixels (..., N, 2) at depth (..., N) into WORLD coordinates
    through camera poses (..., 4, 4) (``Optimizer::Get3DinWorld``)."""
    return lie.transform_point(lie.se3_inv(T_cw),
                               geometry.backproject(K, uv, depth))


def world_lines(K: Intrinsics, T_cw: torch.Tensor, uv4: torch.Tensor,
                depth2: torch.Tensor) -> torch.Tensor:
    """World 3D endpoints (start, end) of image segments -> (..., 6)."""
    s = world_points(K, T_cw, uv4[..., :2], depth2[..., 0])
    e = world_points(K, T_cw, uv4[..., 2:], depth2[..., 1])
    return torch.cat([s, e], -1)


def preprocess_depth(depth_raw: torch.Tensor, choose_data: int,
                     depth_map_factor: float, bf: float) -> torch.Tensor:
    """Depth conversion (Tracking.cc:192-219): negatives -> 0; OMD (1)
    divides by DepthMapFactor; KITTI (2) converts disparity as
    bf / (d / factor); any other mode (VirtualKITTI = 3) matches neither
    reference branch and leaves the values unscaled."""
    zero = torch.zeros_like(depth_raw)
    d = torch.where(depth_raw < 0, zero, depth_raw)
    if choose_data == 1:
        out = d / depth_map_factor
    elif choose_data == 2:
        # a true division: ``bf / tensor`` would take the reciprocal first
        out = torch.where(d > 0, torch.div(torch.full_like(d, bf),
                                           d / depth_map_factor), zero)
    else:
        out = d
    return torch.where(depth_raw < 0, zero, out)
