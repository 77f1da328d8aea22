"""Host-side (numpy) frame feature-selection ops.

The per-frame dense-maps -> feature-arrays transition produces small
arrays whose consumers are host bookkeeping (renewal, map appends), so
the selections, the frame-to-frame inheritance and the line track filter
run on the host; the solvers run on the tracker's device.  Identical to
the JAX package's ``models.frame_host``.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=4)
def _stride_grid(h: int, w: int, step: int):
    vs, us = np.mgrid[0:h:step, 0:w:step]
    us = us.ravel()
    vs = vs.ravel()
    uv = np.stack([us, vs], -1).astype(np.float32)
    return us, vs, uv



def _lookup(img: np.ndarray, uv: np.ndarray):
    h, w = img.shape[:2]
    u = np.floor(uv[..., 0]).astype(np.int32)
    v = np.floor(uv[..., 1]).astype(np.int32)
    inb = (u > 0) & (u < w - 1) & (v > 0) & (v < h - 1)
    return img[np.clip(v, 0, h - 1), np.clip(u, 0, w - 1)], inb


def _compact(arrays, keep: np.ndarray, cap: int):
    idx = np.nonzero(keep)[0][:cap]
    n = len(idx)
    out = []
    for a in arrays:
        o = np.zeros((cap,) + a.shape[1:], a.dtype)
        o[:n] = a[idx]
        out.append(o)
    valid = np.arange(cap) < n
    return out, valid


def select_static_points(cand_uv, cand_valid, depth, flow, mask,
                         th_depth_bg, cap):
    h, w = mask.shape
    d, inb = _lookup(depth, cand_uv)
    m, _ = _lookup(mask, cand_uv)
    f, _ = _lookup(flow, cand_uv)
    corres = cand_uv + f
    keep = (
        cand_valid & inb & (m == 0) & (d > 0) & (d <= th_depth_bg)
        & (f[:, 0] != 0) & (f[:, 1] != 0)
        & (corres[:, 0] < w) & (corres[:, 1] < h)
        & (corres[:, 0] > 0) & (corres[:, 1] > 0)
    )
    (uv, d, f, corres), valid = _compact((cand_uv, d, f, corres), keep, cap)
    return uv, d, f, corres, valid


def select_object_points(depth, flow, mask, th_depth_obj, cap, step=4):
    h, w = mask.shape
    us, vs, uv = _stride_grid(h, w, step)
    d = depth[vs, us]
    m = mask[vs, us]
    f = flow[vs, us]
    corres = uv + f
    keep = (
        (m != 0) & (d > 0) & (d < th_depth_obj)
        & (corres[:, 0] < w) & (corres[:, 0] > 0)
        & (corres[:, 1] < h) & (corres[:, 1] > 0)
    )
    (uv, d, f, corres, m), valid = _compact((uv, d, f, corres, m), keep, cap)
    return uv, d, f, corres, m.astype(np.int32), valid


def select_static_lines(cand_uv4, cand_valid, depth, flow, mask,
                        th_depth_bg, cap):
    h, w = mask.shape
    s_uv, e_uv = cand_uv4[:, :2], cand_uv4[:, 2:]
    ds, inb_s = _lookup(depth, s_uv)
    de, inb_e = _lookup(depth, e_uv)
    ms, _ = _lookup(mask, s_uv)
    me, _ = _lookup(mask, e_uv)
    dm, _ = _lookup(depth, 0.5 * (s_uv + e_uv))
    length = np.linalg.norm(e_uv - s_uv, axis=-1)
    disc_ok = np.abs(dm - 0.5 * (ds + de)) <= 10.0 * length / 1000.0
    fs, _ = _lookup(flow, s_uv)
    fe, _ = _lookup(flow, e_uv)
    f4 = np.concatenate([fs, fe], 1)
    corres = cand_uv4 + f4
    degen = (np.abs(s_uv[:, 0] - e_uv[:, 0]) < 1e-6) & (
        np.abs(s_uv[:, 1] - e_uv[:, 1]) < 1e-6
    )
    inb_c = (
        (corres[:, 0] < w) & (corres[:, 0] > 0)
        & (corres[:, 1] < h) & (corres[:, 1] > 0)
        & (corres[:, 2] < w) & (corres[:, 2] > 0)
        & (corres[:, 3] < h) & (corres[:, 3] > 0)
    )
    keep = (
        cand_valid & inb_s & inb_e & ~degen
        & (ms == 0) & (me == 0)
        & (ds > 0) & (ds <= th_depth_bg) & (de > 0) & (de <= th_depth_bg)
        & disc_ok
        & (fs[:, 0] != 0) & (fs[:, 1] != 0) & (fe[:, 0] != 0) & (fe[:, 1] != 0)
        & inb_c
    )
    d2 = np.stack([ds, de], 1)
    (uv4, d2, f4, corres), valid = _compact(
        (cand_uv4, d2, f4, corres), keep, cap
    )
    return uv4, d2, f4, corres, valid


def select_object_lines(cand_uv4, cand_valid, depth, flow, mask,
                        th_depth_obj, cap):
    h, w = mask.shape
    s_uv, e_uv = cand_uv4[:, :2], cand_uv4[:, 2:]
    ds, inb_s = _lookup(depth, s_uv)
    de, inb_e = _lookup(depth, e_uv)
    ms, _ = _lookup(mask, s_uv)
    me, _ = _lookup(mask, e_uv)
    fs, _ = _lookup(flow, s_uv)
    fe, _ = _lookup(flow, e_uv)
    f4 = np.concatenate([fs, fe], 1)
    corres = cand_uv4 + f4
    degen = (np.abs(s_uv[:, 0] - e_uv[:, 0]) < 1e-6) & (
        np.abs(s_uv[:, 1] - e_uv[:, 1]) < 1e-6
    )
    inb_c = (
        (corres[:, 0] < w) & (corres[:, 0] > 0)
        & (corres[:, 1] < h) & (corres[:, 1] > 0)
        & (corres[:, 2] < w) & (corres[:, 2] > 0)
        & (corres[:, 3] < h) & (corres[:, 3] > 0)
    )
    keep = (
        cand_valid & inb_s & inb_e & ~degen
        & (ms != 0) & (ms == me)
        & (ds > 0) & (ds < th_depth_obj) & (de > 0) & (de < th_depth_obj)
        & inb_c
    )
    d2 = np.stack([ds, de], 1)
    (uv4, d2, f4, corres, ms), valid = _compact(
        (cand_uv4, d2, f4, corres, ms), keep, cap
    )
    return uv4, d2, f4, corres, ms.astype(np.int32), valid


def inherit(last_stat_corres, last_line_corres, last_obj_corres,
            last_oline_corres, depth, mask, th_depth_obj):
    """Host mirror of Tracking._inherit (Tracking.cc:269-473)."""
    s_uv = last_stat_corres.copy()
    s_d, s_inb = _lookup(depth, s_uv)
    s_d = np.where(s_inb & (s_d > 0), s_d, -1.0).astype(np.float32)

    l_uv = last_line_corres.copy()
    ld_s, li_s = _lookup(depth, l_uv[:, :2])
    ld_e, li_e = _lookup(depth, l_uv[:, 2:])
    l_ok = li_s & li_e & (ld_s > 0) & (ld_e > 0)
    l_d = np.where(
        l_ok[:, None], np.stack([ld_s, ld_e], 1), -1.0
    ).astype(np.float32)

    o_uv = last_obj_corres.copy()
    o_d, o_inb = _lookup(depth, o_uv)
    o_m, _ = _lookup(mask, o_uv)
    o_ok = o_inb & (o_d < th_depth_obj) & (o_d > 0)
    o_d = np.where(o_ok, o_d, 0.1).astype(np.float32)
    o_sem = np.where(o_ok, o_m, 0).astype(np.int32)

    ol_uv = last_oline_corres.copy()
    old_s, oli_s = _lookup(depth, ol_uv[:, :2])
    old_e, oli_e = _lookup(depth, ol_uv[:, 2:])
    olm, _ = _lookup(mask, ol_uv[:, :2])
    ol_ok = (
        oli_s & oli_e
        & (old_s > 0) & (old_s < th_depth_obj)
        & (old_e > 0) & (old_e < th_depth_obj)
    )
    ol_d = np.where(
        ol_ok[:, None], np.stack([old_s, old_e], 1), 0.1
    ).astype(np.float32)
    ol_sem = np.where(ol_ok, olm, 0).astype(np.int32)
    return s_uv, s_d, l_uv, l_d, o_uv, o_d, o_sem, ol_uv, ol_d, ol_sem


def line_track_filter(line_uv, line_valid, depth, mask):
    """Host mirror of the Track() line validity filter
    (Tracking.cc:1056-1099)."""
    s_uv, e_uv = line_uv[:, :2], line_uv[:, 2:]
    ds, _ = _lookup(depth, s_uv)
    de, _ = _lookup(depth, e_uv)
    dm, _ = _lookup(depth, 0.5 * (s_uv + e_uv))
    ms, _ = _lookup(mask, s_uv)
    me, _ = _lookup(mask, e_uv)
    length = np.linalg.norm(e_uv - s_uv, axis=-1)
    ok = (
        (np.abs(dm - 0.5 * (ds + de)) <= 10.0 * length / 1000.0)
        & (ms == 0) & (me == 0)
    )
    return line_valid & ok
