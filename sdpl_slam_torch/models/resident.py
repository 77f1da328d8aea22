"""Device-resident frame loop: the whole per-frame pipeline against device
state (counterpart of the JAX package's ``models.resident``).

The tracked-feature state stays on the tracker's device between frames:
frame t+1's step consumes frame t's renewal output device to device, the
host pushes the image planes and receives the map rows on a stream that
lags ``ResidentDriver.LAG`` frames behind.  Everything inside the step is
fixed-shape tensor code with the host path's semantics:

 * mask recovery               (Tracking.cc:4730-4810, tracking._update_mask)
 * inheritance                 (Tracking.cc:269-473,  frame_host.inherit)
 * candidate selections        (Frame.cc:491-875,     frame.select_*)
 * object grouping/association (Tracking.cc:2077-2523, 2631-2699)
 * camera + object solves      (solvers.frame_solvers, as in tracking)
 * scene-flow static test      (Tracking.cc:1989-2075, 2528-2560)
 * label commit + id allocation(Tracking.cc:2560-2736)
 * feature renewal             (Tracking.cc:3959-4730)

No value is read on the host inside a step but the joint LM's loop-exit
tests (``FlowPoseResult.host_syncs``): compactions are cumsum ranks and
scatters or stable sorts, never ``nonzero`` / ``unique`` / boolean
indexing, and matrix inverses skip their error check (``inv_ex``).  JAX
``vmap`` over object lanes is a leading lane dim here.

The whole frame -- detectors and step, the counterpart of the JAX
driver's one jitted ``run`` -- is :func:`build_resident_frame`, run by a
:class:`ResidentProgram` over static buffers: the host copies a frame's
inputs into them, the program writes the new state and the packed output
into them.  On the CPU the program runs eagerly.  On the card
(:func:`graph_resident_step`) it is captured once into CUDA graphs, with
both joint LMs ending on the device in conditional WHILE nodes
(``utils.cuda_graphs``), so a frame is one graph launch and the host
reads nothing back until the lagged output copy.

The per-object host bookkeeping that only feeds the map (GT motions,
speeds, output rows) stays on the host, consuming the lagged stream.
"""

from __future__ import annotations

import collections
import functools
import time
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fast as fast_ops
from ..ops import geometry, lie, ransac
from ..ops import lines as line_ops
from ..ops.geometry import Intrinsics
from ..solvers import ba_builder
from ..solvers import frame_solvers as fs
from ..utils import metrics
from ..utils.device import copy_in, host_array, scatter_add, to_host_async
from . import frame as fr

_BIG = torch.iinfo(torch.int32).max


class ResidentState(NamedTuple):
    """Device-resident tracked-feature state (the host ``last`` dict +
    ``last_meta`` + mask/flow mirrors).  Floats are float32, labels and
    provenance int32, masks bool."""

    pose: torch.Tensor         # (4,4) T_cw of the last processed frame
    velocity: torch.Tensor     # (4,4) mVelocity
    # static points (NS)
    s_uv: torch.Tensor
    s_d: torch.Tensor
    s_f: torch.Tensor
    s_c: torch.Tensor
    s_valid: torch.Tensor
    # static lines (NLS)
    l_uv: torch.Tensor
    l_d: torch.Tensor
    l_f: torch.Tensor
    l_c: torch.Tensor
    l_valid: torch.Tensor
    # object points (NO)
    o_uv: torch.Tensor
    o_d: torch.Tensor
    o_f: torch.Tensor
    o_c: torch.Tensor
    o_sem: torch.Tensor
    o_label: torch.Tensor
    o_valid: torch.Tensor
    # object lines (NLO)
    ol_uv: torch.Tensor
    ol_d: torch.Tensor
    ol_f: torch.Tensor
    ol_c: torch.Tensor
    ol_sem: torch.Tensor
    ol_label: torch.Tensor
    ol_valid: torch.Tensor
    # association meta (last_meta; row order = committed group order)
    meta_sem: torch.Tensor     # (MAXO,) int32
    meta_label: torch.Tensor   # (MAXO,) int32
    meta_stat: torch.Tensor    # (MAXO,) bool
    meta_motion: torch.Tensor  # (MAXO,4,4)
    meta_n: torch.Tensor       # () int32
    max_id: torch.Tensor       # () int32
    # image mirrors for the next frame's mask recovery
    last_mask: torch.Tensor    # (H,W) int32
    last_flow: torch.Tensor    # (H,W,2) float32
    # provenance of each row w.r.t. the previous state: asso >= 0 = kept
    # from that previous row; else cand >= 0 = born from that candidate
    s_asso: torch.Tensor
    s_cand: torch.Tensor
    l_asso: torch.Tensor
    l_cand: torch.Tensor
    o_asso: torch.Tensor
    o_cand: torch.Tensor
    ol_asso: torch.Tensor
    ol_cand: torch.Tensor


def _i32(x):
    return x.to(torch.int32)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, a.dtype)).dtype


def _eye4(like):
    return torch.eye(4, dtype=torch.float32, device=like.device)


def _inv(T):
    """General 4x4 inverse (``jnp.linalg.inv``) without the error check
    that would read a value on the host."""
    return torch.linalg.inv_ex(T)[0]


def _take(a, idx):
    """Rows ``idx`` (*B, k) of ``a`` (*B, n, *F), lane by lane ->
    (*B, k, *F)."""
    nb = idx.dim() - 1
    feat = a.shape[nb + 1:]
    ix = idx.reshape(idx.shape + (1,) * len(feat)).expand(idx.shape + feat)
    return torch.gather(a, nb, ix)


def _lookup(img, uv):
    """img[(int)v, (int)u] clamped + the reference's open-interval bounds."""
    return fr.lookup_nearest(img, uv)


def _first_k(mask, k, order=None):
    """Indices of the first ``k`` True entries along the last dim (in the
    fixed permutation ``order`` if given): ``np.nonzero(m)[0][:k]`` /
    ``order[m[order]][:k]``.  Rank by cumsum, placed by a scatter.
    Returns (idx (..., k) int64, valid (..., k)); invalid rows hold n-1
    (0 with ``order``), as JAX's ``nonzero(size=k, fill_value=n)`` gives
    them after its clip."""
    n = mask.shape[-1]
    m = mask if order is None else mask[..., order]
    rank = torch.cumsum(m.to(torch.int64), -1) - 1
    slot = torch.where(m & (rank < k), rank, torch.full_like(rank, k))
    ar = torch.arange(n, device=mask.device).expand(m.shape)
    pos = torch.full(m.shape[:-1] + (k + 1,), n, dtype=torch.int64,
                     device=mask.device)
    pos = pos.scatter(-1, slot, ar)[..., :k]
    valid = pos < n
    if order is None:
        return torch.where(valid, pos, torch.full_like(pos, n - 1)), valid
    idx = order[pos.clamp(max=n - 1)]
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


def _sorted_unique(vals, valid, cap):
    """First ``cap`` distinct values of vals[valid] in ascending order
    (``np.unique``).  Returns (uniq (cap,), uniq_valid (cap,))."""
    s = torch.sort(torch.where(valid, vals, torch.full_like(vals, _BIG)),
                   -1).values
    isnew = torch.ones_like(s, dtype=torch.bool)
    isnew[..., 1:] = s[..., 1:] != s[..., :-1]
    idx, ok = _first_k(isnew & (s != _BIG), cap)
    return torch.gather(s, -1, idx), ok


def _scatter_occupancy(h, w, uv, valid):
    """1px-dilated occupancy bitmap of the valid rows of ``uv`` (..., N, 2)
    (tracking._near_occupied): (..., (h+2)*(w+2) + 1) bool, whose last slot
    absorbs the invalid rows."""
    size = (h + 2) * (w + 2)
    x = uv[..., 0].to(torch.int64).clamp(0, w - 1)
    y = uv[..., 1].to(torch.int64).clamp(0, h - 1)
    base = y * (w + 2) + x
    occ = torch.zeros(uv.shape[:-2] + (size + 1,), dtype=torch.bool,
                      device=uv.device)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            idx = torch.where(valid, base + dy * (w + 2) + dx,
                              torch.full_like(base, size))
            occ.scatter_(-1, idx, True)
    return occ


def _near_occupied(occ, uv, h, w):
    x = uv[:, 0].to(torch.int64).clamp(0, w - 1)
    y = uv[:, 1].to(torch.int64).clamp(0, h - 1)
    return occ[..., (y + 1) * (w + 2) + x + 1]


def _line_dup(cand_uv4, kept_uv4, kept_valid):
    """Static-line dedup gate (Tracking.cc:4174-4203), with the expanded
    |a|^2 + |b|^2 - 2 a.b midpoint distance of the JAX package."""
    c_dir = cand_uv4[:, 2:] - cand_uv4[:, :2]
    k_dir = kept_uv4[:, 2:] - kept_uv4[:, :2]
    c_mid = 0.5 * (cand_uv4[:, 2:] + cand_uv4[:, :2])
    k_mid = 0.5 * (kept_uv4[:, 2:] + kept_uv4[:, :2])
    c_len = torch.linalg.norm(c_dir, dim=1) + 1e-9
    k_len = torch.linalg.norm(k_dir, dim=1) + 1e-9
    cosang = (c_dir @ k_dir.T) / (c_len[:, None] * k_len[None, :])
    md2 = (torch.sum(c_mid * c_mid, 1)[:, None]
           + torch.sum(k_mid * k_mid, 1)[None, :]
           - 2.0 * (c_mid @ k_mid.T))
    r = 0.5 * torch.maximum(c_len[:, None], k_len[None, :])
    dup = ((cosang > float(np.cos(np.pi / 30))) & (md2 < r * r)
           & kept_valid[None, :])
    return dup.any(1)


def _obj_line_dup(cand_uv4, kept_uv4, kept_valid):
    """Object-line dedup gate (Tracking.cc:4584-4602): angle < 1 rad and
    midpoint distance < 1 px.  ``kept_uv4`` (..., K, 4) may carry lane
    dims; candidates (N, 4) are shared -> (..., N)."""
    a1 = torch.atan2(cand_uv4[:, 3] - cand_uv4[:, 1],
                     cand_uv4[:, 2] - cand_uv4[:, 0])
    a2 = torch.atan2(kept_uv4[..., 3] - kept_uv4[..., 1],
                     kept_uv4[..., 2] - kept_uv4[..., 0])
    ad = torch.abs(a1[:, None] - a2[..., None, :])
    ad = torch.where(ad > np.pi, 2 * np.pi - ad, ad)
    m1 = 0.5 * (cand_uv4[:, :2] + cand_uv4[:, 2:])
    m2 = 0.5 * (kept_uv4[..., :2] + kept_uv4[..., 2:])
    md2 = (torch.sum(m1 * m1, 1)[:, None]
           + torch.sum(m2 * m2, -1)[..., None, :]
           - 2.0 * (m1 @ m2.transpose(-1, -2)))
    dup = (ad < 1.0) & (md2 < 1.0) & kept_valid[..., None, :]
    return dup.any(-1)


@functools.lru_cache(maxsize=8)
def _strided_order(n: int, step: int, device) -> torch.Tensor:
    """0, step, 2 step, ..., 1, 1 + step, ...: the renewal's strided
    top-up order, made on ``device`` (no host copy)."""
    return torch.cat([torch.arange(s, n, step, device=device)
                      for s in range(step)])


def _runs(vals, valid):
    """Sorted masked values (invalid -> int32 max), run heads and the
    length of each run at its head (-1 elsewhere), along the last dim."""
    s = torch.sort(torch.where(valid, vals, torch.full_like(vals, _BIG)),
                   -1).values
    heads = torch.ones_like(s, dtype=torch.bool)
    heads[..., 1:] = s[..., 1:] != s[..., :-1]
    n = s.shape[-1]
    run_id = torch.cumsum(heads.to(torch.int64), -1) - 1
    # segment_sum of ones over the runs, all lanes in one flat scatter
    lane = torch.arange(run_id.numel() // n, device=s.device).reshape(
        s.shape[:-1] + (1,)) * n
    counts = torch.zeros(run_id.numel(), dtype=torch.int64, device=s.device)
    scatter_add(counts, (run_id + lane).reshape(-1),
                torch.ones_like(counts))
    counts = counts.reshape(s.shape)
    head_count = torch.where(heads & (s != _BIG),
                             torch.gather(counts, -1, run_id),
                             torch.full_like(counts, -1))
    return s, head_count


def _majority_nonzero_is_bg(samples, valid):
    """True iff the most frequent value among samples[valid] is 0
    (``np.unique(..., return_counts)`` argmax: ties to the smallest
    value); also whether any sample is valid.  Lane dims lead."""
    s, head_count = _runs(samples, valid)
    best = torch.argmax(head_count, -1, keepdim=True)  # first max
    return torch.gather(s, -1, best)[..., 0] == 0, valid.any(-1)


def _masked_mode(vals, valid):
    """Most frequent value among vals[valid]; smallest on ties.  Returns
    (mode_value, any_valid); lane dims lead."""
    s, head_count = _runs(vals, valid)
    best = torch.argmax(head_count, -1, keepdim=True)
    return torch.gather(s, -1, best)[..., 0], valid.any(-1)


def _rank_within_sem(sem, active, n_total):
    """For the rows where ``active`` holds, the 0-based rank of each row
    within its semantic label, in ascending row order (the host's per-label
    ``nonzero()[:cap]``); ``n_total`` elsewhere."""
    n = sem.shape[0]
    key = torch.where(active, sem, torch.full_like(sem, _BIG))
    order = torch.argsort(key, stable=True)          # sem-major, idx-minor
    s_sorted = key[order]
    heads = torch.ones_like(s_sorted, dtype=torch.bool)
    heads[1:] = s_sorted[1:] != s_sorted[:-1]
    pos = torch.arange(n, device=sem.device)
    run_start = torch.cummax(torch.where(heads, pos, torch.full_like(pos, -1)),
                             0).values
    rank = torch.zeros(n, dtype=torch.int64, device=sem.device)
    rank[order] = pos - run_start
    return torch.where(active, rank, torch.full_like(rank, n_total))


def _bdims(mask, ndim):
    return mask.reshape(mask.shape + (1,) * (ndim - mask.dim()))


def _merge_keep_topup(kept_vals, kept_n, top_vals, top_n, cap):
    """Rows 0..kept_n-1 from the kept arrays, then the top-up rows, into
    ``cap`` rows (lane dims lead; ``kept_n``/``top_n`` carry them)."""
    j = torch.arange(cap, device=kept_n.device)
    kn = kept_n[..., None]
    take_top = j >= kn
    tidx = (j - kn).clamp(0, cap - 1)
    out = tuple(torch.where(_bdims(take_top, k.dim()), _take(t, tidx), k)
                for k, t in zip(kept_vals, top_vals))
    valid = j < torch.clamp(kn + top_n[..., None], max=cap)
    return out, valid


# ---------------------------------------------------------------------------
# dense stage: mask recovery, inheritance, plane filters
# ---------------------------------------------------------------------------

def update_mask_dev(mask, state: ResidentState, maxo: int):
    """Mask recovery (Tracking.cc:4730-4810, tracking._update_mask).  The
    vote runs once per recovered label, as a lane dim; the splat of all
    recovered labels is one scatter-max, which reproduces the host's
    ascending-label overwrite order (the larger label wins a collision in
    both)."""
    h, w = mask.shape
    sem = state.o_sem
    valid = state.o_valid & (sem > 0)
    labs, lab_ok = _sorted_unique(sem, valid, maxo)

    u = state.o_c[:, 0].to(torch.int64)
    v = state.o_c[:, 1].to(torch.int64)
    inb = (u > 0) & (u < w) & (v > 0) & (v < h)
    samples = mask[v.clamp(0, h - 1), u.clamp(0, w - 1)]
    sel = valid & (sem == labs[:, None]) & inb                  # (maxo, NO)
    enough = sel.sum(1) >= 100
    is_bg, any_s = _majority_nonzero_is_bg(
        samples.expand(maxo, -1), sel)
    recover = lab_ok & enough & is_bg & any_s                   # (maxo,)

    # per pixel: is this pixel's last label one that is recovered?
    rec_pix = ((state.last_mask == labs[:, None, None])
               & recover[:, None, None]).any(0)
    ys = torch.arange(h, device=mask.device)[:, None]
    xs = torch.arange(w, device=mask.device)[None, :]
    nx = xs + state.last_flow[..., 0].to(torch.int64)
    ny = ys + state.last_flow[..., 1].to(torch.int64)
    ok = rec_pix & (nx > 0) & (nx < w) & (ny > 0) & (ny < h)
    flat = (ny.clamp(0, h - 1) * w + nx.clamp(0, w - 1)).reshape(-1)
    src = torch.where(ok, state.last_mask, torch.zeros_like(state.last_mask))
    splat = torch.zeros(h * w, dtype=mask.dtype, device=mask.device)
    splat = splat.scatter_reduce(0, flat, src.reshape(-1).to(mask.dtype),
                                 "amax").reshape(h, w)
    return torch.where(splat > 0, splat, mask)


def inherit_dev(state: ResidentState, depth, mask, th_depth_obj):
    """Device counterpart of frame_host.inherit (Tracking.cc:269-473)."""
    s_uv = state.s_c
    s_d, s_inb = _lookup(depth, s_uv)
    s_d = torch.where(s_inb & (s_d > 0), s_d, torch.full_like(s_d, -1.0))

    l_uv = state.l_c
    ld_s, li_s = _lookup(depth, l_uv[:, :2])
    ld_e, li_e = _lookup(depth, l_uv[:, 2:])
    l_ok = li_s & li_e & (ld_s > 0) & (ld_e > 0)
    l_d = torch.stack([ld_s, ld_e], 1)
    l_d = torch.where(l_ok[:, None], l_d, torch.full_like(l_d, -1.0))

    o_uv = state.o_c
    o_d, o_inb = _lookup(depth, o_uv)
    o_m, _ = _lookup(mask, o_uv)
    o_ok = o_inb & (o_d < th_depth_obj) & (o_d > 0)
    o_d = torch.where(o_ok, o_d, torch.full_like(o_d, 0.1))
    o_sem = _i32(torch.where(o_ok, o_m, torch.zeros_like(o_m)))

    ol_uv = state.ol_c
    old_s, oli_s = _lookup(depth, ol_uv[:, :2])
    old_e, oli_e = _lookup(depth, ol_uv[:, 2:])
    olm, _ = _lookup(mask, ol_uv[:, :2])
    ol_ok = (oli_s & oli_e & (old_s > 0) & (old_s < th_depth_obj)
             & (old_e > 0) & (old_e < th_depth_obj))
    ol_d = torch.stack([old_s, old_e], 1)
    ol_d = torch.where(ol_ok[:, None], ol_d, torch.full_like(ol_d, 0.1))
    ol_sem = _i32(torch.where(ol_ok, olm, torch.zeros_like(olm)))
    return s_uv, s_d, l_uv, l_d, o_uv, o_d, o_sem, ol_uv, ol_d, ol_sem


def line_track_filter_dev(line_uv, line_valid, depth, mask):
    """Device counterpart of frame_host.line_track_filter
    (Tracking.cc:1056-1099)."""
    s_uv, e_uv = line_uv[:, :2], line_uv[:, 2:]
    ds, _ = _lookup(depth, s_uv)
    de, _ = _lookup(depth, e_uv)
    dm, _ = _lookup(depth, 0.5 * (s_uv + e_uv))
    ms, _ = _lookup(mask, s_uv)
    me, _ = _lookup(mask, e_uv)
    length = torch.linalg.norm(e_uv - s_uv, dim=-1)
    ok = ((torch.abs(dm - 0.5 * (ds + de)) <= 10.0 * length / 1000.0)
          & (ms == 0) & (me == 0))
    return line_valid & ok


def _trunc_at(uv, h, w):
    """Truncated x, y of ``uv`` and the clamped (row, column) index of
    those pixels (the renewal filters' ``.astype(int32)`` lookups)."""
    x = uv[:, 0].to(torch.int64)
    y = uv[:, 1].to(torch.int64)
    return x, y, (y.clamp(0, h - 1), x.clamp(0, w - 1))


def _filt_point(uv, depth, flow, mask):
    """Renewal point filter (tracking._renew_frame_info.filt_point; 40.0 is
    the reference's hard-coded renewal depth gate)."""
    h, w = mask.shape
    x, y, at = _trunc_at(uv, h, w)
    inb = (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1)
    m, d, f = mask[at], depth[at], flow[at]
    corr = uv + f
    ok = (inb & (m == 0) & (d > 0) & (d <= 40.0)
          & (f[:, 0] != 0) & (f[:, 1] != 0)
          & (corr[:, 0] < w) & (corr[:, 0] > 0)
          & (corr[:, 1] < h) & (corr[:, 1] > 0))
    return ok, d, f, corr


def _filt_line(uv4, depth, flow, mask):
    """Renewal line filter (tracking._renew_frame_info.filt_line)."""
    h, w = mask.shape
    xs, ys, at_s = _trunc_at(uv4[:, :2], h, w)
    xe, ye, at_e = _trunc_at(uv4[:, 2:], h, w)
    inb = ((xs > 0) & (xs < w - 1) & (ys > 0) & (ys < h - 1)
           & (xe > 0) & (xe < w - 1) & (ye > 0) & (ye < h - 1))
    ms, me = mask[at_s], mask[at_e]
    ds, de = depth[at_s], depth[at_e]
    dm = depth[((ys + ye) // 2).clamp(0, h - 1),
               ((xs + xe) // 2).clamp(0, w - 1)]
    ln = torch.sqrt(((xs - xe) ** 2 + (ys - ye) ** 2).to(torch.float32))
    disc = torch.abs(dm - 0.5 * (ds + de)) <= 10.0 * ln / 1000.0
    f4 = torch.cat([flow[at_s], flow[at_e]], 1)
    corr = uv4 + f4
    degen = ((torch.abs(uv4[:, 0] - uv4[:, 2]) < 1e-6)
             & (torch.abs(uv4[:, 1] - uv4[:, 3]) < 1e-6))
    ok = (inb & ~degen & (ms == 0) & (me == 0)
          & (ds > 0) & (ds <= 40.0) & (de > 0) & (de <= 40.0) & disc
          & (corr[:, 0] > 0) & (corr[:, 0] < w)
          & (corr[:, 1] > 0) & (corr[:, 1] < h)
          & (corr[:, 2] > 0) & (corr[:, 2] < w)
          & (corr[:, 3] > 0) & (corr[:, 3] < h))
    return ok, torch.stack([ds, de], 1), f4, corr


def _obj_filt(uv, depth, flow, mask, th_depth_obj):
    """Renewal object-point filter (tracking._renew_frame_info.obj_filt)."""
    h, w = mask.shape
    x, y, at = _trunc_at(uv, h, w)
    inb = (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1)
    m, d, f = mask[at], depth[at], flow[at]
    corr = uv + f
    ok = (inb & (m != 0) & (d > 0) & (d < th_depth_obj)
          & (corr[:, 0] < w) & (corr[:, 0] > 0)
          & (corr[:, 1] < h) & (corr[:, 1] > 0))
    return ok, m, d, f, corr


class StageInputs(NamedTuple):
    """Plane-derived inputs to the core stage, computed from the full
    device planes by the resident step."""

    stat_tmp: tuple      # (uv, d, f, c, v)              candidate selections
    line_tmp: tuple      # (uv4, d2, f4, c4, v)
    obj_tmp: tuple       # (uv, d, f, c, sem, v)
    oline_tmp: tuple     # (uv4, d2, f4, c4, sem, v)
    inh: tuple           # inherit_dev outputs
    line_ok0: torch.Tensor


class DenseFilts:
    """Renewal plane filters over the full device planes."""

    def __init__(self, depth, flow, mask, th_depth_obj):
        self.depth, self.flow, self.mask = depth, flow, mask
        self.th = th_depth_obj

    # state rows, at their (solve-updated) positions
    def stat_state(self, uv):
        return _filt_point(uv, self.depth, self.flow, self.mask)

    def line_state(self, uv4):
        return _filt_line(uv4, self.depth, self.flow, self.mask)

    def obj_state(self, uv):
        return _obj_filt(uv, self.depth, self.flow, self.mask, self.th)

    # candidates (fixed positions)
    stat_cand = stat_state
    line_cand = line_state
    obj_cand = obj_state

    def oline_cand_ok(self, uv4):
        return _filt_line(uv4, self.depth, self.flow, self.mask)[0]

    def flow4(self, uv4):
        """Flow at both endpoints (invalid rows are zeroed to (0, 0) by the
        caller, so their lookup lands on flow[0, 0], as in JAX)."""
        h, w = self.mask.shape
        _, _, at_s = _trunc_at(uv4[:, :2], h, w)
        _, _, at_e = _trunc_at(uv4[:, 2:], h, w)
        return torch.cat([self.flow[at_s], self.flow[at_e]], 1)

    def flow4_final(self, uv4, carried_f4, valid):
        """Flow at the merged object-line rows: looked up again at their
        (zeroed where invalid) positions; the flows carried through the
        merge are for the sampled filters of the chained mode."""
        return self.flow4(uv4)


def dense_stage_inputs(cfg, state, depth, mask):
    """Inheritance and the line track filter from the full planes."""
    inh = inherit_dev(state, depth, mask, cfg.th_depth_obj)
    line_ok0 = line_track_filter_dev(inh[2], state.l_valid, depth, mask)
    return inh, line_ok0


# ---------------------------------------------------------------------------
# core stage: grouping, solves, commit, renewal
# ---------------------------------------------------------------------------

def init_model(K: Intrinsics, thr: float, u, model, T_lw, last_uv,
                last_depth, cur_uv, cur_depth, valid):
    """GetInitModelCam / GetInitModelObj (Tracking.cc:2738-2972) over B
    lanes: RANSAC (draws ``u`` (B, S, 3)) against the motion model
    ``model`` (B, 4, 4); whichever has more inliers gives the initial pose
    and the solve's point subset.  Returns (T_init, subset, n_inliers)."""
    X_w = fr.world_points(K, T_lw, last_uv, last_depth)
    X_c = geometry.backproject(K, cur_uv, cur_depth)
    rs = ransac.ransac_rigid_init(X_w, cur_uv, X_c, valid & (cur_depth > 0),
                                  K, u, thr)
    xyz = lie.transform_point(model, X_w)
    rpe = torch.linalg.norm(cur_uv - geometry.project(K, xyz), dim=-1)
    mm_inl = valid & (xyz[..., 2] > 0) & (rpe < thr)
    mm_n = mm_inl.sum(-1, dtype=torch.int32)
    use_ransac = rs.n_inliers > mm_n
    T_init = torch.where(use_ransac[:, None, None], rs.pose, model)
    subset = torch.where(use_ransac[:, None], rs.inliers, mm_inl)
    return T_init, subset, torch.maximum(rs.n_inliers, mm_n)


def scene_flow_static_frac(K: Intrinsics, sf_mg_thres: float, pose, T_wl,
                           o_obs, o_depth, o_cur_uv, o_cur_d, sf_valid):
    """Per object lane, the share of its valid points whose x-z world scene
    flow between the last frame (``o_obs`` at ``o_depth`` through ``T_wl``)
    and this one (through ``pose``) is below SFMgThres
    (Tracking.cc:1989-2075, :2528-2560)."""
    Xp_w = lie.transform_point(T_wl, geometry.backproject(K, o_obs, o_depth))
    Xc_w = lie.transform_point(_inv(pose),
                               geometry.backproject(K, o_cur_uv, o_cur_d))
    f3 = Xc_w - Xp_w
    sfn = torch.sqrt(f3[..., 0] ** 2 + f3[..., 2] ** 2)
    v = sf_valid.to(torch.float32)
    n = torch.clamp(v.sum(-1), min=1.0)
    return (v * (sfn < sf_mg_thres)).sum(-1) / n


def n_hypotheses(cfg):
    """RANSAC hypotheses of the camera and of each object lane: all in
    parallel, ``pnp_iterations`` the upper bound."""
    n_cam = max(min(int(cfg.pnp_iterations), 128), 8)
    return n_cam, max(n_cam // 2, 8)


def build_core_stage(cfg, K: Intrinsics, caps: dict):
    """The plane-free core of the per-frame step: grouping, solves,
    commit, renewal.  ``core(...)`` returns (new state, packed output
    buffer, LM host reads)."""
    NO, NLO = caps["NO"], caps["NLO"]
    P, L, MAXO, GCAP = caps["P"], caps["L"], caps["MAXO"], caps["GCAP"]
    KITTI = 2
    shr_c = cfg.boundary_shrink_x if cfg.choose_data == KITTI else 0
    shr_r = cfg.boundary_shrink_y if cfg.choose_data == KITTI else 0
    solve = functools.partial(
        fs.solve_flow_pose, K=K, rp_thres=cfg.rp_thres,
        max_iterations=cfg.lm_iterations, use_lines=cfg.use_lines,
        rel_tol=cfg.lm_rel_tol)

    def core(state: ResidentState, si: StageInputs, filts, hw,
             gt_sem_prev, gt_sem_cur, u_cam, u_obj, last_mask, last_flow):
        h, w = hw
        dev = state.pose.device
        I4 = _eye4(state.pose)
        (s_uv, s_d, l_uv, l_d, o_uv, o_d, o_sem, ol_uv, ol_d,
         ol_sem) = si.inh
        last_s_valid = state.s_valid & (state.s_d > 0) & (s_d > 0)
        line_ok0 = si.line_ok0 & state.l_valid
        l_use = (state.l_valid & (state.l_d.min(-1).values > 0) & line_ok0)
        T_lw = state.pose

        # ---- grouping (Tracking.cc:2077-2523) ----
        sf_valid = state.o_valid & (state.o_sem > 0) & (o_sem > 0)
        labs, lab_ok = _sorted_unique(o_sem, sf_valid, GCAP)
        pmask_all = (sf_valid & (o_sem == labs[:, None])
                     & lab_ok[:, None])                     # (GCAP, NO)
        lmask_all = (state.ol_valid & (ol_sem == labs[:, None])
                     & lab_ok[:, None])                     # (GCAP, NLO)
        npts = pmask_all.sum(1)
        nlns = lmask_all.sum(1)
        pu, pv = o_uv[:, 0], o_uv[:, 1]
        p_near = (pv < shr_r) | (pv > h - shr_r) | (pu < shr_c) | (pu > w - shr_c)
        l_near = ((ol_uv[:, 1] < shr_r) | (ol_uv[:, 1] > h - shr_r)
                  | (ol_uv[:, 0] < shr_c) | (ol_uv[:, 0] > w - shr_c)
                  | (ol_uv[:, 3] < shr_r) | (ol_uv[:, 3] > h - shr_r)
                  | (ol_uv[:, 2] < shr_c) | (ol_uv[:, 2] > w - shr_c))
        near = (pmask_all & p_near).sum(1) + (lmask_all & l_near).sum(1)
        # strict > 0.5 boundary-fraction rejection, as on the host
        pass_b = ~(near.to(torch.float32)
                   / torch.clamp(npts + nlns, min=1).to(torch.float32) > 0.5)
        far_small = (
            (torch.where(pmask_all, o_d, torch.zeros_like(o_d)).sum(1)
             / torch.clamp(npts, min=1).to(torch.float32) > cfg.th_depth_obj)
            | (npts < cfg.min_object_points))
        # association: majority of the LAST frame's semantic labels over
        # the group's points and lines (Tracking.cc:2631-2699)
        comb_vals = torch.cat([state.o_sem.expand(GCAP, -1),
                               state.ol_sem.expand(GCAP, -1)], 1)
        comb_valid = torch.cat([pmask_all, lmask_all], 1)
        assoc_sem, _ = _masked_mode(comb_vals, comb_valid)
        meta_rows = torch.arange(MAXO, device=dev)
        match = ((state.meta_sem == assoc_sem[:, None]) & state.meta_stat
                 & (meta_rows < state.meta_n))              # (GCAP, MAXO)
        found = match.any(1) & (state.max_id > 1)
        row = torch.argmax(match.to(torch.int32), 1)
        assigned0 = torch.where(found, state.meta_label[row].to(torch.int64),
                                torch.full_like(row, -1))
        H_prev = torch.where(found[:, None, None], state.meta_motion[row], I4)
        group_exists = lab_ok & (npts > 0) & pass_b
        # groups[:MAXO] in label-ascending order
        g_idx, g_ok = _first_k(group_exists, MAXO)
        g_lab = labs[g_idx]
        g_far = far_small[g_idx]
        g_assigned0 = assigned0[g_idx]
        g_H_prev = H_prev[g_idx]
        g_pmask = pmask_all[g_idx] & g_ok[:, None]
        g_lmask = lmask_all[g_idx] & g_ok[:, None]

        # ---- buckets (tracking._build_buckets, MAXO lanes) ----
        pidx, prow_ok = _first_k(g_pmask, P)                 # (MAXO, P)
        lidx, lrow_ok = _first_k(g_lmask, L)
        pk, lk = prow_ok[..., None], lrow_ok[..., None]
        pt_obs = state.o_uv[pidx] * pk
        pt_depth = torch.where(prow_ok, state.o_d[pidx], 1.0)
        pt_flow0 = (o_uv[pidx] - state.o_uv[pidx]) * pk
        pt_cur_uv = o_uv[pidx] * pk
        pt_cur_d = torch.where(prow_ok, o_d[pidx], 0.0)
        pt_valid = prow_ok & (state.o_d[pidx] > 0)
        pt_sfvalid = prow_ok & sf_valid[pidx]
        ln_obs = state.ol_uv[lidx] * lk
        ln_depth = torch.where(lk, state.ol_d[lidx], 1.0)
        ln_flow0 = (ol_uv[lidx] - state.ol_uv[lidx]) * lk
        ln_valid = lrow_ok & (state.ol_d[lidx].min(-1).values > 0)

        # ---- camera: init + joint flow+pose solve ----
        T_init, subset, _ = init_model(
            K, cfg.pnp_reproj_error, u_cam[None], (state.velocity @ T_lw)[None],
            T_lw, state.s_uv[None], state.s_d[None], s_uv[None], s_d[None],
            last_s_valid[None])
        T_wl = _inv(T_lw)
        # flow0 for the camera = the stored last-frame flow samples
        cam = solve(
            T_init, T_wl,
            fs.PointBundle(state.s_uv[None], state.s_f[None],
                           state.s_d[None], subset),
            fs.LineBundle(state.l_uv[None], state.l_f[None],
                          state.l_d[None], l_use[None]),
            flow_prior_info=cfg.flow_prior_info_cam,
            line_prior_info=cfg.flow_prior_info_cam)
        pose = cam.pose[0]
        static_frac = scene_flow_static_frac(
            K, cfg.sf_mg_thres, pose, T_wl, pt_obs, pt_depth, pt_cur_uv,
            pt_cur_d, pt_sfvalid)

        # ---- objects: init + joint flow+motion solves, all lanes ----
        T_models = pose @ g_H_prev
        T_is, init_inl, init_n = init_model(
            K, cfg.pnp_reproj_error, u_obj, T_models, T_lw, pt_obs, pt_depth,
            pt_cur_uv, pt_cur_d, pt_valid)
        res = solve(
            T_is, T_wl,
            fs.PointBundle(pt_obs, pt_flow0, pt_depth, pt_valid & init_inl),
            fs.LineBundle(ln_obs, ln_flow0, ln_depth, ln_valid),
            flow_prior_info=cfg.flow_prior_info_obj,
            line_prior_info=cfg.flow_prior_info_obj)

        # ---- commit (Tracking.cc:2528-2736 + 1277-1528) ----
        is_static = static_frac > cfg.sf_ds_thres
        committed = g_ok & ~is_static & ~g_far
        needs_new = committed & (g_assigned0 < 0)
        new_rank = torch.cumsum(needs_new.to(torch.int64), 0) - 1
        max_id = state.max_id.to(torch.int64)
        assigned = torch.where(needs_new, max_id + new_rank, g_assigned0)
        assigned = torch.where(committed, assigned, torch.full_like(assigned, -1))
        max_id_new = max_id + needs_new.sum()
        gt_have = ((g_lab[:, None] == gt_sem_prev).any(1)
                   & (g_lab[:, None] == gt_sem_cur).any(1))
        stat = committed & gt_have & (init_n >= cfg.min_pnp_inliers_obj)
        H_lane = _inv(pose) @ res.pose
        H_lane = torch.where(stat[:, None, None], H_lane, I4)
        # centre: masked mean of the last frame's world points of the lane
        Xw_lane = fr.world_points(K, state.pose, state.o_uv[pidx],
                                  state.o_d[pidx])
        nrow = torch.clamp(prow_ok.to(torch.float32).sum(1), min=1.0)
        centre = (Xw_lane * pk).sum(1) / nrow[:, None]
        centre = torch.where((prow_ok.sum(1) > 0)[:, None], centre, 0.0)

        # per-point labels: each object point/line takes its lane's label
        # (lanes are disjoint: one semantic label per point)
        lane_label = torch.where(
            is_static & g_ok, torch.zeros_like(assigned),
            torch.where(committed, assigned, torch.full_like(assigned, -1)))

        def row_labels(lane_match):
            lab = (lane_match.to(torch.int64) * lane_label[:, None]).sum(0)
            return torch.where(lane_match.any(0), lab, torch.full_like(lab, -1))

        obj_label = row_labels(g_pmask)
        oline_label = row_labels(g_lmask)

        # meta' (host last_meta): committed lanes in order
        m_idx, m_ok = _first_k(committed, MAXO)
        meta_sem = torch.where(m_ok, g_lab[m_idx], torch.zeros_like(g_lab))
        meta_label = torch.where(m_ok, assigned[m_idx],
                                 torch.full_like(assigned, -1))
        meta_stat = m_ok & stat[m_idx]
        meta_motion = torch.where(m_ok[:, None, None], H_lane[m_idx], I4)
        meta_n = m_ok.sum()

        velocity = pose @ _inv(state.pose)        # Tracking.cc:1177-1183

        # ---- position updates from the optimised flows ----
        s_uv_upd = torch.where(cam.point_inlier[0][:, None],
                               state.s_uv + cam.flow[0], s_uv)
        l_uv_upd = torch.where(cam.line_inlier[0][:, None],
                               state.l_uv + cam.line_flow[0], l_uv)
        # object rows: only stat lanes update (Tracking._track object loop);
        # padding rows of a lane write to a dump row past the end
        upd_pt = stat[:, None] & prow_ok & res.point_inlier
        pdst = torch.where(prow_ok, pidx, torch.full_like(pidx, NO))
        o_uv_new = torch.cat([o_uv, o_uv[:1]])
        o_uv_new[pdst] = torch.where(upd_pt[..., None],
                                     state.o_uv[pidx] + res.flow, o_uv[pidx])
        obj_ok_flags = torch.zeros(NO + 1, dtype=torch.bool, device=dev)
        obj_ok_flags[pdst] = upd_pt
        upd_ln = stat[:, None] & lrow_ok & res.line_inlier
        ldst = torch.where(lrow_ok, lidx, torch.full_like(lidx, NLO))
        ol_uv_new = torch.cat([ol_uv, ol_uv[:1]])
        ol_uv_new[ldst] = torch.where(upd_ln[..., None],
                                      state.ol_uv[lidx] + res.line_flow,
                                      ol_uv[lidx])
        oline_ok_flags = torch.zeros(NLO + 1, dtype=torch.bool, device=dev)
        oline_ok_flags[ldst] = upd_ln

        # ---- renewal (Tracking.cc:3959-4730) ----
        new_state, core_out = _renew_core(
            cfg, K, caps, si, filts, hw, pose, velocity,
            s_uv_upd, s_d, cam.point_inlier[0],
            l_uv_upd, l_d, cam.line_inlier[0],
            o_uv_new[:NO], o_d, o_sem, obj_label, obj_ok_flags[:NO],
            ol_uv_new[:NLO], ol_d, ol_sem, oline_label, oline_ok_flags[:NLO],
            meta_sem, meta_label, meta_stat, meta_motion, meta_n,
            max_id_new, last_mask, last_flow)

        out = dict(
            pose=pose, velocity=velocity, **core_out,
            lane_label=meta_label, lane_sem=meta_sem, lane_stat=meta_stat,
            lane_H=meta_motion,
            lane_centre=torch.where(m_ok[:, None], centre[m_idx], 0.0),
            lane_valid=m_ok,
            n_point_inliers=cam.point_inlier.sum())
        # one float32 buffer: the map rows come home in one copy
        buf = torch.cat([out[name].reshape(-1).to(torch.float32)
                         for name, _, _ in out_spec(caps)])
        return new_state, buf, cam.host_syncs + res.host_syncs

    return core


def _masked(valid, *arrays, fill=0):
    """Each array with its rows where ``valid`` fails set to ``fill``."""
    return tuple(torch.where(_bdims(valid, a.dim()), a,
                             torch.full_like(a, fill)) for a in arrays)


def _renew_core(cfg, K, caps, si, filts, hw, pose, velocity,
                s_uv, s_d, stat_ok,
                l_uv, l_d, line_ok,
                o_uv, o_d, o_sem, obj_label, obj_ok,
                ol_uv, ol_d, ol_sem, oline_label, oline_ok,
                meta_sem, meta_label, meta_stat, meta_motion, meta_n,
                max_id, last_mask, last_flow):
    """Device counterpart of Tracking._renew_frame_info
    (Tracking.cc:3959-4730).  Returns (ResidentState, the map rows)."""
    NS, NLS, NO, NLO = caps["NS"], caps["NLS"], caps["NO"], caps["NLO"]
    P, L, MAXO = caps["P"], caps["L"], caps["MAXO"]
    h, w = hw
    dev = pose.device
    neg = functools.partial(torch.full, dtype=torch.int64, device=dev,
                            fill_value=-1)

    # ---- static points: keep inliers, top up in strided order ----
    keep_ok, kd, kf, kc = filts.stat_state(s_uv)
    keep = stat_ok & keep_ok
    kept_idx, kept_v = _first_k(keep, NS)
    nk = keep.sum().clamp(max=NS)
    k_uv, k_d, k_f, k_c = _masked(kept_v, s_uv[kept_idx], kd[kept_idx],
                                  kf[kept_idx], kc[kept_idx])
    k_asso = torch.where(kept_v, kept_idx, -1)

    cs_uv, cs_d, cs_f, cs_c, cs_v = si.stat_tmp
    cand_ok, cd, cf, cc = filts.stat_cand(cs_uv)
    occ = _scatter_occupancy(h, w, k_uv, kept_v)
    cand_ok = cand_ok & cs_v & ~((nk > 0) & _near_occupied(occ, cs_uv, h, w))
    t_idx, t_v = _first_k(cand_ok, NS,
                          order=_strided_order(cs_uv.shape[0], 10, dev))
    nt = cand_ok.sum()
    t_vals = _masked(t_v, cs_uv[t_idx], cd[t_idx], cf[t_idx], cc[t_idx])
    t_cnd = torch.where(t_v, t_idx, -1)
    merged, stat_valid = _merge_keep_topup(
        (k_uv, k_d, k_f, k_c, k_asso, neg((NS,))), nk,
        t_vals + (neg((NS,)), t_cnd), nt, NS)
    new_uv, new_d, new_f, new_c = _masked(stat_valid, *merged[:4])
    new_asso, new_cnd = _masked(stat_valid, *merged[4:], fill=-1)

    # ---- static lines: keep + top-up with the dedup gate ----
    lk_ok, lkd, lkf, lkc = filts.line_state(l_uv)
    lkeep = line_ok & lk_ok
    lkept_idx, lkept_v = _first_k(lkeep, NLS)
    nlk = lkeep.sum().clamp(max=NLS)
    kl = _masked(lkept_v, l_uv[lkept_idx], lkd[lkept_idx], lkf[lkept_idx],
                 lkc[lkept_idx])
    kl_asso = torch.where(lkept_v, lkept_idx, -1)

    cl_uv, cl_d, cl_f, cl_c, cl_v = si.line_tmp
    cok, cld, clf, clc = filts.line_cand(cl_uv)
    cok = cok & cl_v & ~((nlk > 0) & _line_dup(cl_uv, kl[0], lkept_v))
    tl_idx, tl_v = _first_k(cok, NLS)
    ntl = cok.sum()
    tl = _masked(tl_v, cl_uv[tl_idx], cld[tl_idx], clf[tl_idx], clc[tl_idx])
    merged, line_valid = _merge_keep_topup(
        kl + (kl_asso, neg((NLS,))), nlk,
        tl + (neg((NLS,)), torch.where(tl_v, tl_idx, -1)), ntl, NLS)
    new_l, new_ld, new_lf, new_lc = _masked(line_valid, *merged[:4])
    new_lasso, new_lcnd = _masked(line_valid, *merged[4:], fill=-1)

    # ---- object points: keep + per-object top-up + new labels, one lane
    # per tracked label ----
    co_uv, co_d, co_f, co_c, co_s, co_v = si.obj_tmp
    ok_o, m_o, d_o, f_o, c_o = filts.obj_state(o_uv)
    tracked, tr_ok = _sorted_unique(obj_label, obj_label > 0, MAXO)
    cok_all, cm, cdd, cff, ccc = filts.obj_cand(co_uv)
    cok_all = cok_all & co_v
    okK = tr_ok[:, None]

    keepm = (obj_label == tracked[:, None]) & obj_ok & ok_o & okK  # (MAXO, NO)
    idx, iv = _first_k(keepm, P)
    n = keepm.sum(1).clamp(max=P)
    sem_now, anyk = _masked_mode(m_o.expand(MAXO, -1), keepm)
    sem_now = torch.where(anyk, sem_now, torch.zeros_like(sem_now))
    kv = _masked(iv, o_uv[idx], d_o[idx], f_o[idx], c_o[idx], m_o[idx]) + (
        torch.where(iv, idx, -1), neg((MAXO, P)))
    occK = _scatter_occupancy(h, w, o_uv[idx], iv)
    topm = (cok_all & (cm == sem_now[:, None]) & (sem_now != 0)[:, None] & okK
            & ~((n > 0)[:, None] & _near_occupied(occK, co_uv, h, w)))
    tidx, tv = _first_k(topm, P)
    tn = topm.sum(1)
    tvv = _masked(tv, co_uv[tidx], cdd[tidx], cff[tidx], ccc[tidx],
                  cm[tidx]) + (neg((MAXO, P)), torch.where(tv, tidx, -1))
    lane_vals, L_v = _merge_keep_topup(kv, n, tvv, tn, P)
    L_v = L_v & okK
    # live semantic labels (host live_sems: sem_now of every tracked lane)
    live_sems = torch.where(tr_ok, sem_now, torch.full_like(sem_now, -1))

    # new-label candidates: per new sem, capped at P, sem-ascending
    is_live = (cm[:, None] == live_sems).any(1)
    new_cand = cok_all & (cm != 0) & ~is_live
    new_sel = new_cand & (_rank_within_sem(cm, new_cand, NO) < P)
    norder = torch.argsort(torch.where(new_sel, cm, torch.full_like(cm, _BIG)),
                           stable=True)
    n_new = new_sel.sum()
    N_v = torch.arange(NO, device=dev) < n_new
    N_vals = (co_uv[norder], cdd[norder], cff[norder], ccc[norder],
              cm[norder], neg((NO,)), torch.where(N_v, norder, -1),
              torch.full((NO,), -2, dtype=torch.int64, device=dev))

    # global compaction: tracked lanes (lane-major), then new labels
    flat_v = L_v.reshape(-1)
    flat = [a.reshape((MAXO * P,) + a.shape[2:]) for a in lane_vals]
    flat.append(tracked[:, None].expand(MAXO, P).reshape(-1).to(torch.int64))
    g_idx, g_v = _first_k(flat_v, NO)
    T_vals = _masked(g_v, *(a[g_idx] for a in flat[:5])) + _masked(
        g_v, flat[5][g_idx], flat[6][g_idx], fill=-1) + _masked(
        g_v, flat[7][g_idx], fill=-2)
    merged, obj_valid = _merge_keep_topup(T_vals, flat_v.sum(), N_vals,
                                          n_new, NO)
    no_uv, no_d, no_f, no_c, no_sem = _masked(obj_valid, *merged[:5])
    no_asso, no_cnd = _masked(obj_valid, *merged[5:7], fill=-1)
    no_label, = _masked(obj_valid, merged[7], fill=-2)

    # ---- object lines: keep + per-object top-up + new labels ----
    col_uv, col_d, col_f, col_c, col_s, col_v = si.oline_tmp
    col_ok_all = filts.oline_cand_ok(col_uv)
    # flow at the kept object-line positions, carried through the merge
    ol_f_now = filts.flow4(ol_uv)
    keepl = (oline_label == tracked[:, None]) & oline_ok & okK
    lidx, liv = _first_k(keepl, L)
    ln = keepl.sum(1).clamp(max=L)
    kvl = _masked(liv, ol_uv[lidx], ol_d[lidx], ol_sem[lidx]) + (
        torch.where(liv, lidx, -1), neg((MAXO, L))) + _masked(
        liv, ol_f_now[lidx])
    topl = (col_v & col_ok_all & (col_s == sem_now[:, None])
            & (sem_now != 0)[:, None] & okK
            & ~_obj_line_dup(col_uv, kvl[0], liv))
    tlidx, tlv = _first_k(topl, L)
    tln = topl.sum(1)
    tvl = _masked(tlv, col_uv[tlidx], col_d[tlidx], col_s[tlidx]) + (
        neg((MAXO, L)), torch.where(tlv, tlidx, -1)) + _masked(
        tlv, col_f[tlidx])
    lane_l, OL_v = _merge_keep_topup(kvl, ln, tvl, tln, L)
    OL_v = OL_v & okK
    # new-label lines: (sem, idx)-sorted, no per-label cap (host quirk)
    nl_is_live = (col_s[:, None] == live_sems).any(1)
    nl_sel = col_v & (col_s != 0) & ~nl_is_live
    nlorder = torch.argsort(
        torch.where(nl_sel, col_s, torch.full_like(col_s, _BIG)), stable=True)
    n_nl = nl_sel.sum()
    NL_vals = (col_uv[nlorder], col_d[nlorder], col_s[nlorder], neg((NLO,)),
               torch.where(torch.arange(NLO, device=dev) < n_nl, nlorder, -1),
               col_f[nlorder],
               torch.full((NLO,), -2, dtype=torch.int64, device=dev))
    flat_lv = OL_v.reshape(-1)
    flat_l = [a.reshape((MAXO * L,) + a.shape[2:]) for a in lane_l]
    lane_lab_l = tracked[:, None].expand(MAXO, L).reshape(-1).to(torch.int64)
    gl_idx, gl_v = _first_k(flat_lv, NLO)
    TL_vals = _masked(gl_v, *(a[gl_idx] for a in flat_l[:3])) + _masked(
        gl_v, flat_l[3][gl_idx], flat_l[4][gl_idx], fill=-1) + _masked(
        gl_v, flat_l[5][gl_idx]) + _masked(gl_v, lane_lab_l[gl_idx], fill=-2)
    merged, oline_valid = _merge_keep_topup(TL_vals, flat_lv.sum(), NL_vals,
                                            n_nl, NLO)
    nol_uv, nol_d, nol_sem = _masked(oline_valid, *merged[:3])
    nol_asso, nol_cnd = _masked(oline_valid, *merged[3:5], fill=-1)
    nol_label, = _masked(oline_valid, merged[6], fill=-2)
    # flows at the merged rows (the dense filters look them up again at the
    # zeroed-where-invalid positions; the sampled ones take the carried)
    nol_f = filts.flow4_final(nol_uv, merged[5], oline_valid)
    nol_c = nol_uv + nol_f

    state = ResidentState(
        pose=pose, velocity=velocity,
        s_uv=new_uv, s_d=new_d, s_f=new_f, s_c=new_c, s_valid=stat_valid,
        l_uv=new_l, l_d=new_ld, l_f=new_lf, l_c=new_lc, l_valid=line_valid,
        o_uv=no_uv, o_d=no_d, o_f=no_f, o_c=no_c, o_sem=_i32(no_sem),
        o_label=_i32(no_label), o_valid=obj_valid,
        ol_uv=nol_uv, ol_d=nol_d, ol_f=nol_f, ol_c=nol_c,
        ol_sem=_i32(nol_sem), ol_label=_i32(nol_label), ol_valid=oline_valid,
        meta_sem=_i32(meta_sem), meta_label=_i32(meta_label),
        meta_stat=meta_stat, meta_motion=meta_motion, meta_n=_i32(meta_n),
        max_id=_i32(max_id), last_mask=_i32(last_mask), last_flow=last_flow,
        s_asso=_i32(new_asso), s_cand=_i32(new_cnd),
        l_asso=_i32(new_lasso), l_cand=_i32(new_lcnd),
        o_asso=_i32(no_asso), o_cand=_i32(no_cnd),
        ol_asso=_i32(nol_asso), ol_cand=_i32(nol_cnd),
    )
    rows = dict(
        stat_uv=new_uv, stat_depth=new_d, stat_valid=stat_valid,
        stat_asso=new_asso,
        line_uv=new_l, line_depth=new_ld, line_valid=line_valid,
        line_asso=new_lasso,
        obj_uv=no_uv, obj_depth=no_d, obj_valid=obj_valid,
        obj_asso=no_asso, obj_label=no_label, obj_sem=no_sem,
        oline_uv=nol_uv, oline_depth=nol_d, oline_valid=oline_valid,
        oline_asso=nol_asso, oline_label=nol_label, oline_sem=nol_sem,
    )
    return state, rows


def out_spec(caps):
    """(name, shape, kind) rows of the packed resident-step output.  The
    world-3D arrays are not in it: the host recomputes them from pose, uv
    and depth (``tracking._np_world_points``)."""
    NS, NLS, NO, NLO = caps["NS"], caps["NLS"], caps["NO"], caps["NLO"]
    MAXO = caps["MAXO"]
    return [
        ("pose", (4, 4), "f"), ("velocity", (4, 4), "f"),
        ("stat_uv", (NS, 2), "f"), ("stat_depth", (NS,), "f"),
        ("stat_valid", (NS,), "bool"),
        ("stat_asso", (NS,), "int"),
        ("line_uv", (NLS, 4), "f"), ("line_depth", (NLS, 2), "f"),
        ("line_valid", (NLS,), "bool"),
        ("line_asso", (NLS,), "int"),
        ("obj_uv", (NO, 2), "f"), ("obj_depth", (NO,), "f"),
        ("obj_valid", (NO,), "bool"),
        ("obj_asso", (NO,), "int"), ("obj_label", (NO,), "int"),
        ("obj_sem", (NO,), "int"),
        ("oline_uv", (NLO, 4), "f"), ("oline_depth", (NLO, 2), "f"),
        ("oline_valid", (NLO,), "bool"),
        ("oline_asso", (NLO,), "int"), ("oline_label", (NLO,), "int"),
        ("oline_sem", (NLO,), "int"),
        ("lane_label", (MAXO,), "int"), ("lane_sem", (MAXO,), "int"),
        ("lane_stat", (MAXO,), "bool"), ("lane_H", (MAXO, 4, 4), "f"),
        ("lane_centre", (MAXO, 3), "f"), ("lane_valid", (MAXO,), "bool"),
        ("n_point_inliers", (), "int"),
    ]


def unpack_out(buf: np.ndarray, caps) -> dict:
    """Slice the packed output buffer into a dict of numpy arrays (views of
    ``buf`` for the float fields)."""
    out = {}
    o = 0
    for name, shape, kind in out_spec(caps):
        n = int(np.prod(shape, dtype=np.int64))
        a = buf[o:o + n].reshape(shape)
        o += n
        if kind == "bool":
            a = a > 0.5
        elif kind == "int":
            a = a.astype(np.int32)
        out[name] = a
    return out


def build_resident_step(cfg, K: Intrinsics, caps: dict):
    """The device-resident frame step (dense planes), a plain function:

        step(state, depth_raw, flow, mask_in, cand_uv, cand_valid,
             lcand_uv4, lcand_valid, gt_sem_prev, gt_sem_cur, u_cam, u_obj)
        -> (new_state, out_buf, lm_host_syncs)

    ``caps``: NS, NLS, NO, NLO, P, L, MAXO, GCAP.  ``gt_sem_*`` are (16,)
    int32 semantic labels with a GT object pose in the previous / current
    frame (-1 pads); ``u_cam`` (n_hyp_cam, 3) and ``u_obj`` (MAXO,
    n_hyp_obj, 3) the RANSAC draws of the camera and the object lanes.
    Depth and flow may come as float16 and the mask as uint8 (the
    compressed push); they are cast on the device."""
    NS, NLS, NO, NLO = caps["NS"], caps["NLS"], caps["NO"], caps["NLO"]
    MAXO = caps["MAXO"]
    core = build_core_stage(cfg, K, caps)

    def step(state: ResidentState, depth_raw, flow, mask_in, cand_uv,
             cand_valid, lcand_uv4, lcand_valid, gt_sem_prev, gt_sem_cur,
             u_cam, u_obj):
        h, w = mask_in.shape
        flow = flow.to(torch.float32)
        depth = fr.preprocess_depth(depth_raw.to(torch.float32),
                                    cfg.choose_data, cfg.depth_map_factor,
                                    cfg.bf)
        mask = update_mask_dev(mask_in.to(torch.int32), state, MAXO)

        # ---- candidate selections (Frame ctor) ----
        obj_tmp = fr.select_object_points(depth, flow, mask,
                                          cfg.th_depth_obj, NO)
        stat_tmp = fr.select_static_points(cand_uv, cand_valid, depth, flow,
                                           mask, cfg.th_depth_bg, NS)
        line_tmp = fr.select_static_lines(lcand_uv4, lcand_valid, depth,
                                          flow, mask, cfg.th_depth_bg, NLS)
        oline_tmp = fr.select_object_lines(lcand_uv4, lcand_valid, depth,
                                           flow, mask, cfg.th_depth_obj, NLO)
        # ---- inherit (Tracking.cc:269-473) ----
        inh, line_ok0 = dense_stage_inputs(cfg, state, depth, mask)
        si = StageInputs(stat_tmp=stat_tmp, line_tmp=line_tmp,
                         obj_tmp=obj_tmp, oline_tmp=oline_tmp, inh=inh,
                         line_ok0=line_ok0)
        filts = DenseFilts(depth, flow, mask, cfg.th_depth_obj)
        return core(state, si, filts, (h, w), gt_sem_prev, gt_sem_cur,
                    u_cam, u_obj, mask, flow)

    return step


def aux_spec(caps, n_cand: int, nl_cand: int, n_cam: int, n_obj: int):
    """(name, shape) rows of the frame's small inputs, packed into one
    float32 buffer (one copy a frame): the GT label tables, the RANSAC
    draws and the injected point and line candidates (zeros where none)
    with their valid flags (1.0 / 0.0)."""
    return [("gt_prev", (16,)), ("gt_cur", (16,)), ("u_cam", (n_cam, 3)),
            ("u_obj", (caps["MAXO"], n_obj, 3)), ("cand", (n_cand, 2)),
            ("cand_v", (n_cand,)), ("lcand", (nl_cand, 4)),
            ("lcand_v", (nl_cand,))]


def _unpack_aux(aux, spec) -> dict:
    out, o = {}, 0
    for name, shape in spec:
        n = int(np.prod(shape, dtype=np.int64))
        out[name] = aux[o:o + n].reshape(shape)
        o += n
    return out


def build_resident_frame(cfg, K: Intrinsics, caps: dict, n_cand: int,
                         nl_cand: int, fast_cfg, line_cfg, need_fast: bool,
                         need_lines: bool, use_grid: bool):
    """The whole resident frame as one function of device tensors, the
    counterpart of the JAX driver's jitted ``run``
    (``ResidentDriver._fn``): FAST and the line detector when the frame
    needs them, else the injected candidates or the sample grid, then the
    step.

        run(state, img, depth_raw, flow, mask, aux)
        -> (new_state, out_buf, lm_host_syncs)

    ``aux`` is the packed float32 buffer of :func:`aux_spec`."""
    step = build_resident_step(cfg, K, caps)
    spec = aux_spec(caps, n_cand, nl_cand, *n_hypotheses(cfg))

    def run(state, img, depth_raw, flow, mask, aux):
        a = _unpack_aux(aux, spec)
        h, w = mask.shape
        dev = mask.device
        if need_fast:
            uv, _, va = fast_ops.detect_keypoints(img, fast_cfg)
            n = min(uv.shape[0], n_cand)
            cand = torch.zeros((n_cand, 2), dtype=torch.float32, device=dev)
            cand_v = torch.zeros(n_cand, dtype=torch.bool, device=dev)
            cand[:n] = uv[:n]
            cand_v[:n] = va[:n]
        elif use_grid:
            cand = fr.grid_sample_uv(h, w, n_points=n_cand, device=dev)
            cand_v = torch.ones(n_cand, dtype=torch.bool, device=dev)
        else:
            cand, cand_v = a["cand"], a["cand_v"] > 0.5
        if need_lines:
            # the valid segments compacted in order, as the host's uv4[valid]
            seg = line_ops.detect_lines(img, line_cfg)
            idx, lv = _first_k(seg.valid, nl_cand)
            lcand = seg.uv4[idx] * lv[:, None]
        else:
            lcand, lv = a["lcand"], a["lcand_v"] > 0.5
        return step(state, depth_raw, flow, mask, cand, cand_v, lcand, lv,
                    _i32(a["gt_prev"]), _i32(a["gt_cur"]), a["u_cam"],
                    a["u_obj"])

    return run


class ResidentProgram:
    """A resident frame function over static buffers: ``state`` (a
    ResidentState of buffers), the inputs ``inp`` (name -> buffer) and the
    packed output ``out``.  :meth:`load` copies a frame's host arrays into
    the inputs; calling the program runs the frame and writes the new
    state and the output into their buffers, returning the LM host reads.

    Eager, the call runs the function (the plain version; on the CPU and
    as the card's reference).  With ``graph=True`` (the card) the first
    call warms the function up on a side stream, puts the state back,
    and captures it into CUDA graphs (:class:`utils.cuda_graphs.GraphRecorder`:
    the two LM loops become WHILE nodes); every call then launches the
    stitched graph and reads nothing on the host.  A failed capture or
    launch raises; nothing falls back to the eager run.  ``captures``
    counts the programs of the class captured in this process."""

    captures = 0

    def __init__(self, run, template: ResidentState, inputs: dict,
                 out_numel: int, device, graph: bool = False):
        dev = torch.device(device)
        self.run, self.device, self.graph = run, dev, graph
        self.state = ResidentState(*(torch.zeros(t.shape, dtype=t.dtype,
                                                 device=dev)
                                     for t in template))
        self.inp = {k: torch.zeros(shape, dtype=dt, device=dev)
                    for k, (shape, dt) in inputs.items()}
        self.out = torch.zeros(out_numel, dtype=torch.float32, device=dev)
        self._owner = None          # the driver whose state the buffers hold
        self.capture_s = None       # seconds of the warm-up and capture
        self.node_counts = None     # the captured graphs' nodes, nested
        self._graph = None
        if graph and dev.type != "cuda":
            raise RuntimeError("ResidentProgram(graph=True) needs a CUDA "
                               "device, got %s" % dev)

    @property
    def owner(self):
        """The driver whose state the buffers hold (weakly held: a memoized
        program does not keep a dropped system alive)."""
        return None if self._owner is None else self._owner()

    @owner.setter
    def owner(self, driver):
        self._owner = None if driver is None else weakref.ref(driver)

    def load(self, arrays: dict):
        """Copy host arrays into the input buffers (pinned and
        non-blocking on the card)."""
        copy_in(self.inp, arrays)

    def held(self) -> list:
        """The buffers the program carries from frame to frame (what a
        driver hands over, and what the warm-up before a capture puts
        back)."""
        return list(self.state)

    def _step(self) -> int:
        new_state, out, syncs = self.run(self.state, **self.inp)
        for dst, src in zip(self.state, new_state):
            dst.copy_(src)
        self.out.copy_(out)
        return syncs

    def __call__(self) -> int:
        if not self.graph:
            return self._step()
        if self._graph is None:
            self._capture()
        self._graph.launch()
        return 0

    def eager_twin(self) -> "ResidentProgram":
        """An eager program of the same frame function over buffers of its
        own on the same device: the plain version a graph is held to."""
        return ResidentProgram(
            self.run, self.state,
            {k: (tuple(t.shape), t.dtype) for k, t in self.inp.items()},
            self.out.numel(), self.device, graph=False)

    def _capture(self):
        from ..utils.cuda_graphs import GraphRecorder, loop_runner

        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        keep = [t.clone() for t in self.held()]
        launches = fast_ops.fast_score_pyramid.launches
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            # warm-up: library handles, workspaces and cached constants are
            # made outside the capture; the frame's state is put back
            self._step()
            for dst, src in zip(self.held(), keep):
                dst.copy_(src)
        fast_ops.fast_score_pyramid.launches = launches
        torch.cuda.synchronize(self.device)
        rec = GraphRecorder(counters=[(fast_ops.fast_score_pyramid,
                                       "launches")])
        with torch.cuda.stream(side):
            with rec, loop_runner(rec.loop):
                self._step()
        self._graph = rec.stitch()
        torch.cuda.synchronize(self.device)
        self.node_counts = self._graph.node_counts()
        self.capture_s = time.perf_counter() - t0
        type(self).captures += 1


# resident programs, shared across identically configured drivers (on the
# card a capture takes a second); the drivers hand the buffers over
_PROGRAMS: dict = {}


def resident_program(cfg, K: Intrinsics, caps: dict, n_cand: int,
                     nl_cand: int, fast_cfg, line_cfg, modes: tuple,
                     template: ResidentState, inputs: dict,
                     device) -> ResidentProgram:
    """The memoized program of the resident frame on ``device``: one per
    (settings, caps, detector configs, modes, state shapes, input shapes
    and dtypes, device).  ``modes`` = (need_fast, need_lines, use_grid);
    ``template`` gives the state buffers' shapes, ``inputs`` name ->
    (shape, dtype) the input buffers'.  A graph program on the card
    (:func:`graph_resident_step`), an eager one on the CPU."""
    dev = torch.device(device)
    key = (repr(cfg), (K.fx, K.fy, K.cx, K.cy), repr(sorted(caps.items())),
           n_cand, nl_cand, repr(fast_cfg), repr(line_cfg), tuple(modes),
           tuple((tuple(t.shape), t.dtype) for t in template),
           tuple((k, tuple(s), d) for k, (s, d) in sorted(inputs.items())),
           str(dev))
    prog = _PROGRAMS.get(key)
    if prog is None:
        run = build_resident_frame(cfg, K, caps, n_cand, nl_cand, fast_cfg,
                                   line_cfg, *modes)
        n_out = sum(int(np.prod(shape, dtype=np.int64))
                    for _, shape, _ in out_spec(caps))
        prog = _PROGRAMS[key] = ResidentProgram(
            run, template, inputs, n_out, dev, graph=dev.type == "cuda")
    return prog


def graph_resident_step(cfg, K: Intrinsics, caps: dict, n_cand: int,
                        nl_cand: int, fast_cfg, line_cfg, modes: tuple,
                        template: ResidentState, inputs: dict,
                        device="cuda") -> ResidentProgram:
    """The memoized graph program of the resident frame on the card, the
    counterpart of ``jit_resident_step`` and of the JAX driver's jitted
    ``run`` (arguments as :func:`resident_program`).  Raises without a
    CUDA device: the CPU runs the eager program."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("graph_resident_step runs on a CUDA device; the "
                           "CPU runs the eager program (device=%s)" % dev)
    return resident_program(cfg, K, caps, n_cand, nl_cand, fast_cfg,
                            line_cfg, modes, template, inputs, dev)


# ---------------------------------------------------------------------------
# host <-> device state
# ---------------------------------------------------------------------------

def state_from_host(last: dict, last_meta: dict, max_id: int, velocity,
                    last_mask, last_flow, maxo: int, device) -> ResidentState:
    """The host tracker's ``last`` dict + ``last_meta`` as a ResidentState
    on ``device``; every row is its own ancestor."""
    ms = np.zeros(maxo, np.int32)
    ml = np.full(maxo, -1, np.int32)
    mt = np.zeros(maxo, bool)
    mm = np.tile(np.eye(4, dtype=np.float32), (maxo, 1, 1))
    n = min(len(last_meta.get("sem_position", [])), maxo)
    for k in range(n):
        ms[k] = last_meta["sem_position"][k]
        ml[k] = last_meta["mod_label"][k]
        mt[k] = bool(last_meta["obj_stat"][k])
        H = last_meta["obj_motion"].get(last_meta["mod_label"][k])
        if H is not None:
            mm[k] = H
    vel = np.eye(4, dtype=np.float32) if velocity is None else velocity

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    def b(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    def ident(n_rows):
        return (torch.arange(n_rows, dtype=torch.int32, device=device),
                torch.full((n_rows,), -1, dtype=torch.int32, device=device))

    s_asso, s_cand = ident(len(last["stat_uv"]))
    l_asso, l_cand = ident(len(last["line_uv"]))
    o_asso, o_cand = ident(len(last["obj_uv"]))
    ol_asso, ol_cand = ident(len(last["oline_uv"]))
    return ResidentState(
        pose=f32(last["pose"]), velocity=f32(vel),
        s_uv=f32(last["stat_uv"]), s_d=f32(last["stat_depth"]),
        s_f=f32(last["stat_flow"]), s_c=f32(last["stat_corres"]),
        s_valid=b(last["stat_valid"]),
        l_uv=f32(last["line_uv"]), l_d=f32(last["line_depth"]),
        l_f=f32(last["line_flow"]), l_c=f32(last["line_corres"]),
        l_valid=b(last["line_valid"]),
        o_uv=f32(last["obj_uv"]), o_d=f32(last["obj_depth"]),
        o_f=f32(last["obj_flow"]), o_c=f32(last["obj_corres"]),
        o_sem=i32(last["obj_sem"]), o_label=i32(last["obj_label"]),
        o_valid=b(last["obj_valid"]),
        ol_uv=f32(last["oline_uv"]), ol_d=f32(last["oline_depth"]),
        ol_f=f32(last["oline_flow"]), ol_c=f32(last["oline_corres"]),
        ol_sem=i32(last["oline_sem"]), ol_label=i32(last["oline_label"]),
        ol_valid=b(last["oline_valid"]),
        meta_sem=i32(ms), meta_label=i32(ml), meta_stat=b(mt),
        meta_motion=f32(mm), meta_n=i32(n), max_id=i32(max_id),
        last_mask=i32(last_mask), last_flow=f32(last_flow),
        s_asso=s_asso, s_cand=s_cand, l_asso=l_asso, l_cand=l_cand,
        o_asso=o_asso, o_cand=o_cand, ol_asso=ol_asso, ol_cand=ol_cand,
    )


def state_to_host(state: ResidentState):
    """The ResidentState as a host ``last`` dict, ``last_meta`` and
    ``max_id``."""
    g = {k: v.cpu().numpy() for k, v in state._asdict().items()}
    last = dict(
        pose=g["pose"],
        stat_uv=g["s_uv"], stat_depth=g["s_d"], stat_flow=g["s_f"],
        stat_corres=g["s_c"], stat_valid=g["s_valid"],
        line_uv=g["l_uv"], line_depth=g["l_d"], line_flow=g["l_f"],
        line_corres=g["l_c"], line_valid=g["l_valid"],
        obj_uv=g["o_uv"], obj_depth=g["o_d"], obj_flow=g["o_f"],
        obj_corres=g["o_c"], obj_sem=g["o_sem"], obj_label=g["o_label"],
        obj_valid=g["o_valid"],
        oline_uv=g["ol_uv"], oline_depth=g["ol_d"], oline_flow=g["ol_f"],
        oline_corres=g["ol_c"], oline_sem=g["ol_sem"],
        oline_label=g["ol_label"], oline_valid=g["ol_valid"],
    )
    n = int(g["meta_n"])
    meta = {
        "sem_position": [int(x) for x in g["meta_sem"][:n]],
        "mod_label": [int(x) for x in g["meta_label"][:n]],
        "obj_stat": [bool(x) for x in g["meta_stat"][:n]],
        "obj_motion": {int(l): g["meta_motion"][k]
                       for k, l in enumerate(g["meta_label"][:n])
                       if bool(g["meta_stat"][k])},
    }
    return last, meta, int(g["max_id"])


def gt_sem_table(gt_rows, cap: int = 16) -> np.ndarray:
    """Semantic labels with a GT object pose row (-1 pads)."""
    t = np.full(cap, -1, np.int32)
    for i, row in enumerate(gt_rows[:cap]):
        t[i] = int(row[1])
    return t


# ---------------------------------------------------------------------------
# host driver: the step per frame, the map stream LAG frames behind
# ---------------------------------------------------------------------------

class ResidentDriver:
    """Drives the device-resident frame loop for a host ``Tracking``.

    Per frame the host computes the GT tables and the RANSAC draws, copies
    them with the image planes into the static input buffers of a
    :class:`ResidentProgram` (pinned memory, non-blocking), runs the
    program -- on the card one launch of its captured graph, which reads
    nothing back -- and starts a non-blocking copy of the packed output
    buffer into pinned memory with a CUDA event after it, on the same
    stream, so the next frame cannot overwrite it first.  The map rows
    drain ``LAG`` frames behind: draining waits on that frame's event.  A
    window BA drains everything first, and its refined pose is written into
    the state buffers; the last frame drains synchronously.

    ``state`` is the live ResidentState: the buffers of the program this
    driver holds, or its own tensors between programs (after ``enter``, or
    when another driver took the program)."""

    LAG = 2

    def __init__(self, tracker):
        self.tr = tracker
        self.caps = dict(
            NS=tracker.NS, NLS=tracker.NLS, NO=tracker.NO, NLO=tracker.NLO,
            P=tracker.P_OBJ, L=tracker.L_OBJ, MAXO=tracker.MAXO,
            GCAP=2 * tracker.MAXO)
        self.state = None
        self.prog = None            # the ResidentProgram holding the state
        self.pending = collections.deque()
        self._prev_gt = None        # (gt_objs, pose_gt) of frame f-1
        self._last_pose = None      # most recent drained pose (T_cw)
        self._ba_frame = -1         # last frame whose window BA ran

    @staticmethod
    def eligible(cfg) -> bool:
        """The joint optimiser and a pinhole camera (no distortion)."""
        return bool(cfg.use_joint_optimization and cfg.k1 == 0
                    and cfg.k2 == 0 and cfg.k3 == 0 and cfg.p1 == 0
                    and cfg.p2 == 0)

    # -- mode transitions ----------------------------------------------
    def enter(self):
        tr = self.tr
        self._leave_program()
        self.state = state_from_host(
            tr.last, tr.last_meta, tr.max_id, tr.velocity, tr.last_mask_np,
            tr.last_flow_np, tr.MAXO, tr.device)
        self._prev_gt = (tr.last.get("gt_objs", []), tr.last["pose_gt"])
        self._last_pose = np.asarray(tr.last["pose"])

    def exit(self):
        """Drain everything and write the device state back to the host
        tracker, so host-path frames or a checkpoint can follow."""
        tr = self.tr
        self.drain_all()
        last, meta, max_id = state_to_host(self.state)
        last["pose_gt"] = self._prev_gt[1]
        last["gt_objs"] = self._prev_gt[0]
        tr.last, tr.last_meta, tr.max_id = last, meta, max_id
        tr.velocity = self.state.velocity.cpu().numpy()
        tr.last_mask_np = self.state.last_mask.cpu().numpy()
        tr.last_flow_np = self.state.last_flow.cpu().numpy()
        tr.mask_np = tr.last_mask_np.copy()
        self._drop_program()
        self.state = None

    # -- the program and its buffers -------------------------------------
    def _leave_program(self):
        """Keep this driver's state in its own tensors and give up its
        program's buffers."""
        if self.prog is not None and self.prog.owner is self:
            self._take(self.prog, clone=True)
        self._drop_program()

    def _drop_program(self):
        """Give up the program without keeping its buffers' contents."""
        if self.prog is not None and self.prog.owner is self:
            self.prog.owner = None
        self.prog = None

    def _held(self) -> list:
        """This driver's carried state, in its program's ``held()`` order."""
        return list(self.state)

    def _take(self, prog, clone=False):
        """Point this driver's state at ``prog``'s buffers (or copies)."""
        self.state = (ResidentState(*(t.clone() for t in prog.state))
                      if clone else prog.state)

    def _hold(self, prog):
        """Make ``prog``'s buffers hold this driver's state; a driver that
        held them keeps a copy of its own."""
        if prog.owner is not self:
            if prog.owner is not None:
                prog.owner._leave_program()
            for dst, src in zip(prog.held(), self._held()):
                dst.copy_(src)
            self._drop_program()
            prog.owner, self.prog = self, prog
            self._take(prog)
        return prog

    def _program(self, modes, inputs) -> ResidentProgram:
        """The shared program of this frame's modes and input shapes (a
        graph on the card), holding this driver's state."""
        tr = self.tr
        return self._hold(resident_program(
            tr.cfg, tr.K, self.caps, tr.N_CAND, tr.NL_CAND,
            tr._fast_cfg() if modes[0] else None,
            tr._line_cfg() if modes[1] else None, modes, self.state, inputs,
            tr.device))

    def _labels_and_draws(self, a: dict, gt_objs, f_id: int):
        """Fill the views ``a`` of a packed aux buffer: the GT label tables
        of the previous and this frame, and this frame's RANSAC draws
        (drawn on the host, so they go out in the one copy)."""
        tr = self.tr
        n_cam, n_obj = a["u_cam"].shape[0], a["u_obj"].shape[1]
        a["gt_prev"][:] = gt_sem_table(self._prev_gt[0])
        a["gt_cur"][:] = gt_sem_table(gt_objs)
        with tr.host_draws():
            a["u_cam"][:] = _np(tr._ransac_uniforms(f_id, 0, n_cam))
            for k in range(tr.MAXO):
                a["u_obj"][k] = _np(tr._ransac_uniforms(f_id, k + 1, n_obj))

    def _frame_arrays(self, gray, depth_raw, flow, mask, gt_objs, f_id,
                      point_detections, line_detections):
        """This frame's host arrays for the program's input buffers, and
        its modes (need_fast, need_lines, use_grid)."""
        tr, cfg = self.tr, self.tr.cfg
        if cfg.resident_compress_input:
            # float16 depth/flow and uint8 mask: ~3 decimal digits, far
            # below the sensor and flow noise; cast back on the device
            planes = (np.asarray(depth_raw, np.float32).astype(np.float16),
                      np.asarray(flow, np.float32).astype(np.float16),
                      np.clip(np.asarray(mask), 0, 255).astype(np.uint8))
        else:
            planes = (np.asarray(depth_raw, np.float32),
                      np.asarray(flow, np.float32),
                      np.asarray(mask, np.int32))
        need_fast = cfg.use_sample_fea == 0 and point_detections is None
        use_grid = cfg.use_sample_fea != 0
        need_lines = line_detections is None and bool(cfg.use_lines)
        n_cam, n_obj = n_hypotheses(cfg)
        spec = aux_spec(self.caps, tr.N_CAND, tr.NL_CAND, n_cam, n_obj)
        aux = np.zeros(sum(int(np.prod(s)) for _, s in spec), np.float32)
        a = _unpack_aux(aux, spec)               # views into aux
        self._labels_and_draws(a, gt_objs, f_id)
        if cfg.use_sample_fea == 0 and point_detections is not None:
            n = min(len(point_detections), tr.N_CAND)
            a["cand"][:n] = np.asarray(point_detections[:n], np.float32)
            a["cand_v"][:n] = 1.0
        if line_detections is not None and len(line_detections):
            n = min(len(line_detections), tr.NL_CAND)
            a["lcand"][:n] = np.asarray(line_detections[:n], np.float32)
            a["lcand_v"][:n] = 1.0
        arrays = dict(img=np.asarray(gray), depth_raw=planes[0],
                      flow=planes[1], mask=planes[2], aux=aux)
        return arrays, (need_fast, need_lines, use_grid)

    # -- per frame -----------------------------------------------------
    def track(self, gray, depth_raw, flow, mask, pose_gt, gt_objs, timing,
              f_id, n_images, stop_frame, line_detections=None,
              point_detections=None):
        """One frame through the resident program; returns the most
        recently drained camera pose (T_cw), ``LAG`` frames behind until
        the last frame."""
        tr = self.tr
        # the previous frame's window BA completes before this step: the
        # refined pose feeds this frame's solve
        if self._lba_trigger(f_id - 1):
            self.drain_all()
            self._run_partial_ba(f_id - 1)

        t0 = time.perf_counter()
        arrays, modes = self._frame_arrays(gray, depth_raw, flow, mask,
                                           gt_objs, f_id, point_detections,
                                           line_detections)
        prog = self._program(modes, {k: (a.shape, _torch_dtype(a))
                                     for k, a in arrays.items()})
        prog.load(arrays)
        with torch.profiler.record_function("resident_step"):
            tr.lm_host_syncs += prog()
        host, ready = to_host_async(prog.out)
        timing[1] = (time.perf_counter() - t0) * 1e3
        self.pending.append(dict(
            f_id=f_id, host=host, ready=ready, pose_gt=pose_gt,
            gt_objs=gt_objs, prev_gt=self._prev_gt, timing=timing.copy()))
        self._prev_gt = (gt_objs, pose_gt)

        while len(self.pending) > self.LAG:
            self._drain_one()
        # the last frame finishes synchronously, so the final map is whole;
        # its own window BA runs here (no later frame would start it)
        if f_id >= stop_frame or f_id >= n_images - 1:
            self.drain_all()
            if self._lba_trigger(f_id):
                self._run_partial_ba(f_id)
            self._finish_run(f_id, stop_frame)
        return np.asarray(self._last_pose)

    def _finish_run(self, f_id, stop_frame):
        """At the stop frame with the global BA on (``run_global_ba``, or
        KITTI data when it is None), write the state back and run it on the
        host map, as the host path does at that frame."""
        cfg = self.tr.cfg
        run_global = (cfg.run_global_ba if cfg.run_global_ba is not None
                      else cfg.choose_data == 2)
        if f_id == stop_frame and run_global:
            self.exit()
            self.tr._batch_ba("global", ba_builder.full_batch_optimization,
                              frame=f_id)

    # -- draining and BA -------------------------------------------------
    def drain_all(self):
        while self.pending:
            self._drain_one()

    def _lba_trigger(self, f_id):
        cfg = self.tr.cfg
        return (cfg.run_local_ba and f_id >= 0 and f_id != self._ba_frame
                and (f_id - cfg.overlap_size + 1)
                % max(cfg.window_size - cfg.overlap_size, 1) == 0
                and f_id >= cfg.window_size - 1)

    def _run_partial_ba(self, f_id):
        tr = self.tr
        tr.map.lba_times.append(tr._batch_ba(
            "local", ba_builder.partial_batch_optimization,
            tr.cfg.window_size, frame=f_id))
        self._ba_frame = f_id
        pose_np = np.linalg.inv(tr.map.camera_poses[-1]).astype(np.float32)
        self._set_pose(pose_np)
        self._last_pose = pose_np

    def _set_pose(self, pose_np):
        """The refined pose into the state, in place: a captured graph
        reads the state buffers."""
        self.state.pose.copy_(torch.from_numpy(pose_np))

    def _drain_one(self):
        p = self.pending.popleft()
        # a writable copy: the BA write-back mutates map rows in place
        o = unpack_out(np.array(host_array(p["host"], p["ready"])), self.caps)
        self._apply_out(p, o)
        return p, o

    def _apply_out(self, p, o):
        """The lagged frame's map rows, per-object GT bookkeeping and map
        appends (``Tracking._commit_objects`` tail + ``_push_map``)."""
        tr = self.tr
        pose_np, pose_gt = o["pose"], p["pose_gt"]
        prev_gt_objs, prev_pose_gt = p["prev_gt"]
        curr_twc_gt = np.linalg.inv(pose_gt)
        last_twc_gt = np.linalg.inv(prev_pose_gt)
        eye = np.eye(4, dtype=np.float32)
        obj_meta = []
        for k in range(tr.MAXO):
            if not bool(o["lane_valid"][k]):
                continue
            sem = int(o["lane_sem"][k])
            centre = np.asarray(o["lane_centre"][k], np.float32)
            L_w_p = tr._gt_obj_pose(list(prev_gt_objs), sem, last_twc_gt)
            L_w_c = tr._gt_obj_pose(list(p["gt_objs"]), sem, curr_twc_gt)
            H_gt_body, H_gt_world, pose_pre = eye.copy(), eye.copy(), eye.copy()
            if L_w_p is not None and L_w_c is not None:
                H_gt_body = (np.linalg.inv(L_w_p) @ L_w_c).astype(np.float32)
                H_gt_world = (L_w_c @ np.linalg.inv(L_w_p)).astype(np.float32)
                pose_pre = L_w_p
            # GT speed (Tracking.cc:1404-1409): v = t - (I - R) c, km/h x36
            sp = H_gt_world[:3, 3] - (np.eye(3) - H_gt_world[:3, :3]) @ centre
            obj_meta.append(dict(
                label=int(o["lane_label"][k]), sem=sem,
                stat=bool(o["lane_stat"][k]),
                H=np.asarray(o["lane_H"][k], np.float32),
                speed_gt=float(np.linalg.norm(sp)) * 36.0,
                H_gt_body=H_gt_body, pose_pre=pose_pre, centre=centre))
        rows = {name: o[name] for name, _, _ in out_spec(self.caps)
                if not name.startswith(("lane_", "n_point"))}
        tr._push_map(rows, pose_np, pose_gt, prev_pose_gt, o["velocity"],
                     obj_meta, p["timing"])
        # the live accuracy tripwire: the per-frame camera RPE against GT
        # every ``rpe_print_every`` frames as the rows drain, like the
        # reference's per-frame cout (Tracking.cc:1190)
        m, every = tr.map, tr.cfg.rpe_print_every
        if every and m.n_frames >= 2 and (m.n_frames - 1) % every == 0:
            t_e, r_e = metrics.camera_rpe(m.camera_poses[-2:],
                                          m.camera_poses_gt[-2:])
            print("[frame %4d] camera RPE: t=%.4f m  r=%.4f deg  "
                  "(pt inliers %d)" % (m.n_frames - 1, t_e, r_e,
                                       int(o["n_point_inliers"])),
                  flush=True)
        self._last_pose = pose_np
        tr.velocity = o["velocity"]
