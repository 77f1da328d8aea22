"""Line-segment detection: the LSD / EDLines replacement.

Counterpart of the JAX package's ``ops.lines``, stage for stage.  The
reference detects lines with LSD (region growing over level-lines) or
EDLines (edge drawing) inside 3rdparty/line_descriptor (reference
src/Lineextractor.cc:47-135); both are sequential, data-dependent region
growers.  This detector is their block-parallel reformulation:

 1. Sobel gradients -> magnitude + level-line orientation (mod pi).
 2. Edge mask: magnitude threshold + thin non-maximum suppression
    (``mode`` 0), or EDLines-style anchors grown along the level line
    (``mode`` 1).
 3. The image is tiled; each tile fits a straight segment to its edge
    pixels by weighted PCA (first/second moments -> principal direction,
    extent = min/max projection).  A tile emits a segment only when it has
    enough edge support and the orientation is coherent (anisotropy test).
 4. Endpoint refinement along the thinned edge map, then collinear merge
    rounds between neighbouring tiles (angle, lateral offset, endpoint
    gap); each round at most doubles segment length.
 5. A-contrario validation (the NFA test of LSD) of every candidate.
 6. Per octave the longest ``max_lines``; all octaves merged globally by
    connected components of the same mergeability gates and one
    length-weighted orthogonal regression per component.

Every shape is fixed by the image size and the config, so nothing is read
on the host until the caller compacts the valid rows: the fixed-length
``lax.scan`` loops of the JAX package are Python loops of the same length
here, ``jax.lax.top_k`` is the stable sort that keeps its tie order, the
segment sums go through the fixed-order scatter-add, and the regularised
incomplete beta function, which PyTorch lacks, is :func:`betainc`.

Output: (L, 4) endpoint arrays (sx, sy, ex, ey) + validity, like the
injected detections ``Tracking.grab_rgbd`` takes.  LBD descriptors are not
computed: the reference matches lines by optical flow, never by descriptor.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import scatter_add
from .fast import _topk_stable


class LineDetectConfig(NamedTuple):
    grad_threshold: float = 30.0     # ~2*5.2 quantization of LSD (q=2)
    tile: int = 8
    min_support: int = 5             # edge pixels per tile
    # scatter anisotropy gate: modest, because the orientation-coherence
    # filter (LSD's 22.5 deg tolerance) is the primary noise rejector and
    # short partial-tile strokes legitimately have lambda1/lambda2 ~ 5
    min_anisotropy: float = 4.0
    merge_rounds: int = 4
    merge_angle_cos: float = 0.985   # ~10 deg
    merge_lateral: float = 2.5       # px
    merge_gap: float = 8.0           # px
    min_length: float = 12.0         # final length gate
    max_lines: int = 512
    # octave pyramid: the reference detects on a 2-level Gaussian pyramid
    # with scale 2 (reference src/Lineextractor.cc:84-96)
    n_octaves: int = 2
    # endpoint refinement: extend endpoints along the segment direction
    # while the thinned edge map keeps supporting them
    refine_steps: int = 12
    # 0 = LSD-style edge map (threshold + gradient-direction NMS),
    # 1 = EDLines-style (anchors + directed propagation along level lines)
    mode: int = 0
    # a-contrario validation (the NFA control of LSD/EDLines): aligned
    # level-line samples along a 3-px-wide strip around each candidate
    # must be binomially significant against p0 = ang_th/180 at the NFA
    # threshold NT = (w*h)^(5/2)*11
    nfa_gate: bool = True
    nfa_samples: int = 24
    nfa_ang_tol_deg: float = 22.5
    nfa_log_eps: float = 0.0
    # keep only the N longest detections (reference lsd_nfeatures);
    # 0 = unlimited (the reference default)
    n_features: int = 0


class Segments(NamedTuple):
    uv4: torch.Tensor      # (N, 4) sx, sy, ex, ey
    length: torch.Tensor   # (N,)
    valid: torch.Tensor    # (N,)


def _pad_edge(img: torch.Tensor, pad) -> torch.Tensor:
    return F.pad(img[None, None], pad, mode="replicate")[0, 0]


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, -1, keepdim=keepdim))


def _iota(gh: int, gw: int, dim: int, device) -> torch.Tensor:
    r = torch.arange(gh if dim == 0 else gw, device=device)
    return (r[:, None] if dim == 0 else r[None, :]).expand(gh, gw)


# ---------------------------------------------------------------------------
# regularised incomplete beta function
# ---------------------------------------------------------------------------
_BETACF_ITERS = 64


def _betacf(a, b, x):
    """Continued fraction of the incomplete beta function by the modified
    Lentz method, a fixed ``_BETACF_ITERS`` iterations (it converges in
    O(sqrt(max(a, b))) of them; the gate's a, b stay under ~75)."""
    tiny = 1e-30
    qab, qap, qam = a + b, a + 1.0, a - 1.0

    def guard(v):
        return torch.where(v.abs() < tiny, torch.full_like(v, tiny), v)

    c = torch.ones_like(x + a + b)
    d = 1.0 / guard(1.0 - qab * x / qap)
    h = d
    for m in range(1, _BETACF_ITERS + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / guard(1.0 + aa * d)
        c = guard(1.0 + aa / c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / guard(1.0 + aa * d)
        c = guard(1.0 + aa / c)
        h = h * d * c
    return h


def betainc(a: torch.Tensor, b: torch.Tensor, x) -> torch.Tensor:
    """Regularised incomplete beta function I_x(a, b) for a, b > 0 and
    0 <= x <= 1, elementwise in the dtype of ``a`` (``scipy.special.betainc``
    / ``jax.scipy.special.betainc``): prefactor through ``lgamma``,
    continued fraction on the side of x = (a+1)/(a+b+2) where it
    converges fast."""
    if not torch.is_tensor(x):
        # a fill on the device: a host scalar copied there would be a
        # blocking copy
        x = torch.full((), float(x), dtype=a.dtype, device=a.device)
    a, b, x = torch.broadcast_tensors(a, b, x.to(a.dtype))
    xs = x.clamp(1e-30, 1.0 - 1e-7 if a.dtype == torch.float32 else 1.0 - 1e-16)
    log_bt = (torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
              + a * torch.log(xs) + b * torch.log1p(-xs))
    bt = torch.exp(log_bt)
    swap = x >= (a + 1.0) / (a + b + 2.0)
    a1 = torch.where(swap, b, a)
    b1 = torch.where(swap, a, b)
    x1 = torch.where(swap, 1.0 - xs, xs)
    part = bt * _betacf(a1, b1, x1) / a1
    out = torch.where(swap, 1.0 - part, part)
    out = torch.where(x <= 0, torch.zeros_like(out), out)
    return torch.where(x >= 1, torch.ones_like(out), out)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------
def _sobel(img: torch.Tensor):
    p = _pad_edge(img.to(torch.float32), (1, 1, 1, 1))
    gx = (
        (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:])
        - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2])
    )
    gy = (
        (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:])
        - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:])
    )
    return gx, gy


def _grad_mag(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """|g| rounded as the JAX package's compiled detector rounds it: XLA
    fuses ``sqrt(gx * gx + gy * gy)`` into ``fma(gx, gx, gy * gy)`` and a
    correctly rounded square root.  Both are taken here in float64 and
    rounded to float32 after each (``gx * gx`` is exact there), so the card
    and the CPU agree; torch's float32 CPU square root is off by one ulp on
    some CPUs.  One ulp in a tile's weights moves a horizontal segment off
    an integer row, and the NFA gate's ``floor`` sampling then reads other
    pixel rows."""
    gx64 = gx.to(torch.float64)
    s = (gx64 * gx64 + (gy * gy).to(torch.float64)).to(torch.float32)
    return torch.sqrt(s.to(torch.float64)).to(torch.float32)


def _neighbours(mag: torch.Tensor):
    p = F.pad(mag, (1, 1, 1, 1))
    return p[1:-1, 1:-1], {
        "e": p[1:-1, 2:], "w": p[1:-1, :-2],
        "s": p[2:, 1:-1], "n": p[:-2, 1:-1],
        "se": p[2:, 2:], "nw": p[:-2, :-2],
        "ne": p[:-2, 2:], "sw": p[2:, :-2],
    }


def _direction_classes(gx, gy):
    """The 4 quantised gradient directions: (mostly x, mostly y, diagonal
    with gx*gy > 0); the fourth class is the other diagonal."""
    ax, ay = gx.abs(), gy.abs()
    diag = (ax > 0.4142 * ay) & (ay > 0.4142 * ax)
    same_sign = (gx * gy) > 0
    return (ax >= ay) & ~diag, (ay > ax) & ~diag, same_sign


def _by_class(horiz, vert, same_sign, a_h, a_v, a_d1, a_d2):
    return torch.where(horiz, a_h, torch.where(
        vert, a_v, torch.where(same_sign, a_d1, a_d2)))


def _dominant(c, n, horiz, vert, same_sign, margin: float = 0.0):
    """Lateral dominance across the gradient direction (the NMS predicate)."""
    return _by_class(
        horiz, vert, same_sign,
        (c >= n["e"] + margin) & (c >= n["w"] + margin),
        (c >= n["s"] + margin) & (c >= n["n"] + margin),
        (c >= n["se"] + margin) & (c >= n["nw"] + margin),
        (c >= n["ne"] + margin) & (c >= n["sw"] + margin))


def _thin_edges(mag, gx, gy, threshold: float):
    """Gradient-direction NMS (quantized to 4 directions)."""
    c, n = _neighbours(mag)
    keep = _dominant(c, n, *_direction_classes(gx, gy))
    return keep & (mag > threshold)


def _ed_edges(mag, gx, gy, threshold: float, steps: int = 24):
    """EDLines-style edge map: sparse anchors (maxima across the gradient
    direction with a margin, over the threshold) grown by ``steps`` rounds
    of directed propagation along the level line: a pixel joins when it
    clears half the threshold, dominates its lateral triple, and a
    neighbour along ITS OWN level-line direction (+-1 lateral slack) is
    lit.  Chains grow from anchors along lines only, so texture above the
    threshold but off any chain stays dark."""
    horiz_g, vert_g, same_sign = _direction_classes(gx, gy)
    c, n = _neighbours(mag)
    grow_ok = _dominant(c, n, horiz_g, vert_g, same_sign) & (
        mag > 0.5 * threshold)
    lit = _dominant(c, n, horiz_g, vert_g, same_sign, margin=2.0) & (
        mag > threshold)

    for _ in range(steps):
        def shift(dy, dx, lit=lit):
            return torch.roll(lit, shifts=(dy, dx), dims=(0, 1))

        up_down = shift(-1, 0) | shift(1, 0)
        left_right = shift(0, -1) | shift(0, 1)
        d_ne = shift(-1, 1) | shift(1, -1)
        d_nw = shift(-1, -1) | shift(1, 1)
        reach = _by_class(
            horiz_g, vert_g, same_sign,
            up_down | d_ne | d_nw,            # line vertical
            left_right | d_ne | d_nw,         # line horizontal
            d_ne | up_down | left_right,      # line along ne-sw
            d_nw | up_down | left_right)
        lit = lit | (grow_ok & reach)
    return lit


_BIN_ANGLES = np.radians([0.0, 45.0, 90.0, 135.0])


@functools.lru_cache(maxsize=8)
def _bin_dirs(device):
    """cos / sin of the doubled histogram bin angles on ``device``, copied
    there once (a copy per call would block the host on the card)."""
    return tuple(torch.as_tensor(v(2 * _BIN_ANGLES), dtype=torch.float32,
                                 device=device) for v in (np.cos, np.sin))


def _tile_fit(edge, mag, tile: int, min_support: int, min_anisotropy: float,
              gx=None, gy=None, angle_tol_deg: float = 22.5):
    """Weighted-PCA segment fit per tile with LSD-style orientation
    coherence: only edge pixels whose level-line angle lies within
    ``angle_tol_deg`` of the tile's dominant orientation contribute.
    Returns the per-tile segment grid (gh, gw, 4) + validity."""
    h, w = edge.shape
    gh, gw = h // tile, w // tile
    dev = mag.device

    def tiles(a):
        return (a.reshape(gh, tile, gw, tile).permute(0, 2, 1, 3)
                .reshape(gh, gw, tile * tile))

    e = edge[: gh * tile, : gw * tile].to(torch.float32)
    m = mag[: gh * tile, : gw * tile] * e

    if gx is not None:
        # doubled-angle unit vectors of the level line
        gxc = gx[: gh * tile, : gw * tile]
        gyc = gy[: gh * tile, : gw * tile]
        g2 = gxc * gxc + gyc * gyc + 1e-9
        tw = tiles(m)
        tc2 = tiles((gxc * gxc - gyc * gyc) / g2)     # cos(2*theta_grad)
        ts2 = tiles((2.0 * gxc * gyc) / g2)           # sin(2*theta_grad)
        # dominant orientation by a magnitude-weighted 4-bin histogram
        # over [0, pi): one strong blob cannot hijack the tile
        bin_c2, bin_s2 = _bin_dirs(dev)
        cos45 = float(np.cos(np.radians(45.0)))
        inbin = (tc2[..., None] * bin_c2 + ts2[..., None] * bin_s2) > cos45
        bin_w = torch.sum(tw[..., None] * inbin, dim=-2)        # (gh, gw, 4)
        best = torch.argmax(bin_w, dim=-1)                      # first maximum
        sel = torch.gather(
            inbin, -1, best[..., None, None].expand(gh, gw, tile * tile, 1)
        )[..., 0]
        twb = tw * sel
        wsum0 = torch.clamp(torch.sum(twb, -1), min=1e-6)
        mc2 = torch.sum(twb * tc2, -1) / wsum0
        ms2 = torch.sum(twb * ts2, -1) / wsum0
        nrm = torch.sqrt(mc2 * mc2 + ms2 * ms2 + 1e-12)
        mc2, ms2 = mc2 / nrm, ms2 / nrm
        cos_tol = float(np.cos(np.radians(2 * angle_tol_deg)))
        coh = (tc2 * mc2[..., None] + ts2 * ms2[..., None]) > cos_tol
        coh_full = (coh.reshape(gh, gw, tile, tile).permute(0, 2, 1, 3)
                    .reshape(gh * tile, gw * tile))
        m = m * coh_full

    ys = torch.arange(gh * tile, dtype=torch.float32, device=dev)
    xs = torch.arange(gw * tile, dtype=torch.float32, device=dev)
    tx = tiles(xs[None, :].expand(gh * tile, gw * tile))
    ty = tiles(ys[:, None].expand(gh * tile, gw * tile))
    wgt0 = tiles(m)

    def fit(wgt):
        wsafe = torch.clamp(torch.sum(wgt, -1), min=1e-6)
        mx = torch.sum(wgt * tx, -1) / wsafe
        my = torch.sum(wgt * ty, -1) / wsafe
        dx = tx - mx[..., None]
        dy = ty - my[..., None]
        sxx = torch.sum(wgt * dx * dx, -1) / wsafe
        syy = torch.sum(wgt * dy * dy, -1) / wsafe
        sxy = torch.sum(wgt * dx * dy, -1) / wsafe
        # eigen of [[sxx, sxy], [sxy, syy]]
        tr = sxx + syy
        det = sxx * syy - sxy * sxy
        disc = torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
        l1 = tr / 2 + disc
        l2 = tr / 2 - disc
        # principal direction: eigenvector of lambda1; when sxy ~ 0 the
        # axes are already principal -- pick the larger-variance axis
        off = sxy.abs() > 1e-9
        xmajor = (sxx >= syy).to(torch.float32)
        vx = torch.where(off, l1 - syy, xmajor)
        vy = torch.where(off, sxy, 1.0 - xmajor)
        vn = torch.sqrt(vx * vx + vy * vy + 1e-12)
        return mx, my, vx / vn, vy / vn, l1, l2, dx, dy

    # robust refit: pixels of the dominant bin that sit laterally off the
    # fitted line are dropped and the moments recomputed once
    mx, my, vx, vy, l1, l2, dx, dy = fit(wgt0)
    lat = (dy * vx[..., None] - dx * vy[..., None]).abs()
    wgt = wgt0 * (lat <= 2.0)
    mx, my, vx, vy, l1, l2, dx, dy = fit(wgt)
    # extent: min/max projection of edge pixels on v
    proj = dx * vx[..., None] + dy * vy[..., None]
    on = wgt > 0
    pmax = torch.where(on, proj, torch.full_like(proj, -1e9)).amax(-1)
    pmin = torch.where(on, proj, torch.full_like(proj, 1e9)).amin(-1)
    count = torch.sum(on.to(torch.float32), -1)
    aniso = l1 / torch.clamp(l2, min=1e-6)
    ok = (count >= min_support) & (aniso >= min_anisotropy) & (pmax > pmin)
    s = torch.stack(
        [mx + pmin * vx, my + pmin * vy, mx + pmax * vx, my + pmax * vy], -1)
    return s, ok


def _merge_pairs(seg, ok, nbr_seg, nbr_ok, cfg: LineDetectConfig,
                 allow=None):
    """Try to merge each tile's segment with a neighbour's.  Returns merged
    segment + merged flag (applied where both exist and are collinear)."""
    d1 = seg[..., 2:] - seg[..., :2]
    d2 = nbr_seg[..., 2:] - nbr_seg[..., :2]
    l1 = _norm(d1) + 1e-9
    l2 = _norm(d2) + 1e-9
    cosang = torch.sum(d1 * d2, -1).abs() / (l1 * l2)
    # lateral offset of neighbour's midpoint from our infinite line
    mid2 = 0.5 * (nbr_seg[..., :2] + nbr_seg[..., 2:])
    n1 = torch.stack([-d1[..., 1], d1[..., 0]], -1) / l1[..., None]
    lat = torch.sum((mid2 - seg[..., :2]) * n1, -1).abs()
    # endpoint gap: smallest distance between endpoints
    gaps = torch.stack([
        _norm(seg[..., 2:] - nbr_seg[..., :2]),
        _norm(seg[..., :2] - nbr_seg[..., 2:]),
        _norm(seg[..., 2:] - nbr_seg[..., 2:]),
        _norm(seg[..., :2] - nbr_seg[..., :2]),
    ], -1).amin(-1)
    can = (
        ok & nbr_ok
        & (cosang > cfg.merge_angle_cos)
        & (lat < cfg.merge_lateral)
        & (gaps < cfg.merge_gap)
    )
    if allow is not None:
        can = can & allow
    # merged endpoints: extreme projections of all 4 endpoints on the
    # length-weighted blended direction through the length-weighted
    # centroid (inheriting one fragment's direction would amplify its
    # tile-fit angle error over the merged length)
    u1 = d1 / l1[..., None]
    u2 = d2 / l2[..., None]
    sign = torch.sign(torch.sum(u1 * u2, -1, keepdim=True))
    ub = u1 * l1[..., None] + sign * u2 * l2[..., None]
    ub = ub / (_norm(ub, keepdim=True) + 1e-9)
    mid1 = 0.5 * (seg[..., :2] + seg[..., 2:])
    cen = (mid1 * l1[..., None] + mid2 * l2[..., None]) / (l1 + l2)[..., None]
    pts = torch.stack(
        [seg[..., :2], seg[..., 2:], nbr_seg[..., :2], nbr_seg[..., 2:]], -2)
    t = torch.sum((pts - cen[..., None, :]) * ub[..., None, :], -1)
    new_s = cen + t.amin(-1)[..., None] * ub
    new_e = cen + t.amax(-1)[..., None] * ub
    merged = torch.cat([new_s, new_e], -1)
    return torch.where(can[..., None], merged, seg), can


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """Gaussian blur (binomial 1-2-1 separable) + stride-2 decimation: one
    octave of the reference's line pyramid."""
    p = _pad_edge(img.to(torch.float32), (1, 1, 1, 1))
    bx = 0.25 * (p[1:-1, :-2] + 2 * p[1:-1, 1:-1] + p[1:-1, 2:])
    p2 = _pad_edge(bx, (0, 0, 1, 1))
    b = 0.25 * (p2[:-2] + 2 * p2[1:-1] + p2[2:])
    return b[::2, ::2]


def _refine_endpoints(seg, ok, edge, mag, steps: int):
    """Extend each segment's endpoints outward along its direction while
    the thinned edge map keeps support within +-1 px laterally (the tile
    fit truncates at tile borders; LSD emits exact region extents)."""
    if steps <= 0:
        return seg
    h, w = edge.shape
    em = (edge & (mag > 0)).to(torch.float32)
    d = seg[..., 2:] - seg[..., :2]
    u = d / (_norm(d, keepdim=True) + 1e-9)              # unit direction
    nrm = torch.stack([-u[..., 1], u[..., 0]], -1)       # lateral unit

    def look(q):
        # nearest lookup with clamping (round half to even, then truncate)
        x = torch.round(q[..., 0]).to(torch.int64).clamp(0, w - 1)
        y = torch.round(q[..., 1]).to(torch.int64).clamp(0, h - 1)
        inb = ((q[..., 0] >= 0) & (q[..., 0] <= w - 1)
               & (q[..., 1] >= 0) & (q[..., 1] <= h - 1))
        return em[y, x] * inb

    def sample(pts):
        # support = max over lateral offsets {-1, 0, 1}
        s = look(pts)
        s = torch.maximum(s, look(pts + nrm[..., None, :]))
        return torch.maximum(s, look(pts - nrm[..., None, :]))

    ts = torch.arange(1, steps + 1, dtype=torch.float32, device=seg.device)

    def extend(base, direction):
        pts = base[..., None, :] + direction[..., None, :] * ts[:, None]
        sup = sample(pts)                                # (..., steps)
        # contiguous support run, one-pixel holes allowed
        run = torch.cumprod(
            torch.clamp(sup + torch.roll(sup, -1, -1), max=1.0), dim=-1)
        return base + direction * torch.sum(run, -1)[..., None]

    new_e = extend(seg[..., 2:], u)
    new_s = extend(seg[..., :2], -u)
    return torch.where(ok[..., None], torch.cat([new_s, new_e], -1), seg)


_NFA_COMBOS = ((1, 0, 0), (0, 1, 0), (0, 0, 1),
               (1, 1, 0), (0, 1, 1), (1, 0, 1), (1, 1, 1))


@functools.lru_cache(maxsize=8)
def _nfa_consts(device):
    """The normal offsets (-1, 0, 1) and :data:`_NFA_COMBOS` on ``device``,
    copied there once."""
    return (torch.tensor([-1.0, 0.0, 1.0], device=device),
            torch.tensor(_NFA_COMBOS, dtype=torch.float32, device=device))


def _nfa_significance(uv4, gx, gy, cfg: LineDetectConfig):
    """Best of the 7 row-subset significances  -log10 B(n, k, p0) - logNT
    of each candidate; see :func:`_nfa_gate`.  Also returns the (k, n)
    counts it scored, for tests."""
    h, w = gx.shape
    dev = gx.device
    S = cfg.nfa_samples
    p0 = cfg.nfa_ang_tol_deg / 180.0
    sin_prec = float(np.sin(np.float32(np.pi * p0)))
    logNT = (2.5 * np.log10(float(h) * float(w)) + np.log10(11.0)
             + np.log10(7.0))

    s, e = uv4[:, :2], uv4[:, 2:]
    d = e - s
    length = _norm(d)
    u = d / torch.clamp(length, min=1e-6)[:, None]              # (N, 2)
    nrm = torch.stack([-u[:, 1], u[:, 0]], -1)                  # unit normal
    t = torch.linspace(0.0, 1.0, S, dtype=torch.float32, device=dev)
    base = s[:, None, :] + t[None, :, None] * d[:, None, :]     # (N, S, 2)
    offs, combos = _nfa_consts(dev)
    pts = base[:, :, None, :] + offs[None, None, :, None] * nrm[:, None, None, :]
    px = torch.floor(pts[..., 0]).to(torch.int64)
    py = torch.floor(pts[..., 1]).to(torch.int64)
    inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    pxc = px.clamp(0, w - 1)
    pyc = py.clamp(0, h - 1)
    gxs = gx[pyc, pxc]
    gys = gy[pyc, pxc]
    g2 = gxs * gxs + gys * gys
    mag_ok = g2 > cfg.grad_threshold ** 2
    # the segment aligns with the level line when |gradient . segdir| <=
    # |g| sin(prec)
    gdot = gxs * u[:, None, None, 0] + gys * u[:, None, None, 1]
    aligned = inb & mag_ok & (gdot.abs() <= torch.sqrt(g2) * sin_prec + 1e-6)
    scale = torch.clamp(length / float(S), max=1.0)[:, None]
    n_row = torch.sum(inb, dim=1).to(torch.float32) * scale     # (N, 3)
    k_row = torch.sum(aligned, dim=1).to(torch.float32) * scale
    n = n_row @ combos.T                                        # (N, 7)
    k = k_row @ combos.T
    q = k / torch.clamp(n, min=1.0)
    # exact tail; betainc needs a, b > 0 -- combos with k == 0 are never
    # significant and are masked instead
    a = torch.clamp(k, min=0.5)
    b = torch.clamp(n - k, min=0.0) + 1.0
    tail = torch.clamp(betainc(a, b, p0), 1e-30, 1.0)
    sig = -torch.log10(tail) - logNT
    sig = torch.where((k > 0) & (q > p0), sig,
                      torch.full_like(sig, -math.inf))
    return sig.amax(-1), k, n


def _nfa_gate(uv4, valid, gx, gy, cfg: LineDetectConfig):
    """Vectorized a-contrario segment validation.

    For each candidate, level-line angles are gathered at ``nfa_samples``
    positions along the segment on 3 lateral offset rows (the detected
    centre may sit +-1 px off the crest) and the samples aligned with the
    segment direction within ``nfa_ang_tol_deg`` (gradient over the
    detection threshold) are counted.  Every subset of the 3 rows (7
    hypotheses: a 2-px stroke has two aligned crests and a flat interior,
    a 1-px edge one) is scored with the exact binomial tail
    B(n, k, p0) = I_p0(k, n-k+1), and the best must satisfy
    -log10 B - logNT - log10(7) > log_eps.  Short segments resample the
    same pixels; counts are rescaled by min(1, length/S)."""
    best, _, _ = _nfa_significance(uv4, gx, gy, cfg)
    return valid & (best > cfg.nfa_log_eps)


_MERGE_DIRS = ((0, 1), (1, 0), (1, 1), (1, -1))


def _merge_rounds(seg, ok, cfg: LineDetectConfig):
    """Merge rounds over 4 neighbour directions (right, down, down-right,
    down-left).  Round r looks at stride 2^r (parallel-reduction style:
    merged segments live in the 'left' tile, so chains double in reach
    each round).  Consumed neighbours are invalidated."""
    gh, gw = ok.shape
    dev = ok.device
    rows, cols = _iota(gh, gw, 0, dev), _iota(gh, gw, 1, dev)
    for rnd in range(cfg.merge_rounds):
        stride = 1 << rnd
        for dy0, dx0 in _MERGE_DIRS:
            dy, dx = dy0 * stride, dx0 * stride
            if abs(dy) >= gh or abs(dx) >= gw:
                continue
            nbr = torch.roll(seg, shifts=(-dy, -dx), dims=(0, 1))
            nbr_ok = torch.roll(ok, shifts=(-dy, -dx), dims=(0, 1))
            # edge tiles must not wrap
            col_ok = cols < gw - dx if dx >= 0 else cols >= -dx
            nbr_ok = nbr_ok & (rows < gh - dy) & col_ok
            # parity-disjoint absorbers: a tile may absorb its neighbour
            # only on the even slot of this round's stride, so nothing is
            # absorbed and extended at once
            idx = cols if dx0 != 0 else rows
            allow = ((idx // stride) % 2) == 0
            seg, did = _merge_pairs(seg, ok, nbr, nbr_ok, cfg, allow)
            consumed = torch.roll(did, shifts=(dy, dx), dims=(0, 1))
            back_ok = (rows >= dy) & (cols >= dx if dx >= 0 else cols < gw + dx)
            ok = ok & ~(consumed & back_ok)
    return seg, ok


def _detect_octave(img: torch.Tensor, cfg: LineDetectConfig) -> Segments:
    """Single-octave detection on ``img``'s own pixel grid."""
    gx, gy = _sobel(img)
    mag = _grad_mag(gx, gy)
    if cfg.mode == 1:
        edge = _ed_edges(mag, gx, gy, cfg.grad_threshold)
    else:
        edge = _thin_edges(mag, gx, gy, cfg.grad_threshold)
    seg, ok = _tile_fit(edge, mag, cfg.tile, cfg.min_support,
                        cfg.min_anisotropy, gx=gx, gy=gy)
    seg = _refine_endpoints(seg, ok, edge, mag, cfg.refine_steps)
    seg, ok = _merge_rounds(seg, ok, cfg)

    flat = seg.reshape(-1, 4)
    length = _norm(flat[:, 2:] - flat[:, :2])
    valid = ok.reshape(-1) & (length >= 0.5 * cfg.min_length)
    if cfg.nfa_gate:
        valid = _nfa_gate(flat, valid, gx, gy, cfg)
    # keep the longest max_lines
    score = torch.where(valid, length, torch.full_like(length, -1.0))
    top = _topk_stable(score, min(cfg.max_lines, score.shape[0]))[1]
    return Segments(uv4=flat[top], length=length[top], valid=valid[top])


def _merge_all(uv4, valid, cfg: LineDetectConfig) -> Segments:
    """Global collinear merge: all-pairs mergeability gates (angle /
    lateral offset / endpoint gap -- the tile rounds' thresholds),
    connected components by 10 steps of min-label propagation with pointer
    jumping, then one length-weighted orthogonal regression per component
    by segment reductions."""
    n = uv4.shape[0]
    dev = uv4.device
    d = uv4[:, 2:] - uv4[:, :2]
    ln = _norm(d) + 1e-9
    u = d / ln[:, None]
    nrm = torch.stack([-u[:, 1], u[:, 0]], 1)
    mid = 0.5 * (uv4[:, :2] + uv4[:, 2:])

    cosang = (u @ u.T).abs()
    lat = (nrm @ mid.T - torch.sum(nrm * uv4[:, :2], -1)[:, None]).abs()
    si = torch.sum(uv4[:, :2] * u, -1)[:, None]
    t0 = u @ uv4[:, :2].T - si
    t1 = u @ uv4[:, 2:].T - si
    tlo = torch.minimum(t0, t1)
    thi = torch.maximum(t0, t1)
    gap = torch.maximum(tlo - ln[:, None], -thi)
    can = (
        (valid[:, None] & valid[None, :])
        & (cosang > cfg.merge_angle_cos)
        & ((lat < cfg.merge_lateral) | (lat.T < cfg.merge_lateral))
        & (gap < cfg.merge_gap)
    )
    can = can | can.T | torch.eye(n, dtype=torch.bool, device=dev)

    lab = torch.arange(n, device=dev)
    far = torch.full((), n, dtype=lab.dtype, device=dev)
    for _ in range(10):
        nxt = torch.where(can, lab[None, :], far).amin(1)
        nxt = torch.minimum(lab, nxt)
        lab = torch.minimum(nxt, nxt[nxt])          # pointer jumping

    # per-component length-weighted orthogonal regression, keyed by root
    pts = torch.cat([uv4[:, :2], uv4[:, 2:]], 0)                # (2n, 2)
    w1 = torch.where(valid, ln, torch.zeros_like(ln))
    wts = torch.cat([w1, w1])
    root = torch.cat([lab, lab])

    def seg_sum(v):
        out = torch.zeros(n, dtype=v.dtype, device=dev)
        scatter_add(out, root, v)
        return out

    def seg_extreme(v, fill, how):
        out = torch.full((n,), fill, dtype=v.dtype, device=dev)
        return out.scatter_reduce_(0, root, v, how, include_self=True)

    wsum = torch.clamp(seg_sum(wts), min=1e-9)
    cx = seg_sum(wts * pts[:, 0]) / wsum
    cy = seg_sum(wts * pts[:, 1]) / wsum
    dx = pts[:, 0] - cx[root]
    dy = pts[:, 1] - cy[root]
    cxx = seg_sum(wts * dx * dx)
    cyy = seg_sum(wts * dy * dy)
    cxy = seg_sum(wts * dx * dy)
    theta = 0.5 * torch.atan2(2 * cxy, cxx - cyy)
    ux, uy = torch.cos(theta), torch.sin(theta)
    t = dx * ux[root] + dy * uy[root]
    on = wts > 0
    tmin = seg_extreme(torch.where(on, t, torch.full_like(t, math.inf)),
                       math.inf, "amin")
    tmax = seg_extreme(torch.where(on, t, torch.full_like(t, -math.inf)),
                       -math.inf, "amax")
    out = torch.stack([cx + tmin * ux, cy + tmin * uy,
                       cx + tmax * ux, cy + tmax * uy], 1)
    # an empty component gives inf - (-inf)
    span = tmax - tmin
    out_len = torch.where(torch.isfinite(span), span, torch.zeros_like(span))
    is_root = lab == torch.arange(n, device=dev)
    out_valid = valid & is_root & (out_len >= cfg.min_length)
    out = torch.where(out_valid[:, None], out, uv4)
    return Segments(uv4=out, length=out_len, valid=out_valid)


def n_segments(h: int, w: int, cfg: LineDetectConfig = LineDetectConfig()):
    """The rows :func:`detect_lines` returns for an (h, w) image: each
    octave's tiles, at most ``max_lines`` an octave."""
    n = 0
    for o in range(max(1, cfg.n_octaves)):
        if o > 0:
            h, w = (h + 1) // 2, (w + 1) // 2
        n += min(cfg.max_lines, (h // cfg.tile) * (w // cfg.tile))
    return n


def detect_lines(img: torch.Tensor,
                 cfg: LineDetectConfig = LineDetectConfig()) -> Segments:
    """Detect line segments over ``cfg.n_octaves`` pyramid levels of the
    (H, W) image ``img``, on the device ``img`` lies on; returns fixed-cap
    (n_octaves * max_lines, 4) + validity, coordinates on the
    full-resolution grid, globally collinear-merged (cross-octave
    duplicates collapse in the final merge).  No value is read on the host."""
    img = img.to(torch.float32)
    outs = []
    for o in range(max(1, cfg.n_octaves)):
        if o > 0:
            img = _downsample2(img)
        # shorter structures need fewer support pixels at coarse octaves;
        # min_length is a full-resolution quantity
        ocfg = cfg._replace(
            min_length=cfg.min_length / (2.0 ** o),
            min_support=max(4, cfg.min_support // (1 + o)),
        )
        s = _detect_octave(img, ocfg)
        scale = float(2.0 ** o)
        outs.append(Segments(uv4=s.uv4 * scale, length=s.length * scale,
                             valid=s.valid))
    merged = _merge_all(torch.cat([s.uv4 for s in outs], 0),
                        torch.cat([s.valid for s in outs], 0), cfg)
    if cfg.n_features > 0:
        # lsd_nfeatures cap: exactly the n_features longest valid
        # detections (the index tie-break truncates ties)
        ln = torch.where(merged.valid, merged.length,
                         torch.full_like(merged.length, -1.0))
        top_idx = _topk_stable(ln, min(int(cfg.n_features), ln.shape[0]))[1]
        keep = torch.zeros_like(merged.valid)
        keep[top_idx] = True
        merged = merged._replace(valid=keep & merged.valid)
    return merged


def merge_components_np(uv4, valid,
                        cfg: LineDetectConfig = LineDetectConfig()):
    """Final collinear merge on the host in numpy: one all-pairs
    mergeability test (the same gates as :func:`_merge_all`), connected
    components by min-label propagation run to its fixed point, and one
    length-weighted orthogonal regression per component.  Returns the
    merged (L, 4) float32 detections, length-filtered."""
    segs = np.asarray(uv4)[np.asarray(valid)].astype(np.float32)
    k = len(segs)
    if k == 0:
        return segs.reshape(0, 4)
    d = segs[:, 2:] - segs[:, :2]
    ln = np.linalg.norm(d, axis=1) + 1e-9
    u = (d / ln[:, None]).astype(np.float32)
    nrm = np.stack([-u[:, 1], u[:, 0]], axis=1)
    mid = 0.5 * (segs[:, :2] + segs[:, 2:])

    cosang = np.abs(u @ u.T)
    # lat[i, j] = |mid_j . n_i - s_i . n_i|
    lat = np.abs((nrm @ mid.T) - np.einsum("ik,ik->i", nrm, segs[:, :2])[:, None])
    # projections of j's endpoints on i's direction, rooted at s_i
    si_ui = np.einsum("ik,ik->i", segs[:, :2], u)[:, None]
    t0 = (u @ segs[:, :2].T) - si_ui
    t1 = (u @ segs[:, 2:].T) - si_ui
    gap = np.maximum(np.minimum(t0, t1) - ln[:, None], -np.maximum(t0, t1))
    can = (
        (cosang > cfg.merge_angle_cos)
        & ((lat < cfg.merge_lateral) | (lat.T < cfg.merge_lateral))
        & (gap < cfg.merge_gap)
    )
    can = can | can.T
    np.fill_diagonal(can, True)

    lab = np.arange(k)
    for _ in range(32):
        nxt = np.minimum(lab, np.where(can, lab[None, :], k).min(1))
        nxt = np.minimum(nxt, nxt[nxt])        # pointer jumping
        if np.array_equal(nxt, lab):
            break
        lab = nxt
    _, comp = np.unique(lab, return_inverse=True)
    nc = comp.max() + 1

    pts = np.concatenate([segs[:, :2], segs[:, 2:]], axis=0)   # (2k, 2)
    wts = np.concatenate([ln, ln])
    root = np.concatenate([comp, comp])
    wsum = np.bincount(root, wts, minlength=nc)
    cx = np.bincount(root, wts * pts[:, 0], minlength=nc) / wsum
    cy = np.bincount(root, wts * pts[:, 1], minlength=nc) / wsum
    dx = pts[:, 0] - cx[root]
    dy = pts[:, 1] - cy[root]
    cxx = np.bincount(root, wts * dx * dx, minlength=nc)
    cyy = np.bincount(root, wts * dy * dy, minlength=nc)
    cxy = np.bincount(root, wts * dx * dy, minlength=nc)
    theta = 0.5 * np.arctan2(2 * cxy, cxx - cyy)
    ux, uy = np.cos(theta), np.sin(theta)
    t = dx * ux[root] + dy * uy[root]
    tmin = np.full(nc, np.inf)
    tmax = np.full(nc, -np.inf)
    np.minimum.at(tmin, root, t)
    np.maximum.at(tmax, root, t)
    out = np.stack([cx + tmin * ux, cy + tmin * uy,
                    cx + tmax * ux, cy + tmax * uy], axis=1).astype(np.float32)
    length = np.linalg.norm(out[:, 2:] - out[:, :2], axis=1)
    return out[length >= cfg.min_length]


def detect_lines_np(img, cfg: LineDetectConfig = LineDetectConfig(), *,
                    device) -> np.ndarray:
    """:func:`detect_lines` of a host image on ``device`` -> numpy (L, 4)
    detections, the form ``Tracking.grab_rgbd`` takes: one copy to the
    device, one read back."""
    segs = detect_lines(
        torch.from_numpy(np.ascontiguousarray(img)).to(device), cfg)
    packed = torch.cat([segs.uv4, segs.valid[:, None].to(torch.float32)], 1)
    packed = packed.cpu().numpy()
    return packed[packed[:, 4] > 0.5, :4].astype(np.float32).reshape(-1, 4)
