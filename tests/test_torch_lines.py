"""The port's line detector (``sdpl_slam_torch.ops.lines``) against the
JAX package's, stage by stage and as a whole, and against the LSD oracle.

Inputs come from numpy seeds; every image is 240x320 so that JAX compiles
``detect_lines`` once per config.  Tolerances, as stated at each test:

* integer-exact stages (Sobel on 8-bit input, the 1-2-1 downsample, both
  edge maps given the same gradients) must be equal;
* continuous outputs given the same inputs: ``allclose`` at 1e-3 px
  (float32 sums of 64 terms in two summation orders);
* boolean gates given the same inputs: equal, except where the deciding
  quantity lies within a stated distance of its threshold;
* the final segment set: every JAX segment has a port segment with both
  endpoints within 0.5 px, and the reverse, for at least 95 % of segments.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from sdpl_slam_tpu.ops import lines as jl
from sdpl_slam_tpu.ops import lsd_oracle as jax_oracle
from sdpl_slam_torch.ops import lines as tl
from sdpl_slam_torch.ops import lsd_oracle
from sdpl_slam_torch.utils import convert
from sdpl_slam_torch.utils.synthetic import draw_strokes

torch.set_num_threads(2)
H, W = 240, 320


# ----------------------------- images -------------------------------------
def _aa_line(img, seg, value):
    """Anti-aliased 1-px line (coverage by distance to the segment)."""
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    p, q = np.asarray(seg[:2], float), np.asarray(seg[2:], float)
    d = q - p
    t = np.clip(((xx - p[0]) * d[0] + (yy - p[1]) * d[1]) / (d @ d), 0, 1)
    dist = np.hypot(xx - (p[0] + t * d[0]), yy - (p[1] + t * d[1]))
    a = np.clip(1.0 - dist, 0, 1)
    img[:] = (img * (1 - a) + value * a).astype(img.dtype)


def render_thin(segs):
    """Bright 1-px anti-aliased lines on a dark ground
    (``tests/test_lines.py``)."""
    img = np.full((H, W), 40, np.uint8)
    for s in segs:
        _aa_line(img, s, 210)
    return img


def render_strokes(segs, fg=25, bg=120, dots=0, seed=3, thick=False):
    """Dark 2-px strokes over optional dot texture
    (``tests/test_line_recall.py``)."""
    rng = np.random.default_rng(seed)
    img = np.full((H, W), bg, np.uint8)
    if dots:
        dy = rng.integers(1, H - 2, dots)
        dx = rng.integers(1, W - 2, dots)
        val = rng.choice([30, 220], dots).astype(np.uint8)
        for ddy in (0, 1):
            for ddx in (0, 1):
                img[np.clip(dy + ddy, 0, H - 1),
                    np.clip(dx + ddx, 0, W - 1)] = val
    draw_strokes(img, segs, fg)
    if thick:
        draw_strokes(img, np.asarray(segs) + 1.0, fg)
    return img


def grid_segments(lengths, angles, spacing=55):
    segs, i = [], 0
    for y in range(30, H - 30, spacing):
        for x in range(25, W - 80, 110):
            ln = lengths[i % len(lengths)]
            an = np.radians(angles[i % len(angles)])
            ex, ey = x + ln * np.cos(an), y + ln * np.sin(an)
            if 2 < ex < W - 2 and 2 < ey < H - 2:
                segs.append([x, y, ex, ey])
            i += 1
    return np.asarray(segs, np.float32)


FOUR = np.array([[40, 30, 160, 30], [60, 60, 60, 170],
                 [120, 80, 250, 160], [200, 40, 280, 20]], np.float32)


def _noisy(img, seed=0, sigma=10.0):
    rng = np.random.default_rng(seed)
    return np.clip(img + rng.normal(0, sigma, img.shape), 0, 255).astype(np.uint8)


IMAGES = {
    "four-thin": lambda: render_thin(FOUR),
    "long-thin": lambda: render_thin([[20, 96, 300, 96]]),
    "short": lambda: render_strokes(grid_segments([16, 20, 25], [0, 90, 35, 120])),
    "shallow": lambda: render_strokes(grid_segments([60, 90], [2, 4, 7, -3, -6])),
    "textured": lambda: render_strokes(grid_segments([50, 80], [0, 90, 30, 60]),
                                       dots=300),
    "low-contrast": lambda: render_strokes(grid_segments([70, 100], [10, 100]),
                                           fg=95, thick=True),
    "noisy": lambda: _noisy(render_strokes(grid_segments([50, 80], [15, 75, 140]))),
}

CONFIGS = {
    "default": {},
    "ed": dict(mode=1),
    "cap2": dict(n_features=2),
    "norefine": dict(refine_steps=0),
    "one-octave": dict(n_octaves=1),
}


def _match_frac(a, b, tol=0.5):
    """Share of segments of ``a`` that have a segment of ``b`` with both
    endpoints within ``tol`` px."""
    if len(a) == 0:
        return 1.0
    if len(b) == 0:
        return 0.0
    d = (a[:, None, :] - b[None, :, :]).reshape(len(a), len(b), 2, 2)
    d = np.sqrt((d ** 2).sum(-1)).max(-1)
    return float((d.min(1) < tol).mean())


def _both(img, **kw):
    det_j = jl.detect_lines_np(jnp.asarray(img), jl.LineDetectConfig(**kw))
    det_t = tl.detect_lines_np(img, tl.LineDetectConfig(**kw), device="cpu")
    return det_j, det_t


# ------------------------- the whole detector ------------------------------
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_segments_match_jax(cfg_name):
    """Set-level match on every image, both directions, >= 95 % (measured:
    100 % on all of them)."""
    total = matched = 0
    for name, make in IMAGES.items():
        det_j, det_t = _both(make(), **CONFIGS[cfg_name])
        assert len(det_j) > 0, name
        fj, ft = _match_frac(det_j, det_t), _match_frac(det_t, det_j)
        assert fj >= 0.95 and ft >= 0.95, (name, fj, ft, len(det_j), len(det_t))
        total += len(det_j) + len(det_t)
        matched += fj * len(det_j) + ft * len(det_t)
    assert matched / total >= 0.95


def test_config_converts_from_jax():
    c = jl.LineDetectConfig(mode=1, n_features=7, max_lines=99, min_length=9.5)
    assert convert.line_config_from_jax(c) == tl.LineDetectConfig(
        mode=1, n_features=7, max_lines=99, min_length=9.5)
    assert tl.LineDetectConfig()._asdict() == jl.LineDetectConfig()._asdict()


def test_flat_image_has_no_lines():
    segs = tl.detect_lines(torch.full((H, W), 100, dtype=torch.uint8))
    assert int(segs.valid.sum()) == 0
    # per octave the cap is min(max_lines, tiles): 512 of 30x40, 300 of 15x20
    assert segs.uv4.shape == (512 + 300, 4)


def test_isolated_segments_detected_and_capped():
    """``tests/test_lines.py``'s gates on the port alone."""
    det = tl.detect_lines_np(render_thin(FOUR), device="cpu")
    assert len(det) >= 4
    cap = tl.detect_lines_np(render_thin(FOUR),
                             tl.LineDetectConfig(n_features=2), device="cpu")
    assert 1 <= len(cap) <= 2
    assert np.linalg.norm(cap[:, 2:] - cap[:, :2], axis=1).min() > 80.0
    long = tl.detect_lines_np(render_thin([[20, 96, 300, 96]]), device="cpu")
    assert np.linalg.norm(long[:, 2:] - long[:, :2], axis=1).max() > 60


def _recall(gt, det, lat_tol=3.0, cover_frac=0.6):
    hits = 0
    for g in np.asarray(gt, np.float64):
        glen = np.linalg.norm(g[2:] - g[:2])
        u = (g[2:] - g[:2]) / (glen + 1e-9)
        n = np.array([-u[1], u[0]])
        for d in np.asarray(det, np.float64):
            if max(abs((d[:2] - g[:2]) @ n), abs((d[2:] - g[:2]) @ n)) > lat_tol:
                continue
            t0, t1 = (d[:2] - g[:2]) @ u, (d[2:] - g[:2]) @ u
            if min(max(t0, t1), glen) - max(min(t0, t1), 0.0) >= cover_frac * glen:
                hits += 1
                break
    return hits / max(len(gt), 1)


@pytest.mark.parametrize("name,lengths,angles,kw,cfg,bar", [
    ("short", [16, 20, 25], [0, 90, 35, 120], {}, {}, 0.75),
    ("shallow", [60, 90], [2, 4, 7, -3, -6], {}, {}, 0.8),
    ("textured", [50, 80], [0, 90, 30, 60], dict(dots=300), {}, 0.7),
    ("ed-textured", [40, 70], [0, 90, 45], dict(dots=250), dict(mode=1), 0.7),
])
def test_recall_of_known_segments(name, lengths, angles, kw, cfg, bar):
    """``tests/test_line_recall.py``'s recall bars on the port alone."""
    gt = grid_segments(lengths, angles)
    det = tl.detect_lines_np(render_strokes(gt, **kw),
                             tl.LineDetectConfig(**cfg), device="cpu")
    assert _recall(gt, det) >= bar, (name, _recall(gt, det), len(gt), len(det))


# ------------------------------ stages -------------------------------------
def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def stage_inputs():
    img = _noisy(IMAGES["textured"](), seed=5, sigma=6.0)
    gx, gy = jl._sobel(jnp.asarray(img))
    mag = jnp.sqrt(gx * gx + gy * gy)
    edge = jl._thin_edges(mag, gx, gy, 30.0)
    return dict(img=img, gx=np.asarray(gx), gy=np.asarray(gy),
                mag=np.asarray(mag), edge=np.asarray(edge))


def test_sobel_and_downsample_exact(stage_inputs):
    img = stage_inputs["img"]
    gx, gy = tl._sobel(_t(img))
    np.testing.assert_array_equal(gx.numpy(), stage_inputs["gx"])
    np.testing.assert_array_equal(gy.numpy(), stage_inputs["gy"])
    np.testing.assert_array_equal(tl._downsample2(_t(img)).numpy(),
                                  np.asarray(jl._downsample2(jnp.asarray(img))))
    # one sqrt: equal to the last bit or next to it
    mag = torch.sqrt(gx * gx + gy * gy).numpy()
    np.testing.assert_allclose(mag, stage_inputs["mag"], rtol=2e-7)


def test_edge_maps_exact(stage_inputs):
    s = stage_inputs
    mag, gx, gy = _t(s["mag"]), _t(s["gx"]), _t(s["gy"])
    np.testing.assert_array_equal(
        tl._thin_edges(mag, gx, gy, 30.0).numpy(), s["edge"])
    ed_j = jl._ed_edges(jnp.asarray(s["mag"]), jnp.asarray(s["gx"]),
                        jnp.asarray(s["gy"]), 30.0)
    ed_t = tl._ed_edges(mag, gx, gy, 30.0).numpy()
    np.testing.assert_array_equal(ed_t, np.asarray(ed_j))
    assert ed_t.sum() > 0 and (ed_t != s["edge"]).any()


@pytest.fixture(scope="module")
def tile_fits(stage_inputs):
    s = stage_inputs
    seg_j, ok_j = jl._tile_fit(jnp.asarray(s["edge"]), jnp.asarray(s["mag"]),
                               8, 5, 4.0, gx=jnp.asarray(s["gx"]),
                               gy=jnp.asarray(s["gy"]))
    seg_t, ok_t = tl._tile_fit(_t(s["edge"]), _t(s["mag"]), 8, 5, 4.0,
                               gx=_t(s["gx"]), gy=_t(s["gy"]))
    return np.asarray(seg_j), np.asarray(ok_j), seg_t, ok_t


def test_tile_fit(tile_fits):
    """Segments within 1e-3 px where both fit; the validity gates differ
    on at most 0.5 % of tiles (anisotropy ties at its threshold)."""
    seg_j, ok_j, seg_t, ok_t = tile_fits
    ok_t = ok_t.numpy()
    assert ok_j.sum() > 50
    assert (ok_j != ok_t).mean() <= 0.005
    both = ok_j & ok_t
    np.testing.assert_allclose(seg_t.numpy()[both], seg_j[both], atol=1e-3)


def test_refine_and_merge_pairs(stage_inputs, tile_fits):
    """Given JAX's tile fits: refined endpoints within 1e-3 px; one merge
    direction's ``can`` equal and merged segments within 1e-3 px."""
    s = stage_inputs
    seg_j, ok_j, _, _ = tile_fits
    ref_j = jl._refine_endpoints(jnp.asarray(seg_j), jnp.asarray(ok_j),
                                 jnp.asarray(s["edge"]), jnp.asarray(s["mag"]), 12)
    ref_t = tl._refine_endpoints(_t(seg_j), _t(ok_j), _t(s["edge"]),
                                 _t(s["mag"]), 12)
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(ref_j), atol=1e-3)
    assert np.abs(np.asarray(ref_j) - seg_j).max() > 1.0     # it extended
    cfg_j, cfg_t = jl.LineDetectConfig(), tl.LineDetectConfig()
    nbr = np.roll(np.asarray(ref_j), (0, -1), axis=(0, 1))
    nbr_ok = np.roll(ok_j, (0, -1), axis=(0, 1))
    m_j, can_j = jl._merge_pairs(ref_j, jnp.asarray(ok_j), jnp.asarray(nbr),
                                 jnp.asarray(nbr_ok), cfg_j)
    m_t, can_t = tl._merge_pairs(_t(np.asarray(ref_j)), _t(ok_j), _t(nbr),
                                 _t(nbr_ok), cfg_t)
    np.testing.assert_array_equal(can_t.numpy(), np.asarray(can_j))
    assert can_t.sum() > 10
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=1e-3)


@pytest.fixture(scope="module")
def octave(stage_inputs):
    cfg = jl.LineDetectConfig(nfa_gate=False)
    return jl._detect_octave(jnp.asarray(stage_inputs["img"], jnp.float32), cfg)


def test_detect_octave_candidates(stage_inputs, octave):
    """One octave without the NFA gate: the candidate set, 95 % both ways."""
    got = tl._detect_octave(_t(stage_inputs["img"]).float(),
                            tl.LineDetectConfig(nfa_gate=False))
    a = np.asarray(octave.uv4)[np.asarray(octave.valid)]
    b = got.uv4.numpy()[got.valid.numpy()]
    assert len(a) > 10
    assert _match_frac(a, b) >= 0.95 and _match_frac(b, a) >= 0.95


def test_nfa_gate(stage_inputs, octave):
    """Given the same candidates: the gate's booleans are equal, except
    where the significance lies within 1e-3 of the threshold (none on this
    image), and it rejects some of them."""
    s = stage_inputs
    cfg_j, cfg_t = jl.LineDetectConfig(), tl.LineDetectConfig()
    uv4, valid = np.asarray(octave.uv4), np.asarray(octave.valid)
    g_j = np.asarray(jl._nfa_gate(jnp.asarray(uv4), jnp.asarray(valid),
                                  jnp.asarray(s["gx"]), jnp.asarray(s["gy"]), cfg_j))
    g_t = tl._nfa_gate(_t(uv4), _t(valid), _t(s["gx"]), _t(s["gy"]), cfg_t).numpy()
    best = tl._nfa_significance(_t(uv4), _t(s["gx"]), _t(s["gy"]), cfg_t)[0].numpy()
    flips = g_j != g_t
    assert np.all(np.abs(best[flips]) < 1e-3), best[flips]
    assert flips.sum() == 0
    assert 0 < g_t.sum() < valid.sum()


def test_merge_all(octave):
    """Given the same candidates: components, validity and merged
    endpoints (1e-3 px) equal."""
    uv4, valid = np.asarray(octave.uv4), np.asarray(octave.valid)
    m_j = jl._merge_all(jnp.asarray(uv4), jnp.asarray(valid), jl.LineDetectConfig())
    m_t = tl._merge_all(_t(uv4), _t(valid), tl.LineDetectConfig())
    np.testing.assert_array_equal(m_t.valid.numpy(), np.asarray(m_j.valid))
    assert 0 < m_t.valid.sum() < valid.sum()                 # it merged
    v = m_t.valid.numpy()
    np.testing.assert_allclose(m_t.uv4.numpy()[v], np.asarray(m_j.uv4)[v], atol=1e-3)
    np.testing.assert_allclose(m_t.length.numpy()[v], np.asarray(m_j.length)[v],
                               atol=1e-3)
    # the host merge is numpy in both packages: identical
    np.testing.assert_array_equal(
        tl.merge_components_np(uv4, valid), jl.merge_components_np(uv4, valid))


# ------------------------------ betainc ------------------------------------
def _gate_grid():
    """(a, b) the gate can produce: per-row counts 0..24 over 1-3 rows,
    scaled by min(1, length / 24)."""
    a, b = [], []
    for scale in (1.0, 0.75, 0.5, 0.3):
        for n in range(1, 73):
            for k in range(0, n + 1):
                a.append(max(np.float32(k) * np.float32(scale), np.float32(0.5)))
                b.append(np.float32(n - k) * np.float32(scale) + np.float32(1.0))
    return np.asarray(a, np.float32), np.asarray(b, np.float32)


def test_betainc_against_scipy_float64():
    a, b = _gate_grid()
    got = tl.betainc(_t(a.astype(np.float64)), _t(b.astype(np.float64)), 0.125)
    want = scipy.special.betainc(a.astype(np.float64), b.astype(np.float64), 0.125)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-300)
    # the other side of the swap, and the ends
    x = np.array([0.0, 1e-3, 0.3, 0.5, 0.9, 0.999, 1.0])
    aa, bb, xx = np.meshgrid([0.5, 1.0, 2.5, 30.0], [1.0, 3.5, 73.0], x)
    got = tl.betainc(_t(aa), _t(bb), _t(xx)).numpy()
    np.testing.assert_allclose(got, scipy.special.betainc(aa, bb, xx),
                               rtol=1e-9, atol=1e-14)


def test_betainc_against_jax_float32():
    """Float32, as the gate runs it: within 2e-5 relative of float64 where
    the tail is representable, and the gate's compare flips against JAX's
    float32 version in no case of the grid (a flip would need the
    significance within 1e-4 of the threshold)."""
    a, b = _gate_grid()
    got = tl.betainc(_t(a), _t(b), 0.125).numpy()
    ref = scipy.special.betainc(a.astype(np.float64), b.astype(np.float64), 0.125)
    big = ref > 1e-30
    np.testing.assert_allclose(got[big], ref[big], rtol=2e-5)
    jx = np.asarray(jax.scipy.special.betainc(jnp.asarray(a), jnp.asarray(b), 0.125))
    log_nt = 2.5 * math.log10(H * W) + math.log10(11.0) + math.log10(7.0)
    sig_t = -np.log10(np.clip(got, 1e-30, 1.0)) - log_nt
    sig_j = -np.log10(np.clip(jx, 1e-30, 1.0)) - log_nt
    flips = (sig_t > 0) != (sig_j > 0)
    assert np.all(np.abs(sig_t[flips]) < 1e-4), (a[flips], b[flips], sig_t[flips])
    assert flips.sum() == 0, (a[flips], b[flips])


# --------------------------- the LSD oracle --------------------------------
def _draw_bar(img, cx, cy, length, width, angle, amp):
    h, w = img.shape
    dx, dy = math.cos(angle), math.sin(angle)
    yy, xx = np.mgrid[0:h, 0:w]
    l = (xx - cx) * dx + (yy - cy) * dy
    t = -(xx - cx) * dy + (yy - cy) * dx
    img[(np.abs(l) < length / 2) & (np.abs(t) < width / 2)] += amp


def _scene(seed, n_bars=6):
    rng = np.random.default_rng(seed)
    img = rng.normal(110.0, 5.0, (H, W))
    img += np.linspace(0, 25, W)[None, :]
    for _ in range(n_bars):
        cx, cy = rng.uniform(60, W - 60), rng.uniform(50, H - 50)
        ang, ln, wd = rng.uniform(0, math.pi), rng.uniform(70, 150), rng.uniform(6, 14)
        _draw_bar(img, cx, cy, ln, wd, ang, rng.uniform(45, 75))
    return np.clip(img, 0, 255)


def _seg_angle(s):
    return math.atan2(s[3] - s[1], s[2] - s[0])


def _perp_dist(p, seg):
    x1, y1, x2, y2 = seg[:4]
    dx, dy = x2 - x1, y2 - y1
    n = math.hypot(dx, dy)
    if n < 1e-9:
        return math.hypot(p[0] - x1, p[1] - y1)
    return abs((p[0] - x1) * dy - (p[1] - y1) * dx) / n


def _overlap_frac(a, b):
    x1, y1, x2, y2 = b[:4]
    dx, dy = x2 - x1, y2 - y1
    n = math.hypot(dx, dy)
    if n < 1e-9:
        return 0.0
    ux, uy = dx / n, dy / n
    ta = sorted([(a[0] - x1) * ux + (a[1] - y1) * uy,
                 (a[2] - x1) * ux + (a[3] - y1) * uy])
    lo, hi = max(ta[0], 0.0), min(ta[1], n)
    return max(hi - lo, 0.0) / max(math.hypot(a[2] - a[0], a[3] - a[1]), 1e-9)


def _match(a, b, ang_tol=math.radians(10), lat_tol=3.0, min_ov=0.5):
    d = abs(_seg_angle(a) - _seg_angle(b)) % math.pi
    if min(d, math.pi - d) > ang_tol:
        return False
    if _perp_dist(((a[0] + a[2]) / 2, (a[1] + a[3]) / 2), b) > lat_tol:
        return False
    return _overlap_frac(a, b) > min_ov


def _detector_fidelity(oracle_segs, det_segs, min_len=25.0):
    """``tests/test_lsd_oracle.py``'s measure: recall of oracle lines
    (>= min_len), precision of detections, perpendicular RMS of matched
    detection endpoints."""
    o_long = [s for s in oracle_segs
              if math.hypot(s[2] - s[0], s[3] - s[1]) >= min_len]
    hits = sum(1 for o in o_long
               if any(_match(d, o, min_ov=0.3) or _match(o, d, min_ov=0.3)
                      for d in det_segs))
    good, errs = 0, []
    for d in det_segs:
        m = [o for o in oracle_segs if _match(d, o, min_ov=0.55)]
        if m:
            good += 1
            errs += [_perp_dist((d[0], d[1]), m[0]), _perp_dist((d[2], d[3]), m[0])]
    rms = float(np.sqrt(np.mean(np.square(errs)))) if errs else np.inf
    return hits / max(len(o_long), 1), good / max(len(det_segs), 1), rms


@pytest.fixture(scope="module")
def fidelity_runs():
    runs = []
    for seed in (11, 12, 13):
        img = _scene(seed)
        oracle_segs = lsd_oracle.detect_pyramid(img, n_octaves=2)[:, :4]
        det = tl.detect_lines_np(img.astype(np.float32), device="cpu")
        runs.append((img, oracle_segs, det))
    return runs


def test_oracle_copy_is_the_jax_packages(fidelity_runs):
    img, segs, _ = fidelity_runs[0]
    np.testing.assert_array_equal(
        segs, jax_oracle.detect_pyramid(img, n_octaves=2)[:, :4])


def test_fidelity_scenes_match_jax(fidelity_runs):
    """The whole detector on the three fidelity scenes: the same segment
    count as the JAX package's compiled ``detect_lines``, and each port
    segment's endpoints within 1e-3 px of its own JAX segment (a
    one-to-one pairing)."""
    for img, _, det in fidelity_runs:
        ref = np.asarray(jl.detect_lines_np(img.astype(np.float32)))
        assert len(det) == len(ref), (len(det), len(ref))
        dist = np.abs(det[:, None, :] - ref[None, :, :]).max(-1)
        pair = dist.argmin(1)
        assert len(set(pair.tolist())) == len(ref)
        assert dist[np.arange(len(det)), pair].max() <= 1e-3, dist.min(1)


def test_recall_vs_oracle(fidelity_runs):
    recalls = [_detector_fidelity(o, d)[0] for _, o, d in fidelity_runs]
    assert np.mean(recalls) >= 0.75 and min(recalls) >= 0.6, recalls


def test_precision_vs_oracle(fidelity_runs):
    precisions = [_detector_fidelity(o, d)[1] for _, o, d in fidelity_runs]
    assert np.mean(precisions) >= 0.7, precisions


def test_endpoint_error_vs_oracle(fidelity_runs):
    rms = [_detector_fidelity(o, d)[2] for _, o, d in fidelity_runs]
    assert np.mean(rms) <= 1.5, rms
