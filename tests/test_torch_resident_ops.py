"""The resident loop's building blocks against the JAX package's: the
device half of ``models/frame.py`` (also against the port's numpy
``frame_host`` on the valid rows), the helpers of ``models/resident.py``
and its dense stage (mask recovery, inheritance, the renewal filters),
on inputs made from a seeded numpy generator.

Integer and boolean outputs must match exactly, floats within 1e-5
(float32).  The tie cases of ``_first_k``, ``_sorted_unique``,
``_rank_within_sem`` and ``_majority_nonzero_is_bg`` are built in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpl_slam_tpu.models import frame as jfr
from sdpl_slam_tpu.models import resident as jres
from sdpl_slam_tpu.ops.geometry import Intrinsics as JaxK
from sdpl_slam_torch.models import frame as fr
from sdpl_slam_torch.models import frame_host as fh
from sdpl_slam_torch.models import resident as res
from sdpl_slam_torch.ops.geometry import Intrinsics
from sdpl_slam_torch.utils import convert
from sdpl_slam_torch.utils.config import Settings

torch.set_num_threads(2)
H, W = 48, 64
ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _same(ours, theirs, what=""):
    """Exact for integer/bool arrays, 1e-5 for floats."""
    a = ours.cpu().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    b = np.asarray(theirs)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=what)


def _planes(seed=0):
    """depth with zeros, negatives and far values; flow with zero and
    fractional components; a mask of label blocks."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 60.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = 0.0
    depth[rng.random((H, W)) < 0.05] = -1.0
    depth[40:, :] = 12.0              # flat background for static lines
    depth[11:29, 6:24] = rng.uniform(5.0, 25.0, (18, 18))   # object 1
    flow = rng.normal(0, 3, (H, W, 2)).astype(np.float32)
    flow[rng.random((H, W)) < 0.1] = 0.0
    flow[5:9, 40:60] = np.round(flow[5:9, 40:60])
    mask = np.zeros((H, W), np.int32)
    mask[10:30, 5:25] = 1
    mask[20:40, 30:50] = 2
    mask[2:8, 50:60] = 3
    return depth, flow, mask


def _points(rng, n):
    uv = rng.uniform(-3, W + 3, (n, 2)).astype(np.float32)
    uv[:, 1] = rng.uniform(-3, H + 3, n)
    uv[: n // 4] = np.round(uv[: n // 4])          # integral positions
    return uv


def _lines(rng, n):
    uv4 = np.concatenate([_points(rng, n), _points(rng, n)], 1)
    uv4[:3, 2:] = uv4[:3, :2]                      # degenerate segments
    short = rng.uniform(-4, 4, (n // 3, 2)).astype(np.float32)
    uv4[3:3 + n // 3, 2:] = uv4[3:3 + n // 3, :2] + short
    return uv4


# ---------------------------------------------------------------------------
# models/frame.py
# ---------------------------------------------------------------------------

def test_lookup_nearest_and_stride_grid():
    depth, _, mask = _planes()
    uv = _points(np.random.default_rng(1), 200)
    for img in (depth, mask):
        v, inb = fr.lookup_nearest(_t(img), _t(uv))
        jv, jinb = jfr.lookup_nearest(jnp.asarray(img), jnp.asarray(uv))
        _same(v, jv, "value")
        _same(inb, jinb, "inb")
        v2, inb2 = res._lookup(_t(img), _t(uv))
        jv2, jinb2 = jres._lookup(jnp.asarray(img), jnp.asarray(uv))
        _same(v2, jv2, "_lookup")
        _same(inb2, jinb2, "_lookup inb")
    for step in (4, 3):
        _same(fr.stride_grid_uv(H, W, step, device="cpu"),
              jfr.stride_grid_uv(H, W, step), "grid")


@pytest.mark.parametrize("cap", [5, 37, 60])
def test_compact_by_mask(cap):
    rng = np.random.default_rng(cap)
    keep = rng.random(60) < 0.4
    a = rng.normal(size=(60, 2)).astype(np.float32)
    b = rng.integers(0, 9, 60).astype(np.int32)
    (oa, ob), valid, order = fr.compact_by_mask((_t(a), _t(b)), _t(keep), cap)
    (ja, jb), jvalid, jorder = jfr.compact_by_mask(
        (jnp.asarray(a), jnp.asarray(b)), jnp.asarray(keep), cap)
    _same(oa, ja)
    _same(ob, jb)
    _same(valid, jvalid)
    _same(order, np.asarray(jorder).astype(np.int64))


def _host_valid_rows(ours, host, valid):
    v = valid.numpy()
    hv = np.asarray(host[-1])
    np.testing.assert_array_equal(v, hv)
    for o, h in zip(ours[:-1], host[:-1]):
        o = o.numpy()[v]
        h = np.asarray(h)[hv]
        if o.dtype.kind in "biu":
            np.testing.assert_array_equal(o, h)
        else:
            np.testing.assert_allclose(o, h, atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_selections(seed):
    depth, flow, mask = _planes(seed)
    rng = np.random.default_rng(10 + seed)
    cand = _points(rng, 300)
    cand_v = rng.random(300) < 0.9
    lc = _lines(rng, 90)
    lc[40:60] = np.array([9, 13, 20, 26], np.float32) + rng.uniform(
        -2, 2, (20, 4)).astype(np.float32)       # both ends on label 1
    lc[60:80] = np.array([5, 42, 40, 46], np.float32) + rng.uniform(
        -3, 3, (20, 4)).astype(np.float32)       # on the flat background
    lv = rng.random(90) < 0.9
    T = lambda a: _t(a)
    J = jnp.asarray
    cases = [
        ("static points", fr.select_static_points, jfr.select_static_points,
         fh.select_static_points, (cand, cand_v), 50.0, 120),
        ("static lines", fr.select_static_lines, jfr.select_static_lines,
         fh.select_static_lines, (lc, lv), 50.0, 40),
        ("object lines", fr.select_object_lines, jfr.select_object_lines,
         fh.select_object_lines, (lc, lv), 30.0, 40),
    ]
    for what, ours_fn, jax_fn, host_fn, cands, th, cap in cases:
        ours = ours_fn(*map(T, cands), T(depth), T(flow), T(mask), th, cap)
        theirs = jax_fn(*map(J, cands), J(depth), J(flow), J(mask), th, cap)
        for i, (o, j) in enumerate(zip(ours, theirs)):
            _same(o, j, "%s[%d]" % (what, i))
        assert int(ours[-1].sum()) > 3, what
        host = host_fn(*cands, np.maximum(depth, 0), flow, mask, th, cap)
        # the host takes preprocessed (non-negative) depth
        ours_pp = ours_fn(*map(T, cands), T(np.maximum(depth, 0)), T(flow),
                          T(mask), th, cap)
        _host_valid_rows(ours_pp, host, ours_pp[-1])
    ours = fr.select_object_points(T(depth), T(flow), T(mask), 30.0, 150)
    theirs = jfr.select_object_points(J(depth), J(flow), J(mask), 30.0, 150)
    for i, (o, j) in enumerate(zip(ours, theirs)):
        _same(o, j, "object points[%d]" % i)
    host = fh.select_object_points(np.maximum(depth, 0), flow, mask, 30.0, 150)
    ours_pp = fr.select_object_points(T(np.maximum(depth, 0)), T(flow),
                                      T(mask), 30.0, 150)
    _host_valid_rows(ours_pp, host, ours_pp[-1])


@pytest.mark.parametrize("choose_data", [1, 2, 3])
def test_preprocess_depth_and_world_lines(choose_data):
    depth, _, _ = _planes(3)
    _same(fr.preprocess_depth(_t(depth), choose_data, 256.0, 387.57),
          jfr.preprocess_depth(jnp.asarray(depth), choose_data, 256.0,
                               387.57))
    rng = np.random.default_rng(4)
    uv4 = _lines(rng, 30)
    d2 = rng.uniform(1, 30, (30, 2)).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.3, -0.1, 1.2]
    T[:3, :3] = np.array([[0.99, -0.141, 0], [0.141, 0.99, 0], [0, 0, 1]],
                         np.float32)
    K = (360.0, 360.0, 32.0, 24.0)
    _same(fr.world_lines(Intrinsics(*K), _t(T), _t(uv4), _t(d2)),
          jfr.world_lines(JaxK(*map(jnp.float32, K)), jnp.asarray(T),
                          jnp.asarray(uv4), jnp.asarray(d2)))


# ---------------------------------------------------------------------------
# models/resident.py helpers
# ---------------------------------------------------------------------------

def _tie_masks(rng, n=80):
    return [np.zeros(n, bool), np.ones(n, bool), rng.random(n) < 0.3,
            np.arange(n) % 7 == 0]


@pytest.mark.parametrize("k", [1, 10, 80, 100])
def test_first_k(k):
    rng = np.random.default_rng(k)
    order = res._strided_order(80, 10, torch.device("cpu"))
    _same(order, jres._strided_order(80, 10).astype(np.int64), "order")
    for m in _tie_masks(rng):
        idx, v = res._first_k(_t(m), k)
        jidx, jv = jres._first_k(jnp.asarray(m), k)
        _same(idx, np.asarray(jidx).astype(np.int64))
        _same(v, jv)
        idx, v = res._first_k(_t(m), k, order=order)
        jidx, jv = jres._first_k(jnp.asarray(m), k,
                                 order=jres._strided_order(80, 10))
        _same(idx, np.asarray(jidx).astype(np.int64))
        _same(v, jv)
    # lanes: one call over a leading dim = one call per lane
    ms = np.stack(_tie_masks(rng))
    idx, v = res._first_k(_t(ms), k)
    for i, m in enumerate(ms):
        jidx, jv = jres._first_k(jnp.asarray(m), k)
        _same(idx[i], np.asarray(jidx).astype(np.int64))
        _same(v[i], jv)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sorted_unique_mode_rank(seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 5, 60).astype(np.int32)     # many ties
    vals[:10] = 3
    for valid in (rng.random(60) < 0.5, np.zeros(60, bool),
                  np.ones(60, bool)):
        for cap in (2, 8):
            u, ok = res._sorted_unique(_t(vals), _t(valid), cap)
            ju, jok = jres._sorted_unique(jnp.asarray(vals),
                                          jnp.asarray(valid), cap)
            _same(ok, jok)
            _same(u, ju)
        is_bg, any_v = res._majority_nonzero_is_bg(_t(vals), _t(valid))
        jbg, jany = jres._majority_nonzero_is_bg(jnp.asarray(vals),
                                                 jnp.asarray(valid))
        _same(is_bg, jbg)
        _same(any_v, jany)
        mode, any_v = res._masked_mode(_t(vals), _t(valid))
        jmode, jany = jres._masked_mode(jnp.asarray(vals), jnp.asarray(valid))
        _same(mode, jmode)
        _same(any_v, jany)
        rank = res._rank_within_sem(_t(vals), _t(valid), 60)
        _same(rank, np.asarray(jres._rank_within_sem(
            jnp.asarray(vals), jnp.asarray(valid), 60)).astype(np.int64))
    # ties of counts: 0 and 2 twice each -> the smaller (0) wins
    tie = np.array([2, 0, 2, 0, 7], np.int32)
    valid = np.array([1, 1, 1, 1, 1], bool)
    is_bg, _ = res._majority_nonzero_is_bg(_t(tie), _t(valid))
    jbg, _ = jres._majority_nonzero_is_bg(jnp.asarray(tie),
                                          jnp.asarray(valid))
    assert bool(is_bg) and bool(jbg)
    # lanes
    lanes = np.stack([vals, np.roll(vals, 3), np.zeros(60, np.int32)])
    lvalid = rng.random((3, 60)) < 0.6
    mode, anyv = res._masked_mode(_t(lanes), _t(lvalid))
    for i in range(3):
        jm, ja = jres._masked_mode(jnp.asarray(lanes[i]),
                                   jnp.asarray(lvalid[i]))
        _same(mode[i], jm)
        _same(anyv[i], ja)


def test_occupancy_and_line_dups():
    rng = np.random.default_rng(5)
    kept = _points(rng, 40)
    kv = rng.random(40) < 0.7
    cand = _points(rng, 100)
    cand[:20] = kept[:20] + rng.uniform(-1.5, 1.5, (20, 2))
    occ = res._scatter_occupancy(H, W, _t(kept), _t(kv))
    jocc = np.array(jres._scatter_occupancy(H, W, jnp.asarray(kept),
                                              jnp.asarray(kv)))
    ours = occ[:-1].reshape(H + 2, W + 2).numpy()
    # JAX parks invalid rows on the corner cell, never read
    jocc[H + 1, W + 1] = ours[H + 1, W + 1]
    np.testing.assert_array_equal(ours, jocc)
    _same(res._near_occupied(occ, _t(cand), H, W),
          jres._near_occupied(jnp.asarray(jres._scatter_occupancy(
              H, W, jnp.asarray(kept), jnp.asarray(kv))), jnp.asarray(cand),
              H, W))
    kl = _lines(rng, 30)
    cl = np.concatenate([kl[:15] + rng.uniform(-0.6, 0.6, (15, 4)),
                         _lines(rng, 25)]).astype(np.float32)
    klv = rng.random(30) < 0.8
    _same(res._line_dup(_t(cl), _t(kl), _t(klv)),
          jres._line_dup(jnp.asarray(cl), jnp.asarray(kl), jnp.asarray(klv)))
    _same(res._obj_line_dup(_t(cl), _t(kl), _t(klv)),
          jres._obj_line_dup(jnp.asarray(cl), jnp.asarray(kl),
                             jnp.asarray(klv)))
    # lanes of kept sets
    kls = np.stack([kl, np.roll(kl, 5, 0)])
    klvs = np.stack([klv, ~klv])
    dup = res._obj_line_dup(_t(cl), _t(kls), _t(klvs))
    for i in range(2):
        _same(dup[i], jres._obj_line_dup(jnp.asarray(cl), jnp.asarray(kls[i]),
                                         jnp.asarray(klvs[i])))


@pytest.mark.parametrize("kept_n,top_n", [(0, 5), (7, 3), (12, 9), (4, 0)])
def test_merge_keep_topup(kept_n, top_n):
    rng = np.random.default_rng(kept_n)
    cap = 12
    kept = (rng.normal(size=(cap, 2)).astype(np.float32),
            rng.integers(0, 50, cap).astype(np.int32))
    top = (rng.normal(size=(cap, 2)).astype(np.float32),
           rng.integers(0, 50, cap).astype(np.int32))
    (a, b), v = res._merge_keep_topup(
        tuple(map(_t, kept)), torch.tensor(kept_n), tuple(map(_t, top)),
        torch.tensor(top_n), cap)
    (ja, jb), jv = jres._merge_keep_topup(
        tuple(map(jnp.asarray, kept)), kept_n, tuple(map(jnp.asarray, top)),
        top_n, cap)
    _same(a, ja)
    _same(b, jb)
    _same(v, jv)
    assert res._bdims(_t(np.ones(3, bool)), 3).shape == \
        jres._bdims(jnp.ones(3, bool), 3).shape


# ---------------------------------------------------------------------------
# dense stage
# ---------------------------------------------------------------------------

def _state(seed=0, maxo=3, p=80, ns=40, nls=12, l_obj=5):
    """A ResidentState of the port with structured content: label 1's
    object points (120) lie in a block the current mask has lost (its
    recovery triggers), label 2's (110) where the mask keeps it, label 3
    has 10; and its JAX twin through the converter."""
    rng = np.random.default_rng(seed)
    no, nlo = maxo * p, maxo * l_obj
    last_mask = np.zeros((H, W), np.int32)
    last_mask[10:30, 5:25] = 1
    last_mask[20:40, 30:50] = 2
    last_mask[2:8, 50:60] = 3
    o_c = np.zeros((no, 2), np.float32)
    o_sem = np.zeros(no, np.int32)
    o_c[:120] = np.stack([rng.uniform(6, 24, 120), rng.uniform(11, 29, 120)], 1)
    o_sem[:120] = 1
    o_c[120:230] = np.stack([rng.uniform(31, 49, 110),
                             rng.uniform(21, 39, 110)], 1)
    o_sem[120:230] = 2
    o_c[230:] = np.stack([rng.uniform(51, 59, no - 230),
                          rng.uniform(3, 7, no - 230)], 1)
    o_sem[230:] = 3
    o_valid = rng.random(no) < 0.97
    f32 = lambda *s: rng.uniform(1, W - 2, s).astype(np.float32)
    st = res.ResidentState(
        pose=torch.eye(4), velocity=torch.eye(4),
        s_uv=_t(f32(ns, 2)), s_d=_t(f32(ns)), s_f=_t(f32(ns, 2) / 20),
        s_c=_t(_points(rng, ns)), s_valid=_t(rng.random(ns) < 0.8),
        l_uv=_t(_lines(rng, nls)), l_d=_t(f32(nls, 2)),
        l_f=_t(f32(nls, 4) / 20), l_c=_t(_lines(rng, nls)),
        l_valid=_t(rng.random(nls) < 0.8),
        o_uv=_t(o_c - 1.0), o_d=_t(f32(no)), o_f=_t(f32(no, 2) / 20),
        o_c=_t(o_c), o_sem=_t(o_sem),
        o_label=_t(rng.integers(-2, 4, no).astype(np.int32)),
        o_valid=_t(o_valid),
        ol_uv=_t(_lines(rng, nlo)), ol_d=_t(f32(nlo, 2)),
        ol_f=_t(f32(nlo, 4) / 20), ol_c=_t(_lines(rng, nlo)),
        ol_sem=_t(rng.integers(0, 4, nlo).astype(np.int32)),
        ol_label=_t(rng.integers(-2, 4, nlo).astype(np.int32)),
        ol_valid=_t(rng.random(nlo) < 0.8),
        meta_sem=_t(np.array([1, 2, 0], np.int32)),
        meta_label=_t(np.array([2, 3, -1], np.int32)),
        meta_stat=_t(np.array([True, True, False])),
        meta_motion=torch.eye(4).repeat(maxo, 1, 1), meta_n=torch.tensor(2,
                                                                    dtype=torch.int32),
        max_id=torch.tensor(4, dtype=torch.int32), last_mask=_t(last_mask),
        last_flow=_t(rng.uniform(-2.5, 2.5, (H, W, 2)).astype(np.float32)),
        s_asso=torch.arange(ns, dtype=torch.int32),
        s_cand=torch.full((ns,), -1, dtype=torch.int32),
        l_asso=torch.arange(nls, dtype=torch.int32),
        l_cand=torch.full((nls,), -1, dtype=torch.int32),
        o_asso=torch.arange(no, dtype=torch.int32),
        o_cand=torch.full((no,), -1, dtype=torch.int32),
        ol_asso=torch.arange(nlo, dtype=torch.int32),
        ol_cand=torch.full((nlo,), -1, dtype=torch.int32),
    )
    return st, convert.resident_state_to_jax(st, jres.ResidentState)


def test_state_converts_both_ways():
    st, jst = _state()
    back = convert.resident_state_from_jax(jst, "cpu")
    for name in res.ResidentState._fields:
        a, b = getattr(st, name), getattr(back, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert set(jres.ResidentState._fields) == set(res.ResidentState._fields)


def test_update_mask_dev():
    st, jst = _state()
    mask = np.zeros((H, W), np.int32)
    mask[20:40, 30:50] = 2            # label 1 lost, label 2 kept
    mask[0:3, 0:3] = 5
    ours = res.update_mask_dev(_t(mask), st, 3)
    theirs = jres.update_mask_dev(jnp.asarray(mask), jst, 3)
    _same(ours, theirs)
    assert int((ours == 1).sum()) > 100         # label 1 recovered
    assert int((ours == 3).sum()) == 0          # too few samples


def test_inherit_filters_and_dense_inputs():
    st, jst = _state(1)
    depth, flow, mask = _planes(1)
    depth = np.maximum(depth, 0)
    J, T = jnp.asarray, _t
    for i, (o, j) in enumerate(zip(
            res.inherit_dev(st, T(depth), T(mask), 30.0),
            jres.inherit_dev(jst, J(depth), J(mask), 30.0))):
        _same(o, j, "inherit[%d]" % i)
    _same(res.line_track_filter_dev(st.l_uv, st.l_valid, T(depth), T(mask)),
          jres.line_track_filter_dev(J(jst.l_uv), J(jst.l_valid), J(depth),
                                     J(mask)))
    cfg = Settings()
    cfg.th_depth_obj = 30.0
    (inh, ok0) = res.dense_stage_inputs(cfg, st, T(depth), T(mask))
    (jinh, jok0) = jres.dense_stage_inputs(cfg, None, jst, J(depth), J(flow),
                                           J(mask))
    _same(ok0, jok0)
    for o, j in zip(inh, jinh):
        _same(o, j)
    rng = np.random.default_rng(7)
    uv, uv4 = _points(rng, 150), _lines(rng, 60)
    f, jf = (res.DenseFilts(T(depth), T(flow), T(mask), 30.0),
             jres.DenseFilts(J(depth), J(flow), J(mask), 30.0))
    for name, arg in (("stat_state", uv), ("line_state", uv4),
                      ("obj_state", uv), ("stat_cand", uv),
                      ("line_cand", uv4), ("obj_cand", uv),
                      ("oline_cand_ok", uv4), ("flow4", uv4)):
        o, j = getattr(f, name)(T(arg)), getattr(jf, name)(J(arg))
        for a, b in zip(o if isinstance(o, tuple) else (o,),
                        j if isinstance(j, tuple) else (j,)):
            _same(a, b, name)
    assert int(res._filt_point(T(uv), T(depth), T(flow), T(mask))[0].sum()) > 5
    assert int(res._obj_filt(T(uv), T(depth), T(flow), T(mask),
                             30.0)[0].sum()) > 5


# ---------------------------------------------------------------------------
# one resident step, the port's against JAX's, from one state
# ---------------------------------------------------------------------------

# tests/test_resident.py's keys and tolerances
INT_KEYS = ["stat_valid", "line_valid", "obj_sem", "obj_label", "obj_valid",
            "oline_sem", "oline_label", "oline_valid"]
FLOAT_KEYS = ["pose", "stat_uv", "stat_depth", "stat_flow", "stat_corres",
              "line_uv", "line_depth", "line_flow", "line_corres",
              "obj_uv", "obj_depth", "obj_flow", "obj_corres",
              "oline_uv", "oline_depth", "oline_flow", "oline_corres"]


def _jax_settings(cfg):
    from synthetic import synth_settings

    s = synth_settings(cfg)
    s.pipelined_tracking = False
    return s


def _caps(tr):
    return dict(NS=tr.NS, NLS=tr.NLS, NO=tr.NO, NLO=tr.NLO, P=tr.P_OBJ,
                L=tr.L_OBJ, MAXO=tr.MAXO, GCAP=2 * tr.MAXO)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's jitted resident step, compiled once: both sequences share the
    generator's settings and so one program."""
    from synthetic import SynthConfig
    from sdpl_slam_tpu.models.tracking import Tracking as JaxTracking

    tr = JaxTracking(_jax_settings(SynthConfig()))
    return jres.jit_resident_step(tr.cfg, tr.K, _caps(tr))


def _jax_draws(t, n_cam, n_obj, maxo):
    key = jax.random.PRNGKey(t)
    u_cam = np.array(jax.random.uniform(key, (n_cam, 3)))
    u_obj = np.stack([np.array(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, 7), k), (n_obj, 3)))
        for k in range(maxo)])
    return torch.from_numpy(u_cam), torch.from_numpy(u_obj)


@pytest.mark.parametrize("n_objects,noise", [(1, 0.0), (2, 0.2)])
def test_step_matches_jax(jax_step, n_objects, noise):
    """Frames 1-3 of a synthetic sequence: each step starts both packages
    from the same state (JAX's, converted), with JAX's draws; the new
    states and the packed map rows must agree field by field."""
    from synthetic import SynthConfig, SynthSequence
    from sdpl_slam_torch.models.system import System

    cfg = SynthConfig(n_frames=5, n_objects=n_objects, noise_flow=noise)
    seq = SynthSequence(cfg)
    settings = convert.settings_from_jax(_jax_settings(cfg))
    sysP = System(settings, verbose=False, device="cpu")
    f0 = seq.frame(0)
    sysP.track_rgbd(f0.gray, f0.depth, f0.flow, f0.mask, f0.gt_pose,
                    f0.obj_rows, 0.0, 4, line_detections=f0.lines)
    tr = sysP.tracker
    caps = _caps(tr)
    jstate = jres.state_from_host(tr.last, tr.last_meta, tr.max_id,
                                  tr.velocity, tr.last_mask_np,
                                  tr.last_flow_np, tr.MAXO)
    step = res.build_resident_step(settings, tr.K, caps)
    n_cam, n_obj = res.n_hypotheses(settings)
    cand = fr.grid_sample_uv(cfg.height, cfg.width, n_points=tr.N_CAND,
                             device="cpu")
    _same(cand, jfr.grid_sample_uv(cfg.height, cfg.width,
                                   n_points=tr.N_CAND), "grid")
    cand_v = np.ones(tr.N_CAND, bool)
    prev_rows = f0.obj_rows
    for t in range(1, 4):
        f = seq.frame(t)
        lc = np.zeros((tr.NL_CAND, 4), np.float32)
        lv = np.zeros(tr.NL_CAND, bool)
        lc[:len(f.lines)] = f.lines[:tr.NL_CAND]
        lv[:len(f.lines)] = True
        planes = (np.asarray(f.depth, np.float32),
                  np.ascontiguousarray(f.flow, np.float32),
                  np.asarray(f.mask, np.int32))
        gts = (jres.gt_sem_table(prev_rows), jres.gt_sem_table(f.obj_rows))
        pstate = convert.resident_state_from_jax(jstate, "cpu")
        new_j, out_j = jax_step(jstate, *planes, np.asarray(cand), cand_v,
                                lc, lv, *gts, jax.random.PRNGKey(t))
        new_p, out_p, syncs = step(
            pstate, *map(_t, planes), cand, _t(cand_v), _t(lc), _t(lv),
            *map(_t, gts), *_jax_draws(t, n_cam, n_obj, tr.MAXO))
        assert syncs >= 2                      # camera + object LM exits
        for name in res.ResidentState._fields:
            a = getattr(new_p, name)
            b = np.asarray(getattr(new_j, name))
            if a.dtype.is_floating_point:
                np.testing.assert_allclose(a.numpy(), b, atol=5e-3, rtol=1e-4,
                                           err_msg="frame %d %s" % (t, name))
            else:
                _same(a, b, "frame %d %s" % (t, name))
        lastP, metaP, idP = res.state_to_host(new_p)
        lastJ, metaJ, idJ = jres.state_to_host(new_j)
        for k in INT_KEYS:
            np.testing.assert_array_equal(lastP[k], lastJ[k])
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(lastP[k], lastJ[k], atol=5e-3,
                                       rtol=1e-4)
        assert idP == idJ and metaP["mod_label"] == metaJ["mod_label"]
        assert metaP["sem_position"] == metaJ["sem_position"]
        assert metaP["obj_stat"] == metaJ["obj_stat"]
        op = res.unpack_out(out_p.numpy(), caps)
        oj = jres.unpack_out(np.array(out_j), caps)
        for name, _, kind in res.out_spec(caps):
            if kind == "f":
                np.testing.assert_allclose(op[name], oj[name], atol=5e-3,
                                           rtol=1e-4, err_msg=name)
            else:
                np.testing.assert_array_equal(op[name], oj[name], name)
        jstate, prev_rows = new_j, f.obj_rows
    assert idJ > 1 and any(metaJ["obj_stat"])   # an object was tracked
