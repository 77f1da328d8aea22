"""sdpl_slam_torch.solvers.ba_builder: the graph against the JAX package's,
and the BA entry points on maps the JAX package tracked (the 640x192
synthetic sequence, 7 frames, as in tests/test_batch_ba.py) -- twins of
tests/test_batch_ba.py and tests/test_ba_golden.py.

The golden fixture's exact fixed point is held here on what the
matrix-free CG step determines: cameras, camera odometry, static points and
the static line.  Its motions and dynamic structure (three ternary chains
under near-L1 Huber costs) need the exact dense-Schur step, which JAX's
golden test asks for (``ba_schur``); tests/test_torch_schur_ba.py holds the
port's Schur path to them.  JAX's own CG path (``ba_schur = False``) stops
as far from them: the tests show that, and hold the port's CG motions and
dynamic structure against that path's.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_ba_golden as golden_fixture
from sdpl_slam_tpu.models.system import System as JaxSystem
from sdpl_slam_tpu.solvers import ba_builder as jbb
from sdpl_slam_torch.ops.geometry import Intrinsics
from sdpl_slam_torch.solvers import ba_builder as tbb
from sdpl_slam_torch.utils import metrics
from sdpl_slam_torch.utils.config import Settings
from sdpl_slam_torch.utils.convert import settings_from_jax
from synthetic import SynthConfig, SynthSequence, synth_settings

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tracked():
    """(JAX System after 7 frames, the port's Settings, the port's K)."""
    cfg = SynthConfig(n_frames=8, n_objects=1)
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    settings.run_local_ba = False
    sys = JaxSystem(settings, verbose=False)
    for t in range(7):
        f = seq.frame(t)
        sys.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
                       t * 0.1, 7, line_detections=f.lines)
    sys.tracker.flush()
    port_cfg = settings_from_jax(settings)
    return sys, port_cfg, Intrinsics.from_config(port_cfg)


def _valid_prefix(jax_graph, field):
    """Length of the valid prefix of ``field`` in JAX's padded graph."""
    owner = {"cam": "cam", "prior": None, "odo": "odo", "mot": "mot",
             "smo": "smo", "Xs": "Xs", "sp": "sp", "Ls": "Ls", "sl": "sl",
             "Xd": "Xd", "dp": "dp", "tern": "tern", "Ld": "Ld", "dl": "dl",
             "ltern": "ltern"}
    for prefix in sorted(owner, key=len, reverse=True):
        if field.startswith(prefix):
            if owner[prefix] is None:
                return None
            return int(np.asarray(getattr(jax_graph, owner[prefix]
                                          + "_valid")).sum())
    raise KeyError(field)


@pytest.mark.parametrize("kind", ["full", "window"])
def test_build_graph_matches_jax_prefix(tracked, kind):
    """Every array of the port's graph (exact counts) equals the valid
    prefix of JAX's padded one, bit for bit; the write-back maps too."""
    sys, cfg, K = tracked
    m = sys.map
    f0 = 0 if kind == "full" else m.n_frames - 5
    kw = (dict(motion_init_identity=True, prior_info=1e5) if kind == "full"
          else dict(motion_init_identity=False, prior_info=1e7))
    jg, jmeta = jbb.build_graph(m, sys.tracker.K, f0, m.n_frames, **kw)
    tg, tmeta = tbb.build_graph(m, K, f0, m.n_frames, device="cpu", **kw)
    for field in tg._fields:
        ref, got = np.asarray(getattr(jg, field)), getattr(tg, field)
        n = _valid_prefix(jg, field)
        if n is None:
            np.testing.assert_array_equal(np.asarray(got), ref, field)
            continue
        assert got.shape[0] == n, field
        np.testing.assert_array_equal(got.numpy(), ref[:n], field)
    assert tg.sl_cam.numel() > 0 and tg.ltern_prev.numel() > 0
    for key in ("sp_map", "sl_map", "dp_map", "dl_map"):
        for a, b in zip(tmeta[key], jmeta[key]):
            np.testing.assert_array_equal(a, b, key)
    assert tmeta["mot_keys"] == jmeta["mot_keys"]


K_GOLDEN = Intrinsics(golden_fixture.FX, golden_fixture.FY,
                      golden_fixture.CX, golden_fixture.CY)


GOLDEN_ITERATIONS = 40


def _golden_dynamic(m):
    """Object motions, dynamic points and (normalised) dynamic lines."""
    return dict(
        motions=np.stack([m.rigid_motions_rf[f - 1][1] for f in (1, 2)]),
        dyn_3d=np.stack(m.dyn_3d),
        dline=np.stack([golden_fixture._plucker_normed(m.dline_plucker[f][0])
                        for f in range(3)]))


@pytest.fixture(scope="module")
def golden_jax_cg():
    """JAX's ``full_batch_optimization`` on the golden map with the CG step
    (``ba_schur = False``), float64, at the port's iteration budget."""
    from sdpl_slam_tpu.ops.geometry import Intrinsics as JaxIntrinsics
    from sdpl_slam_tpu.utils.config import Settings as JaxSettings

    m, gt = golden_fixture.golden.__wrapped__()
    cfg = JaxSettings()
    cfg.ba_dtype = "float64"
    cfg.ba_gain_threshold = 1e-12
    cfg.ba_global_iterations = GOLDEN_ITERATIONS
    cfg.ba_schur = False
    K = JaxIntrinsics(*(jnp.float32(v) for v in (
        golden_fixture.FX, golden_fixture.FY, golden_fixture.CX,
        golden_fixture.CY)))
    jbb.full_batch_optimization(m, K, cfg=cfg, use_lines=True)
    return _golden_dynamic(m), gt


def test_golden_cg_path_leaves_motions_off(golden_jax_cg):
    """JAX's CG path lands its cameras on the fixed point but not the
    motions and dynamic points: past the 0.05 that JAX's Schur path meets
    in float32 (tests/test_ba_golden.py)."""
    ref, gt = golden_jax_cg
    assert np.abs(ref["motions"] - gt["H"]).max() > 0.05
    assert np.abs(ref["dyn_3d"] - np.stack(gt["Xd"])).max() > 0.05


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-5), ("float32", 1e-3)])
def test_golden_fixed_point(golden_jax_cg, dtype, tol):
    """tests/test_ba_golden.py through ``full_batch_optimization`` (the CG
    step): float64 lands on the constructed optimum to 1e-5, float32 to
    1e-3 (JAX's f32 tolerance); points and lines to 5e-5 in float64.
    Motions, dynamic points and dynamic lines against JAX's CG path:
    float64 to 1e-6, float32 to JAX's float32 tolerance on them, 0.05."""
    m, gt = golden_fixture.golden.__wrapped__()
    cfg = Settings()
    cfg.ba_dtype = dtype
    cfg.ba_gain_threshold = 1e-12
    cfg.ba_global_iterations = GOLDEN_ITERATIONS
    cost = tbb.full_batch_optimization(m, K_GOLDEN, cfg=cfg, device="cpu")
    assert np.isfinite(cost)
    for f in range(3):
        np.testing.assert_allclose(m.camera_poses_rf[f], gt["cams"][f],
                                   atol=tol, err_msg="camera %d" % f)
        assert m.camera_poses_rf[f].dtype == np.float32
    for f in range(1, 3):
        want = np.linalg.inv(gt["cams"][f - 1]) @ gt["cams"][f]
        np.testing.assert_allclose(m.rigid_motions_rf[f - 1][0], want,
                                   atol=tol)
    stol = 5 * tol if dtype == "float64" else tol
    want = golden_fixture._plucker_normed(golden_fixture._plucker(*gt["line"]))
    for f in range(3):
        np.testing.assert_allclose(m.stat_3d[f], gt["Xs"], atol=stol)
        got = golden_fixture._plucker_normed(m.line_plucker[f][0])
        np.testing.assert_allclose(got, want, atol=stol)
    ref, _ = golden_jax_cg
    got = _golden_dynamic(m)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-6 if dtype == "float64" else 0.05,
                                   err_msg=k)


SCHUR_ITERATIONS = 10


@pytest.fixture(scope="module")
def schur_run(tracked):
    """The port's full BA by the dense-Schur step on the tracked map, float32,
    ``SCHUR_ITERATIONS`` LM iterations: (map, cost, Schur LM iterations)."""
    from sdpl_slam_torch.solvers import schur_ba as tsb

    sys, cfg, K = tracked
    cfg = copy.deepcopy(cfg)
    cfg.ba_schur = True
    cfg.ba_global_iterations = SCHUR_ITERATIONS
    m = copy.deepcopy(sys.map)
    before = tsb.run_ba_schur.iterations
    cost = tbb.full_batch_optimization(m, K, cfg, device="cpu")
    return m, cost, tsb.run_ba_schur.iterations - before


def test_schur_step_refused(tracked, schur_run):
    """``ba_schur = True`` was refused until the dense-Schur step was
    ported (ROADMAP A12); now the full BA takes it on the tracked map (7
    frames, 30 dof a frame and motion, far under ``MAX_DENSE_DOF``), and
    lands at a cost no higher than the CG step's at the same LM cap (JAX's
    criterion, tests/test_schur_ba.py: within 1.05x), without degrading the
    trajectory."""
    sys, cfg, K = tracked
    m, cost, iterations = schur_run
    assert iterations > 0
    cfg = copy.deepcopy(cfg)
    cfg.ba_schur = False
    cfg.ba_global_iterations = SCHUR_ITERATIONS
    c_cg = tbb.full_batch_optimization(copy.deepcopy(sys.map), K, cfg,
                                       device="cpu")
    assert np.isfinite(cost) and cost <= 1.05 * c_cg + 1e-9, (cost, c_cg)
    t0, _ = metrics.camera_rpe(sys.map.camera_poses, m.camera_poses_gt)
    t1, _ = metrics.camera_rpe(m.camera_poses_rf, m.camera_poses_gt)
    assert t1 < max(2.5 * t0, 0.01), (t0, t1)


def _jax_schur_run(sys, dtype="float32", iterations=SCHUR_ITERATIONS,
                   gain=None):
    jcfg = copy.deepcopy(sys.settings)
    jcfg.ba_schur = True
    jcfg.ba_global_iterations = iterations
    jcfg.ba_dtype = dtype
    if gain is not None:
        jcfg.ba_gain_threshold = gain
    jm = copy.deepcopy(sys.map)
    return jm, float(jbb.full_batch_optimization(jm, sys.tracker.K, jcfg))


def _gaps(m, jm):
    """Largest differences of the refined cameras, camera motions and
    object motions of two maps."""
    out = [np.abs(np.stack(m.camera_poses_rf)
                  - np.stack(jm.camera_poses_rf)).max()]
    for k in (0, 1):
        got, want = (np.stack([row[k] for row in mm.rigid_motions_rf])
                     for mm in (m, jm))
        out.append(np.abs(got - want).max())
    return out


# The float32 Schur run to convergence: at the gain rule 1e-12 the LM runs
# to this cap (see test_schur_run_matches_jax)
CONVERGED_ITERATIONS = 80


def test_schur_run_matches_jax(tracked):
    """The port's float32 Schur run against the JAX package's float64 run
    on the same map, both taken to convergence (gain 1e-12, 80 LM
    iterations): cost within rtol 1e-4; refined cameras and camera motions
    within 1e-5 (tests/test_torch_schur_ba.py's bound on them); object
    motions within 2.5e-4.  Measured 2.8e-5, 5.2e-7, 2.4e-7, 1.8e-6 (the
    port's float32 run against JAX's float32 one: 1.6e-5, 2.4e-7, 2.4e-7,
    8.9e-7).

    Float32 runs stopped short of convergence are no yardstick on this
    map: their first four steps are rejected, and from the first accepted
    one the two packages' float32 paths part by rounding that depends on
    the CPU (XLA's code for AVX-512 or AVX2 moves the tracked map itself).
    At 10 LM iterations the two float32 runs were 1.2e-4 apart in cost
    (AVX-512) or 4.5e-5 (XLA held to AVX2), their object motions 1.1e-3 or
    4.9e-4; unconverged at 10 iterations, the port's run sits 0.11, 2.2e-4,
    1.3e-4 and 4.3e-4 from the converged float64 one, past every bound."""
    sys, cfg, K = tracked
    cfg = copy.deepcopy(cfg)
    cfg.ba_schur = True
    cfg.ba_global_iterations = CONVERGED_ITERATIONS
    cfg.ba_gain_threshold = 1e-12
    m = copy.deepcopy(sys.map)
    cost = tbb.full_batch_optimization(m, K, cfg, device="cpu")
    jm, jcost = _jax_schur_run(sys, "float64", CONVERGED_ITERATIONS, 1e-12)
    assert abs(cost - jcost) <= 1e-4 * abs(jcost), (cost, jcost)
    cam, cam_mot, obj_mot = _gaps(m, jm)
    assert cam < 1e-5 and cam_mot < 1e-5, (cam, cam_mot)
    assert obj_mot < 2.5e-4, obj_mot


def test_schur_run_float64_matches_jax(tracked):
    """With ``ba_dtype = "float64"`` the two packages' Schur runs take the
    same LM path: cameras, camera motions and object motions within 1e-9
    (measured 2.9e-18, 0, 0); the cost within rtol 1e-4, the float32
    test's bound (measured 6.5e-6 with equal starting costs: the dynamic
    lines, which 10 LM steps do not determine, part by 3.5e-4 in their
    Pluecker coordinates, as _refined notes below).  Float32 runs of either
    package part from these by up to 1.5e-3 in the object motions after
    10 iterations, so the float32 test above reads against JAX's float32
    run."""
    sys, cfg, K = tracked
    cfg = copy.deepcopy(cfg)
    cfg.ba_schur = True
    cfg.ba_global_iterations = SCHUR_ITERATIONS
    cfg.ba_dtype = "float64"
    m = copy.deepcopy(sys.map)
    cost = tbb.full_batch_optimization(m, K, cfg, device="cpu")
    jm, jcost = _jax_schur_run(sys, "float64")
    assert max(_gaps(m, jm)) < 1e-9, _gaps(m, jm)
    assert abs(cost - jcost) <= 1e-4 * abs(jcost), (cost, jcost)


def _short_cfg(dtype="float32"):
    cfg = Settings(width=320, height=96)
    cfg.ba_global_iterations = 20
    cfg.ba_dtype = dtype
    return cfg


@pytest.fixture(scope="module")
def f32_run(tracked):
    sys, _, K = tracked
    m = copy.deepcopy(sys.map)
    cost = tbb.full_batch_optimization(m, K, _short_cfg(), device="cpu")
    return m, cost


def test_full_ba_float64_escape_hatch(tracked, f32_run):
    """ba_dtype "float64": the solve runs in double, writes back f32, and
    lands no meaningfully farther from GT than the f32 run (the absolute
    slack of tests/test_batch_ba.py)."""
    sys, _, K = tracked
    m32, _ = f32_run
    m64 = copy.deepcopy(sys.map)
    tbb.full_batch_optimization(m64, K, _short_cfg("float64"), device="cpu")
    t32, _ = metrics.camera_rpe(m32.camera_poses_rf, m32.camera_poses_gt)
    t64, _ = metrics.camera_rpe(m64.camera_poses_rf, m64.camera_poses_gt)
    assert np.isfinite(t64)
    assert t64 <= t32 * 1.5 + 2e-3, (t32, t64)
    assert m64.camera_poses_rf[0].dtype == np.float32


def _refined(m):
    """Refined motions, and the valid rows of the static and dynamic points
    and of the (normalised) static Pluecker lines of a map, one array each.
    The dynamic lines are left out: 20 LM steps do not determine them (on
    the tracked map JAX's own f32 and mixed runs part by 1.66 in their
    normalised coordinates)."""
    def rows(values, valid, norm=False):
        out = np.concatenate([np.asarray(v)[np.asarray(ok, bool)]
                              for v, ok in zip(values, valid)])
        if not norm:
            return out
        return np.stack([golden_fixture._plucker_normed(r) for r in out])

    return dict(
        motions=np.stack([x for row in m.rigid_motions_rf for x in row]),
        stat_3d=rows(m.stat_3d, m.stat_valid),
        dyn_3d=rows(m.dyn_3d, m.dyn_valid),
        line_plucker=rows(m.line_plucker, m.line_valid, True))


def test_full_ba_mixed_precision(tracked, f32_run):
    """ba_dtype "mixed": f32 storage and HVP, f64 CG recurrences and dots.
    The port's mixed run against the JAX package's runs on the same map:
    its cost within 1.02x of JAX's mixed run's, its motions, points and
    static lines within the f32 parity tolerance (0.05) of JAX's float64 run,
    the solution both mixed runs approximate.  (Under this suite's XLA
    flags JAX's own f32 and mixed runs part from its float64 run from the
    first LM step on, by 0.0394 in a weakly determined object motion after
    20 steps; the port's mixed run stays 0.0207 from it.)  The GT bound of
    tests/test_batch_ba.py against the port's f32 run, and the f32
    write-back."""
    from sdpl_slam_tpu.utils.config import Settings as JaxSettings

    sys, _, K = tracked
    m32, _ = f32_run
    ref = {}
    for dtype in ("mixed", "float64"):
        jcfg = JaxSettings(width=320, height=96)
        jcfg.ba_global_iterations = 20
        jcfg.ba_dtype = dtype
        m = copy.deepcopy(sys.map)
        ref[dtype] = (m, float(jbb.full_batch_optimization(
            m, sys.tracker.K, jcfg)))
    mmx = copy.deepcopy(sys.map)
    cmx = tbb.full_batch_optimization(mmx, K, _short_cfg("mixed"),
                                      device="cpu")
    t32, _ = metrics.camera_rpe(m32.camera_poses_rf, m32.camera_poses_gt)
    tmx, _ = metrics.camera_rpe(mmx.camera_poses_rf, mmx.camera_poses_gt)
    assert np.isfinite(tmx)
    cjx = ref["mixed"][1]
    assert cmx <= cjx * 1.02 + 1e-9, (cjx, cmx)
    want, got = _refined(ref["float64"][0]), _refined(mmx)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=0.05,
                                   err_msg=k)
    assert tmx <= max(3.0 * t32, 2e-3), (t32, tmx)
    assert mmx.camera_poses_rf[0].dtype == np.float32


def test_tree_dot_f64_reduction():
    """The mixed mode's inner products accumulate in f64: 2^24 + 1 is exact
    in f64 and rounds the +1 away in f32."""
    from sdpl_slam_torch.solvers import batch_ba as tba

    a = torch.tensor([16777216.0, 1.0])
    ones = torch.ones(2)
    assert float(tba._tree_dot(a, ones)) == 16777216.0
    assert float(tba._tree_dot(a, ones, torch.float64)) == 16777217.0


def test_full_ba_does_not_degrade_and_refines_structure(tracked, f32_run):
    """The refined trajectory stays within a small factor of the accurate
    front end; refined motions are finite; refined points and Pluecker
    lines are written into the map (Optimizer.cc:5658-5736)."""
    sys, _, _ = tracked
    m0 = sys.map
    m, _ = f32_run
    t0, r0 = metrics.camera_rpe(m0.camera_poses, m0.camera_poses_gt)
    t1, r1 = metrics.camera_rpe(m.camera_poses_rf, m.camera_poses_gt)
    assert t1 < max(2.5 * t0, 0.01), (t0, t1)
    assert r1 < max(2.5 * r0, 0.05), (r0, r1)
    for Ts in m.rigid_motions_rf:
        for T in Ts:
            assert np.all(np.isfinite(T))
    assert any(not np.allclose(a, b) for a, b in zip(m.stat_3d, m0.stat_3d))
    assert any(not np.allclose(a, b)
               for a, b in zip(m.line_plucker, m0.line_plucker))
    for a in m.stat_3d + m.line_plucker:
        assert np.all(np.isfinite(a))


def test_full_ba_improves_corrupted_trajectory(tracked):
    sys, _, K = tracked
    m = copy.deepcopy(sys.map)
    rng = np.random.default_rng(3)
    for i in range(2, m.n_frames):
        d = np.eye(4, dtype=np.float32)
        d[:3, 3] = rng.normal(0, 0.05, 3)
        m.camera_poses[i] = (m.camera_poses[i] @ d).astype(np.float32)
    t0, _ = metrics.camera_rpe(m.camera_poses, m.camera_poses_gt)
    tbb.full_batch_optimization(m, K, _short_cfg(), device="cpu")
    t1, _ = metrics.camera_rpe(m.camera_poses_rf, m.camera_poses_gt)
    assert t1 < t0 * 0.8, (t0, t1)


def test_partial_ba_runs_and_writes_back(tracked):
    sys, cfg, K = tracked
    m = copy.deepcopy(sys.map)
    before = [p.copy() for p in m.camera_poses]
    cost = tbb.partial_batch_optimization(m, K, window=5, cfg=cfg,
                                          device="cpu")
    assert np.isfinite(cost)
    f0 = m.n_frames - 5
    # the first window pose is pinned by the strong prior
    np.testing.assert_allclose(m.camera_poses[f0], before[f0], atol=1e-3)
    t1, _ = metrics.camera_rpe(m.camera_poses, m.camera_poses_gt)
    assert t1 < 0.02, t1
    for i in range(f0, m.n_frames):
        np.testing.assert_array_equal(m.camera_poses_rf[i], m.camera_poses[i])


def test_partial_ba_writes_back_refined_structure(tracked):
    """Corrupted static points that enter the window graph move back
    toward their values, and an overlapping window linearizes from the
    refined values (Optimizer.cc:1123-1143)."""
    sys, cfg, K = tracked
    m = copy.deepcopy(sys.map)
    rng = np.random.default_rng(7)
    f0 = m.n_frames - 5
    corrupted = {}
    for i in range(f0, m.n_frames):
        sel = np.nonzero(m.stat_valid[i])[0][:50]
        corrupted[i] = (sel, m.stat_3d[i][sel].copy())
        m.stat_3d[i][sel] += rng.normal(0, 0.5, (len(sel), 3)).astype(
            np.float32)
    bad = {i: m.stat_3d[i][sel].copy() for i, (sel, _) in corrupted.items()}
    _, meta0 = tbb.build_graph(m, K, f0, m.n_frames,
                               motion_init_identity=False, device="cpu")
    cams0, slots0, _ = meta0["sp_map"]
    in_graph = {(f0 + int(c), int(s)) for c, s in zip(cams0, slots0)}

    tbb.partial_batch_optimization(m, K, window=5, cfg=cfg, device="cpu")
    moved = improved = 0
    for i, (sel, truth) in corrupted.items():
        err_now = np.linalg.norm(m.stat_3d[i][sel] - truth, axis=1)
        err_bad = np.linalg.norm(bad[i] - truth, axis=1)
        for j, s in enumerate(sel):
            if (i, int(s)) in in_graph:
                moved += 1
                improved += err_now[j] < 0.5 * err_bad[j]
    assert moved > 0
    assert improved > 0.5 * moved, (improved, moved)

    graph2, meta2 = tbb.build_graph(m, K, m.n_frames - 6, m.n_frames,
                                    motion_init_identity=False, device="cpu")
    cams, slots, vids = meta2["sp_map"]
    Xs0 = graph2.Xs0.numpy()
    checked = fresh = 0
    for k in range(len(cams)):
        f_abs = m.n_frames - 6 + int(cams[k])
        if f_abs not in corrupted or (f_abs, int(slots[k])) not in in_graph:
            continue
        sel = list(corrupted[f_abs][0])
        if int(slots[k]) in sel:
            checked += 1
            fresh += not np.allclose(Xs0[vids[k]],
                                     bad[f_abs][sel.index(int(slots[k]))],
                                     atol=1e-4)
    assert checked > 0
    assert fresh > 0.5 * checked, (fresh, checked)
