"""KITTI mode (``ChooseData: 2``) of sdpl_slam_torch against the JAX
package: twins of tests/test_kitti_mode.py, tests/test_gt_parsing.py and
tests/test_update_mask.py, each on the same inputs as the JAX function,
and the disparity-mode system on the host and the resident paths against
JAX's host run (ROADMAP North-star gates: translation within 1 % of the
per-frame motion, rotation within 0.03 deg, identical labels).

The frames are tests/synthetic.py's, with their depth written as KITTI
disparity (``raw = factor * bf / depth``, read back as ``bf / (raw /
factor)``) and their object rows as KITTI rows (camera-frame position and
yaw, lifted to the world by the GT camera pose); the port takes JAX's
RANSAC draws.  The boundary shrink is 0 as in JAX's test (the generator's
objects reach the image border), and in one case at the reference's
values.
"""

import jax
import numpy as np
import pytest
import torch

import synthetic as jsynth
from sdpl_slam_tpu.models import frame as jfr
from sdpl_slam_tpu.models import tracking as jtr
from sdpl_slam_tpu.models.system import System as JaxSystem
from sdpl_slam_torch.models import frame as tfr
from sdpl_slam_torch.models import tracking as ttr
from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.models.tracking import Tracking
from sdpl_slam_torch.utils import convert, metrics
from sdpl_slam_torch.utils import synthetic as tsynth

torch.set_num_threads(2)

N = 4            # frames tracked
BF, FACTOR = 120.0, 256.0


def jax_uniforms(self, f_id, lane, n_hyp):
    """The JAX tracker's draws (tests/test_torch_system.py)."""
    key = jax.random.PRNGKey(f_id)
    if lane > 0:
        key = jax.random.fold_in(jax.random.fold_in(key, 7), lane - 1)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n_hyp, 3))))


@pytest.fixture(autouse=True)
def _jax_draws(monkeypatch):
    monkeypatch.setattr(Tracking, "_ransac_uniforms", jax_uniforms)


def _kitti_rows(cfg, t, ids=(1,)):
    """tests/test_kitti_mode.py's rows (there for object 1 alone): the
    boxes do not rotate in the world and the camera only yaws, so the
    row's yaw is -cam_yaw - pi/2."""
    T_cw = np.linalg.inv(jsynth._cam_pose(cfg, t).astype(np.float64))
    rows = []
    for i in ids:
        L_w = jsynth._obj_pose(cfg, int(i) - 1, t).astype(np.float64)
        t_cam = T_cw[:3, :3] @ L_w[:3, 3] + T_cw[:3, 3]
        rows.append(np.array([t, i, 0, 0, 0, 0, t_cam[0], t_cam[1],
                              t_cam[2], -0.012 * t - np.pi / 2], np.float32))
    return rows


def _kitti_settings(cfg):
    s = jsynth.synth_settings(cfg)
    s.choose_data = 2
    s.depth_map_factor = FACTOR
    s.bf = BF
    s.run_local_ba = False
    s.run_global_ba = False      # keep the test fast
    s.boundary_shrink_x = 0      # synthetic objects reach the border
    s.boundary_shrink_y = 0
    s.pipelined_tracking = False
    return s


def _disparity(depth):
    with np.errstate(divide="ignore"):
        return np.where(depth > 0, FACTOR * BF / depth, 0.0).astype(
            np.float32)


def _run(system, seq, traj=None):
    for t in range(N):
        f = seq.frame(t)
        kw = {} if traj is None else dict(traj=traj)
        rows = _kitti_rows(seq.cfg, t, [r[1] for r in f.obj_rows])
        system.track_rgbd(f.gray, _disparity(f.depth), f.flow, f.mask,
                          f.gt_pose, rows, t * 0.1, N,
                          line_detections=f.lines, **kw)
    return system.map


@pytest.fixture(scope="module", params=["shrink-0", "shrink-reference"])
def kitti_runs(request):
    """The disparity-mode sequence through JAX's host path and the port's
    host and resident paths: one object and no boundary shrink, as in
    JAX's test; and two objects with the reference's shrink (25 / 50 px),
    which drops the second object at the border in every run."""
    shrink = request.param == "shrink-reference"
    cfg = jsynth.SynthConfig(n_frames=N + 1, n_objects=2 if shrink else 1)
    seq = jsynth.SynthSequence(cfg)
    js = _kitti_settings(cfg)
    if shrink:
        js.boundary_shrink_x, js.boundary_shrink_y = 25, 50
    mp = pytest.MonkeyPatch()
    mp.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
    try:
        maps = {"jax": _run(JaxSystem(js, verbose=False), seq)}
        for mode in ("host", "resident"):
            s = convert.settings_from_jax(js)
            s.resident_tracking = mode == "resident"
            maps[mode] = _run(System(s, verbose=False, device="cpu"), seq)
    finally:
        mp.undo()
    maps["cfg"] = cfg
    return maps


@pytest.mark.parametrize("mode", ["host", "resident"])
def test_kitti_disparity_depth_mode(kitti_runs, mode):
    """tests/test_kitti_mode.py::test_kitti_disparity_depth_mode on the
    port: the JAX test's GT gates, and the object survives the KITTI
    parsing path."""
    m = kitti_runs[mode]
    t_err, r_err = metrics.camera_rpe(m.camera_poses, m.camera_poses_gt)
    assert t_err < 0.02, t_err
    assert r_err < 0.2, r_err
    assert any(len(x) > 1 for x in m.rigid_motions)


@pytest.mark.parametrize("mode", ["host", "resident"])
def test_kitti_system_matches_jax(kitti_runs, mode):
    """The port's host and resident runs against JAX's host run: the
    North-star gates, identical label streams, and the GT object motions
    parsed from the KITTI rows to 1e-5."""
    mj, mt = kitti_runs["jax"], kitti_runs[mode]
    assert mj.n_frames == mt.n_frames == N
    gt = mj.camera_poses_gt
    motion = np.median([np.linalg.norm(gt[f][:3, 3] - gt[f - 1][:3, 3])
                        for f in range(1, N)])
    for f in range(1, N):
        rel = [np.linalg.inv(np.asarray(m.camera_poses[f - 1], np.float64))
               @ np.asarray(m.camera_poses[f], np.float64) for m in (mj, mt)]
        d = np.linalg.inv(rel[0]) @ rel[1]
        R = d[:3, :3]
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                            R[1, 0] - R[0, 1]])
        assert np.linalg.norm(d[:3, 3]) < 0.01 * motion, f
        assert np.degrees(np.arcsin(min(np.linalg.norm(w), 1.0))) < 0.03, f
    for name in ("rm_labels", "sm_labels", "obj_stat"):
        assert [list(x) for x in getattr(mt, name)] == \
            [list(x) for x in getattr(mj, name)], name
    assert any(len(x) > 1 for x in mt.rm_labels)
    for ra, rb in zip(mj.rigid_motions_gt, mt.rigid_motions_gt):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            np.testing.assert_allclose(y, x, atol=1e-5)
    # the GT body-frame motions of the generator's boxes
    cfg, checked = kitti_runs["cfg"], 0
    for f in range(1, N):
        for j, sem in enumerate(mt.sm_labels[f - 1][1:], 1):
            want = (np.linalg.inv(jsynth._obj_pose(cfg, sem - 1, f - 1))
                    @ jsynth._obj_pose(cfg, sem - 1, f))
            np.testing.assert_allclose(mt.rigid_motions_gt[f - 1][j], want,
                                       atol=1e-4)
            checked += 1
    assert checked >= N - 1


@pytest.mark.parametrize("mode", ["host", "resident"])
def test_traj_canvas_drawn(mode):
    """tests/test_kitti_mode.py::test_traj_canvas_drawn on the port (the
    disparity frames above): the canvas is drawn in place, and equals the
    JAX package's canvas of the same frames outside the header band."""
    cfg = jsynth.SynthConfig(n_frames=N + 1, n_objects=1)
    seq = jsynth.SynthSequence(cfg)
    js = _kitti_settings(cfg)
    canvases = {}
    for name in ("jax", "torch"):
        traj = np.full((1000, 1000, 3), 255, np.uint8)  # sdpl_slam.cc:93
        if name == "jax":
            system = JaxSystem(js, verbose=False)
        else:
            s = convert.settings_from_jax(js)
            s.resident_tracking = mode == "resident"
            system = System(s, verbose=False, device="cpu")
        _run(system, seq, traj=traj)
        canvases[name] = traj
    traj, before = canvases["torch"], np.full_like(canvases["torch"], 255)
    assert (traj != before).any(), "canvas untouched"
    red = (traj[:, :, 0] == 255) & (traj[:, :, 1] == 0) & (traj[:, :, 2] == 0)
    assert red.any(), "no camera squares drawn"
    assert (traj[35:55, 200:540] == 0).any(), "no header band"
    # equal but for the header's text, which the JAX package draws with
    # OpenCV and the port leaves out (utils/traj_canvas.py)
    outside = np.ones(traj.shape[:2], bool)
    outside[30:61, 10:551] = False
    np.testing.assert_array_equal(traj[outside], canvases["jax"][outside])


def test_preprocess_depth_modes():
    """tests/test_kitti_mode.py::test_preprocess_depth_modes: OMD divides
    by DepthMapFactor, KITTI converts disparity bf / (d / factor),
    VirtualKITTI (3) leaves the values unscaled; negatives clamp to 0.  The
    port's device and host conversions against JAX's on the same input."""
    raw = np.array([[-1.0, 0.0, 50.0, 200.0]], np.float32)
    factor, bf = 100.0, 387.5744
    for mode, expect in (
        (1, np.array([[0.0, 0.0, 0.5, 2.0]], np.float32)),
        (2, np.array([[0.0, 0.0, bf / 0.5, bf / 2.0]], np.float32)),
        (3, np.array([[0.0, 0.0, 50.0, 200.0]], np.float32)),
    ):
        dev = tfr.preprocess_depth(torch.from_numpy(raw), mode, factor,
                                   bf).numpy()
        host = ttr._np_preprocess_depth(raw, mode, factor, bf)
        np.testing.assert_allclose(dev, expect, rtol=1e-6)
        np.testing.assert_allclose(host, expect, rtol=1e-6)
        np.testing.assert_array_equal(
            dev, np.asarray(jfr.preprocess_depth(raw, mode, factor, bf)))
        np.testing.assert_array_equal(
            host, jtr._np_preprocess_depth(raw, mode, factor, bf))


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def test_kt_rotation_is_ry_yaw_plus_half_pi():
    yaw = 0.37
    row = np.array([3, 1, 10, 20, 30, 40, 1.5, -0.2, 8.0, yaw], np.float32)
    pose = ttr.obj_pose_parsing_kt(row)
    np.testing.assert_allclose(pose[:3, :3], _ry(yaw + np.pi / 2), atol=1e-6)
    np.testing.assert_allclose(pose[:3, 3], [1.5, -0.2, 8.0], atol=1e-6)
    np.testing.assert_allclose(pose[3], [0, 0, 0, 1], atol=0)
    np.testing.assert_array_equal(pose, jtr.obj_pose_parsing_kt(row))


def test_kt_zero_yaw_is_quarter_turn():
    row = np.array([0, 2, 0, 0, 0, 0, 0.0, 0.0, 5.0, 0.0], np.float32)
    R = ttr.obj_pose_parsing_kt(row)[:3, :3]
    np.testing.assert_allclose(R @ np.array([1.0, 0, 0]), [0, 0, -1],
                               atol=1e-6)
    np.testing.assert_allclose(R @ np.array([0.0, 0, 1]), [1, 0, 0],
                               atol=1e-6)
    np.testing.assert_array_equal(R, jtr.obj_pose_parsing_kt(row)[:3, :3])


def test_kt_body_frame_gt_motion_hand_computed():
    """tests/test_gt_parsing.py's chain: camera-frame rows -> world poses
    by Twc_gt -> world motion -> body-frame motion, against a hand-built
    rigid scenario; the port's parser and JAX's give the same poses."""
    Twc_p, Twc_c = np.eye(4), np.eye(4)
    Twc_c[2, 3] = 1.0
    yaw_p, yaw_c = 0.20, 0.30
    L_w_p = np.eye(4)
    L_w_p[:3, :3] = _ry(yaw_p + np.pi / 2)
    L_w_p[:3, 3] = [2.0, -0.5, 9.0]
    L_w_c = np.eye(4)
    L_w_c[:3, :3] = _ry(yaw_c + np.pi / 2)
    L_w_c[:3, 3] = [2.1, -0.5, 9.9]

    def row_from_world(L_w, Twc, yaw):
        T_cw = np.linalg.inv(Twc)
        t_cam = T_cw[:3, :3] @ L_w[:3, 3] + T_cw[:3, 3]
        return np.array([0, 1, 0, 0, 0, 0, t_cam[0], t_cam[1], t_cam[2],
                         yaw], np.float32)

    rp = row_from_world(L_w_p, Twc_p, yaw_p)
    rc = row_from_world(L_w_c, Twc_c, yaw_c)
    Lp = Twc_p @ ttr.obj_pose_parsing_kt(rp)
    Lc = Twc_c @ ttr.obj_pose_parsing_kt(rc)
    np.testing.assert_allclose(Lp, L_w_p, atol=1e-5)
    np.testing.assert_allclose(Lc, L_w_c, atol=1e-5)
    np.testing.assert_array_equal(Lp, Twc_p @ jtr.obj_pose_parsing_kt(rp))
    np.testing.assert_array_equal(Lc, Twc_c @ jtr.obj_pose_parsing_kt(rc))
    H_body = np.linalg.inv(Lp) @ (Lc @ np.linalg.inv(Lp)) @ Lp
    np.testing.assert_allclose(H_body, np.linalg.inv(L_w_p) @ L_w_c,
                               atol=1e-5)
    np.testing.assert_allclose(H_body[:3, :3], _ry(yaw_c - yaw_p), atol=1e-5)


def test_ox_axis_angle_row():
    aa = np.array([0.0, 0.25, 0.0])
    row = np.array([0, 1, 1.0, 2.0, 3.0, aa[0], aa[1], aa[2]], np.float32)
    pose = ttr.obj_pose_parsing_ox(row)
    np.testing.assert_allclose(pose[:3, :3], _ry(0.25), atol=1e-6)
    np.testing.assert_allclose(pose[:3, 3], [1.0, 2.0, 3.0], atol=1e-6)
    np.testing.assert_allclose(pose, jtr.obj_pose_parsing_ox(row), atol=1e-7)
    origin = np.asarray(jsynth._cam_pose(jsynth.SynthConfig(), 3))
    np.testing.assert_allclose(ttr.obj_pose_parsing_ox(row, origin),
                               jtr.obj_pose_parsing_ox(row, origin),
                               atol=1e-6)


def test_generator_kitti_rows():
    """``utils.synthetic.kitti_obj_rows`` (the KITTI-layout writer's rows)
    equal tests/test_kitti_mode.py's construction, and parse back through
    the tracker's chain (Twc_gt @ ObjPoseParsingKT) to the generator's
    world pose to 1e-5."""
    cfg = tsynth.SynthConfig(n_frames=4, n_objects=2)
    seq = tsynth.SynthSequence(cfg)
    jcfg = jsynth.SynthConfig(n_frames=4, n_objects=1)
    for t in range(4):
        rows = tsynth.kitti_obj_rows(cfg, t, seq.frame(t).obj_rows)
        assert [int(r[1]) for r in rows] == \
            [int(r[1]) for r in seq.frame(t).obj_rows]
        assert len(rows) == 2
        # both from float32 generator poses: 1e-6 relative at ~10 m
        np.testing.assert_allclose(rows[0], _kitti_rows(jcfg, t)[0],
                                   atol=1e-5)
        Twc = tsynth._cam_pose(cfg, t).astype(np.float64)
        for r in rows:
            L_w = Twc @ ttr.obj_pose_parsing_kt(r)
            np.testing.assert_allclose(
                L_w, tsynth._obj_pose(cfg, int(r[1]) - 1, t), atol=1e-5)


@pytest.mark.parametrize("mode", ["host", "resident"])
def test_mask_dropout_recovered(mode):
    """tests/test_update_mask.py on the port's host and resident paths:
    the instance mask of frame 2 is dropped, and UpdateMask's recovery
    keeps the object tracked; the label streams equal JAX's host run."""
    cfg = jsynth.SynthConfig(n_frames=6, n_objects=1)
    seq = jsynth.SynthSequence(cfg)
    js = jsynth.synth_settings(cfg)
    js.run_local_ba = False
    js.pipelined_tracking = False
    s = convert.settings_from_jax(js)
    s.resident_tracking = mode == "resident"
    maps = {}
    for name, system in (("jax", JaxSystem(js, verbose=False)),
                         ("torch", System(s, verbose=False, device="cpu"))):
        for t in range(5):
            f = seq.frame(t)
            mask = np.zeros_like(f.mask) if t == 2 else f.mask
            system.track_rgbd(f.gray, f.depth, f.flow, mask, f.gt_pose,
                              f.obj_rows, t * 0.1, 5,
                              line_detections=f.lines)
        maps[name] = system.map
    m = maps["torch"]
    frames_with_obj = [len(mo) > 1 for mo in m.rigid_motions]
    assert frames_with_obj[1], "frame 2 lost the object despite recovery"
    assert sum(frames_with_obj) >= 3
    for name in ("rm_labels", "sm_labels", "obj_stat"):
        assert [list(x) for x in getattr(m, name)] == \
            [list(x) for x in getattr(maps["jax"], name)], name


def _example(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / (name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def kitti_files(tmp_path_factory):
    """4 frames of the port's generator (320x96, 2 objects) written in the
    KITTI layout by examples/make_demo_sequence_torch.py."""
    cfg = tsynth.SynthConfig(n_frames=4, n_objects=2, width=320, height=96,
                             fx=180.0, fy=180.0, cx=160.0, cy=48.0)
    seq = tsynth.SynthSequence(cfg)
    root = tmp_path_factory.mktemp("kitti")
    clipped = _example("make_demo_sequence_torch").write_sequence(
        root, seq, 4, kitti=True)
    return root, seq, clipped


def test_kitti_layout_round_trip(kitti_files):
    """The writer's disparity PNGs read back (both packages' loaders, equal
    arrays) through the KITTI conversion to the generator's depth within
    the 16-bit quantisation, with the clipped pixels counted; its object
    rows are ``kitti_obj_rows``; its settings load as KITTI mode."""
    from sdpl_slam_tpu.io import dataset as jds
    from sdpl_slam_torch.io import dataset as tds
    from sdpl_slam_torch.utils.config import load_settings

    root, seq, clipped = kitti_files
    mk = _example("make_demo_sequence_torch")
    s = load_settings(root / "settings.yaml")
    assert (s.choose_data, s.depth_map_factor, s.bf) == (
        2, mk.KITTI_DEPTH_FACTOR, mk.BF)
    a, b = tds.load_sequence(root), jds.load_sequence(root)
    floor = mk.KITTI_DEPTH_FACTOR * mk.BF / 65535
    n_clip = 0
    for i in range(4):
        for x, y in zip(a.frame(i), b.frame(i)):
            np.testing.assert_array_equal(x, y)
        f = seq.frame(i)
        raw = a.frame(i)[1]
        depth = ttr._np_preprocess_depth(raw, 2, s.depth_map_factor, s.bf)
        ok = (f.depth > floor) & (f.depth > 0)
        # half a disparity step: depth^2 / (2 factor bf) relative to depth
        tol = f.depth[ok] ** 2 / (2 * s.depth_map_factor * s.bf) + 1e-4
        assert np.all(np.abs(depth[ok] - f.depth[ok]) <= tol)
        np.testing.assert_array_equal(depth[f.depth <= 0], 0)
        n_clip += int(((f.depth > 0) & (f.depth < floor)).sum())
        rows = tsynth.kitti_obj_rows(seq.cfg, i, f.obj_rows)
        np.testing.assert_allclose(np.stack(a.gt_obj_poses(i)),
                                   np.stack(rows), rtol=0, atol=1e-6)
    assert clipped == n_clip


def test_evaluate_torch_matches_evaluate(kitti_files, tmp_path, capsys):
    """examples/evaluate_torch.py prints what examples/evaluate.py prints on
    the same result files (a port run of the KITTI-layout files on the
    CPU, detectors in the loop)."""
    from sdpl_slam_torch.io.dataset import load_sequence

    root, _, _ = kitti_files
    system = System(root / "settings.yaml", verbose=False, device="cpu")
    loaded = load_sequence(root)
    for i in range(loaded.n_frames):
        gray, depth, flow, mask = loaded.frame(i)
        system.track_rgbd(gray, depth, flow, mask, loaded.gt_pose(i),
                          loaded.gt_obj_poses(i), float(loaded.timestamps[i]),
                          loaded.n_frames)
    out = tmp_path / "out"
    system.save_results(out)
    capsys.readouterr()
    ref_rows = _example("evaluate").evaluate(out)
    ref_text = capsys.readouterr().out
    got = _example("evaluate_torch").evaluate(out)
    assert capsys.readouterr().out == ref_text
    assert got["camera"] == ref_rows
    assert [r[0] for r in ref_rows] == ["initial", "refined"]
