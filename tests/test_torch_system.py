"""The slice as a whole: sdpl_slam_torch's System against sdpl_slam_tpu's
on two synthetic sequences of 6 frames -- the generator's defaults
(640x192, 1 moving object) and the bench's KITTI scale (1242x375, 2 moving
objects, 0.2 px flow noise, reference caps) -- with FAST in the loop
(``use_sample_fea = 0``), injected lines, no batch BA and no pipelining;
the 640x192 sequence also with grid-sampled points instead of FAST.  The port takes JAX's RANSAC draws (``_ransac_uniforms`` is
overridden), so both run the same algorithm on the same numbers up to f32
rounding.

Gates (ROADMAP North star): per-frame mutual translation delta < 1 % of
the per-frame GT motion, mutual rotation delta < 0.03 deg, identical
label streams, both under the bench's GT gates (t < 5 mm, r < 0.1 deg),
and the 7 result files alike.  Rotation deltas are measured from the
antisymmetric part of the relative rotation in float64: the trace-acos
formula reads float32 rounding of a rotation matrix as ~0.02 deg.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from sdpl_slam_tpu.models.system import System as JaxSystem
from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.models.tracking import Tracking
from sdpl_slam_torch.utils import convert, metrics
from sdpl_slam_torch.utils import synthetic as port_synth
from synthetic import SynthConfig, SynthSequence, synth_settings

torch.set_num_threads(2)

N = 6
SNAP = 4          # JAX state after frames 0..SNAP-1 is carried into the port


def jax_uniforms(self, f_id, lane, n_hyp):
    """The JAX tracker's draws: camera = PRNGKey(f_id); object lane k =
    fold_in(fold_in(PRNGKey(f_id), 7), k)."""
    key = jax.random.PRNGKey(f_id)
    if lane > 0:
        key = jax.random.fold_in(jax.random.fold_in(key, 7), lane - 1)
    u = np.array(jax.random.uniform(key, (n_hyp, 3)))
    return torch.from_numpy(u).to(self.device)


def _settings(cfg):
    s = synth_settings(cfg)
    s.use_sample_fea = 0
    s.run_local_ba = False
    s.run_global_ba = False
    s.pipelined_tracking = False
    return s


def _track(system, seq, frames):
    for t in frames:
        f = seq.frame(t)
        system.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                          f.obj_rows, t * 0.1, N, line_detections=f.lines)


def _kitti_settings(cfg):
    """The bench's caps (bench.py:130-144) on the slice."""
    s = _settings(cfg)
    s.max_track_point_bg, s.max_track_point_obj = 1200, 800
    s.max_static_lines, s.max_objects = 400, 8
    s.th_depth_bg, s.th_depth_obj = 40.0, 25.0
    s.min_object_points = 150
    return s


def _grid_settings(cfg):
    """The generator's own settings: grid-sampled background points
    (``use_sample_fea = 1``), which bypasses FAST."""
    s = _settings(cfg)
    s.use_sample_fea = 1
    return s


CONFIGS = {
    "640x192": lambda: (SynthConfig(n_frames=N), _settings),
    "640x192-grid": lambda: (SynthConfig(n_frames=N), _grid_settings),
    "kitti": lambda: (SynthConfig(
        n_frames=N, n_objects=2, width=1242, height=375, fx=721.5377,
        fy=721.5377, cx=609.5593, cy=172.854, noise_flow=0.2),
        _kitti_settings),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
    cfg, make_settings = CONFIGS[request.param]()
    seq = SynthSequence(cfg)
    settings = make_settings(cfg)

    js = JaxSystem(settings, verbose=False)
    _track(js, seq, range(SNAP))
    snap = copy.deepcopy(convert.jax_tracker_state(js))
    _track(js, seq, range(SNAP, N))

    ts = System(convert.settings_from_jax(settings), verbose=False,
                device="cpu")
    _track(ts, seq, range(N))

    resumed = System(convert.settings_from_jax(settings), verbose=False,
                     device="cpu")
    convert.tracker_state_from_jax(resumed.tracker, snap)
    f = seq.frame(SNAP)
    resumed_pose = resumed.track_rgbd(
        f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows, SNAP * 0.1,
        N, line_detections=f.lines)

    dirs = {}
    for name, s in (("jax", js), ("torch", ts)):
        d = tmp_path_factory.mktemp(name)
        s.save_results(d)
        dirs[name] = d
    mp.undo()
    return dict(jax=js.map, torch=ts.map, dirs=dirs, resumed=resumed,
                resumed_pose=resumed_pose)


def _rel(m, f):
    p0 = np.asarray(m.camera_poses[f - 1], np.float64)
    p1 = np.asarray(m.camera_poses[f], np.float64)
    return np.linalg.inv(p0) @ p1


def _angle_deg(R):
    """Rotation angle of a near-identity rotation, from its antisymmetric
    part (accurate where trace-acos is not)."""
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return np.degrees(np.arcsin(min(np.linalg.norm(w), 1.0)))


def _gt_motion(m):
    return np.median([np.linalg.norm(m.camera_poses_gt[f][:3, 3]
                                     - m.camera_poses_gt[f - 1][:3, 3])
                      for f in range(1, len(m.camera_poses_gt))])


def test_camera_matches_jax_per_frame(runs):
    mj, mt = runs["jax"], runs["torch"]
    assert mj.n_frames == mt.n_frames == N
    motion = _gt_motion(mj)
    assert motion > 0.1
    for f in range(1, N):
        d = np.linalg.inv(_rel(mj, f)) @ _rel(mt, f)
        assert np.linalg.norm(d[:3, 3]) < 0.01 * motion, f
        assert _angle_deg(d[:3, :3]) < 0.03, f


def test_label_streams_identical(runs):
    mj, mt = runs["jax"], runs["torch"]
    assert len(mt.rm_labels) == len(mj.rm_labels) == N - 1
    assert [list(x) for x in mt.rm_labels] == [list(x) for x in mj.rm_labels]
    assert [list(x) for x in mt.obj_stat] == [list(x) for x in mj.obj_stat]
    assert any(len(x) > 1 for x in mt.rm_labels)        # an object tracked


def test_object_motions_match_jax(runs):
    mj, mt = runs["jax"], runs["torch"]
    for f in range(len(mj.rigid_motions)):
        for j in range(1, len(mj.rigid_motions[f])):
            a = np.asarray(mj.rigid_motions[f][j], np.float64)
            b = np.asarray(mt.rigid_motions[f][j], np.float64)
            d = np.linalg.inv(a) @ b
            assert np.linalg.norm(d[:3, 3]) < 0.01 * np.linalg.norm(a[:3, 3]) + 1e-4
            assert _angle_deg(d[:3, :3]) < 0.03


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_gt_gates(runs, which):
    m = runs[which]
    t_err, r_err = metrics.camera_rpe(m.camera_poses, m.camera_poses_gt)
    assert t_err < 0.005 and r_err < 0.1, (t_err, r_err)


RESULT_FILES = (
    "obj_mot_stereo_new.txt", "obj_mot_stereo_rf_new.txt", "obj_mot_gt.txt",
    "obj_centre.txt", "initial_stereo_new.txt", "refined_stereo_new.txt",
    "cam_pose_gt_stereo.txt",
)


def test_result_files_alike(runs):
    dj, dt = runs["dirs"]["jax"], runs["dirs"]["torch"]
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))
    for name in RESULT_FILES:
        lj = (dj / name).read_text().splitlines()
        lt = (dt / name).read_text().splitlines()
        assert len(lt) == len(lj) > 0, name
        for rj, rt in zip(lj, lt):
            tj, tt = rj.split(), rt.split()
            assert len(tt) == len(tj), (name, rj, rt)
            # integer columns (frame id, label) must agree exactly
            assert [x for x in tt if "." not in x] == \
                   [x for x in tj if "." not in x], (name, rj, rt)
            assert [len(x.partition(".")[2]) for x in tt] == \
                   [len(x.partition(".")[2]) for x in tj], (name, rj, rt)
            np.testing.assert_allclose(np.float64(tt), np.float64(tj),
                                       atol=1e-3, err_msg=name)


def test_state_carried_from_jax(runs):
    """JAX frames 0..3 -> convert -> the port takes frame 4 from the same
    state and lands where JAX did."""
    mj, mr = runs["jax"], runs["resumed"].map
    pose_jax = np.linalg.inv(np.asarray(mj.camera_poses[SNAP], np.float64))
    np.testing.assert_allclose(runs["resumed_pose"], pose_jax, atol=1e-4)
    assert list(mr.rm_labels[-1]) == list(mj.rm_labels[SNAP - 1])
    assert mr.n_frames == SNAP + 1
    assert runs["resumed"].tracker.f_id == SNAP + 1


def test_numpy_generator_matches_test_generator(monkeypatch):
    """The port's generator renders the same arrays as tests/synthetic.py.
    Both render in float64 from the float32 camera poses of ``se3_exp``;
    the two frameworks round that one call differently (next test), so
    here both sides take the same poses and must agree to 1e-6.  The grey
    image's strokes are drawn in numpy here and with ``cv2.line`` there:
    outside either stroke the images are equal, and the strokes are held
    by overlap (at least 95 % of the port's stroke pixels lie inside
    OpenCV's wider one, measured 98 %; intersection over union at least
    0.6, measured 0.70)."""
    import cv2
    import synthetic as test_synth

    monkeypatch.setattr(port_synth, "_cam_pose", test_synth._cam_pose)
    kw = dict(n_frames=3, n_objects=2, width=320, height=96, fx=180.0,
              fy=180.0, cx=160.0, cy=48.0, noise_flow=0.2)
    a = SynthSequence(SynthConfig(**kw))
    b = port_synth.SynthSequence(port_synth.SynthConfig(**kw))
    for t in range(3):
        fa, fb = a.frame(t), b.frame(t)
        ours = np.zeros_like(fb.gray)
        port_synth.draw_strokes(ours, fb.lines, 1)
        theirs = np.zeros_like(fa.gray)
        for sx, sy, ex, ey in fa.lines:
            cv2.line(theirs, (int(sx), int(sy)), (int(ex), int(ey)), 1, 2)
        either = (ours | theirs).astype(bool)
        assert ours.sum() > 300
        np.testing.assert_array_equal(fb.gray[~either], fa.gray[~either])
        assert np.all(fb.gray[ours > 0] == 20)
        assert (ours & theirs).sum() >= 0.95 * ours.sum()
        assert (ours & theirs).sum() >= 0.6 * either.sum()
        np.testing.assert_array_equal(fb.mask, fa.mask)
        for k in ("depth", "flow", "gt_pose", "lines"):
            np.testing.assert_allclose(getattr(fb, k), getattr(fa, k),
                                       atol=1e-6, rtol=1e-6, err_msg=k)
        assert len(fb.obj_rows) == len(fa.obj_rows) == 2
        for ra, rb in zip(fa.obj_rows, fb.obj_rows):
            np.testing.assert_allclose(rb, ra, atol=1e-6)


def test_generator_camera_poses_match():
    """The one framework call in the generator: float32 se3_exp in torch
    against JAX, a few ulps apart (f32 sin/cos differ)."""
    import synthetic as test_synth

    cfg = SynthConfig()
    for t in range(60):
        np.testing.assert_allclose(port_synth._cam_pose(cfg, t),
                                   test_synth._cam_pose(cfg, t), atol=1e-5)


def test_settings_round_trip():
    s = _settings(SynthConfig())
    p = convert.settings_from_jax(s)
    import dataclasses
    assert dataclasses.asdict(p) == dataclasses.asdict(s)
