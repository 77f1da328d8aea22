"""The port's System against the JAX System with nothing injected (FAST
and the line detector run in the loop; twin of
``tests/test_detector_in_loop.py``), with the non-joint solver (twin of
``tests/test_nonjoint_path.py``), and from a sequence on disk through
``examples/run_sequence_torch.py --cpu`` (twin of the JAX package's
test of its own sequence runner).  640x192, 6 frames, inputs from the
port's numpy generator fed to both packages; the port takes JAX's RANSAC
draws.

Gates (ROADMAP North star): per-frame mutual translation delta < 1 % of
the per-frame GT motion, mutual rotation delta < 0.03 deg, identical label
streams; plus the GT gates of the JAX tests being twinned.
"""

import importlib.util
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sdpl_slam_tpu.models.system import System as JaxSystem
from sdpl_slam_tpu.utils import config as jax_config
from sdpl_slam_torch.io import dataset
from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.models.tracking import Tracking
from sdpl_slam_torch.utils import convert, metrics, trace
from sdpl_slam_torch.utils.synthetic import (SynthConfig, SynthSequence,
                                             synth_settings)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
N = 6


def jax_uniforms(self, f_id, lane, n_hyp):
    """The JAX tracker's draws: camera = PRNGKey(f_id); object lane k =
    fold_in(fold_in(PRNGKey(f_id), 7), k)."""
    key = jax.random.PRNGKey(f_id)
    if lane > 0:
        key = jax.random.fold_in(jax.random.fold_in(key, 7), lane - 1)
    u = np.array(jax.random.uniform(key, (n_hyp, 3)))
    return torch.from_numpy(u).to(self.device)


def _jax_settings(port_settings):
    import dataclasses
    return jax_config.Settings(**dataclasses.asdict(port_settings))


def _settings(cfg, **over):
    s = synth_settings(cfg)
    s.use_sample_fea = 0          # FAST corners, not grid sampling
    s.run_local_ba = False
    s.run_global_ba = False
    for k, v in over.items():
        setattr(s, k, v)
    return s


def _run(system, seq, n, inject_lines=False):
    for t in range(n):
        f = seq.frame(t)
        system.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            t * 0.1, n, line_detections=f.lines if inject_lines else None)
    return system.map


def _pair(cfg, n, inject_lines=False, **over):
    """(JAX map, port map, port tracker) of the same frames."""
    seq = SynthSequence(cfg)
    s = _settings(cfg, **over)
    mp = pytest.MonkeyPatch()
    mp.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
    try:
        mj = _run(JaxSystem(_jax_settings(s), verbose=False), seq, n,
                  inject_lines)
        ts = System(s, verbose=False, device="cpu")
        mt = _run(ts, seq, n, inject_lines)
    finally:
        mp.undo()
    return mj, mt, ts.tracker


def _rel(m, f):
    p0 = np.asarray(m.camera_poses[f - 1], np.float64)
    p1 = np.asarray(m.camera_poses[f], np.float64)
    return np.linalg.inv(p0) @ p1


def _angle_deg(R):
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return np.degrees(np.arcsin(min(np.linalg.norm(w), 1.0)))


def _assert_camera_parity(mj, mt):
    assert mj.n_frames == mt.n_frames
    motion = np.median([np.linalg.norm(mj.camera_poses_gt[f][:3, 3]
                                       - mj.camera_poses_gt[f - 1][:3, 3])
                        for f in range(1, mj.n_frames)])
    assert motion > 0.1
    for f in range(1, mj.n_frames):
        d = np.linalg.inv(_rel(mj, f)) @ _rel(mt, f)
        assert np.linalg.norm(d[:3, 3]) < 0.01 * motion, f
        assert _angle_deg(d[:3, :3]) < 0.03, f


@pytest.fixture(scope="module")
def detector_run():
    """(JAX map, port map, the port's timed line stages: its
    ``detector.lines`` spans)."""
    with trace.enabled():
        mj, mt, _ = _pair(SynthConfig(n_frames=N, n_objects=1), N - 1)
        lines = sum(s.name == "detector.lines"
                    for s in trace.collect()["spans"])
    return mj, mt, lines


def test_detector_run_matches_jax(detector_run):
    mj, mt, _ = detector_run
    _assert_camera_parity(mj, mt)
    assert [list(x) for x in mt.rm_labels] == [list(x) for x in mj.rm_labels]
    assert [list(x) for x in mt.obj_stat] == [list(x) for x in mj.obj_stat]


def test_detected_lines_match_jax(detector_run):
    """The same static lines are selected and tracked in both packages:
    equal counts per frame and equal endpoints to 0.5 px."""
    mj, mt, n_lines = detector_run
    assert n_lines == N - 1      # ran once a frame
    for i in range(mj.n_frames):
        vj, vt = np.asarray(mj.line_valid[i]), np.asarray(mt.line_valid[i])
        assert vj.sum() == vt.sum(), i
        np.testing.assert_allclose(np.asarray(mt.line_uv[i])[vt],
                                   np.asarray(mj.line_uv[i])[vj], atol=0.5)


def test_detected_features_survive_selection(detector_run):
    _, m, _ = detector_run
    for i in range(m.n_frames):
        assert m.stat_valid[i].sum() >= 100, (i, int(m.stat_valid[i].sum()))
    assert m.line_valid[1].sum() >= 5, int(m.line_valid[1].sum())


def test_camera_accuracy_with_detectors(detector_run):
    _, m, _ = detector_run
    t_err, r_err = metrics.camera_rpe(m.camera_poses, m.camera_poses_gt)
    assert t_err < 0.01, t_err
    assert r_err < 0.05, r_err


def test_object_tracked_with_detectors(detector_run):
    _, m, _ = detector_run
    assert sum(1 for mo in m.rigid_motions if len(mo) > 1) >= 3
    t_obj, r_obj, _ = metrics.object_motion_error(
        m.rigid_motions, m.obj_pose_pre, m.rigid_motions_gt, m.obj_stat,
        m.rm_labels)
    assert t_obj < 0.05, t_obj
    assert r_obj < 0.5, r_obj


def test_prefetch_hints_change_nothing():
    """``next_image`` / ``next_image2`` are accepted and unused."""
    cfg = SynthConfig(n_frames=3, n_objects=1)
    seq = SynthSequence(cfg)

    def run(hint):
        s = System(_settings(cfg), verbose=False, device="cpu")
        for t in range(2):
            f = seq.frame(t)
            kw = dict(next_image=seq.frame(t + 1).gray,
                      next_image2=seq.frame(t + 1).gray) if hint else {}
            s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                         f.obj_rows, t * 0.1, 2, **kw)
        return s.map

    for a, b in zip(run(False).camera_poses, run(True).camera_poses):
        np.testing.assert_array_equal(a, b)


def test_edlines_mode_and_cap_run_in_loop():
    """``line_extractor = 1`` (EDLines-style) and ``lsd_nfeatures`` reach
    the detector through the settings."""
    cfg = SynthConfig(n_frames=3, n_objects=0)
    seq = SynthSequence(cfg)
    s = System(_settings(cfg, line_extractor=1, lsd_nfeatures=4),
               verbose=False, device="cpu")
    lc = s.tracker._line_cfg()
    assert (lc.mode, lc.n_features, lc.max_lines) == (1, 4, s.tracker.NL_CAND)
    m = _run(s, seq, 2)
    assert 1 <= m.line_valid[0].sum() <= 4


# ------------------------- non-joint solver -------------------------------
@pytest.fixture(scope="module")
def nonjoint_run():
    return _pair(SynthConfig(n_frames=5, n_objects=0), 4, inject_lines=True,
                 use_joint_optimization=False, use_sample_fea=1)


def test_nonjoint_matches_jax(nonjoint_run):
    mj, mt, _ = nonjoint_run
    _assert_camera_parity(mj, mt)
    for i in range(mj.n_frames):
        np.testing.assert_array_equal(mt.stat_valid[i], mj.stat_valid[i])


def test_nonjoint_camera_path_tracks(nonjoint_run):
    _, m, _ = nonjoint_run
    t_err, r_err = metrics.camera_rpe(m.camera_poses, m.camera_poses_gt)
    assert t_err < 0.02, t_err
    assert r_err < 0.2, r_err


def test_nonjoint_with_an_object():
    """The non-joint camera with the joint object chain behind it: the
    camera matches JAX's (it does not depend on the objects) and the
    object's motion is under the detector tests' gates."""
    mj, mt, _ = _pair(SynthConfig(n_frames=6, n_objects=1), 5,
                      inject_lines=True, use_joint_optimization=False,
                      use_sample_fea=1)
    _assert_camera_parity(mj, mt)
    assert sum(1 for mo in mt.rigid_motions if len(mo) > 1) >= 3
    t_obj, r_obj, _ = metrics.object_motion_error(
        mt.rigid_motions, mt.obj_pose_pre, mt.rigid_motions_gt, mt.obj_stat,
        mt.rm_labels)
    assert t_obj < 0.05, t_obj
    assert r_obj < 0.5, r_obj


# ------------------------- a sequence on disk ------------------------------
def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / (name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_sequence_from_disk(tmp_path, capsys):
    """``make_demo_sequence_torch.py`` then ``run_sequence_torch.py --cpu``:
    loader, prefetcher, ``System(settings.yaml)``, nothing injected, the 7
    result files.  Depth is stored in 1 cm steps, so the gates are those
    of the JAX package's test of its sequence runner (0.05 m / 0.3 deg)."""
    root, out = tmp_path / "demo", tmp_path / "out"
    assert _load_example("make_demo_sequence_torch").main(
        ["make_demo_sequence_torch.py", str(root), "4", "1"]) == 0
    loaded = dataset.load_sequence(root)
    assert loaded.n_frames == 4
    gray, depth, flow, mask = loaded.frame(1)
    assert gray.shape == (192, 640) and depth.shape == gray.shape
    assert flow.shape == gray.shape + (2,) and mask.max() >= 1
    assert len(loaded.gt_obj_poses(1)) >= 1
    # 4 tracked frames stay under the default window of 20: no BA fires
    assert _load_example("run_sequence_torch").main(
        ["run_sequence_torch.py", "--cpu", str(root / "settings.yaml"),
         str(root), str(out)]) == 0
    assert "Images in the sequence: 4" in capsys.readouterr().out
    for name in ("obj_mot_stereo_new.txt", "obj_mot_stereo_rf_new.txt",
                 "obj_mot_gt.txt", "obj_centre.txt", "initial_stereo_new.txt",
                 "refined_stereo_new.txt", "cam_pose_gt_stereo.txt",
                 "Metrix_error.txt", "track_distribution_static.txt"):
        assert os.path.getsize(out / name) > 0, name
    est = np.loadtxt(out / "initial_stereo_new.txt")
    gt = np.loadtxt(out / "cam_pose_gt_stereo.txt")
    assert est.shape == gt.shape and len(est) == 4

    def poses(rows):          # frame id + 16 floats, row-major 4x4
        return [r[1:17].reshape(4, 4) for r in rows]

    t_err, r_err = metrics.camera_rpe(poses(est), poses(gt))
    assert t_err < 0.05, t_err
    assert r_err < 0.3, r_err


def test_run_sequence_without_a_card_raises(tmp_path):
    """Without ``--cpu`` the example asks for the card and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load_example("run_sequence_torch").main(
            ["run_sequence_torch.py", str(ROOT / "examples" / "kitti.yaml"),
             str(tmp_path), str(tmp_path / "out")])
