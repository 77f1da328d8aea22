"""The port's pipelined host path (``pipelined_tracking``, the default):
twins of tests/test_pipelined_equivalence.py on the CPU, and the port's
pipelined run against the JAX package's on the same frames.

The pipeline only moves when a frame's pull, renewal and map push run
(into the start of the next call); every input the finish consumes is in
the in-flight dict, so the final map equals the synchronous one bit for
bit.  Against the JAX package: the ROADMAP's North-star gates (identical
label streams, per-frame translation delta < 1 % of the per-frame GT
motion, rotation delta < 0.03 deg), with JAX's RANSAC draws.
"""

import jax
import numpy as np
import pytest
import torch

from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.models.tracking import Tracking
from sdpl_slam_torch.utils.synthetic import (SynthConfig, SynthSequence,
                                             synth_settings)

torch.set_num_threads(2)


def _run(pipelined, detectors_in_loop, hints=True, n_frames=6, system=None):
    cfg = SynthConfig(n_frames=n_frames, n_objects=1)
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    settings.pipelined_tracking = pipelined
    if detectors_in_loop:
        settings.use_sample_fea = 0
    sys_ = (System(settings, verbose=False, device="cpu") if system is None
            else system(settings))
    n = seq.n_frames - 1
    for t in range(n):
        f = seq.frame(t)
        nxt = seq.frame(t + 1) if hints and t + 1 < n else None
        sys_.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            float(t) * 0.1, n,
            line_detections=None if detectors_in_loop else f.lines,
            next_image=None if nxt is None else nxt.gray)
    return sys_


def _assert_maps_equal(a, b):
    """tests/test_pipelined_equivalence.py's comparison, over every row the
    map holds."""
    flat = ("camera_poses", "camera_poses_rf", "camera_poses_gt", "stat_uv",
            "stat_3d", "stat_valid", "stat_asso", "line_uv", "line_valid",
            "line_plucker", "dyn_uv", "dyn_3d", "dyn_label", "dline_uv",
            "dline_label")
    for name in flat:
        va, vb = getattr(a, name), getattr(b, name)
        assert len(va) == len(vb), name
        for i, (x, y) in enumerate(zip(va, vb)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f"{name}[{i}]")
    nested = ("rigid_motions", "rm_labels", "obj_stat", "speeds_gt",
              "rigid_centres")
    for name in nested:
        va, vb = getattr(a, name), getattr(b, name)
        assert len(va) == len(vb), name
        for i, (ra, rb) in enumerate(zip(va, vb)):
            assert len(ra) == len(rb), f"{name}[{i}]"
            for j, (x, y) in enumerate(zip(ra, rb)):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                              err_msg=f"{name}[{i}][{j}]")


def test_pipelined_equals_synchronous_injected():
    sync, pipe = _run(False, False), _run(True, False)
    _assert_maps_equal(sync.map, pipe.map)
    assert sync.map.n_frames == 5


def test_pipelined_equals_synchronous_detectors_in_loop():
    """FAST and the line detector in the loop; the pipelined run takes
    frames 1-4's detections from the previous call's predispatch."""
    sync, pipe = _run(False, True), _run(True, True)
    _assert_maps_equal(sync.map, pipe.map)
    assert len(sync.tracker.line_detect_ms) == 5
    assert len(pipe.tracker.line_detect_ms) == 1          # frame 0 alone
    assert len(pipe.tracker.predispatch_ms) == 4


def test_pipelined_returns_previous_pose_and_finishes_last_frame():
    """A pipelined call returns the previous frame's pose and leaves its
    own frame in flight; the last frame finishes in its call."""
    cfg = SynthConfig(n_frames=5, n_objects=1)
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    sys_ = System(settings, verbose=False, device="cpu")
    n, poses = seq.n_frames - 1, []
    for t in range(n):
        f = seq.frame(t)
        poses.append(sys_.track_rgbd(f.gray, f.depth, f.flow, f.mask,
                                     f.gt_pose, f.obj_rows, t * 0.1, n,
                                     line_detections=f.lines))
        in_flight = sys_.tracker._inflight is not None
        assert in_flight == (0 < t < n - 1), t
    m = sys_.tracker.map
    assert m.n_frames == n
    want = [np.linalg.inv(p) for p in m.camera_poses]      # T_cw a frame
    for t in range(1, n - 1):
        np.testing.assert_allclose(poses[t], want[t - 1], atol=1e-5)
        assert np.abs(poses[t] - want[t]).max() > 1e-3, t
    np.testing.assert_allclose(poses[-1], want[-1], atol=1e-5)


def test_mid_sequence_map_access_flushes():
    """Reading .map mid-sequence finishes the frame in flight."""
    cfg = SynthConfig(n_frames=5, n_objects=1)
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    assert settings.pipelined_tracking is True
    sys_ = System(settings, verbose=False, device="cpu")
    n = seq.n_frames - 1
    for t in range(n):
        f = seq.frame(t)
        sys_.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                        f.obj_rows, float(t) * 0.1, n,
                        line_detections=f.lines)
        assert sys_.map.n_frames == t + 1
        assert sys_.tracker._inflight is None


def test_next_image_predispatch_gives_the_same_map():
    """``next_image`` hints dispatch frame t+1's detectors during frame t;
    the map is the one without hints, and each frame's detectors run
    once."""
    hinted = _run(True, True, hints=True)
    plain = _run(True, True, hints=False)
    _assert_maps_equal(plain.map, hinted.map)
    assert len(plain.tracker.line_detect_ms) == 5
    assert len(plain.tracker.predispatch_ms) == 0
    assert (len(hinted.tracker.line_detect_ms)
            + len(hinted.tracker.predispatch_ms)) == 5


def test_pipelined_window_ba_matches_synchronous():
    """A window BA fires in a pipelined finish (window 4 / overlap 2: at
    frame 3): it runs before the next frame's dispatch, as on the
    synchronous path, and logs its own frame."""
    def with_ba(settings):
        settings.run_local_ba = True
        settings.window_size, settings.overlap_size = 4, 2
        return System(settings, verbose=False, device="cpu")

    sync = _run(False, False, system=with_ba)
    pipe = _run(True, False, system=with_ba)
    _assert_maps_equal(sync.map, pipe.map)
    for s in (sync, pipe):
        assert [r["frame"] for r in s.tracker.ba_runs] == [3]


def jax_uniforms(self, f_id, lane, n_hyp):
    """The JAX tracker's draws: camera = PRNGKey(f_id); object lane k =
    fold_in(fold_in(PRNGKey(f_id), 7), k)."""
    key = jax.random.PRNGKey(f_id)
    if lane > 0:
        key = jax.random.fold_in(jax.random.fold_in(key, 7), lane - 1)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n_hyp, 3))))


def pose_gates(mj, mt, n):
    """North-star gates between two maps' first ``n`` camera poses."""
    motion = np.median([np.linalg.norm(mj.camera_poses_gt[f][:3, 3]
                                       - mj.camera_poses_gt[f - 1][:3, 3])
                        for f in range(1, n)])
    assert motion > 0.05
    for f in range(1, n):
        rel = [np.linalg.inv(np.asarray(m.camera_poses[f - 1], np.float64))
               @ np.asarray(m.camera_poses[f], np.float64) for m in (mj, mt)]
        d = np.linalg.inv(rel[0]) @ rel[1]
        R = d[:3, :3]
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                            R[1, 0] - R[0, 1]])
        assert np.linalg.norm(d[:3, 3]) < 0.01 * motion, f
        assert np.degrees(np.arcsin(min(np.linalg.norm(w), 1.0))) < 0.03, f


@pytest.mark.parametrize("detectors_in_loop", [False, True],
                         ids=["injected", "detectors"])
def test_pipelined_matches_jax(detectors_in_loop):
    """The port's pipelined System and the JAX package's on the same frames
    (the port's generator, 2 objects, 0.1 px flow noise), with the
    next-frame hints, the port with JAX's RANSAC draws."""
    from sdpl_slam_tpu.models.system import System as JaxSystem
    from sdpl_slam_tpu.utils.config import Settings as JaxSettings

    cfg = SynthConfig(n_frames=6, n_objects=2, noise_flow=0.1)
    seq = SynthSequence(cfg)
    ps = synth_settings(cfg)
    ps.run_local_ba = False
    if detectors_in_loop:
        ps.use_sample_fea = 0
    js = JaxSettings(**{k: getattr(ps, k)
                        for k in JaxSettings.__dataclass_fields__
                        if hasattr(ps, k)})
    assert js.pipelined_tracking is True and ps.pipelined_tracking is True
    maps = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
    try:
        for name, system in (("jax", JaxSystem(js, verbose=False)),
                             ("torch", System(ps, verbose=False,
                                              device="cpu"))):
            for t in range(5):
                f, nxt = seq.frame(t), seq.frame(t + 1)
                system.track_rgbd(
                    f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
                    t * 0.1, 5,
                    line_detections=None if detectors_in_loop else f.lines,
                    next_image=nxt.gray if t < 4 else None)
            maps[name] = system.map
    finally:
        mp.undo()
    mj, mt = maps["jax"], maps["torch"]
    assert mj.n_frames == mt.n_frames == 5
    pose_gates(mj, mt, 5)
    assert [list(x) for x in mt.rm_labels] == [list(x) for x in mj.rm_labels]
    assert [list(x) for x in mt.obj_stat] == [list(x) for x in mj.obj_stat]
    assert any(len(x) > 1 for x in mt.rm_labels)
