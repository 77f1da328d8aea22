"""The port's device-resident loop (``resident_tracking``) end to end on
the CPU: against the port's own host path (twins of
``tests/test_resident.py``, with its key lists and ``_maps_close``'s
tolerances), against the JAX package's resident ``System`` on the same
frames with JAX's RANSAC draws (ROADMAP North-star gates: per-frame
translation delta < 1 % of the per-frame GT motion, rotation delta < 0.03
deg, identical label streams), and its mode handling: ``check_supported``,
the lagging map stream and a write-back to the host path mid-sequence.
"""

import numpy as np
import pytest
import torch

from sdpl_slam_torch.models import resident as res
from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.models.tracking import Tracking, check_supported
from sdpl_slam_torch.utils import metrics
from sdpl_slam_torch.utils.synthetic import (SynthConfig, SynthSequence,
                                             synth_settings)

torch.set_num_threads(2)

INT_KEYS = ["stat_valid", "line_valid", "obj_sem", "obj_label", "obj_valid",
            "oline_sem", "oline_label", "oline_valid"]
FLOAT_KEYS = ["pose", "stat_uv", "stat_depth", "stat_flow", "stat_corres",
              "line_uv", "line_depth", "line_flow", "line_corres",
              "obj_uv", "obj_depth", "obj_flow", "obj_corres",
              "oline_uv", "oline_depth", "oline_flow", "oline_corres"]


def _run_pair(noise_flow=0.0, n_objects=1, n_frames=5):
    """The port's resident step against its host tracker, frame by frame
    from frame 0's host state (twin of tests/test_resident.py)."""
    cfg = SynthConfig(n_frames=n_frames, n_objects=n_objects,
                      noise_flow=noise_flow)
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    settings.pipelined_tracking = False      # tr.last after every call
    sysH = System(settings, verbose=False, device="cpu")
    tr = sysH.tracker
    n = seq.n_frames - 1
    f0 = seq.frame(0)
    sysH.track_rgbd(f0.gray, f0.depth, f0.flow, f0.mask, f0.gt_pose,
                    f0.obj_rows, 0.0, n, line_detections=f0.lines)
    caps = dict(NS=tr.NS, NLS=tr.NLS, NO=tr.NO, NLO=tr.NLO, P=tr.P_OBJ,
                L=tr.L_OBJ, MAXO=tr.MAXO, GCAP=2 * tr.MAXO)
    step = res.build_resident_step(tr.cfg, tr.K, caps)
    state = res.state_from_host(tr.last, tr.last_meta, tr.max_id,
                                tr.velocity, tr.last_mask_np,
                                tr.last_flow_np, tr.MAXO, "cpu")
    n_cam, n_obj = res.n_hypotheses(tr.cfg)
    cand = res.fr.grid_sample_uv(cfg.height, cfg.width, n_points=tr.N_CAND,
                                 device="cpu")
    cand_v = torch.ones(tr.N_CAND, dtype=torch.bool)
    prev_rows = f0.obj_rows
    for t in range(1, n):
        f = seq.frame(t)
        lc = torch.zeros((tr.NL_CAND, 4))
        lv = torch.zeros(tr.NL_CAND, dtype=torch.bool)
        nl = min(len(f.lines), tr.NL_CAND)
        lc[:nl] = torch.from_numpy(f.lines[:nl])
        lv[:nl] = True
        state, _, _ = step(
            state, torch.from_numpy(np.asarray(f.depth, np.float32)),
            torch.from_numpy(np.ascontiguousarray(f.flow, np.float32)),
            torch.from_numpy(np.asarray(f.mask, np.int32)), cand, cand_v,
            lc, lv, torch.from_numpy(res.gt_sem_table(prev_rows)),
            torch.from_numpy(res.gt_sem_table(f.obj_rows)),
            tr._ransac_uniforms(t, 0, n_cam),
            torch.stack([tr._ransac_uniforms(t, k + 1, n_obj)
                         for k in range(tr.MAXO)]))
        sysH.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                        f.obj_rows, t * 0.1, n, line_detections=f.lines)
        yield (t, tr) + res.state_to_host(state)
        prev_rows = f.obj_rows


def _compare(t, tr, lastD, metaD, max_idD):
    for k in INT_KEYS:
        np.testing.assert_array_equal(tr.last[k], lastD[k],
                                      err_msg="frame %d: %s" % (t, k))
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(tr.last[k], lastD[k], atol=5e-3,
                                   rtol=1e-4, err_msg="frame %d: %s" % (t, k))
    assert max_idD == tr.max_id, t
    for k in ("sem_position", "mod_label", "obj_stat"):
        assert metaD[k] == tr.last_meta[k], (t, k)


def test_resident_matches_host_clean():
    for args in _run_pair(noise_flow=0.0):
        _compare(*args)


def test_resident_matches_host_noisy():
    for args in _run_pair(noise_flow=0.2, n_objects=2):
        _compare(*args)


def _run_system(resident, detectors_in_loop=False, local_ba=False,
                n_frames=6, **over):
    cfg = SynthConfig(n_frames=n_frames, n_objects=2, noise_flow=0.1)
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    settings.resident_tracking = resident
    settings.run_local_ba = local_ba
    if local_ba:
        settings.window_size, settings.overlap_size = 4, 2
    if detectors_in_loop:
        settings.use_sample_fea = 0
    for k, v in over.items():
        setattr(settings, k, v)
    sys_ = System(settings, verbose=False, device="cpu")
    n = seq.n_frames - 1
    for t in range(n):
        f = seq.frame(t)
        sys_.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                        f.obj_rows, t * 0.1, n,
                        line_detections=None if detectors_in_loop else f.lines)
    return sys_


def _maps_close(a, b):
    """tests/test_resident.py's map comparison."""
    for name in ("stat_valid", "line_valid", "dyn_valid", "dyn_label",
                 "dline_label", "stat_asso"):
        va, vb = getattr(a, name), getattr(b, name)
        assert len(va) == len(vb), name
        for i, (x, y) in enumerate(zip(va, vb)):
            np.testing.assert_array_equal(x, y, err_msg="%s[%d]" % (name, i))
    for name in ("camera_poses", "camera_poses_gt", "stat_uv", "stat_3d",
                 "line_uv", "dyn_uv", "dyn_3d"):
        va, vb = getattr(a, name), getattr(b, name)
        assert len(va) == len(vb), name
        for i, (x, y) in enumerate(zip(va, vb)):
            np.testing.assert_allclose(x, y, atol=5e-3, rtol=1e-3,
                                       err_msg="%s[%d]" % (name, i))
    for name in ("rm_labels", "sm_labels", "obj_stat"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("rigid_motions", "speeds_gt", "rigid_motions_gt"):
        va, vb = getattr(a, name), getattr(b, name)
        assert len(va) == len(vb), name
        for i, (ra, rb) in enumerate(zip(va, vb)):
            assert len(ra) == len(rb), "%s[%d]" % (name, i)
            for x, y in zip(ra, rb):
                np.testing.assert_allclose(x, y, atol=5e-3, rtol=1e-3,
                                           err_msg="%s[%d]" % (name, i))


def test_resident_system_matches_host_injected():
    _maps_close(_run_system(False).map, _run_system(True).map)


def test_resident_system_matches_host_detectors():
    """FAST and the line detector inside the step (``use_sample_fea = 0``,
    nothing injected)."""
    host, resident = _run_system(False, True), _run_system(True, True)
    _maps_close(host.map, resident.map)
    assert len(host.tracker.line_detect_ms) == 5
    # the step does not host-time the detector (a host-path figure)
    assert len(resident.tracker.line_detect_ms) == 1


@pytest.mark.parametrize("n_frames", [6, 7])
def test_resident_system_with_local_ba(n_frames):
    """Window 4 / overlap 2: a window at frame 3; with 7 frames also at
    frame 5, the stop frame, which the resident driver runs at its final
    drain (no later frame would start it).

    The windows run their LM to its iteration cap (a gain threshold of
    1e-12, not the reference's 1e-3).  The two paths feed the window the
    same map up to float32 rounding (the host path's velocity and object
    motions come from numpy's inverse, the step's from torch's: 1e-4 px
    apart by frame 4), and at the 1e-3 rule the window's LM stops at 22
    iterations on one path and 20 on the other (15 and 14 in float64, so
    float64 does not steady it), while an object motion in a flat valley
    still moves 5e-3 between those iterations.  Run to the cap, both land
    within 4e-4 of each other."""
    over = dict(ba_gain_threshold_partial=1e-12)
    host = _run_system(False, local_ba=True, n_frames=n_frames, **over)
    resident = _run_system(True, local_ba=True, n_frames=n_frames, **over)
    want = [3] if n_frames == 6 else [3, 5]
    for s in (host, resident):
        assert [r["frame"] for r in s.tracker.ba_runs] == want
    if n_frames == 6:
        _maps_close(host.map, resident.map)
        return
    # two windows in a row: the second window's CG amplifies the f32
    # differences of the two paths' inputs, and the refined structure
    # parts by up to 2e-3 relative (measured 1.9e-3 at 40 m); the
    # trajectory, the labels and the motions hold _maps_close's gates
    a, b = host.map, resident.map
    for name in ("rm_labels", "sm_labels", "obj_stat"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("camera_poses", "camera_poses_rf"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            np.testing.assert_allclose(x, y, atol=5e-3, rtol=1e-3,
                                       err_msg=name)
    for ra, rb in zip(a.rigid_motions, b.rigid_motions):
        for x, y in zip(ra, rb):
            np.testing.assert_allclose(x, y, atol=5e-3, rtol=1e-3)


def test_window_ba_pose_written_into_the_buffers(monkeypatch):
    """The driver runs over the static buffers of a ``ResidentProgram``
    (the plumbing the card's captured graph reads): the state buffers keep
    their addresses from frame to frame, the window BA at frame 3 writes
    its refined pose into them in place before frame 4's step, and the map
    is the one test_resident_system_with_local_ba holds to the host path."""
    seen = []
    call = res.ResidentProgram.__call__

    def spy(prog):
        drv = prog.owner
        seen.append(([t.data_ptr() for t in prog.state] + [prog.out.data_ptr()],
                     prog.state.pose.clone(), len(drv.tr.map.camera_poses),
                     np.asarray(drv.tr.map.camera_poses[-1]).copy()))
        assert drv.state is prog.state
        return call(prog)

    monkeypatch.setattr(res.ResidentProgram, "__call__", spy)
    over = dict(ba_gain_threshold_partial=1e-12)
    resident = _run_system(True, local_ba=True, n_frames=6, **over)
    monkeypatch.undo()
    assert [r["frame"] for r in resident.tracker.ba_runs] == [3]
    assert len(seen) == 4                      # frames 1-4 in the step
    assert all(s[0] == seen[0][0] for s in seen)
    ptrs, pose, n_map, last = seen[3]          # frame 4, after the window
    assert n_map == 4
    np.testing.assert_array_equal(
        pose.numpy(), np.linalg.inv(last).astype(np.float32))
    host = _run_system(False, local_ba=True, n_frames=6, **over)
    _maps_close(host.map, resident.map)


def test_drivers_sharing_a_program_keep_their_states():
    """Two resident systems on the same frames, interleaved, over their one
    shared program (identically configured drivers share it, as they share
    the card's captured graph): each frame a driver takes the buffers from
    the other, which keeps a copy of its state, and both maps equal a run
    alone bit for bit; an exit and re-entry in the middle changes nothing
    either."""
    ref = _run_system(True).map
    cfg = SynthConfig(n_frames=6, n_objects=2, noise_flow=0.1)
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    settings.resident_tracking = True
    settings.run_local_ba = False
    systems = [System(settings, verbose=False, device="cpu")
               for _ in range(2)]
    for t in range(5):
        f = seq.frame(t)
        for sys_ in systems:
            sys_.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                            f.obj_rows, t * 0.1, 5, line_detections=f.lines)
        if t == 2:
            systems[0].tracker.sync_host_state()        # exit
            assert systems[0].tracker._res is None
    progs = [s.tracker._res.prog for s in systems]
    assert progs[0] is None and progs[1].owner is systems[1].tracker._res
    assert systems[0].tracker._res.state is not progs[1].state
    for sys_ in systems:
        m = sys_.map
        _maps_close(ref, m)
        for x, y in zip(ref.camera_poses, m.camera_poses):
            np.testing.assert_array_equal(x, y)


def test_resident_system_with_global_ba():
    """The global BA at the stop frame: the resident driver drains, writes
    its state back and runs it, as the host path does at that frame."""
    # 3 frames and 5 LM iterations keep the BA short on the CPU
    over = dict(run_global_ba=True, ba_global_iterations=5, n_frames=4)
    host = _run_system(False, **over)
    resident = _run_system(True, **over)
    for s in (host, resident):
        assert [(r["kind"], r["frame"]) for r in s.tracker.ba_runs] == \
            [("global", 2)]
    assert resident.tracker._res is None
    a, b = host.map, resident.map
    for name in ("rm_labels", "sm_labels", "obj_stat"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("camera_poses", "camera_poses_rf"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            np.testing.assert_allclose(x, y, atol=5e-3, rtol=1e-3,
                                       err_msg=name)


def test_resident_compressed_input():
    """float16 depth/flow and a uint8 mask stay within the host-parity
    tolerances: ~1e-3 relative quantisation, below the flow noise."""
    m = _run_system(True, resident_compress_input=True).map
    t_err, r_err = metrics.camera_rpe(m.camera_poses, m.camera_poses_gt)
    assert t_err < 0.02, t_err
    assert r_err < 0.2, r_err
    assert sum(1 for mm in m.rigid_motions if len(mm) > 1) >= 2


def test_map_stream_lags_and_host_write_back():
    """The map trails the step by ``LAG`` frames until a reader drains it;
    a write-back to the host state mid-sequence and re-entry change no
    result."""
    cfg = SynthConfig(n_frames=6, n_objects=2, noise_flow=0.1)
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    settings.resident_tracking = True
    settings.run_local_ba = False
    ref = _run_system(True).map
    sys_ = System(settings, verbose=False, device="cpu")
    for t in range(5):
        f = seq.frame(t)
        sys_.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                        f.obj_rows, t * 0.1, 5, line_detections=f.lines)
        if t == 3:
            # frame 0 (host) + frame 1 drained; frames 2, 3 in flight
            assert sys_.tracker.map.n_frames == 2
            assert sys_.map.n_frames == 4          # a reader drains
            sys_.tracker.sync_host_state()
            assert sys_.tracker._res is None
            assert sys_.tracker.last["obj_label"].dtype == np.int32
    _maps_close(ref, sys_.map)


def test_check_supported_and_device():
    """Without the joint optimiser or with lens distortion the driver is
    not eligible, and ``resident_tracking`` runs the host path, as in the
    JAX package (it was refused until ROADMAP C1 was repaired): a non-joint
    resident run gives the host non-joint run's poses and labels.  The
    chained mode, refused until it was ported (ROADMAP A14), is accepted
    under the same eligibility rule."""
    s = synth_settings(SynthConfig())
    s.resident_tracking = True
    check_supported(s)
    assert res.ResidentDriver.eligible(s)
    for over in (dict(use_joint_optimization=False), dict(k1=0.1),
                 dict(resident_tracking=False, chained_tracking=True)):
        other = synth_settings(SynthConfig())
        other.resident_tracking = True
        for k, v in over.items():
            setattr(other, k, v)
        check_supported(other)
        if "chained_tracking" in over:
            from sdpl_slam_torch.models.chained import ChainedDriver
            assert ChainedDriver.eligible(other)
            continue
        assert not res.ResidentDriver.eligible(other)
    host = _run_system(False, n_frames=4, use_joint_optimization=False)
    resident = _run_system(True, n_frames=4, use_joint_optimization=False)
    assert resident.tracker._res is None
    a, b = host.map, resident.map
    assert a.n_frames == b.n_frames == 3
    for x, y in zip(a.camera_poses, b.camera_poses):
        np.testing.assert_array_equal(x, y)
    for name in ("rm_labels", "sm_labels", "obj_stat", "dyn_label"):
        va, vb = getattr(a, name), getattr(b, name)
        assert len(va) == len(vb), name
        for x, y in zip(va, vb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            System(s, verbose=False)
    assert System(s, verbose=False, device="cpu").device.type == "cpu"


def test_rpe_print_every(capsys):
    """``rpe_print_every``: the resident drain prints the camera RPE of the
    newest frame pair every N frames, in the JAX resident drain's format
    (sdpl_slam_tpu/models/resident.py:1854-1866), and nothing when 0."""
    import re

    sys_ = _run_system(True, rpe_print_every=2)
    m = sys_.map
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "camera RPE" in ln]
    fmt = re.compile(r"^\[frame +(\d+)\] camera RPE: t=(\d+\.\d{4}) m  "
                     r"r=(\d+\.\d{4}) deg  \(pt inliers (\d+)\)$")
    got = [fmt.match(ln) for ln in lines]
    assert all(got), lines
    assert [int(g.group(1)) for g in got] == [2, 4]
    for g in got:
        f = int(g.group(1))
        t_e, r_e = metrics.camera_rpe(m.camera_poses[f - 1:f + 1],
                                      m.camera_poses_gt[f - 1:f + 1])
        assert g.group(2) == "%.4f" % t_e and g.group(3) == "%.4f" % r_e
        assert int(g.group(4)) > 0
    _run_system(True, rpe_print_every=0)
    assert "camera RPE" not in capsys.readouterr().out


def test_resident_system_matches_jax():
    """The slice as a whole: the JAX package's resident System and the
    port's on the same frames (tests/synthetic.py, 2 objects, 0.1 px flow
    noise, lines injected), the port with JAX's RANSAC draws."""
    import jax
    import synthetic as jsynth
    from sdpl_slam_tpu.models.system import System as JaxSystem
    from sdpl_slam_torch.utils import convert

    def jax_uniforms(self, f_id, lane, n_hyp):
        key = jax.random.PRNGKey(f_id)
        if lane > 0:
            key = jax.random.fold_in(jax.random.fold_in(key, 7), lane - 1)
        return torch.from_numpy(np.array(jax.random.uniform(key, (n_hyp, 3))))

    cfg = jsynth.SynthConfig(n_frames=6, n_objects=2, noise_flow=0.1)
    seq = jsynth.SynthSequence(cfg)
    js = jsynth.synth_settings(cfg)
    js.resident_tracking = True
    js.run_local_ba = False
    js.pipelined_tracking = False
    ps = convert.settings_from_jax(js)
    maps = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
    try:
        for name, system in (("jax", JaxSystem(js, verbose=False)),
                             ("torch", System(ps, verbose=False,
                                              device="cpu"))):
            for t in range(5):
                f = seq.frame(t)
                system.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                                  f.obj_rows, t * 0.1, 5,
                                  line_detections=f.lines)
            maps[name] = system.map
    finally:
        mp.undo()
    mj, mt = maps["jax"], maps["torch"]
    assert mj.n_frames == mt.n_frames == 5
    motion = np.median([np.linalg.norm(mj.camera_poses_gt[f][:3, 3]
                                       - mj.camera_poses_gt[f - 1][:3, 3])
                        for f in range(1, 5)])
    assert motion > 0.1
    for f in range(1, 5):
        rel = [np.linalg.inv(np.asarray(m.camera_poses[f - 1], np.float64))
               @ np.asarray(m.camera_poses[f], np.float64) for m in (mj, mt)]
        d = np.linalg.inv(rel[0]) @ rel[1]
        R = d[:3, :3]
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                            R[1, 0] - R[0, 1]])
        assert np.linalg.norm(d[:3, 3]) < 0.01 * motion, f
        assert np.degrees(np.arcsin(min(np.linalg.norm(w), 1.0))) < 0.03, f
    assert [list(x) for x in mt.rm_labels] == [list(x) for x in mj.rm_labels]
    assert [list(x) for x in mt.obj_stat] == [list(x) for x in mj.obj_stat]
    assert any(len(x) > 1 for x in mt.rm_labels)
