"""The tracking slice with the window BA in the loop: sdpl_slam_torch's
System against sdpl_slam_tpu's on the 640x192 synthetic sequence, 9 frames,
FAST in the loop, injected lines, ``run_local_ba`` on with window 5 and
overlap 2, so windows fire at frames 4 and 7 and later frames start from
the refined poses.  The JAX side runs synchronously
(``pipelined_tracking = False``); the port takes JAX's RANSAC draws.

Gates (as tests/test_torch_system.py): per-frame mutual translation delta
< 1 % of the per-frame GT motion, rotation delta < 0.03 deg, on the
primary and the refined (``*_rf``) poses; object motions, which the
windows write back, to 1 % and 0.03 deg; identical label streams; both
under the GT gates (t < 5 mm, r < 0.1 deg); the 7 result files alike; and
the same number of windows.
"""

import numpy as np
import pytest
import torch

from sdpl_slam_tpu.models.system import System as JaxSystem
from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.models.tracking import Tracking
from sdpl_slam_torch.utils import convert, metrics
from synthetic import SynthConfig, SynthSequence, synth_settings
# the two tests imported here are collected again in this module, on its
# own ``runs`` fixture
from test_torch_system import (_angle_deg, _gt_motion, _rel, jax_uniforms,
                               test_object_motions_match_jax,
                               test_result_files_alike)

torch.set_num_threads(2)

N = 9


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
    # the JAX package's background compile of the first window only hides
    # a compile; it changes no result
    mp.setenv("SDPL_BA_PRECOMPILE", "0")
    cfg = SynthConfig(n_frames=N)
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    settings.use_sample_fea = 0
    settings.run_local_ba = True
    settings.window_size, settings.overlap_size = 5, 2
    settings.run_global_ba = False
    settings.pipelined_tracking = False
    systems = (JaxSystem(settings, verbose=False),
               System(convert.settings_from_jax(settings), verbose=False,
                      device="cpu"))
    for t in range(N):
        f = seq.frame(t)
        for s in systems:
            s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                         f.obj_rows, t * 0.1, N, line_detections=f.lines)
    dirs = {}
    for name, s in zip(("jax", "torch"), systems):
        dirs[name] = tmp_path_factory.mktemp(name)
        s.save_results(dirs[name])
    mp.undo()
    return dict(jax=systems[0].map, torch=systems[1].map, dirs=dirs)


def test_windows_fired(runs):
    assert len(runs["jax"].lba_times) == len(runs["torch"].lba_times) == 2


def test_camera_matches_jax_per_frame(runs):
    mj, mt = runs["jax"], runs["torch"]
    assert mj.n_frames == mt.n_frames == N
    motion = _gt_motion(mj)
    for f in range(1, N):
        d = np.linalg.inv(_rel(mj, f)) @ _rel(mt, f)
        assert np.linalg.norm(d[:3, 3]) < 0.01 * motion, f
        assert _angle_deg(d[:3, :3]) < 0.03, f


def test_refined_poses_match_jax(runs):
    """The ``*_rf`` trajectory, which the windows also write."""
    mj, mt = runs["jax"], runs["torch"]
    for f in range(N):
        d = (np.linalg.inv(np.asarray(mj.camera_poses_rf[f], np.float64))
             @ mt.camera_poses_rf[f])
        assert np.linalg.norm(d[:3, 3]) < 0.01 * _gt_motion(mj), f
        assert _angle_deg(d[:3, :3]) < 0.03, f


def test_label_streams_identical(runs):
    mj, mt = runs["jax"], runs["torch"]
    assert [list(x) for x in mt.rm_labels] == [list(x) for x in mj.rm_labels]
    assert [list(x) for x in mt.obj_stat] == [list(x) for x in mj.obj_stat]
    assert any(len(x) > 1 for x in mt.rm_labels)


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_gt_gates(runs, which):
    m = runs[which]
    t_err, r_err = metrics.camera_rpe(m.camera_poses, m.camera_poses_gt)
    assert t_err < 0.005 and r_err < 0.1, (t_err, r_err)
