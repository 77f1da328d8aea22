"""``System.save_checkpoint`` / ``load_checkpoint`` of sdpl_slam_torch
(twins of tests/test_checkpoint.py): the map's round trip, a resumed run
against an uninterrupted one on the host and the resident paths (JAX's
1e-5 bound: the solves are deterministic), the resumed run against the
JAX package's uninterrupted run (ROADMAP North-star gates: translation
within 1 % of the per-frame motion, rotation within 0.03 deg, identical
labels), and the file's contents: builtins and numpy arrays only.

Both packages take the frames of tests/synthetic.py, and the port takes
JAX's RANSAC draws, so they run the same algorithm on the same numbers.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from sdpl_slam_tpu.models.system import System as JaxSystem
from sdpl_slam_torch.models.map_state import MapState
from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.models.tracking import Tracking
from sdpl_slam_torch.utils import convert
from synthetic import SynthConfig, SynthSequence, synth_settings

torch.set_num_threads(2)

N, CUT = 5, 3        # frames tracked; the checkpoint is written after CUT


def jax_uniforms(self, f_id, lane, n_hyp):
    """The JAX tracker's draws (tests/test_torch_system.py)."""
    key = jax.random.PRNGKey(f_id)
    if lane > 0:
        key = jax.random.fold_in(jax.random.fold_in(key, 7), lane - 1)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n_hyp, 3))))


def test_map_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    m = MapState()
    m.camera_poses.append(np.eye(4, dtype=np.float32))
    m.stat_uv.append(rng.normal(size=(10, 2)).astype(np.float32))
    m.rigid_motions.append([np.eye(4, dtype=np.float32)])
    m.rm_labels.append([0])
    p = tmp_path / "map.ckpt"
    m.save(p)
    m2 = MapState.load(p)
    assert m2.n_frames == 1
    np.testing.assert_array_equal(m2.stat_uv[0], m.stat_uv[0])
    assert m2.rm_labels == [[0]]


@pytest.fixture(scope="module")
def seq_and_settings():
    cfg = SynthConfig(n_frames=N + 1, n_objects=1)
    js = synth_settings(cfg)
    js.run_local_ba = False
    js.pipelined_tracking = False
    return SynthSequence(cfg), js


def _track(system, seq, frames):
    for t in frames:
        f = seq.frame(t)
        system.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                          f.obj_rows, t * 0.1, N, line_detections=f.lines)


@pytest.fixture(scope="module")
def jax_map(seq_and_settings):
    """The JAX package's uninterrupted host run."""
    seq, js = seq_and_settings
    ref = JaxSystem(js, verbose=False)
    _track(ref, seq, range(N))
    return ref.map


class _PlainUnpickler(pickle.Unpickler):
    """Loads builtins and numpy only."""

    def find_class(self, module, name):
        if module == "builtins" or module.split(".")[0] == "numpy":
            return super().find_class(module, name)
        raise pickle.UnpicklingError("%s.%s is not allowed" % (module, name))


@pytest.fixture(scope="module", params=["host", "resident"])
def resumed(request, seq_and_settings, tmp_path_factory):
    """(uninterrupted port map, resumed port map, checkpoint path)."""
    seq, js = seq_and_settings
    settings = convert.settings_from_jax(js)
    settings.resident_tracking = request.param == "resident"
    mp = pytest.MonkeyPatch()
    mp.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
    try:
        ref = System(settings, verbose=False, device="cpu")
        _track(ref, seq, range(N))
        a = System(settings, verbose=False, device="cpu")
        _track(a, seq, range(CUT))
        if request.param == "resident":
            assert a.tracker._res is not None
            assert a.tracker.map.n_frames < CUT      # rows still in flight
        path = tmp_path_factory.mktemp("ckpt") / "run.ckpt"
        a.save_checkpoint(path)
        assert a.tracker._res is None and a.tracker.map.n_frames == CUT
        b = System(settings, verbose=False, device="cpu")
        b.load_checkpoint(path)
        assert b.tracker.f_id == CUT and b.map.n_frames == CUT
        _track(b, seq, range(CUT, N))
        if request.param == "resident":
            assert b.tracker._res is not None        # the driver re-entered
    finally:
        mp.undo()
    return ref.map, b.map, path


def test_system_resume_matches_uninterrupted(resumed):
    ref, got, _ = resumed
    assert got.n_frames == ref.n_frames == N
    for i in range(N):
        np.testing.assert_allclose(got.camera_poses[i], ref.camera_poses[i],
                                   atol=1e-5)
    assert got.rm_labels == ref.rm_labels
    assert got.obj_stat == ref.obj_stat


def test_resumed_run_matches_jax(resumed, jax_map):
    _, got, _ = resumed
    mj = jax_map
    assert mj.n_frames == got.n_frames == N
    gt = mj.camera_poses_gt
    motion = np.median([np.linalg.norm(gt[f][:3, 3] - gt[f - 1][:3, 3])
                        for f in range(1, N)])
    for f in range(1, N):
        rel = [np.linalg.inv(np.asarray(m.camera_poses[f - 1], np.float64))
               @ np.asarray(m.camera_poses[f], np.float64) for m in (mj, got)]
        d = np.linalg.inv(rel[0]) @ rel[1]
        R = d[:3, :3]
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                            R[1, 0] - R[0, 1]])
        assert np.linalg.norm(d[:3, 3]) < 0.01 * motion, f
        assert np.degrees(np.arcsin(min(np.linalg.norm(w), 1.0))) < 0.03, f
    assert [list(x) for x in got.rm_labels] == [list(x) for x in mj.rm_labels]
    assert [list(x) for x in got.obj_stat] == [list(x) for x in mj.obj_stat]
    assert any(len(x) > 1 for x in got.rm_labels)


def test_checkpoint_holds_builtins_and_numpy_only(resumed):
    """The file names no class of either package: an unpickler that
    allows only builtins and numpy reads it, with JAX's fields (the
    tracker's, and the resident mode's written-back mask, flow and
    object metadata)."""
    _, _, path = resumed
    with open(path, "rb") as fh:
        blob = _PlainUnpickler(fh).load()
    assert set(blob) == {"tracker", "map"}
    assert set(blob["tracker"]) == set(convert.TRACKER_FIELDS)
    tr = blob["tracker"]
    assert tr["f_id"] == CUT
    assert tr["last_mask"].shape == tr["last_flow"].shape[:2]
    assert set(tr["last_meta"]) == {"sem_position", "mod_label", "obj_stat",
                                    "obj_motion"}
    assert len(blob["map"]["camera_poses"]) == CUT
    with pytest.raises(pickle.UnpicklingError):
        _PlainUnpickler(_io_of(pickle.dumps(MapState()))).load()


def _io_of(data):
    import io

    return io.BytesIO(data)
