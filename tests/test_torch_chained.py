"""The port's chained loop (``chained_tracking``, models/chained.py) on the
CPU: the bundle layout, the host samplers and the provenance gathers
against the JAX package's on inputs drawn from a numpy seed; twins of the
7 tests of tests/test_chained.py at their size (320x192, 8 frames, 1
object, 0.15 px flow noise; depths 2 and 3), each also holding the port
against the JAX package's chained run on the same frames (the port's
generator, JAX's RANSAC draws: identical labels, and JAX's host-parity
tolerances of tests/test_chained.py); and a chained checkpoint round trip.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

from sdpl_slam_tpu.models import chained as jch
from sdpl_slam_torch.models import chained as tch
from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.models.tracking import Tracking
from sdpl_slam_torch.utils import metrics
from sdpl_slam_torch.utils.synthetic import (SynthConfig, SynthSequence,
                                             synth_settings)

torch.set_num_threads(2)

CAPS = dict(NS=60, NLS=16, NO=48, NLO=12)
N = 8


@pytest.mark.parametrize("depth", [2, 3])
def test_bundle_layout_matches_jax(depth):
    """Row for row JAX's layout: names, shapes, offsets, and a bundle
    packed by numpy unpacks to the same arrays in both packages."""
    assert tch.bundle_spec(CAPS, depth) == jch.bundle_spec(CAPS, depth)
    assert tch.bundle_size(CAPS, depth) == jch.bundle_size(CAPS, depth)
    buf = np.random.default_rng(depth).standard_normal(
        tch.bundle_size(CAPS, depth)).astype(np.float32)
    want = jch._unpack_bundle(buf, CAPS, depth)
    got = tch._unpack_bundle(torch.from_numpy(buf), CAPS, depth)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def _planes(rng, h=40, w=56):
    """A depth ramp with holes and a far band, flow with zeros, a mask with
    two labelled blocks: every gate of the filters both passes and fails
    somewhere."""
    depth = np.broadcast_to(5.0 + 0.05 * np.arange(w, dtype=np.float32),
                            (h, w)).copy()
    depth[:, -6:] = 45.0
    depth[rng.random((h, w)) < 0.05] = 0.0
    flow = rng.normal(0.0, 2.0, (h, w, 2)).astype(np.float32)
    flow[rng.random((h, w)) < 0.05] = 0.0
    mask = np.zeros((h, w), np.int32)
    mask[5:15, 5:20] = 1
    mask[25:35, 30:45] = 2
    return depth, flow, mask


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_host_samplers_match_jax(native, monkeypatch):
    """The samplers, ``_rolled_positions``, ``_np_floor_lookup`` and
    ``_np_filt_line_ok`` give JAX's values exactly, positions in and out of
    the image, through the native library where it loads and through
    numpy."""
    from sdpl_slam_tpu.io import native as jnat
    from sdpl_slam_torch.io import native as tnat

    if not native:
        for mod in (jnat, tnat):
            for name in ("sample_point_rows", "sample_line_rows",
                         "sample_oline_rows"):
                monkeypatch.setattr(mod, name, lambda *a: None)
            monkeypatch.setattr(mod, "roll_positions", lambda *a: False)
    rng = np.random.default_rng(11)
    depth, flow, mask = _planes(rng)
    q = rng.uniform(-3.0, 60.0, (200, 2)).astype(np.float32)
    q4 = rng.uniform(-3.0, 60.0, (120, 4)).astype(np.float32)
    q4[:5, 2:] = q4[:5, :2]                     # degenerate segments
    for fn, pos in (("_sample_point_rows", q), ("_sample_line_rows", q4),
                    ("_sample_oline_rows", q4)):
        np.testing.assert_array_equal(
            getattr(tch, fn)(depth, flow, mask, pos),
            getattr(jch, fn)(depth, flow, mask, pos), err_msg=fn)
    for pos, stride in ((q, 2), (q4, 4)):
        np.testing.assert_array_equal(tch._rolled_positions(pos, flow, stride),
                                      jch._rolled_positions(pos, flow, stride))
    for plane in (depth, flow, mask):
        for a, b in zip(tch._np_floor_lookup(plane, q),
                        jch._np_floor_lookup(plane, q)):
            np.testing.assert_array_equal(a, b)
    ok = tch._np_filt_line_ok(q4, depth, flow, mask)
    np.testing.assert_array_equal(ok, jch._np_filt_line_ok(q4, depth, flow,
                                                           mask))
    assert ok.any() and not ok.all()


def test_gathers_and_compose_match_jax():
    """``_gather_prov``, ``_gather_prov3``, ``_compose_prov`` and
    ``identity_prov`` against JAX's, with indices out of range on both
    sides (JAX clips them)."""
    rng = np.random.default_rng(5)
    n, nb = 30, 20
    A, B1, B2 = (rng.standard_normal((m, 5)).astype(np.float32)
                 for m in (n, nb, nb))
    idx = [rng.integers(-3, n + 5, n).astype(np.int32) for _ in range(3)]
    t = torch.from_numpy
    np.testing.assert_array_equal(
        tch._gather_prov(t(A), t(B1), t(idx[0]), t(idx[1])).numpy(),
        np.asarray(jch._gather_prov(A, B1, idx[0], idx[1])))
    np.testing.assert_array_equal(
        tch._gather_prov3(t(A), t(B1), t(B2), *map(t, idx)).numpy(),
        np.asarray(jch._gather_prov3(A, B1, B2, *idx)))
    caps = dict(NS=n, NLS=n, NO=n, NLO=n)

    def state(lib):
        vals = {}
        for fam in ("s", "l", "o", "ol"):
            for kind in ("asso", "cand"):
                vals[f"{fam}_{kind}"] = rng.integers(-2, n + 3, n).astype(
                    np.int32)
        return vals

    prev, new = state(np), state(np)
    got = tch._compose_prov(
        types.SimpleNamespace(**{k: t(v) for k, v in prev.items()}),
        types.SimpleNamespace(**{k: t(v) for k, v in new.items()}), caps)
    want = jch._compose_prov(types.SimpleNamespace(**prev),
                             types.SimpleNamespace(**new), caps)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    got, want = tch.identity_prov(caps, "cpu"), jch.identity_prov(caps)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# twins of tests/test_chained.py
# ---------------------------------------------------------------------------

def jax_uniforms(self, f_id, lane, n_hyp):
    """The JAX step's draws: camera = PRNGKey(f_id); object lane k =
    fold_in(fold_in(PRNGKey(f_id), 7), k)."""
    key = jax.random.PRNGKey(f_id)
    if lane > 0:
        key = jax.random.fold_in(jax.random.fold_in(key, 7), lane - 1)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n_hyp, 3))))


def _cfg():
    return SynthConfig(n_frames=N + 1, n_objects=1, width=320, height=192,
                       noise_flow=0.15)


def _settings(chained, depth=2):
    s = synth_settings(_cfg())
    s.run_local_ba = False
    s.run_global_ba = False
    s.chained_tracking = chained
    s.chained_depth = depth
    return s


def _run(system, seq, frames=range(N)):
    for t in frames:
        f = seq.frame(t)
        nxt = seq.frame(t + 1) if t + 1 < N else None
        system.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                          f.obj_rows, t * 0.1, N, line_detections=f.lines,
                          next_image=None if nxt is None else nxt.gray)
    return system


def _runs(chained, depth, with_jax=True):
    """The port's run and the JAX package's on the port's frames, the port
    with JAX's draws."""
    from sdpl_slam_tpu.models.system import System as JaxSystem
    from sdpl_slam_tpu.utils.config import Settings as JaxSettings

    seq = SynthSequence(_cfg())
    ps = _settings(chained, depth)
    js = JaxSettings(**{k: getattr(ps, k)
                        for k in JaxSettings.__dataclass_fields__
                        if hasattr(ps, k)})
    mp = pytest.MonkeyPatch()
    mp.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
    try:
        port = _run(System(ps, verbose=False, device="cpu"), seq)
    finally:
        mp.undo()
    return port, _run(JaxSystem(js, verbose=False), seq) if with_jax else None


@pytest.fixture(scope="module")
def chained_runs():
    host, _ = _runs(False, 2, with_jax=False)
    chained, jax_chained = _runs(True, 2)
    return host, chained, jax_chained


@pytest.fixture(scope="module")
def chained3_run():
    return _runs(True, 3)


def _pose_deltas(ma, mb):
    for pa, pb in zip(ma.camera_poses, mb.camera_poses):
        dt = np.linalg.norm(pa[:3, 3] - pb[:3, 3])
        dr = np.degrees(np.arccos(np.clip(
            (np.trace(pa[:3, :3].T @ pb[:3, :3]) - 1) / 2, -1, 1)))
        yield dt, dr


def _same_labels(ma, mb):
    assert ma.n_frames == mb.n_frames == N
    for name in ("rm_labels", "sm_labels", "obj_stat"):
        assert ([list(x) for x in getattr(ma, name)]
                == [list(x) for x in getattr(mb, name)]), name


def test_chained_tracks_accurately(chained_runs):
    _, chained, jax_chained = chained_runs
    for m in (chained.map, jax_chained.map):
        t_err, r_err = metrics.camera_rpe(m.camera_poses, m.camera_poses_gt)
        assert t_err < 0.02, t_err
        assert r_err < 0.2, r_err


def test_chained_close_to_host_path(chained_runs):
    """Per-frame camera poses within tests/test_chained.py's gates of the
    port's host run, and of the JAX package's chained run."""
    host, chained, jax_chained = chained_runs
    for ref in (host.map, jax_chained.map):
        for dt, dr in _pose_deltas(ref, chained.map):
            assert dt < 0.02, (dt, dr)
            assert dr < 0.2, (dt, dr)
    _same_labels(chained.map, jax_chained.map)


def test_chained_tracks_object_motion(chained_runs):
    _, chained, jax_chained = chained_runs
    m = chained.map
    assert sum(1 for mm in m.rigid_motions if len(mm) > 1) >= 4
    t_err, r_err, _ = metrics.object_motion_error(
        m.rigid_motions, m.obj_pose_pre, m.rigid_motions_gt, m.obj_stat,
        m.rm_labels)
    assert t_err < 0.05, t_err
    assert r_err < 0.5, r_err
    _same_labels(m, jax_chained.map)


def test_chained_depth3_tracks_accurately(chained3_run):
    port, jax_run = chained3_run
    assert port.tracker.cfg.chained_depth == 3
    for m in (port.map, jax_run.map):
        t_err, r_err = metrics.camera_rpe(m.camera_poses, m.camera_poses_gt)
        assert t_err < 0.02, t_err
        assert r_err < 0.2, r_err


def test_chained_depth3_close_to_host_path(chained_runs, chained3_run):
    """One more frame of shadow staleness than depth 2: the gates of
    tests/test_chained.py's depth-3 twin (0.03 m, 0.3 deg)."""
    host, _, _ = chained_runs
    port, jax_run = chained3_run
    for ref in (host.map, jax_run.map):
        for dt, dr in _pose_deltas(ref, port.map):
            assert dt < 0.03, (dt, dr)
            assert dr < 0.3, (dt, dr)
    _same_labels(port.map, jax_run.map)


def test_chained_depth3_tracks_object_motion(chained3_run):
    port, jax_run = chained3_run
    m = port.map
    assert sum(1 for mm in m.rigid_motions if len(mm) > 1) >= 4
    t_err, r_err, _ = metrics.object_motion_error(
        m.rigid_motions, m.obj_pose_pre, m.rigid_motions_gt, m.obj_stat,
        m.rm_labels)
    assert t_err < 0.05, t_err
    assert r_err < 0.5, r_err
    _same_labels(m, jax_run.map)


def test_chained_checkpointable_state(chained_runs, tmp_path):
    """After the run the host state is authoritative (the driver left at
    the stop frame) and the result files are written."""
    _, chained, _ = chained_runs
    chained.save_results(tmp_path)
    assert os.path.exists(tmp_path / "initial_stereo_new.txt")


def test_chained_checkpoint_round_trip(tmp_path):
    """``save_checkpoint`` mid-run leaves the chained driver through
    ``sync_host_state`` (drained, provenance at the identity); a fresh
    System loaded from the file and the original continue to the same map,
    bit for bit."""
    seq = SynthSequence(_cfg())
    path = tmp_path / "chained.ckpt"
    a = _run(System(_settings(True), verbose=False, device="cpu"), seq,
             range(4))
    assert a.tracker._res is not None and a.tracker._res.pending
    a.save_checkpoint(path)
    assert a.tracker._res is None
    assert a.map.n_frames == 4
    b = System(_settings(True), verbose=False, device="cpu")
    b.load_checkpoint(path)
    for s in (a, b):
        _run(s, seq, range(4, N))
    ma, mb = a.map, b.map
    assert ma.n_frames == mb.n_frames == N
    for name in ("camera_poses", "stat_uv", "dyn_uv", "dyn_label"):
        for x, y in zip(getattr(ma, name), getattr(mb, name)):
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert ma.rm_labels == mb.rm_labels
    t_err, _ = metrics.camera_rpe(mb.camera_poses, mb.camera_poses_gt)
    assert t_err < 0.02
