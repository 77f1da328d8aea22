"""The stress sequence of tests/test_stress_sequence.py on the port's three
tracking paths (host, resident, chained), on the CPU: mid-run object birth
(object 1 appears at frame 8) and death (object 0 vanishes after frame
18), the segmenter losing object 0 at frames 12-13 (UpdateMask recovery
must keep its tracking label), and depth holes at frames 10-11; the line
detector in the loop, and the next-frame hints.  The assertions are the
JAX test's; the port's host run also gives the JAX package's host run's
label streams on the same frames (the port's generator, JAX's RANSAC
draws).
"""

import jax
import numpy as np
import pytest
import torch

from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.models.tracking import Tracking
from sdpl_slam_torch.utils import metrics
from sdpl_slam_torch.utils.synthetic import (SynthConfig, SynthSequence,
                                             synth_settings)

torch.set_num_threads(2)

BIRTH_K, BIRTH_T = 1, 8      # object 1 appears at frame 8
DEATH_K, DEATH_T = 0, 18     # object 0 vanishes after frame 18
OCCL = ((0, 12), (0, 13))    # segmenter loses object 0 at frames 12-13
HOLES = (10, 11)


def _stress_cfg():
    """tests/test_stress_sequence.py's configuration."""
    return SynthConfig(
        n_frames=26, n_objects=2, seed=3, noise_flow=0.1,
        obj_birth=((BIRTH_K, BIRTH_T),), obj_death=((DEATH_K, DEATH_T),),
        occl_frames=OCCL, depth_hole_frames=HOLES)


def jax_uniforms(self, f_id, lane, n_hyp):
    """The JAX tracker's draws: camera = PRNGKey(f_id); object lane k =
    fold_in(fold_in(PRNGKey(f_id), 7), k)."""
    key = jax.random.PRNGKey(f_id)
    if lane > 0:
        key = jax.random.fold_in(jax.random.fold_in(key, 7), lane - 1)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n_hyp, 3))))


def _drive(system, seq):
    n = seq.n_frames - 1
    for t in range(n):
        f = seq.frame(t)
        nxt = seq.frame(t + 1) if t + 1 < n else None
        nxt2 = seq.frame(t + 2) if t + 2 < n else None
        system.track_rgbd(
            f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
            t * 0.1, n + 1,
            next_image=None if nxt is None else nxt.gray,
            next_image2=None if nxt2 is None else nxt2.gray)
    system.tracker.flush()
    return system.map


def _run(mode):
    seq = SynthSequence(_stress_cfg())
    settings = synth_settings(seq.cfg)
    settings.resident_tracking = mode == "resident"
    settings.chained_tracking = mode == "chained"
    settings.run_local_ba = False
    mp = pytest.MonkeyPatch()
    mp.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
    try:
        return _drive(System(settings, verbose=False, device="cpu"), seq)
    finally:
        mp.undo()


_MAPS = {}


def _map(mode):
    if mode not in _MAPS:
        _MAPS[mode] = _run(mode)
    return _MAPS[mode]


def _tracked_sems(m, i):
    """Semantic labels of committed moving objects at frame i."""
    return set(m.sm_labels[i][1:]) if i < len(m.sm_labels) else set()


@pytest.mark.parametrize("mode", ["host", "resident", "chained"])
def test_stress_lifecycle(mode):
    """tests/test_stress_sequence.py's assertions on one of the port's
    paths."""
    m = _map(mode)

    # 1. no NaNs anywhere in the trajectory or motions
    for i in range(len(m.camera_poses)):
        assert np.isfinite(m.camera_poses[i]).all(), i
    for i in range(len(m.rigid_motions)):
        for Hm in m.rigid_motions[i]:
            assert np.isfinite(Hm).all(), i

    # 2. camera accuracy over the whole sequence
    t_err, r_err = metrics.camera_rpe(m.camera_poses, m.camera_poses_gt)
    assert t_err < 0.01, t_err
    assert r_err < 0.15, r_err

    # 3. birth: object 1 is not tracked before its first frame, and is
    # tracked within a few frames after
    sem_birth = BIRTH_K + 1
    for i in range(0, BIRTH_T):
        assert sem_birth not in _tracked_sems(m, i), i
    post_birth = [i for i in range(BIRTH_T, len(m.sm_labels))
                  if sem_birth in _tracked_sems(m, i)]
    assert post_birth and post_birth[0] <= BIRTH_T + 4, post_birth[:3]

    # 4. death: object 0 is not tracked after its last frame (+2 frames of
    # tracked-feature runoff)
    sem_death = DEATH_K + 1
    for i in range(DEATH_T + 3, len(m.sm_labels)):
        assert sem_death not in _tracked_sems(m, i), i

    # 5. occlusion recovery: object 0's tracking label is the same just
    # before and just after the mask-dropout frames
    def track_label_of(sem, i):
        for j in range(1, len(m.sm_labels[i])):
            if m.sm_labels[i][j] == sem:
                return m.rm_labels[i][j]
        return None

    first_occl = min(fr for (_, fr) in OCCL)
    last_occl = max(fr for (_, fr) in OCCL)
    before = track_label_of(sem_death, first_occl - 1)
    after = None
    for i in range(last_occl + 1, min(last_occl + 4, DEATH_T)):
        after = track_label_of(sem_death, i)
        if after is not None:
            break
    assert before is not None
    assert after is not None, "object 0 lost across the mask dropout"
    assert after == before, (before, after)

    # 6. depth holes: the hole frames still track
    per = []
    for i in range(1, len(m.camera_poses)):
        te, _ = metrics.camera_rpe(m.camera_poses[i - 1:i + 1],
                                   m.camera_poses_gt[i - 1:i + 1])
        per.append(te)
    med = float(np.median(per))
    for fr in HOLES:
        assert per[fr - 1] < max(10 * med, 0.02), (fr, per[fr - 1], med)


def test_stress_host_labels_match_jax():
    """The port's host run and the JAX package's host run on the same
    frames commit the same objects under the same labels."""
    from sdpl_slam_tpu.models.system import System as JaxSystem
    from sdpl_slam_tpu.utils.config import Settings as JaxSettings

    seq = SynthSequence(_stress_cfg())
    ps = synth_settings(seq.cfg)
    ps.run_local_ba = False
    js = JaxSettings(**{k: getattr(ps, k)
                        for k in JaxSettings.__dataclass_fields__
                        if hasattr(ps, k)})
    mj, mt = _drive(JaxSystem(js, verbose=False), seq), _map("host")
    assert mj.n_frames == mt.n_frames == seq.n_frames - 1
    for name in ("rm_labels", "sm_labels", "obj_stat"):
        assert ([list(x) for x in getattr(mt, name)]
                == [list(x) for x in getattr(mj, name)]), name
