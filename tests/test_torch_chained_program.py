"""The chained step's program of sdpl_slam_torch (``models/chained.py``:
``ChainedProgram`` over static buffers, run by ``ChainedDriver``) on the
CPU, where the program runs eagerly.

On the frames of tests/test_torch_chained.py's sequence (320x192, 1 moving
object, 0.15 px flow noise), with a window BA between two steps:

- at depths 2 and 3, every call of the program writes the same state,
  provenance and output, bit for bit, as a direct call of
  ``build_chained_step`` on the state and provenance it started from and
  the same bundle and draws; the program holds the driver's state, and
  the step after the window starts from the window's refined pose and the
  identity provenance;
- ``_set_pose`` and ``_rebase_identity`` write the program's buffers in
  place (their ``data_ptr()`` stays);
- two chained drivers (one a frame behind the other) and a resident
  driver, interleaved in one process, hand the shared programs over
  without disturbing each other: each map equals, bit for bit, the map
  of the same frames run alone.

This file imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sdpl_slam_torch.models import chained as tch
from sdpl_slam_torch.models.resident import ResidentState
from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.utils.synthetic import (SynthConfig, SynthSequence,
                                             synth_settings)

torch.set_num_threads(2)

N = 6                      # frames; the window of frame 4 runs at frame 5


def _cfg():
    return SynthConfig(n_frames=N + 1, n_objects=1, width=320, height=192,
                       noise_flow=0.15)


def _settings(chained=True, depth=2, window=True):
    s = synth_settings(_cfg())
    s.run_local_ba = window         # window 5, overlap 2: fires at frame 4
    s.run_global_ba = False
    s.pipelined_tracking = False
    s.chained_tracking = chained
    s.resident_tracking = not chained
    s.chained_depth = depth
    return s


def _track(system, seq, t):
    f = seq.frame(t)
    nxt = seq.frame(t + 1) if t + 1 < N else None
    system.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
                      t * 0.1, N, line_detections=f.lines,
                      next_image=None if nxt is None else nxt.gray)


def _direct(prog, state, prov, inp):
    """``build_chained_step`` called on ``state`` / ``prov`` and the
    program's inputs: the bundle, and the GT tables and draws decoded
    from its aux buffer."""
    drv = prog.owner
    tr = drv.tr
    step = tch.build_chained_step(tr.cfg, tr.K, drv.caps, drv._hw,
                                  depth=drv.depth)
    aux, o, a = inp["aux"].numpy(), 0, {}
    for name, shape in tch.chained_aux_spec(drv.caps, tr.n_hyp_cam,
                                            tr.n_hyp_obj):
        n = int(np.prod(shape))
        a[name] = torch.from_numpy(aux[o:o + n].reshape(shape).copy())
        o += n
    args = (inp["bundle"], a["gt_prev"].to(torch.int32),
            a["gt_cur"].to(torch.int32), a["u_cam"], a["u_obj"])
    if drv.depth >= 3:
        return step(state, prov, *args)
    new_state, out, syncs = step(state, *args)
    return new_state, {}, out, syncs


@pytest.mark.parametrize("depth", [2, 3])
def test_program_equals_direct_step(depth, monkeypatch):
    seq = SynthSequence(_cfg())
    call, refined, rows = tch.ChainedProgram.__call__, [], []
    run_ba = tch.ChainedDriver._run_partial_ba

    def windowed(drv, f_id):
        run_ba(drv, f_id)
        refined.append(f_id)

    def checked(prog):
        drv = prog.owner
        # the program holds the driver's state and provenance
        assert all(a.data_ptr() == b.data_ptr()
                   for a, b in zip(prog.held(), drv._held()))
        state = ResidentState(*(t.clone() for t in prog.state))
        prov = {k: t.clone() for k, t in prog.prov.items()}
        inp = {k: t.clone() for k, t in prog.inp.items()}
        if refined and refined[-1] == drv.tr.f_id - 1:
            # the step after the window: refined pose, identity provenance
            want = np.linalg.inv(drv.tr.map.camera_poses[-1])
            np.testing.assert_array_equal(state.pose.numpy(),
                                          want.astype(np.float32))
            assert torch.equal(state.s_asso, torch.arange(drv.caps["NS"],
                                                          dtype=torch.int32))
            assert (state.o_cand == -1).all()
            if depth == 3:
                assert (prov["c2_l"] == -1).all()
        syncs = call(prog)
        new_state, new_prov, out, want_syncs = _direct(prog, state, prov, inp)
        bad = [name for name, a, b in zip(ResidentState._fields, new_state,
                                          prog.state) if not torch.equal(a, b)]
        bad += [k for k in new_prov if not torch.equal(new_prov[k],
                                                       prog.prov[k])]
        rows.append((drv.tr.f_id, bad, torch.equal(out, prog.out),
                     syncs == want_syncs))
        return syncs

    monkeypatch.setattr(tch.ChainedProgram, "__call__", checked)
    monkeypatch.setattr(tch.ChainedDriver, "_run_partial_ba", windowed)
    s = System(_settings(depth=depth), verbose=False, device="cpu")
    for t in range(N):
        _track(s, seq, t)
    assert refined == [4]
    assert [r[0] for r in rows] == list(range(1, N))
    assert all(not bad and same and syncs for _, bad, same, syncs in rows), rows
    prog = s.tracker._res.prog
    assert isinstance(prog, tch.ChainedProgram) and not prog.graph
    assert sorted(prog.prov) == ([] if depth == 2 else sorted(
        tch.identity_prov(s.tracker._res.caps, "cpu")))
    assert s.map.n_frames == N and s.tracker.ba_runs[0]["frame"] == 4


def test_pose_and_rebase_write_in_place():
    """A depth-3 driver mid-run: the window's pose and the rebase to the
    identity land in the program's buffers, which keep their addresses,
    and the next step runs from them."""
    seq = SynthSequence(_cfg())
    s = System(_settings(depth=3, window=False), verbose=False, device="cpu")
    for t in range(3):
        _track(s, seq, t)
    drv = s.tracker._res
    prog = drv.prog
    assert drv.pending and prog.owner is drv
    ptrs = [t.data_ptr() for t in prog.held()]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.5, -0.25, 2.0)
    drv.drain_all()                     # rebases to the identity
    drv._set_pose(pose)
    assert [t.data_ptr() for t in prog.held()] == ptrs
    assert [t.data_ptr() for t in drv._held()] == ptrs
    np.testing.assert_array_equal(prog.state.pose.numpy(), pose)
    for fam, cap in tch._FAMS:
        ident = torch.arange(drv.caps[cap], dtype=torch.int32)
        assert torch.equal(getattr(prog.state, f"{fam}_asso"), ident)
        assert (getattr(prog.state, f"{fam}_cand") == -1).all()
        assert torch.equal(prog.prov[f"a2_{fam}"], ident)
        assert (prog.prov[f"c2_{fam}"] == -1).all()
    _track(s, seq, 3)
    assert [t.data_ptr() for t in prog.held()] == ptrs


def _assert_same(a, b, what):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, "%s[%d]" % (what, k))
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)


def _assert_same_map(a, b):
    for f in dataclasses.fields(a):
        if f.name not in ("frame_times", "lba_times"):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f.name)


def test_drivers_hand_programs_over():
    """Chained drivers A and B (B a frame behind) share one program; a
    resident driver R has its own.  Interleaved, each map equals its run
    alone, bit for bit, and the last driver to run holds the program."""
    seq = SynthSequence(_cfg())
    alone = {}
    for name, chained in (("chained", True), ("resident", False)):
        s = System(_settings(chained, window=False), verbose=False,
                   device="cpu")
        for t in range(N):
            _track(s, seq, t)
        alone[name] = s.map
    A, B, R = (System(_settings(chained, window=False), verbose=False,
                      device="cpu") for chained in (True, True, False))
    for t in range(N + 1):
        if t < N:
            _track(A, seq, t)
            _track(R, seq, t)
        if t >= 1:
            _track(B, seq, t - 1)
    for m, ref in ((A.map, alone["chained"]), (B.map, alone["chained"]),
                   (R.map, alone["resident"])):
        assert m.n_frames == N
        _assert_same_map(m, ref)
    # B ran last: it holds the shared program, A kept a copy of its own
    progs = [A.tracker._res.prog, B.tracker._res.prog]
    assert progs[0] is None and progs[1].owner is B.tracker._res
