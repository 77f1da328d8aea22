"""The span recorder of sdpl_slam_torch (``utils/trace.py``) on the CPU:
off it hands out one null context and keeps nothing; on it keeps spans
with their parents, frame ids and counters; and a chained run keeps the
chained loop's seven sections, contiguous, with the wait for the
detectors inside the selection section, and ``ChainedDriver.perf`` as the
bench reads it."""

import numpy as np
import pytest
import torch

from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.utils import trace
from sdpl_slam_torch.utils.synthetic import (SynthConfig, SynthSequence,
                                             synth_settings)

torch.set_num_threads(2)

SECTIONS = ["chained." + k for k in (
    "dispatch_det", "drain", "planes", "families", "selection",
    "families_pack", "dispatch_step")]
N = 5                          # frames tracked; 1-4 chained


def test_off_hands_out_one_null_context_and_records_nothing():
    with trace.enabled(False):
        trace.collect()
        a, b = trace.span("frame", f_id=3), trace.span("graph.launch",
                                                        kind="step")
        assert a is b and trace.section("chained.drain", {}) is a
        with a:
            trace.count("detector.sync_detects")
        assert trace.device_span("step", torch.device("cpu")) is a
        assert trace.stamps("step", [dict(path="step/0.seg")],
                            torch.device("cpu")) is None
        rec = trace.collect()
    assert rec["spans"] == [] and rec["counters"] == {}
    assert rec["device"] == [] and rec["graphs"] == {}


def test_on_keeps_nesting_parents_frame_ids_and_counters():
    perf = {}
    with trace.enabled():
        with trace.span("frame", f_id=7):
            with trace.section("chained.drain", perf):
                with trace.span("detector.take"):
                    trace.count("detector.sync_detects")
            with trace.section("chained.planes", perf):
                trace.count("detector.sync_detects", 2)
        with trace.span("outside", kind="x"):
            pass
        rec = trace.collect()
    names = [s.name for s in rec["spans"]]
    assert names == ["frame", "chained.drain", "detector.take",
                     "chained.planes", "outside"]
    frame, drain, take, planes, outside = rec["spans"]
    assert (frame.parent, drain.parent, take.parent, planes.parent) == (
        -1, 0, 1, 0)
    assert all(s.f_id == 7 and s.frame == 0 for s in rec["spans"][:4])
    assert outside.f_id is None and outside.frame == -1
    assert outside.kind == "x" and not outside.profiled
    assert planes.start_ns == drain.end_ns          # sections tile
    assert all(s.start_ns <= s.end_ns for s in rec["spans"])
    assert frame.start_ns <= drain.start_ns and planes.end_ns <= frame.end_ns
    assert rec["counters"] == {"detector.sync_detects": 3}
    assert sorted(perf) == ["drain", "planes"]
    assert perf["drain"] == [(drain.end_ns - drain.start_ns) * 1e-6]
    assert trace.collect()["spans"] == []            # collected: cleared
    with trace.enabled():
        with trace.span("frame", f_id=8):
            trace.start()                            # cleared while open
            with trace.span("detector.take"):
                trace.count("detector.sync_detects")
        rec = trace.collect()
    assert [(s.name, s.parent, s.f_id) for s in rec["spans"]] == [
        ("detector.take", -1, None)]
    assert rec["counters"] == {"detector.sync_detects": 1}


def test_a_span_enters_the_profilers_range_while_one_runs():
    from torch.profiler import ProfilerActivity, profile

    for on in (False, True):
        with trace.enabled(on):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with trace.span("frame", f_id=0):
                    torch.ones(3).sum()
            rec = trace.collect()
        names = [e.name for e in prof.events()]
        assert "frame" in names, on
        assert [s.profiled for s in rec["spans"]] == ([True] if on else [])


def _chained_run(hints: bool):
    cfg = SynthConfig(n_frames=N + 1, n_objects=1, width=320, height=192,
                      noise_flow=0.15)
    seq = SynthSequence(cfg)
    s = synth_settings(cfg)
    s.run_local_ba = s.run_global_ba = False
    s.chained_tracking = True
    system = System(s, verbose=False, device="cpu")
    with trace.enabled():
        for t in range(N):
            f = seq.frame(t)
            nxt = [seq.frame(t + i).gray if hints and t + i < N else None
                   for i in (1, 2)]
            system.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                              f.obj_rows, t * 0.1, N, next_image=nxt[0],
                              next_image2=nxt[1])
        system.tracker.flush()
        rec = trace.collect()
    return system, rec


@pytest.fixture(scope="module", params=[True, False], ids=["ahead", "sync"])
def chained(request):
    return request.param, _chained_run(request.param)


def test_chained_perf_has_the_seven_sections_a_chained_frame(chained):
    _, (system, _) = chained
    perf = system.tracker._res.perf
    assert list(perf) == [k.partition(".")[2] for k in SECTIONS]
    assert all(len(v) == N - 1 for v in perf.values())
    assert all(x >= 0 for v in perf.values() for x in v)


def test_chained_sections_tile_each_chained_frame(chained):
    _, (_, rec) = chained
    spans = rec["spans"]
    frames = [i for i, s in enumerate(spans) if s.name == "frame"]
    assert [spans[i].f_id for i in frames] == list(range(N))
    for i in frames[1:]:
        secs = [s for s in spans if s.parent == i
                and s.name.startswith("chained.")]
        assert [s.name for s in secs] == SECTIONS
        assert all(b.start_ns == a.end_ns for a, b in zip(secs, secs[1:]))
        assert spans[i].start_ns <= secs[0].start_ns
        assert secs[-1].end_ns <= spans[i].end_ns
        assert all(s.f_id == spans[i].f_id for s in secs)
        step = [s for s in spans if s.name == "chained_step"
                and spans[s.parent].name == "chained.dispatch_step"
                and s.frame == i]
        assert len(step) == 1


def test_detector_take_nests_in_the_selection_section(chained):
    hints, (_, rec) = chained
    spans = rec["spans"]
    takes = [s for s in spans if s.name == "detector.take"
             and spans[s.frame].f_id > 0]
    assert len(takes) == N - 1
    for s in takes:
        up = s
        while spans[up.parent].name != "frame":
            up = spans[up.parent]
        assert up.name == "chained.selection"
    # frames 0 and 1 run their detectors at once (the host path's frame 0
    # dispatches none ahead for a chained frame); with the next images
    # given, each chained frame dispatches frames t+1 and t+2
    sync = rec["counters"].get("detector.sync_detects", 0)
    assert sync == (2 if hints else N)
    lines = [s for s in spans if s.name == "detector.lines"]
    assert len(lines) == sync                      # timed: synchronous only
    assert np.all([spans[s.parent].name == "detector.dispatch"
                   for s in lines])
