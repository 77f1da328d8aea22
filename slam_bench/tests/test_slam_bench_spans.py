"""The readers of the program's own spans (``slam_bench/spans.py`` and
``metrics/step.*.py``, ``metrics/detector.take_ms.py``) on a hand-built
record of what the program's span recorder keeps of a traced run."""

import pytest

from slam_bench import spec


def _program_rec():
    """What the program's span recorder keeps of a traced run: a warm-up
    sequence, the window's sequence (frame 0 on the host path, frames 1
    and 2 chained) and a profiled stretch, with a step launch in every
    chained frame.  Window: takes of 1 and 3 ms, launches of 0.2 and 0.4
    ms, the steps 5 and 7 ms behind their launch, LMs of 10 and 20 ms
    over 12 and 20 iterations."""
    from sdpl_slam_torch.utils.trace import DeviceSpan, Span

    spans, device, ms = [], [], 1_000_000
    items = [dict(path="step/0.seg", name="seg", kind="seg", depth=0,
                  nodes=10),
             dict(path="step/1.flow_pose.lm", name="flow_pose.lm",
                  kind="loop", depth=0, nodes=40),
             dict(path="step/1.flow_pose.lm/body", name="flow_pose.lm",
                  kind="body", depth=0, nodes=40),
             dict(path="step/1.flow_pose.lm/body/0.seg", name="seg",
                  kind="seg", depth=1, nodes=40),
             dict(path="step/2.seg", name="seg", kind="seg", depth=0,
                  nodes=5)]

    def add(name, t0, t1, parent=-1, kind=None, f_id=None, profiled=False):
        frame = len(spans) if name == "frame" else spans[parent].frame
        f = f_id if name == "frame" else spans[parent].f_id
        spans.append(Span(name, t0, t1, parent, frame, f, kind, profiled))
        return len(spans) - 1

    def frame(t, f_id, take_ms, launch_ms=None, queue_ms=0.0, lm=(0, 0),
              profiled=False):
        fr = add("frame", t, t + 30 * ms, f_id=f_id, profiled=profiled)
        if launch_ms is None:                 # the host path's frame 0
            run_ = add("detector.run", t, t + 5 * ms, fr)
            add("detector.take", t + ms, t + ms + int(take_ms * ms), run_)
            return
        sel = add("chained.selection", t + 2 * ms, t + 10 * ms, fr)
        add("detector.take", t + 3 * ms, t + 3 * ms + int(take_ms * ms), sel)
        disp = add("chained.dispatch_step", t + 10 * ms, t + 12 * ms, fr)
        step = add("chained_step", t + 10 * ms, t + 12 * ms, disp)
        s0 = t + 11 * ms
        launch = add("graph.launch", s0, s0 + int(launch_ms * ms), step,
                     kind="step")
        d0 = s0 + int(queue_ms * ms)
        device.append(DeviceSpan("step", d0, d0 + 25 * ms, launch,
                                 [ms, lm[0] * ms, lm[0] * ms - 1, ms, ms],
                                 [1, 1, lm[1], lm[1], 1]))

    frame(0, 0, 9.0)                                        # warm-up
    frame(40 * ms, 1, 9.0, 9.0, 9.0, (90, 90))
    frame(100 * ms, 0, 0.5)                                 # the window
    frame(140 * ms, 1, 1.0, 0.2, 5.0, (10, 12))
    frame(180 * ms, 2, 3.0, 0.4, 7.0, (20, 20))
    frame(300 * ms, 0, 9.0)                                 # the stretch
    frame(340 * ms, 1, 9.0, 9.0, 9.0, (90, 90), profiled=True)
    return dict(frames=3, program_records=dict(
        spans=spans, device=device, counters={}, anchors=[],
        graphs={"step": dict(items=items, launches=4, ns=[], runs=[])}))


@pytest.mark.parametrize("name,value", [
    ("step.loop_ms", (10.0 + 20.0) / 2),
    ("step.lm_iters", (12 + 20) / 2),
    ("step.queue_ms", (5.0 + 7.0) / 2),
    ("step.launch_ms", (0.2 + 0.4) / 2),
    ("detector.take_ms", (1.0 + 3.0) / 2),
])
def test_program_span_readers(name, value):
    """The readers of the program's spans take the window's sequence alone
    (not the warm-up before it, nor the profiled stretch after it), and
    read nothing where the program has no recorder."""
    read = spec.Benchmark().reader(name)
    assert read(_program_rec()) == pytest.approx(value)
    assert read(dict(frames=3, program_records=None)) is None
