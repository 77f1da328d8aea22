"""The span recorder of sdpl_slam_torch (``utils/trace.py``) on a CUDA
card: a stitched graph's stamp nodes count a WHILE loop's iterations and
time its items within the launch's event interval; with the recorder off
the stitched graph has the nodes it had before stamps existed; device
spans land on the host's clock after the ``graph.launch`` span that
launched them; and a chained run's step graph is timed from inside.
Skipped where there is no card.  This file imports no JAX:

    python -m pytest tests/test_torch_trace_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from sdpl_slam_torch.utils import trace
from sdpl_slam_torch.utils.cuda_graphs import (GraphRecorder, host_while,
                                               loop_runner, run_loop)

ITERS = 37


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _loop_graph(cuda, iters=ITERS, n=512):
    """A stitched graph: a segment, a WHILE loop of ``iters`` matrix
    products, a segment; -> (graph, the counter, what it keeps alive)."""
    a = torch.randn(n, n, device=cuda) / n ** 0.5
    x = torch.randn(n, n, device=cuda)
    i = torch.zeros((), dtype=torch.int32, device=cuda)
    flag = torch.ones((), dtype=torch.bool, device=cuda)

    def fn():
        i.zero_()
        flag.fill_(True)
        x.mul_(0.5)

        def body():
            x.copy_(torch.tanh(a @ x))
            i.add_(1)
            flag.copy_(i < iters)

        assert run_loop(body, flag, "test.loop")
        x.add_(1.0)

    with loop_runner(host_while):          # warm-up outside the capture
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    rec = GraphRecorder()
    with torch.cuda.stream(side):
        with rec, loop_runner(rec.loop):
            fn()
    torch.cuda.synchronize()
    return rec.stitch("test"), i, (a, x, flag)


def _parent_node_total(graph) -> int:
    """The node total of the graph as built without stamps: a segment is a
    child-graph node holding its capture; a loop is its condition kernel,
    the WHILE node and, in the body, its items and a condition kernel."""
    def total(items):
        n = 0
        for it in items:
            if it[0] == "seg":
                if graph._node_count(it[1]):
                    n += 1 + sum(graph._node_types(it[1]).values())
            else:
                n += 3 + total(it[1])
        return n
    return total(graph._items)


@pytest.mark.gpu
def test_body_runs_are_the_loops_iterations(cuda):
    with trace.enabled():
        graph, i, keep = _loop_graph(cuda)
        assert [it["path"] for it in graph.stamps.items] == [
            "test/0.seg", "test/1.test.loop", "test/1.test.loop/body",
            "test/1.test.loop/body/0.seg", "test/2.seg"]
        for _ in range(3):
            graph.launch()
        rec = trace.collect()
    assert int(i) == ITERS
    launches = [d for d in rec["device"] if d.kind == "test"]
    assert len(launches) == 3
    for d in launches:
        assert d.runs == [1, 1, ITERS, ITERS, 1]
        assert all(ns > 0 for ns in d.ns)
        # the loop holds its body's runs; the body its segment's
        assert d.ns[1] >= d.ns[2] >= d.ns[3]
    g = rec["graphs"]["test"]
    assert g["launches"] == 3 and g["runs"][2] == 3 * ITERS


@pytest.mark.gpu
def test_stamped_items_sum_to_the_launch_interval(cuda):
    with trace.enabled():
        graph, _, keep = _loop_graph(cuda, iters=200, n=1024)
        for _ in range(5):
            graph.launch()
        torch.cuda.synchronize()
        rec = trace.collect()
    for d in rec["device"]:
        top = d.ns[0] + d.ns[1] + d.ns[4]           # the top-level items
        assert abs(top / (d.end_ns - d.start_ns) - 1) < 0.05, (
            top, d.end_ns - d.start_ns)


@pytest.mark.gpu
def test_off_the_graph_has_the_nodes_it_had_before_stamps(cuda):
    with trace.enabled(False):
        off, _, keep_off = _loop_graph(cuda)
    with trace.enabled():
        on, _, keep_on = _loop_graph(cuda)
        trace.collect()
    assert off.stamps is None and on.stamps is not None
    assert off.node_counts() == on.node_counts()
    assert off.node_total == _parent_node_total(off)
    assert on.node_total == off.node_total + 2 * len(on.stamps.items)
    # a graph without a loop is timed whole by its device span: no stamps
    x = torch.ones(64, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with trace.enabled():
        rec = GraphRecorder()
        with torch.cuda.stream(side):
            with rec:
                x.mul_(2.0)
        torch.cuda.synchronize()
        straight = rec.stitch("straight")
        straight.launch()
        got = trace.collect()
    assert straight.stamps is None
    assert straight.node_total == _parent_node_total(straight)
    assert [(d.kind, d.ns) for d in got["device"]] == [("straight", None)]


@pytest.mark.gpu
def test_device_spans_start_after_their_launch_span(cuda):
    with trace.enabled():
        graph, _, keep = _loop_graph(cuda)
        for k in range(6):
            graph.launch()
            if k % 2:
                torch.cuda.synchronize()     # idle and busy streams both
        rec = trace.collect()
    spans = rec["spans"]
    assert len(rec["device"]) == 6
    for d in rec["device"]:
        launch = spans[d.launch]
        assert launch.name == "graph.launch" and launch.kind == "test"
        assert d.start_ns >= launch.start_ns - 50_000
        assert d.end_ns >= d.start_ns
    (h0, d0), (h1, d1) = rec["anchors"][0], rec["anchors"][-1]
    assert abs((h1 - h0) - (d1 - d0)) < 100_000        # the clocks' drift


@pytest.mark.gpu
def test_chained_step_is_timed_from_inside(cuda):
    """A chained run on the card with the recorder on from the start: each
    step launch carries its stamped items, whose top level covers its
    event interval; the LM loops ran; and the chained sections, the
    detector wait and the launches are spans of the frames."""
    from sdpl_slam_torch.models.system import System
    from sdpl_slam_torch.utils.synthetic import (SynthConfig, SynthSequence,
                                                 slice_settings)

    seq = SynthSequence(SynthConfig(n_frames=8, n_objects=2,
                                    noise_flow=0.1))
    s = slice_settings(seq.cfg)
    s.chained_tracking = True
    s.run_local_ba = s.run_global_ba = False
    with trace.enabled():
        sys_ = System(s, verbose=False)
        n = seq.n_frames - 1
        for t in range(n):
            f = seq.frame(t)
            nxt = [seq.frame(t + k).gray if t + k < n else None
                   for k in (1, 2)]
            sys_.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                            f.obj_rows, t * 0.1, n, next_image=nxt[0],
                            next_image2=nxt[1])
        sys_.tracker.flush()
        rec = trace.collect()
    spans = rec["spans"]
    steps = [d for d in rec["device"] if d.kind == "step"]
    assert len(steps) == n - 1 and all(d.ns is not None for d in steps)
    items = rec["graphs"]["step"]["items"]
    names = {it["name"] for it in items if it["kind"] == "loop"}
    assert "flow_pose.lm" in names, names
    top = [i for i, it in enumerate(items) if it["depth"] == 0
           and it["kind"] in ("seg", "loop")]
    bodies = [i for i, it in enumerate(items) if it["kind"] == "body"]

    def ancestors(x):
        while x.parent >= 0:
            x = spans[x.parent]
            yield x.name

    for d in steps:
        got = sum(d.ns[i] for i in top)
        assert abs(got / (d.end_ns - d.start_ns) - 1) < 0.05
        assert sum(d.runs[i] for i in bodies) > 0
        launch = spans[d.launch]
        assert launch.name == "graph.launch" and launch.kind == "step"
        assert d.start_ns >= launch.start_ns - 50_000
        assert "chained.dispatch_step" in ancestors(launch)
    kinds = {d.kind for d in rec["device"]}
    assert {"step", "detector.lines"} <= kinds, kinds
    takes = [x for x in spans if x.name == "detector.take"
             and "chained.selection" in ancestors(x)]
    assert len(takes) == n - 1
    assert np.all([x.f_id == spans[x.frame].f_id for x in takes])
