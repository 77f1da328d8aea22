"""sdpl_slam_torch on a CUDA card: the FAST kernel against its plain
version, the tracking slice on the card against the same slice on the
CPU, the window BA on the card run twice, the line detector on the card
against the CPU, frames from disk with nothing injected, the resident loop
against the host path, the resident loop's captured graph against its
eager step and without a synchronising call, the pipelined and chained
paths on the card, the dense-Schur window BA run twice, the fused BA
programs against their eager plain versions, the host path's
fused-frame and detector programs' graphs against their eager twins,
without a synchronising call or an LM host read, and the chained step's
and the non-joint frame's graphs against their eager twins, likewise;
the flagship entry on the card against the CPU; the bench's
device-exec probe leaving the chained program as it found it; and the
host-to-card copies of ``utils.device.copy_in``.
Skipped where there is no card.  This file imports no JAX, so it runs on
a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.ops import fast as tf
from sdpl_slam_torch.utils import trace
from sdpl_slam_torch.utils.synthetic import (SynthSequence, kitti_config,
                                             slice_settings)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def seq():
    return SynthSequence(kitti_config(n_frames=3))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain(cuda, seq):
    """Every pyramid level of two KITTI frames in one launch: kernel ==
    plain, bit-exact (same differences, same in-order SAD)."""
    levels = []
    for t in range(2):
        img = torch.from_numpy(seq.frame(t).gray).float()
        h, w = img.shape
        levels += [(img if lvl == 0 else tf.resize_linear(img, lh, lw))
                   .contiguous() for lvl, s, lh, lw in tf.pyramid_shapes(h, w)]
    before = tf.fast_score_pyramid.launches
    maps = tf.fast_score_pyramid([lv.to(cuda) for lv in levels], 20.0, 7.0)
    torch.cuda.synchronize()
    assert tf.fast_score_pyramid.launches == before + 1
    for lv, (hi, lo) in zip(levels, maps):
        assert torch.equal(hi.cpu(), tf.fast_score_map_torch(lv, 20.0))
        assert torch.equal(lo.cpu(), tf.fast_score_map_torch(lv, 7.0))


@pytest.mark.gpu
def test_cuda_kernel_odd_shapes(cuda):
    """Levels smaller than a unit, of odd sides and all border, in one
    launch with a KITTI-size one: kernel == plain, bit-exact."""
    rng = np.random.default_rng(5)
    shapes = [(1, 1), (2, 9), (5, 7), (7, 40), (33, 65), (9, 31), (375, 1242)]
    levels = [torch.from_numpy(rng.uniform(0, 255, s).astype(np.float32))
              for s in shapes]
    maps = tf.fast_score_pyramid([lv.to(cuda) for lv in levels], 20.0, 7.0)
    torch.cuda.synchronize()
    for lv, (hi, lo) in zip(levels, maps):
        assert torch.equal(hi.cpu(), tf.fast_score_map_torch(lv, 20.0))
        assert torch.equal(lo.cpu(), tf.fast_score_map_torch(lv, 7.0))


@pytest.mark.gpu
def test_more_levels_than_one_launch_takes(cuda):
    """70 levels: two launches (64 levels each at most), all bit-exact."""
    rng = np.random.default_rng(6)
    levels = [torch.from_numpy(rng.uniform(0, 255, (20 + i, 40 + 3 * i))
                               .astype(np.float32)) for i in range(70)]
    before = tf.fast_score_pyramid.launches
    maps = tf.fast_score_pyramid([lv.to(cuda) for lv in levels], 20.0, 7.0)
    torch.cuda.synchronize()
    assert tf.fast_score_pyramid.launches == before + 2
    for lv, (hi, lo) in zip(levels, maps):
        assert torch.equal(hi.cpu(), tf.fast_score_map_torch(lv, 20.0))
        assert torch.equal(lo.cpu(), tf.fast_score_map_torch(lv, 7.0))


@pytest.mark.gpu
def test_detect_keypoints_batch_on_card(cuda, seq):
    """Two frames through one launch: each frame's keypoints are its
    single-frame detection."""
    imgs = torch.from_numpy(np.stack([seq.frame(t).gray for t in range(2)]))
    before = tf.fast_score_pyramid.launches
    got = tf.detect_keypoints_batch(imgs.to(cuda))
    assert tf.fast_score_pyramid.launches == before + 1
    for b in range(2):
        for g, r in zip(got, tf.detect_keypoints(imgs[b].to(cuda))):
            assert torch.equal(g[b], r)


@pytest.mark.gpu
def test_wrapper_refuses_bad_cuda_input(cuda):
    img = torch.zeros((64, 80), device=cuda)
    with pytest.raises(ValueError):
        tf.fast_score_pyramid([img.double()], 20.0, 7.0)
    with pytest.raises(ValueError):
        tf.fast_score_pyramid([img.t()], 20.0, 7.0)
    with pytest.raises(ValueError):
        tf.fast_score_pyramid([img, img.cpu()], 20.0, 7.0)


@pytest.mark.gpu
def test_copy_in_on_card(cuda):
    """``utils.device.copy_in`` (NumPy fills a pinned block, then a
    non-blocking copy): every array lands in its buffer as a blocking
    copy puts it there, cast to the buffer's dtype, also when the source
    is not contiguous, and the next call's arrays do not overwrite the
    last call's before its copy ran."""
    from sdpl_slam_torch.utils.device import copy_in

    rng = np.random.default_rng(0)
    arrays = [dict(img=rng.integers(0, 256, (375, 1242), np.uint8),
                   vec=rng.standard_normal(186002).astype(np.float32),
                   flow=rng.standard_normal((40, 30, 2))[:, ::2],
                   ok=rng.random(7) < 0.5) for _ in range(2)]
    bufs = [dict(img=torch.empty((375, 1242), dtype=torch.uint8,
                                 device=cuda),
                 vec=torch.empty(186002, device=cuda),
                 flow=torch.empty((40, 15, 2), device=cuda),
                 ok=torch.empty(7, dtype=torch.bool, device=cuda))
            for _ in range(2)]
    torch.cuda._sleep(2 ** 26)          # both copies queue behind it
    for b, a in zip(bufs, arrays):
        copy_in(b, a)
    torch.cuda.synchronize()
    for b, a in zip(bufs, arrays):
        for k, v in a.items():
            want = torch.as_tensor(np.ascontiguousarray(v)).to(
                cuda, b[k].dtype)
            assert torch.equal(b[k], want), k


@pytest.mark.gpu
def test_slice_on_card_matches_cpu(cuda, seq):
    """Three KITTI-scale frames through System on the card and on the CPU:
    the same RANSAC draws on both, so poses agree to f32 rounding and the
    label streams are identical."""
    maps = {}
    for dev in ("cuda", "cpu"):
        s = System(slice_settings(seq.cfg), verbose=False, device=dev)
        for t in range(3):
            f = seq.frame(t)
            s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                         f.obj_rows, t * 0.1, 3, line_detections=f.lines)
        maps[dev] = s.map
    for a, b in zip(maps["cuda"].camera_poses, maps["cpu"].camera_poses):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert maps["cuda"].rm_labels == maps["cpu"].rm_labels


@pytest.mark.gpu
def test_resident_on_card_matches_host(cuda, seq):
    """Three KITTI-scale frames with ``resident_tracking`` on the card
    against the host path on the card: identical label streams, poses to
    f32 rounding, one FAST launch a frame."""
    maps = {}
    for resident in (False, True):
        settings = slice_settings(seq.cfg)
        settings.resident_tracking = resident
        s = System(settings, verbose=False)
        before = tf.fast_score_pyramid.launches
        for t in range(3):
            f = seq.frame(t)
            s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                         f.obj_rows, t * 0.1, 3)
        maps[resident] = s.map
        assert tf.fast_score_pyramid.launches == before + 3
    for a, b in zip(maps[True].camera_poses, maps[False].camera_poses):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert maps[True].rm_labels == maps[False].rm_labels


@pytest.mark.gpu
def test_pipelined_and_chained_on_card(cuda, seq):
    """The fixture's KITTI-scale frames on the card: the pipelined host path
    with the next frames' images as hints gives the synchronous map bit for
    bit, and the chained loop (depth 2) the same label streams and poses
    within tests/test_chained.py's gates; one FAST launch a frame on each."""
    maps, n = {}, seq.n_frames
    for mode in ("sync", "pipelined", "chained"):
        settings = slice_settings(seq.cfg)
        settings.pipelined_tracking = mode == "pipelined"
        settings.chained_tracking = mode == "chained"
        s = System(settings, verbose=False)
        before = tf.fast_score_pyramid.launches
        for t in range(n):
            f = seq.frame(t)
            nxt = [seq.frame(k).gray if k < n else None
                   for k in (t + 1, t + 2)]
            s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                         f.obj_rows, t * 0.1, n, next_image=nxt[0],
                         next_image2=nxt[1])
        maps[mode] = s.map
        assert tf.fast_score_pyramid.launches == before + n, mode
    for a, b in zip(maps["sync"].camera_poses, maps["pipelined"].camera_poses):
        np.testing.assert_array_equal(a, b)
    assert maps["sync"].rm_labels == maps["pipelined"].rm_labels
    assert maps["sync"].rm_labels == maps["chained"].rm_labels
    for a, b in zip(maps["sync"].camera_poses, maps["chained"].camera_poses):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.02


@pytest.mark.gpu
def test_window_ba_on_card_is_deterministic(cuda, seq):
    """The window BA on the same map twice on the card: the scatter-adds
    sum in a fixed order, so cost, iterations and poses are identical."""
    import copy

    from sdpl_slam_torch.ops.geometry import Intrinsics
    from sdpl_slam_torch.solvers import ba_builder
    from sdpl_slam_torch.solvers import batch_ba as bb

    s = System(slice_settings(seq.cfg), verbose=False, device="cuda")
    for t in range(3):
        f = seq.frame(t)
        s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
                     t * 0.1, 3, line_detections=f.lines)
    K = Intrinsics.from_config(s.settings)
    runs = []
    for _ in range(2):
        m = copy.deepcopy(s.map)
        before = (bb.run_ba.iterations, bb.run_ba.cg_iterations)
        cost = ba_builder.partial_batch_optimization(
            m, K, 3, s.settings, use_lines=s.settings.use_lines,
            device="cuda")
        runs.append((cost, bb.run_ba.iterations - before[0],
                     bb.run_ba.cg_iterations - before[1],
                     np.stack(m.camera_poses), np.stack(m.stat_3d[-1])))
    (c0, i0, g0, p0, x0), (c1, i1, g1, p1, x1) = runs
    assert np.isfinite(c0) and i0 > 0
    assert (c0, i0, g0) == (c1, i1, g1)
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_array_equal(x0, x1)


@pytest.mark.gpu
def test_schur_window_on_card_is_deterministic(cuda, seq):
    """The window BA by the dense-Schur step (``ba_schur``) on the same map
    twice on the card: identical cost, iterations and poses; and the
    card's final cost within 1e-2 of the CPU's (chip_smoke.BA_COST_RTOL:
    two sound float32 LM runs stop some steps apart under the window's
    1e-3 gain rule)."""
    import copy
    import dataclasses

    from sdpl_slam_torch.ops.geometry import Intrinsics
    from sdpl_slam_torch.solvers import ba_builder, schur_ba

    s = System(slice_settings(seq.cfg), verbose=False, device="cuda")
    for t in range(3):
        f = seq.frame(t)
        s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
                     t * 0.1, 3, line_detections=f.lines)
    cfg = dataclasses.replace(s.settings, ba_schur=True)
    K = Intrinsics.from_config(cfg)
    runs = []
    for dev in ("cuda", "cuda", "cpu"):
        m = copy.deepcopy(s.map)
        before = schur_ba.run_ba_schur.iterations
        cost = ba_builder.partial_batch_optimization(
            m, K, 3, cfg, use_lines=cfg.use_lines, device=dev)
        runs.append((cost, schur_ba.run_ba_schur.iterations - before,
                     np.stack(m.camera_poses), np.stack(m.dyn_3d[-1])))
    (c0, i0, p0, x0), (c1, i1, p1, x1), (c2, i2, _, _) = runs
    assert np.isfinite(c0) and i0 > 0 and i2 > 0
    assert (c0, i0) == (c1, i1)
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_array_equal(x0, x1)
    assert abs(c0 - c2) <= 1e-2 * abs(c2), (c0, c2)


def _match_frac(a, b, tol=0.5):
    """Share of ``a`` with a segment of ``b`` whose endpoints both lie
    within ``tol`` px, in either order."""
    if len(a) == 0:
        return 1.0
    if len(b) == 0:
        return 0.0
    best = np.inf
    for other in (b, b[:, [2, 3, 0, 1]]):
        d = (a[:, None, :] - other[None, :, :]).reshape(len(a), len(b), 2, 2)
        best = np.minimum(best, np.sqrt((d ** 2).sum(-1)).max(-1))
    return float((best.min(1) < tol).mean())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1])
def test_detect_lines_on_card_matches_cpu(cuda, seq, mode):
    """The line detector on a KITTI-size frame on the card and on the CPU:
    both endpoints within 0.5 px for at least 80 % of either set (measured
    92-98 % on an H100: the generator's strokes sit on integer pixels,
    where rounded lookups and threshold compares tie, and the card sums in
    another order), and the card's own two runs identical."""
    from sdpl_slam_torch.ops import lines

    cfg = lines.LineDetectConfig(max_lines=800, min_length=8.0, mode=mode)
    gray = seq.frame(0).gray
    on_card = lines.detect_lines_np(gray, cfg, device=cuda)
    on_cpu = lines.detect_lines_np(gray, cfg, device="cpu")
    assert len(on_card) >= 10
    assert _match_frac(on_card, on_cpu) >= 0.8
    assert _match_frac(on_cpu, on_card) >= 0.8
    np.testing.assert_array_equal(
        lines.detect_lines_np(gray, cfg, device=cuda), on_card)


@pytest.mark.gpu
def test_disk_frames_on_card_match_cpu(cuda, seq, tmp_path):
    """Two frames written to disk and read back through the loader into
    ``System(settings.yaml)`` with nothing injected, on the card (the
    default) and on the CPU: poses within 1e-4, the same static lines."""
    import importlib.util
    from pathlib import Path

    from sdpl_slam_torch.io.dataset import load_sequence
    from sdpl_slam_torch.utils import config

    spec = importlib.util.spec_from_file_location(
        "make_demo_sequence_torch", Path(__file__).resolve().parents[1]
        / "examples" / "make_demo_sequence_torch.py")
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    settings = slice_settings(seq.cfg)
    settings.depth_map_factor = mk.DEPTH_FACTOR
    mk.write_sequence(tmp_path, seq, 3, config.format_overrides(settings))
    loaded = load_sequence(tmp_path)
    maps = {}
    for dev in ("cuda", "cpu"):
        kw = {} if dev == "cuda" else dict(device="cpu")
        s = System(tmp_path / "settings.yaml", verbose=False, **kw)
        assert s.device.type == dev
        before = tf.fast_score_pyramid.launches
        with trace.enabled():
            for i in range(loaded.n_frames):
                s.track_rgbd(*loaded.frame(i), loaded.gt_pose(i),
                             loaded.gt_obj_poses(i),
                             float(loaded.timestamps[i]), loaded.n_frames)
            spans = trace.collect()["spans"]
        assert tf.fast_score_pyramid.launches - before == (
            loaded.n_frames if dev == "cuda" else 0)
        assert sum(x.name == "detector.lines"
                   for x in spans) == loaded.n_frames
        maps[dev] = s.map
    for a, b in zip(maps["cuda"].camera_poses, maps["cpu"].camera_poses):
        np.testing.assert_allclose(a, b, atol=1e-4)
    for a, b in zip(maps["cuda"].line_valid, maps["cpu"].line_valid):
        assert a.sum() > 0 and abs(int(a.sum()) - int(b.sum())) <= 2


def _graph_against_eager(monkeypatch, log, cls=None):
    """Wrap ``cls.__call__`` (``ResidentProgram`` by default, or
    ``ChainedProgram``): before each graph launch an eager twin (the plain
    version) runs the same frame from the same carried state and inputs;
    ``log`` gets which carried buffers (state fields, provenance) differ
    and whether the outputs agree bit for bit."""
    from sdpl_slam_torch.models import resident as res

    cls = cls or res.ResidentProgram
    call, twins = cls.__call__, {}

    def both(prog):
        if not prog.graph:
            return call(prog)
        twin = twins.setdefault(id(prog), prog.eager_twin())
        for dst, src in zip(twin.held(), prog.held()):
            dst.copy_(src)
        for k, t in prog.inp.items():
            twin.inp[k].copy_(t)
        twin()
        syncs = call(prog)
        names = list(res.ResidentState._fields) + sorted(
            getattr(prog, "prov", {}))
        bad = [name for name, a, b in zip(names, twin.held(), prog.held())
               if not torch.equal(a, b)]
        log.append((bad, torch.equal(twin.out, prog.out)))
        return syncs

    monkeypatch.setattr(cls, "__call__", both)


@pytest.mark.gpu
def test_resident_graph_matches_eager_step(cuda, monkeypatch):
    """Six 640x192 resident frames (FAST and the line detector in the
    step): the captured graph's state and output buffers equal the eager
    step's bit for bit on every frame, from the same state; the graph
    reads nothing on the host and launches FAST once a frame, counted per
    replay."""
    from sdpl_slam_torch.utils.synthetic import SynthConfig

    sq = SynthSequence(SynthConfig(n_frames=8, n_objects=2, noise_flow=0.1))
    settings = slice_settings(sq.cfg)
    settings.resident_tracking = True
    s = System(settings, verbose=False)
    log = []
    _graph_against_eager(monkeypatch, log)
    before = tf.fast_score_pyramid.launches
    n = sq.n_frames - 1
    for t in range(n):
        f = sq.frame(t)
        s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
                     t * 0.1, n)
    assert len(log) == n - 1 == 6
    assert all(bad == [] and same_out for bad, same_out in log), log
    assert s.tracker.lm_host_syncs == 0
    # frame 0 on the host path, then one a frame from the graph and one
    # from each eager twin
    assert tf.fast_score_pyramid.launches - before == n + len(log)


@pytest.mark.gpu
def test_resident_graph_frame_makes_no_sync(cuda):
    """A steady resident frame on the card calls no synchronising
    operation (``torch.cuda.set_sync_debug_mode("warn")``): its inputs go
    out through pinned memory, the graph ends both LMs on the device and
    the output comes home behind the stream."""
    import warnings

    from sdpl_slam_torch.utils.synthetic import SynthConfig

    sq = SynthSequence(SynthConfig(n_frames=6, n_objects=2, noise_flow=0.1))
    settings = slice_settings(sq.cfg)
    settings.resident_tracking = True
    s = System(settings, verbose=False)
    n = sq.n_frames - 1
    for t in range(n):
        f = sq.frame(t)
        args = (f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
                t * 0.1, n)
        if t != 3:
            s.track_rgbd(*args)
            continue
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                s.track_rgbd(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    hits = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    assert hits == []
    assert s.tracker.lm_host_syncs == 0


def _tracked_window(seq):
    """The 3 tracked frames' window graph, padded as ``ba_builder`` pads
    it, on the card, with its padded chain tables."""
    from sdpl_slam_torch.ops.geometry import Intrinsics
    from sdpl_slam_torch.solvers import ba_builder

    s = System(slice_settings(seq.cfg), verbose=False, device="cuda")
    for t in range(3):
        f = seq.frame(t)
        s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
                     t * 0.1, 3, line_detections=f.lines)
    g, meta = ba_builder.build_graph(
        s.map, Intrinsics.from_config(s.settings), 0, 3,
        motion_init_identity=False, prior_info=1e7, device="cuda")
    g = ba_builder.pad_graph(g, ba_builder.bucket_sizes(g))
    chains = [ba_builder._padded_chains(int(n), links, 3, None, None)
              for n, links in ((g.Xd0.shape[0], meta["tern_prev"]),
                               (g.Ld_U0.shape[0], meta["ltern_prev"]))]
    return g, chains


@pytest.mark.gpu
@pytest.mark.parametrize("step", ["cg", "schur"])
def test_fused_ba_graph_matches_eager(cuda, seq, step):
    """The fused BA call (one launch of the captured program, the LM loop
    and for CG the CG loop nested in it as WHILE nodes) against the eager
    plain version on the same padded window on the card: state, cost, LM
    and CG iterations bit for bit; one host read a fused call; a second
    call of the same shapes makes no new capture."""
    from sdpl_slam_torch.solvers import batch_ba as bb
    from sdpl_slam_torch.solvers import schur_ba

    g, chains = _tracked_window(seq)
    w = bb.BAWeights()
    kw = dict(max_iters=20, gain_threshold=1e-3)
    counters = bb.run_ba if step == "cg" else schur_ba.run_ba_schur
    if step == "cg":
        es, ec, eit = bb.run_ba(g, w, **kw)
        fused = lambda: bb.run_ba_fused(g, w, **kw)  # noqa: E731
    else:
        es, ec, eit = schur_ba.run_ba_schur(g, w, *chains, **kw)
        fused = lambda: schur_ba.run_ba_fused_schur(  # noqa: E731
            g, w, *chains, 3, int(g.mot_T0.shape[0]), **kw)
    cg0 = bb.run_ba.cg_iterations
    fused()                                   # the first call captures
    eager_cg = bb.run_ba.cg_iterations - cg0
    for _ in range(2):
        before = (counters.host_syncs, bb.BAProgram.captures,
                  bb.run_ba.cg_iterations)
        fs, fc, fit = fused()
        assert counters.host_syncs - before[0] == 1
        assert bb.BAProgram.captures == before[1]
        assert bb.run_ba.cg_iterations - before[2] == eager_cg
        assert fit == eit > 0 and fc == float(ec)
        for a, b in zip(fs, es):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_graph_recorder_nests_while_loops(cuda):
    """A counted loop inside a counted loop, captured by ``GraphRecorder``
    and stitched: the inner WHILE node sits in the outer one's body; one
    launch runs 4 outer iterations of 5 inner each, and a second launch
    the same again."""
    from sdpl_slam_torch.utils.cuda_graphs import (GraphRecorder,
                                                   loop_runner, run_loop)

    outer = torch.zeros((), dtype=torch.int32, device=cuda)
    total = torch.zeros((), dtype=torch.int32, device=cuda)
    o_flag = torch.ones((), dtype=torch.bool, device=cuda)
    keep = []

    def fn():
        outer.zero_()
        total.zero_()
        o_flag.fill_(True)

        def outer_body():
            inner = torch.zeros((), dtype=torch.int32, device=cuda)
            i_flag = torch.ones((), dtype=torch.bool, device=cuda)
            keep.extend((inner, i_flag))

            def inner_body():
                inner.add_(1)
                total.add_(1)
                i_flag.copy_(inner < 5)

            assert run_loop(inner_body, i_flag)
            outer.add_(1)
            o_flag.copy_(outer < 4)

        assert run_loop(outer_body, o_flag)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    rec = GraphRecorder()
    with torch.cuda.stream(side):
        with rec, loop_runner(rec.loop):
            fn()
    graph = rec.stitch()
    assert [type(x) for x in graph.node_counts()] == [int, list, int]
    for _ in range(2):
        graph.launch()
        torch.cuda.synchronize()
        assert (int(outer), int(total)) == (4, 20)


def _host_frames(n_frames=4):
    """A 640x192 sequence of 2 moving objects through the host path on the
    card (FAST and the line detector in the loop, synchronous frames); the
    arguments of each frame's ``Tracking._pack_frame`` are recorded."""
    from sdpl_slam_torch.models.tracking import Tracking
    from sdpl_slam_torch.utils.synthetic import SynthConfig

    sq = SynthSequence(SynthConfig(n_frames=n_frames, n_objects=2,
                                   noise_flow=0.1))
    s = System(slice_settings(sq.cfg), verbose=False)
    rec = []
    pack = Tracking._pack_frame

    def recording(self, *args):
        rec.append((self.f_id, args))
        return pack(self, *args)

    Tracking._pack_frame = recording
    try:
        for t in range(n_frames):
            f = sq.frame(t)
            s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                         f.obj_rows, t * 0.1, n_frames)
    finally:
        Tracking._pack_frame = pack
    return s, sq, rec


@pytest.mark.gpu
def test_frame_program_graph_matches_eager(cuda):
    """The fused-frame program's captured graph against its eager twin on
    the same packed input, bit for bit: the camera only and every bucket
    width up to 16 object lanes (the recorded frame's two lanes cut or
    repeated), each with and without the objects' line terms; a second
    launch of a captured program makes no new capture."""
    from sdpl_slam_torch.models import frame_program as fp

    s, _, rec = _host_frames()
    tr = s.tracker
    assert tr.lm_host_syncs == 0
    f_id, args = rec[-1]
    b = args[-1]
    assert b is not None and b["pt_obs"].shape[0] == 2
    tr.f_id = f_id
    caps = fp.frame_caps(tr)
    for MB in (0, 1, 2, 4, 8, 16):
        cut = None if MB == 0 else {
            k: (np.concatenate([v] * (1 + MB // 2))[:MB]
                if k != "any_lines" else v) for k, v in b.items()}
        flat, mb, _ = tr._pack_frame(*args[:-1], cut)
        assert mb == MB
        for lines in ((False,) if MB == 0 else (False, True)):
            prog = fp.frame_program(tr.cfg, tr.K, caps, MB, lines, cuda)
            twin = prog.eager_twin()
            for p in (prog, twin):
                p.load({"buf": flat})
            captures = fp.FrameProgram.captures
            assert prog() == 0
            prog()
            assert fp.FrameProgram.captures - captures <= 1
            reads = twin()
            assert reads > 0 and torch.equal(prog.out, twin.out), (MB, lines)


@pytest.mark.gpu
def test_detector_program_graph_matches_eager(cuda, seq):
    """The detector program at KITTI scale, captured as two graphs (FAST,
    the line detector) on the detector stream, against its eager twin:
    packed output bit for bit, one FAST launch a replay."""
    from sdpl_slam_torch.models import frame_program as fp

    s = System(slice_settings(seq.cfg), verbose=False, device="cuda")
    tr = s.tracker
    gray = seq.frame(1).gray
    prog = fp.detector_program(gray.shape, gray.dtype, tr._fast_cfg(),
                               tr._line_cfg(), cuda)
    twin = prog.eager_twin()
    stream = fp.detector_stream(cuda)
    with torch.cuda.stream(stream):
        for p in (prog, twin):
            p.load({"img": gray})
        prog()
        before = tf.fast_score_pyramid.launches
        prog()
        assert tf.fast_score_pyramid.launches - before == 1
        twin()
    torch.cuda.synchronize()
    assert prog.graph and len(prog.node_counts) == 2
    assert torch.equal(prog.out, twin.out)


@pytest.mark.gpu
def test_host_frame_programs_make_no_sync(cuda):
    """A steady host-path frame's solve (pack, one copy in, one graph
    launch, the copy home started) and its detectors (two graph launches
    on the detector stream) call no synchronising operation under
    ``torch.cuda.set_sync_debug_mode("warn")``, and the frames' LMs read
    nothing on the host."""
    import warnings

    s, sq, rec = _host_frames()
    tr = s.tracker
    assert tr.lm_host_syncs == 0
    f_id, args = rec[-1]
    tr.f_id = f_id
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            handle = tr._dispatch_detectors(sq.frame(f_id).gray, True, True)
            pulled = tr._solve_frame(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    hits = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    assert hits == []
    assert tr.lm_host_syncs == 0
    from sdpl_slam_torch.utils.device import host_array

    assert tr._take_detections(handle)[0] is not None
    assert np.isfinite(host_array(*pulled[:2])).all()


def _chained_system(depth, n_frames=8, window=True):
    """A 640x192 sequence of 2 moving objects and the chained settings at
    ``depth`` on the card (FAST and the line detector in the loop); with
    ``window`` a window of 4 frames, overlap 2: windows at frames 3 and 5,
    each run at the start of the next frame."""
    from sdpl_slam_torch.utils.synthetic import SynthConfig

    sq = SynthSequence(SynthConfig(n_frames=n_frames, n_objects=2,
                                   noise_flow=0.1))
    settings = slice_settings(sq.cfg)
    settings.chained_tracking = True
    settings.chained_depth = depth
    settings.run_local_ba = window
    settings.window_size, settings.overlap_size = 4, 2
    settings.run_global_ba = False
    return System(settings, verbose=False), sq


def _track_hinted(s, sq, t, n):
    """Frame ``t`` with the next two frames' images as hints (the chained
    driver predispatches their detectors)."""
    f = sq.frame(t)
    nxt = [sq.frame(k).gray if k < n else None for k in (t + 1, t + 2)]
    return s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                        f.obj_rows, t * 0.1, n, next_image=nxt[0],
                        next_image2=nxt[1])


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [2, 3])
def test_chained_graph_matches_eager_step(cuda, monkeypatch, depth):
    """The chained step's captured graph against its eager twin from the
    same state, provenance and inputs, bit for bit on every frame,
    across the window BAs' pose write and the rebase to the identity
    provenance; one capture, no LM host read."""
    from sdpl_slam_torch.models import chained as tch

    s, sq = _chained_system(depth)
    log = []
    _graph_against_eager(monkeypatch, log, tch.ChainedProgram)
    captures = tch.ChainedProgram.captures
    n = sq.n_frames - 1
    for t in range(n):
        _track_hinted(s, sq, t, n)
    assert [(r["kind"], r["frame"]) for r in s.tracker.ba_runs] == [
        ("local", 3), ("local", 5)]
    assert len(log) == n - 1 == 6
    assert all(bad == [] and same_out for bad, same_out in log), log
    assert s.tracker.lm_host_syncs == 0
    assert tch.ChainedProgram.captures - captures == 1
    assert s.tracker._res.prog.graph and s.tracker._res.prog.node_counts


@pytest.mark.gpu
def test_chained_graph_frame_makes_no_sync(cuda):
    """A steady chained frame on the card (host sampling, one load, one
    graph launch, the lagged drain) calls no synchronising operation
    under ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    s, sq = _chained_system(2, n_frames=7, window=False)
    n = sq.n_frames - 1
    for t in range(n):
        if t != 3:
            _track_hinted(s, sq, t, n)
            continue
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _track_hinted(s, sq, t, n)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    hits = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    assert hits == []
    assert s.tracker.lm_host_syncs == 0


def _nonjoint_frames(n_frames=4):
    """``_host_frames`` with ``use_joint_optimization = False``: the
    arguments of each frame's ``Tracking._solve_frame_nonjoint``."""
    from sdpl_slam_torch.models.tracking import Tracking
    from sdpl_slam_torch.utils.synthetic import SynthConfig

    sq = SynthSequence(SynthConfig(n_frames=n_frames, n_objects=2,
                                   noise_flow=0.1))
    settings = slice_settings(sq.cfg)
    settings.use_joint_optimization = False
    s = System(settings, verbose=False)
    rec = []
    solve = Tracking._solve_frame_nonjoint

    def recording(self, *args):
        rec.append((self.f_id, args))
        return solve(self, *args)

    Tracking._solve_frame_nonjoint = recording
    try:
        for t in range(n_frames):
            f = sq.frame(t)
            s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                         f.obj_rows, t * 0.1, n_frames)
    finally:
        Tracking._solve_frame_nonjoint = solve
    return s, rec


@pytest.mark.gpu
def test_nonjoint_program_graph_matches_eager(cuda):
    """The non-joint program's captured graph (camera init, the pose-only
    LM's 130 iterations unrolled, the objects' LM in a WHILE node) against
    its eager twin on the same packed input, bit for bit: the camera only
    and one and two object lanes; a second launch makes no new capture;
    a steady frame's solve calls no synchronising operation and reads no
    LM exit on the host."""
    import warnings

    from sdpl_slam_torch.models import frame_program as fp

    s, rec = _nonjoint_frames()
    tr = s.tracker
    assert tr.lm_host_syncs == 0
    f_id, args = rec[-1]
    b = args[-1]
    assert b is not None and b["pt_obs"].shape[0] == 2
    tr.f_id = f_id
    caps = fp.frame_caps(tr)
    for MB in (0, 1, 2):
        cut = None if MB == 0 else {
            k: (v[:MB] if k != "any_lines" else v) for k, v in b.items()}
        flat, mb, lines = tr._pack_nonjoint(*args[:-1], cut)
        assert mb == MB
        prog = fp.nonjoint_program(tr.cfg, tr.K, caps, MB, lines, cuda)
        twin = prog.eager_twin()
        for p in (prog, twin):
            p.load({"buf": flat})
        captures = fp.FrameProgram.captures
        assert prog() == 0
        prog()
        assert fp.FrameProgram.captures - captures <= 1
        reads = twin()
        assert (reads > 0) == (MB > 0) and torch.equal(prog.out, twin.out), MB
        assert prog.node_counts
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = tr._solve_frame_nonjoint(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    hits = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    assert hits == []
    assert tr.lm_host_syncs == 0
    assert np.isfinite(out["pose"]).all() and out["o_pose"].shape[0] == 2


@pytest.mark.gpu
def test_entry_on_the_card_matches_cpu(cuda):
    """``entry()`` builds its inputs on the card by default, and its solve
    there gives the CPU's pose within the North star's rotation floor
    (0.03 deg) and 1e-4 m, with at most 6 of the 1,200 inlier flags apart
    (a gate tie may round the other way)."""
    from sdpl_slam_torch.entry import entry
    from sdpl_slam_torch.ops import lie

    fn, args = entry()
    assert all(a.is_cuda for a in args)
    pose, inl = (t.cpu() for t in fn(*args))
    fn_c, args_c = entry("cpu")
    pose_c, inl_c = fn_c(*args_c)
    assert torch.isfinite(pose).all()
    r_deg = lie.rotation_angle_deg(pose_c[:3, :3].T @ pose[:3, :3])
    assert float(r_deg) < 0.03
    assert float((pose_c[:3, 3] - pose[:3, 3]).abs().max()) < 1e-4
    assert int((inl != inl_c).sum()) <= 6 and inl.sum() > 0.9 * inl.numel()


@pytest.mark.gpu
def test_bench_probe_restores_the_chained_program(cuda):
    """``bench.run`` for one pass at 640x192 on the card (one window, at
    frame 7): a headline under the gates, and the device-exec probe, run
    again after it, leaves the chained program's carried state and output
    as they were, bit for bit, and captures no program."""
    from sdpl_slam_torch import bench
    from sdpl_slam_torch.utils.synthetic import SynthConfig

    cfg = SynthConfig(n_frames=10, n_objects=2, noise_flow=0.2)
    settings = bench._settings(cfg)
    settings.run_local_ba = True
    settings.window_size, settings.overlap_size = 8, 2
    systems = []
    out = bench.run(cfg, settings, passes=1, device="cuda", warmup=2,
                    systems=systems)
    assert out["platform"] == "gpu" and out["value"] > 0
    assert "gate_failed" not in out and out["device_exec_ms_per_frame"] > 0
    assert len(systems[0].map.lba_times) == 1
    prog = systems[0].tracker._res.prog
    before = [t.clone() for t in prog.held() + [prog.out]]
    captures = bench.captures()
    assert bench._device_exec_probe(systems[0]) > 0
    assert bench.captures() == captures
    assert all(torch.equal(a, b)
               for a, b in zip(before, prog.held() + [prog.out]))
