"""sdpl_slam_torch on a CUDA card: the FAST kernel against its plain
version, the tracking slice on the card against the same slice on the
CPU, the window BA on the card run twice, the line detector on the card
against the CPU, and frames from disk with nothing injected.  Skipped where there is no card.  This file imports no JAX, so it
runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.ops import fast as tf
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
        for i in range(loaded.n_frames):
            s.track_rgbd(*loaded.frame(i), loaded.gt_pose(i),
                         loaded.gt_obj_poses(i), float(loaded.timestamps[i]),
                         loaded.n_frames)
        assert tf.fast_score_pyramid.launches - before == (
            loaded.n_frames if dev == "cuda" else 0)
        assert len(s.tracker.line_detect_ms) == loaded.n_frames
        maps[dev] = s.map
    for a, b in zip(maps["cuda"].camera_poses, maps["cpu"].camera_poses):
        np.testing.assert_allclose(a, b, atol=1e-4)
    for a, b in zip(maps["cuda"].line_valid, maps["cpu"].line_valid):
        assert a.sum() > 0 and abs(int(a.sum()) - int(b.sum())) <= 2
