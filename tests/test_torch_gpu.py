"""sdpl_slam_torch on a CUDA card: the FAST kernel against its plain
version, and the tracking slice on the card against the same slice on the
CPU.  Skipped where there is no card.  This file imports no JAX, so it
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
