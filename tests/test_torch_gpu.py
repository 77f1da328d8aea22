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
    """Every pyramid level of a KITTI frame: kernel == plain, bit-exact
    (same differences, same in-order SAD)."""
    img = torch.from_numpy(seq.frame(0).gray).float()
    h, w = img.shape
    for lvl, s, lh, lw in tf.pyramid_shapes(h, w):
        li = img if lvl == 0 else tf.resize_linear(img, lh, lw)
        before = tf.fast_score_maps.launches
        hi, lo = tf.fast_score_maps(li.to(cuda).contiguous(), 20.0, 7.0)
        torch.cuda.synchronize()
        assert tf.fast_score_maps.launches == before + 1
        assert torch.equal(hi.cpu(), tf.fast_score_map_torch(li, 20.0))
        assert torch.equal(lo.cpu(), tf.fast_score_map_torch(li, 7.0))


@pytest.mark.gpu
def test_wrapper_refuses_bad_cuda_input(cuda):
    img = torch.zeros((64, 80), device=cuda)
    with pytest.raises(ValueError):
        tf.fast_score_maps(img.double(), 20.0, 7.0)
    with pytest.raises(ValueError):
        tf.fast_score_maps(img.t(), 20.0, 7.0)


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
