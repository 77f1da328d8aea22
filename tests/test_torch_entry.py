"""``sdpl_slam_torch.entry.entry`` against the JAX package's
``__graft_entry__.entry``: the flagship joint flow+pose camera LM at
KITTI capacities (1200 points, 400 lines), on the CPU.

Tolerances: the drawn arrays (pixels and depths) within 1e-6 (they are
equal); the flows within 2.5e-4 px.  A flow is the difference of a
projected pixel and the drawn one.  Both packages transform the points in
float32 by a 3x3 product whose summation order and fused multiply-adds
differ (XLA's dot against PyTorch's matmul), so a transformed coordinate
may round a unit apart; the projection multiplies that by the focal
length (721.5 px) and the subtraction keeps the absolute error: 1.22e-4
px at most, in 384 of the 2400 point flows and 236 of the 1600 line
flows.  The pose within the North star's rotation floor (0.03 deg) and
1e-4 m; the point inlier masks equal.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sdpl_slam_torch import entry as tentry
from sdpl_slam_torch.ops import lie

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def both():
    jfn, jargs = graft.entry()
    tfn, targs = tentry.entry("cpu")
    jpose, jin = jax.jit(jfn)(*jargs)
    tpose, tin = tfn(*targs)
    return (jargs, np.asarray(jpose), np.asarray(jin)), (targs, tpose, tin)


def test_entry_inputs_match_jax(both):
    (jargs, _, _), (targs, _, _) = both
    assert len(jargs) == len(targs) == 6
    for i, (j, t) in enumerate(zip(jargs, targs)):
        j, t = np.asarray(j), t.numpy()
        assert t.dtype == np.float32 and t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=2.5e-4 if i in (1, 4) else 1e-6)


def test_entry_pose_and_inliers_match_jax(both):
    (_, jpose, jin), (_, tpose, tin) = both
    assert tpose.shape == (4, 4) and torch.isfinite(tpose).all()
    dR = torch.from_numpy(jpose[:3, :3].copy()).T @ tpose[:3, :3]
    assert float(lie.rotation_angle_deg(dR)) < 0.03
    np.testing.assert_allclose(tpose[:3, 3].numpy(), jpose[:3, 3], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(tin.numpy(), jin)
    # the solve recovers the motion the flows were drawn from
    assert tin.sum() > 0.9 * tin.numel()


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
