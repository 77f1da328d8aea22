"""The joint flow+pose LM's body on a CUDA card: the hand-written kernel
``csrc/flow_pose_lm.cu`` (``frame_solvers.lm_iteration_cuda``) against
the plain PyTorch body (``lm_iteration_torch``) on the card, from the same
``LMState``, at the chained step's capacities (the camera: 1 lane, 1200
points, 400 lines; the object lanes: 8 lanes, 800 points, 100 lines),
with and without lines; a whole solve against the plain body's loop; the
captured loop's body; and the wrapper's refusals.  Skipped where there is
no card.  This file imports no JAX:

    python -m pytest tests/test_torch_flow_pose_lm_gpu.py -m gpu --noconftest -p no:cacheprovider

Tolerances: the kernel sums each lane's 6x6 system over its features in
another order than ``torch.einsum`` (per thread, then warp shuffles, then
warps), factors each line's 4x4 flow block by Cholesky where the body
inverts it by LU, and solves the 6x6 system in one thread.  That moves
float32 rounding, not the arithmetic: after one iteration from a common
state the pose agrees to 2e-5 (unit-scale rotation, translation under a
metre: ~100 float32 ulps of the step), the flows to 2e-3 px (they are
~1-50 px, and each is its own 2x2 or 4x4 solve on the step), the cost to
a relative 1e-5 and the damping to a relative 1e-3 (lambda's update goes
through rho = (c - c_new) / gain, a ratio of two differences).  The
discrete outcomes -- accepted or not, the iteration count, the exit --
are identical.
"""

import numpy as np
import pytest
import torch

from sdpl_slam_torch.solvers import frame_solvers as fs
from sdpl_slam_torch.utils.synthetic import flow_pose_lanes

STATE = ("T", "f", "g", "cost", "lam", "nu", "it", "done", "active_any")
CAM = dict(n=1200, m=400, motions=(1.0,), prior=0.3)
OBJ = dict(n=800, m=100, motions=(1.0, 0.3, 2.0, 0.05, 0.5, 1.5, 0.1, 0.8),
           prior=0.5)
REL_TOL = 1e-4     # the configurations' lm_rel_tol


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(cuda, shape, seed=0, pad_lane=None, nan_lines=False):
    """Lanes of ``shape`` on the card; ``pad_lane`` all padding; with
    ``nan_lines`` every padded line's depth NaN (its endpoints then
    project to NaN, which the body zeroes)."""
    T0, pts, lns, K = flow_pose_lanes(seed, shape["n"], shape["m"],
                                      shape["motions"], cuda)
    if pad_lane is not None:
        pts.valid[pad_lane] = False
        lns.valid[pad_lane] = False
    if nan_lines:
        lns.depth[~lns.valid] = float("nan")
    return T0, pts, lns, K


def _init(inp, shape, use_lines=True):
    T0, pts, lns, K = inp
    return fs.lm_init(T0, torch.eye(4, device=T0.device), pts, lns, K,
                      flow_prior_info=shape["prior"],
                      line_prior_info=shape["prior"], use_lines=use_lines,
                      rel_tol=REL_TOL)


def _state(s):
    return {k: getattr(s, k).clone() for k in STATE}


@pytest.mark.gpu
@pytest.mark.parametrize("use_lines", [True, False])
@pytest.mark.parametrize("name", ["camera", "objects"])
def test_one_iteration_matches_the_plain_body(cuda, name, use_lines):
    """One iteration from the same state: a lane already done, and (with
    the object lanes) an all-padding lane, stay bit for bit; the other
    lanes agree as the module docstring states."""
    shape = CAM if name == "camera" else OBJ
    pad = 2 if name == "objects" else None
    inp = _inputs(cuda, shape, pad_lane=pad, nan_lines=True)
    sk, sp = _init(inp, shape, use_lines), _init(inp, shape, use_lines)
    if name == "objects":           # a lane that finished earlier
        for s in (sk, sp):
            s.done[5] = True
    before = _state(sk)
    launches = fs.lm_iteration_cuda.launches
    runs = fs.lm_kernel_runs()
    fs.lm_iteration(sk)             # the kernel on a CUDA state
    fs.lm_iteration_torch(sp)
    torch.cuda.synchronize()
    assert fs.lm_iteration_cuda.launches == launches + 1
    assert fs.lm_kernel_runs() - runs == 1
    frozen = [l for l in range(sk.T.shape[0]) if bool(before["done"][l])]
    assert frozen == ([] if pad is None else [2, 5])
    for l in frozen:
        for k in STATE[:-1]:
            assert torch.equal(getattr(sk, k)[l], before[k][l]), (l, k)
    # accepted or not (nu: 2 after an accepted step, else doubled)
    for k in ("nu", "it", "done", "active_any"):
        assert torch.equal(getattr(sk, k), getattr(sp, k)), k
    assert bool((sk.nu == 2).any()), "no lane accepted its first step"
    torch.testing.assert_close(sk.T, sp.T, rtol=0, atol=2e-5)
    torch.testing.assert_close(sk.f, sp.f, rtol=0, atol=2e-3)
    torch.testing.assert_close(sk.g, sp.g, rtol=0, atol=2e-3)
    torch.testing.assert_close(sk.cost, sp.cost, rtol=1e-5, atol=0)
    torch.testing.assert_close(sk.lam, sp.lam, rtol=1e-3, atol=0)
    assert torch.isfinite(sk.f).all() and torch.isfinite(sk.g).all()


@pytest.mark.gpu
def test_two_launches_agree_bit_for_bit(cuda):
    """Fixed-order sums and no float atomics: the same state gives the same
    bits, iteration after iteration."""
    inp = _inputs(cuda, OBJ, seed=3, nan_lines=True)
    a, b = _init(inp, OBJ), _init(inp, OBJ)
    for _ in range(4):
        fs.lm_iteration(a)
        fs.lm_iteration(b)
        for k in STATE:
            assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["camera", "objects"])
def test_solve_ends_where_the_plain_body_ends(cuda, name):
    """A whole ``solve_flow_pose`` on the card (the kernel, its loop read on
    the host) against ``lm_init``, the plain body's loop and ``lm_finish``:
    each lane's iteration count within one, poses within the card tests'
    gate (atol 1e-4)."""
    shape = CAM if name == "camera" else OBJ
    T0, pts, lns, K = _inputs(cuda, shape, seed=7)
    got = fs.solve_flow_pose(T0, torch.eye(4, device=cuda), pts, lns, K,
                             flow_prior_info=shape["prior"],
                             line_prior_info=shape["prior"], rel_tol=REL_TOL)
    s = _init((T0, pts, lns, K), shape)
    while bool(s.active_any):
        fs.lm_iteration_torch(s)
    ref = fs.lm_finish(s)
    it_k, it_p = got.n_iters.cpu().numpy(), ref.n_iters.cpu().numpy()
    assert np.abs(it_k - it_p).max() <= 1, (it_k, it_p)
    assert got.host_syncs == int(it_k.max()) + 1
    torch.testing.assert_close(got.pose, ref.pose, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_captured_loop_body_is_one_kernel(cuda):
    """Under ``loop_runner`` the solve's loop captures as a WHILE node whose
    body holds the one kernel node (at most 2 allowed); a launch of the
    stitched graph gives the eager kernel loop's state bit for bit, and
    the launch counter gains one a replay."""
    from sdpl_slam_torch.utils.cuda_graphs import (GraphRecorder,
                                                   loop_runner)

    inp = _inputs(cuda, OBJ, seed=11, pad_lane=4, nan_lines=True)
    eager = _init(inp, OBJ)
    while bool(eager.active_any):
        fs.lm_iteration(eager)
    holder = {}

    def fn():
        s = _init(inp, OBJ)
        fs.lm_run(s)
        holder["s"] = s

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                              # warm-up outside the capture
    torch.cuda.synchronize()
    rec = GraphRecorder(counters=[(fs.lm_iteration_cuda, "launches")])
    with torch.cuda.stream(side):
        with rec, loop_runner(rec.loop):
            fn()
    graph = rec.stitch("lm")
    counts = graph.node_counts()
    bodies = [c for c in counts if isinstance(c, list)]
    assert len(bodies) == 1 and sum(bodies[0]) <= 2, counts
    body_graphs = [it[1] for it in graph._items if it[0] == "while"]
    kinds = graph._node_types(body_graphs[0][0][1])
    assert kinds == {0: 1}, kinds        # cudaGraphNodeTypeKernel only
    launches = fs.lm_iteration_cuda.launches
    runs = fs.lm_kernel_runs()
    graph.launch()
    torch.cuda.synchronize()
    # the host counts the captured call once a replay; the kernel counts
    # each body run, as many as the lanes' most iterations (a lane still
    # active has been active in every run before)
    assert fs.lm_iteration_cuda.launches == launches + 1
    assert fs.lm_kernel_runs() - runs == int(holder["s"].it.max()) > 1
    for k in STATE:
        assert torch.equal(getattr(holder["s"], k), getattr(eager, k)), k


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    inp = _inputs(cuda, CAM)

    def refused(**swap):
        s = _init(inp, CAM)
        for k, v in swap.items():
            setattr(s, k, v(getattr(s, k)))
        with pytest.raises(ValueError):
            fs.lm_iteration_cuda(s)

    refused(f=lambda t: t.cpu())                     # CPU mixed with CUDA
    refused(cost=lambda t: t.double())               # a wrong dtype
    refused(g=lambda t: t.transpose(1, 2).contiguous().transpose(1, 2))
    refused(ticket=lambda t: None)                   # no scratch
    cpu = _init(flow_pose_lanes(0, 12, 4, device="cpu"), CAM)
    assert cpu.ticket is None
    with pytest.raises(ValueError):
        fs.lm_iteration_cuda(cpu)                    # a CPU state
