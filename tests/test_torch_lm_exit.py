"""The joint LM as state plus body (``solvers.frame_solvers``: ``lm_init``,
``lm_iteration``, ``lm_finish``), the form in which the resident step's
graph ends the loop on the device: against the JAX package's
``solve_flow_pose`` on seeded camera problems and on seeded multi-lane
object problems (``jax.vmap``), with test_torch_ransac_solvers.py's
tolerances (pose atol 1e-4, equal iteration counts, inlier sets equal
except within 1e-4 of the gate); iterations past the exit change no
tensor; an all-padding lane exits at once; the eager loop reads the host
once an iteration and once at the exit; a loop runner takes the loop
over; and the graph program refuses a CPU device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpl_slam_tpu.ops import geometry as jg
from sdpl_slam_tpu.ops import lie as jl
from sdpl_slam_tpu.solvers import frame_solvers as jfs
from sdpl_slam_torch.models import resident as res
from sdpl_slam_torch.ops import geometry as tg
from sdpl_slam_torch.solvers import frame_solvers as tfs
from sdpl_slam_torch.utils.cuda_graphs import loop_runner

torch.set_num_threads(2)

KJ = jg.Intrinsics(jnp.float32(721.5377), jnp.float32(721.5377),
                   jnp.float32(609.5593), jnp.float32(172.8540))
KT = tg.Intrinsics(721.5377, 721.5377, 609.5593, 172.8540)
K64 = [721.5377, 721.5377, 609.5593, 172.8540]


def _problem(rng, n=300, m=40, motion=1.0):
    """One seeded joint problem at KITTI intrinsics: last-frame pixels and
    depths of points and segments, their measured flow through a small
    rigid motion plus 0.3 px noise and 10 % gross outliers, 10 % padding."""
    xi = rng.normal(size=6) * np.array([0.01, 0.01, 0.01, 0.2, 0.05, 0.5])
    T = np.asarray(jl.se3_exp(jnp.asarray((xi * motion).astype(np.float32))))

    def flow_of(uv, z):
        x = (uv[:, 0] - K64[2]) * z / K64[0]
        y = (uv[:, 1] - K64[3]) * z / K64[1]
        X = np.stack([x, y, z], 1) @ T[:3, :3].T + T[:3, 3]
        p = np.stack([K64[0] * X[:, 0] / X[:, 2] + K64[2],
                      K64[1] * X[:, 1] / X[:, 2] + K64[3]], 1)
        f = p - uv + rng.normal(0, 0.3, uv.shape)
        bad = rng.random(len(uv)) < 0.1
        f[bad] += rng.uniform(-20, 20, (bad.sum(), 2))
        return f.astype(np.float32)

    obs = rng.uniform([40, 40], [1200, 335], (n, 2)).astype(np.float32)
    depth = rng.uniform(4, 30, n).astype(np.float32)
    flow0 = flow_of(obs, depth)
    lobs = rng.uniform([40, 40, 40, 40], [1200, 335, 1200, 335],
                       (m, 4)).astype(np.float32)
    ldepth = rng.uniform(4, 30, (m, 2)).astype(np.float32)
    lflow0 = np.concatenate([flow_of(lobs[:, :2], ldepth[:, 0]),
                             flow_of(lobs[:, 2:], ldepth[:, 1])], 1)
    return [obs, flow0, depth, rng.random(n) > 0.1,
            lobs, lflow0, ldepth, rng.random(m) > 0.1]


def _stack(problems):
    return [np.stack(parts) for parts in zip(*problems)]


def _bundles(arrs, lib):
    mk = jnp.asarray if lib == "jax" else (lambda a: torch.from_numpy(
        np.array(a)))
    P = jfs.PointBundle if lib == "jax" else tfs.PointBundle
    L = jfs.LineBundle if lib == "jax" else tfs.LineBundle
    return P(*map(mk, arrs[:4])), L(*map(mk, arrs[4:]))


def _chi2_p(pose, flow, obs, depth):
    """Point chi2 (info 0.1) at a JAX solution, in float64."""
    x = (obs[:, 0] - K64[2]) * depth / K64[0]
    y = (obs[:, 1] - K64[3]) * depth / K64[1]
    Xc = (np.stack([x, y, depth], 1) @ np.asarray(pose, np.float64)[:3, :3].T
          + np.asarray(pose, np.float64)[:3, 3])
    proj = np.stack([K64[0] * Xc[:, 0] / Xc[:, 2] + K64[2],
                     K64[1] * Xc[:, 1] / Xc[:, 2] + K64[3]], 1)
    r = obs + flow - proj
    return 0.1 * (r * r).sum(1)


def _assert_inliers(got, ref, chi2_ref, thr):
    diff = np.nonzero(got != ref)[0]
    assert np.all(np.abs(chi2_ref[diff] - thr) < 1e-4), (diff, chi2_ref[diff])


def _state_body(T0, arrs, **kw):
    """lm_init, the eager loop as its own ``while active_any``, lm_finish;
    returns (result, the state, the loop's host reads)."""
    pt, lt = _bundles(arrs, "torch")
    s = tfs.lm_init(torch.from_numpy(T0), torch.eye(4), pt, lt, KT, **kw)
    reads = 0
    while True:
        reads += 1
        if not bool(s.active_any):
            break
        tfs.lm_iteration(s)
    return tfs.lm_finish(s), s, reads


def _check_lanes(got, ref, arrs):
    np.testing.assert_array_equal(got.n_iters.numpy(), np.asarray(ref.n_iters))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose),
                               atol=1e-4)
    for lane in range(got.pose.shape[0]):
        chi2 = _chi2_p(np.asarray(ref.pose[lane]), np.asarray(ref.flow[lane]),
                       arrs[0][lane], arrs[2][lane])
        _assert_inliers(got.point_inlier[lane].numpy(),
                        np.asarray(ref.point_inlier[lane]), chi2, 0.04)
        np.testing.assert_array_equal(got.line_inlier[lane].numpy(),
                                      np.asarray(ref.line_inlier[lane]))


# rel_tol 1e-4, as test_torch_ransac_solvers.py's lane test: the stop test
# then lies far above the float32 rounding of the cost, where the two
# reduction orders could otherwise stop an iteration apart
CAM = dict(flow_prior_info=0.5, line_prior_info=0.5, rel_tol=1e-4)
OBJ = dict(flow_prior_info=0.5, line_prior_info=0.5, rel_tol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_state_body_matches_jax_camera(seed):
    """One camera lane (the resident step's camera solve)."""
    arrs = _stack([_problem(np.random.default_rng(seed))])
    T0 = np.eye(4, dtype=np.float32)[None]
    got, _, reads = _state_body(T0, arrs, **CAM)
    pj, lj = _bundles([a[0] for a in arrs], "jax")
    one = jax.jit(lambda p, l: jfs.solve_flow_pose(
        jnp.eye(4, dtype=jnp.float32), jnp.eye(4, dtype=jnp.float32), p, l,
        KJ, **CAM))(pj, lj)
    ref = jax.tree_util.tree_map(lambda x: x[None], one)
    _check_lanes(got, ref, arrs)
    assert reads == int(got.n_iters[0]) + 1


@pytest.mark.parametrize("seed", [3, 4])
def test_state_body_matches_jax_object_lanes(seed):
    """Four object lanes of different sizes of motion (they stop after
    different iteration counts) against ``jax.vmap`` of the JAX solver."""
    rng = np.random.default_rng(seed)
    arrs = _stack([_problem(rng, motion=mo) for mo in (1.0, 0.3, 2.0, 0.05)])
    T0 = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    got, _, _ = _state_body(T0, arrs, **OBJ)
    pj, lj = _bundles(arrs, "jax")
    eye = jnp.eye(4, dtype=jnp.float32)
    ref = jax.jit(jax.vmap(lambda T, p, l: jfs.solve_flow_pose(
        T, eye, p, l, KJ, **OBJ)))(jnp.asarray(T0), pj, lj)
    assert len(set(np.asarray(ref.n_iters).tolist())) > 1
    _check_lanes(got, ref, arrs)


@pytest.mark.parametrize("use_lines", [True, False])
def test_iterations_after_exit_change_nothing(use_lines):
    """Five more ``lm_iteration`` calls after the exit leave every state
    tensor and every output bit for bit as they were: a captured body that
    a WHILE node repeats past a lane's exit cannot move it."""
    rng = np.random.default_rng(5)
    arrs = _stack([_problem(rng, motion=mo) for mo in (1.0, 0.2, 0.0)])
    arrs[3][2] = False                  # an all-padding lane as well
    arrs[7][2] = False
    T0 = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    res0, s, _ = _state_body(T0, arrs, use_lines=use_lines, **OBJ)
    names = ("T", "f", "g", "cost", "lam", "nu", "it", "done", "active_any")
    before = {k: getattr(s, k).clone() for k in names}
    out0 = [x.clone() for x in res0[:7]]
    assert not bool(s.active_any)
    for _ in range(5):
        tfs.lm_iteration(s)
    for k in names:
        assert torch.equal(getattr(s, k), before[k]), k
    for a, b in zip(out0, tfs.lm_finish(s)[:7]):
        assert torch.equal(a, b)


def test_all_padding_lane_exits_at_once():
    """A lane with no valid point or line is done before the first
    iteration and keeps its initial pose; alone, the loop reads the host
    once and iterates never."""
    rng = np.random.default_rng(6)
    arrs = _stack([_problem(rng), _problem(rng)])
    arrs[3][1] = False
    arrs[7][1] = False
    T0 = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    T0[1, :3, 3] = [0.1, -0.2, 0.3]
    got, s, _ = _state_body(T0, arrs, **CAM)
    assert int(got.n_iters[1]) == 0 and int(got.n_iters[0]) > 0
    assert bool(s.done[1])
    np.testing.assert_array_equal(s.T[1].numpy(), T0[1])
    alone = [a[1:] for a in arrs]
    got1, s1, reads = _state_body(T0[1:], alone, **CAM)
    assert reads == 1 and got1.host_syncs == 0
    assert int(got1.n_iters[0]) == 0 and not bool(s1.active_any)


def test_eager_loop_reads_largest_lane_plus_one():
    """``solve_flow_pose``'s eager loop counts one host read an iteration
    of its longest lane and one at the exit."""
    rng = np.random.default_rng(7)
    arrs = _stack([_problem(rng, motion=mo) for mo in (0.1, 1.5, 0.5)])
    pt, lt = _bundles(arrs, "torch")
    T0 = torch.eye(4).repeat(3, 1, 1)
    r = tfs.solve_flow_pose(T0, torch.eye(4), pt, lt, KT, **OBJ)
    assert r.host_syncs == int(r.n_iters.max()) + 1
    assert len(set(r.n_iters.tolist())) > 1


def test_loop_runner_takes_the_loop():
    """Under ``loop_runner`` the solver hands over ``(body, flag)`` and
    reads nothing itself: a runner that loops on the flag gives the eager
    result bit for bit, with no host read counted."""
    rng = np.random.default_rng(8)
    arrs = _stack([_problem(rng, motion=mo) for mo in (1.0, 0.4)])
    pt, lt = _bundles(arrs, "torch")
    T0 = torch.eye(4).repeat(2, 1, 1)
    eager = tfs.solve_flow_pose(T0, torch.eye(4), pt, lt, KT, **OBJ)
    calls = []

    def run(body, flag):
        calls.append(flag)
        while bool(flag):
            body()

    with loop_runner(run):
        taken = tfs.solve_flow_pose(T0, torch.eye(4), pt, lt, KT, **OBJ)
    assert len(calls) == 1 and calls[0].dtype == torch.bool
    assert taken.host_syncs == 0 and eager.host_syncs > 0
    for a, b in zip(eager[:7], taken[:7]):
        assert torch.equal(a, b)


def test_graph_program_refuses_the_cpu():
    """The graph wrapper raises on a CPU device instead of running the
    eager program."""
    from sdpl_slam_torch.utils.synthetic import SynthConfig, synth_settings

    cfg = synth_settings(SynthConfig())
    caps = dict(NS=8, NLS=4, NO=8, NLO=4, P=4, L=2, MAXO=2, GCAP=4)
    state = res.ResidentState(*[torch.zeros(1)] * len(res.ResidentState._fields))
    with pytest.raises(RuntimeError, match="CUDA device"):
        res.graph_resident_step(cfg, KT, caps, 16, 8, None, None,
                                (False, False, False), state, {},
                                device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        res.ResidentProgram(lambda *a: None, state, {}, 1, "cpu", graph=True)


def test_cpu_body_never_reaches_the_kernel(monkeypatch):
    """On CPU tensors ``lm_iteration`` is the plain PyTorch body: with the
    kernel build made to raise it still runs, bit for bit as
    ``lm_iteration_torch``, and launches nothing."""
    from sdpl_slam_torch.utils import cuda_build
    from sdpl_slam_torch.utils.synthetic import flow_pose_lanes

    def refuse(*args, **kw):
        raise AssertionError("the CPU path reached the CUDA kernel's build")

    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build", refuse)
    T0, pts, lns, K = flow_pose_lanes(9, 60, 12, (1.0, 0.2))
    a, b = (tfs.lm_init(T0, torch.eye(4), pts, lns, K, **OBJ)
            for _ in range(2))
    assert a.ticket is None and a.f_try is None
    launches = tfs.lm_iteration_cuda.launches
    for _ in range(3):
        tfs.lm_iteration(a)
        tfs.lm_iteration_torch(b)
    for k in ("T", "f", "g", "cost", "lam", "nu", "it", "done",
              "active_any"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert tfs.lm_iteration_cuda.launches == launches
