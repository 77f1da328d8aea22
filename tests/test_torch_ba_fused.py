"""The fused BA programs of sdpl_slam_torch (``batch_ba.run_ba_fused``,
``schur_ba.run_ba_fused_schur``) and ``ba_builder``'s shape buckets, held
to the JAX package's functions of the same names on the CPU, where the
fused calls run their loops on the host (``utils.cuda_graphs.host_while``,
what the card's WHILE nodes do).

The graphs are the JAX package's ``build_graph`` over a map that it
tracked (the 640x192 synthetic sequence, 7 frames, as in
tests/test_batch_ba.py), carried over by ``utils.convert.graph_from_jax``.
Every tolerance is written at its assertion.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sdpl_slam_tpu.models.system import System as JaxSystem
from sdpl_slam_tpu.solvers import ba_builder as jbb
from sdpl_slam_tpu.solvers import batch_ba as jba
from sdpl_slam_tpu.solvers import schur_ba as jsb
from sdpl_slam_torch.ops.geometry import Intrinsics
from sdpl_slam_torch.solvers import ba_builder as tbb
from sdpl_slam_torch.solvers import batch_ba as tba
from sdpl_slam_torch.solvers import schur_ba as tsb
from sdpl_slam_torch.utils import cuda_graphs
from sdpl_slam_torch.utils.convert import graph_from_jax, settings_from_jax
from synthetic import SynthConfig, SynthSequence, synth_settings

torch.set_num_threads(2)

STEPS = ("cg", "schur")


@pytest.fixture(scope="module")
def tracked():
    cfg = SynthConfig(n_frames=8, n_objects=1)
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    settings.run_local_ba = False
    sys = JaxSystem(settings, verbose=False)
    for t in range(7):
        f = seq.frame(t)
        sys.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
                       t * 0.1, 7, line_detections=f.lines)
    sys.tracker.flush()
    port_cfg = settings_from_jax(settings)
    return sys, port_cfg, Intrinsics.from_config(port_cfg)


_KINDS = {"full": dict(motion_init_identity=True, prior_info=1e5),
          "window": dict(motion_init_identity=False, prior_info=1e7)}


def _f0(m, kind):
    return 0 if kind == "full" else m.n_frames - 5


@pytest.fixture(scope="module")
def window(tracked):
    """The window graph (the partial BA's) built and padded by the JAX
    package, with its padded chain tables."""
    sys, _, _ = tracked
    m = sys.map
    g, _ = jbb.build_graph(m, sys.tracker.K, _f0(m, "window"), m.n_frames,
                           **_KINDS["window"])
    F = int(g.cam_T0.shape[0])
    chains = []
    for n, prev, valid in ((g.Xd0, g.tern_prev, g.tern_valid),
                           (g.Ld_U0, g.ltern_prev, g.ltern_valid)):
        ch = jsb.chains_from_links(int(n.shape[0]), np.asarray(prev), F,
                                   valid=np.asarray(valid))
        out = np.full((jbb._bucket(len(ch)), F), -1, np.int32)
        out[:len(ch)] = ch
        chains.append(out)
    return g, chains


def _port_fused(step, tg, chains, **kw):
    w = tba.BAWeights()
    if step == "cg":
        return tba.run_ba_fused(tg, w, **kw)
    F, M = tg.cam_T0.shape[0], tg.mot_T0.shape[0]
    return tsb.run_ba_fused_schur(tg, w, *chains, F, M, **kw)


def _jax_fused(step, jg, chains, **kw):
    w = jba.BAWeights()
    if step == "cg":
        state, cost, it = jba.run_ba_fused(jg, w, **kw)
    else:
        F, M = int(jg.cam_T0.shape[0]), int(jg.mot_T0.shape[0])
        state, cost, it = jsb.run_ba_fused_schur(
            jg, w, jnp.asarray(chains[0]), jnp.asarray(chains[1]), F, M,
            **kw)
    return ({k: np.asarray(v) for k, v in state._asdict().items()},
            float(cost), int(it))


# ---------------------------------------------------------------------------
# buckets, padding, ratchet
# ---------------------------------------------------------------------------


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 1 << 22))
def test_bucket_matches_jax(n):
    """``_bucket`` equals JAX's (quarter steps above 128, pow2 below,
    minimum 8) exactly, at any size."""
    assert tbb._bucket(n) == jbb._bucket(n)


def test_bucket_dense_range():
    """Every size up to 4,100, and the minimum: the same buckets."""
    for n in range(4100):
        assert tbb._bucket(n) == jbb._bucket(n), n
        assert tbb._bucket(n, minimum=1) == jbb._bucket(n, minimum=1), n


@pytest.mark.parametrize("fill", [0, np.eye(4), np.array([1.0, 0.0])])
def test_pad_matches_jax(fill):
    """``_pad`` equals JAX's on numpy, and its torch path the numpy one."""
    a = np.random.default_rng(1).normal(
        size=(5,) + np.shape(fill)).astype(np.float32)
    want = jbb._pad(a, 12, fill)
    np.testing.assert_array_equal(tbb._pad(a, 12, fill), want)
    np.testing.assert_array_equal(
        tbb._pad(torch.from_numpy(a), 12, fill).numpy(), want)


@pytest.mark.parametrize("kind", ["full", "window"])
def test_pad_graph_matches_jax(tracked, kind):
    """``pad_graph(build_graph(...), bucket_sizes(...))`` equals JAX's
    padded ``build_graph`` on the same map, field by field: the same
    shapes, fill values and ``*_valid`` flags (indices int64 against
    int32)."""
    sys, _, K = tracked
    m = sys.map
    jg, _ = jbb.build_graph(m, sys.tracker.K, _f0(m, kind), m.n_frames,
                            **_KINDS[kind])
    tg, _ = tbb.build_graph(m, K, _f0(m, kind), m.n_frames, device="cpu",
                            **_KINDS[kind])
    pg = tbb.pad_graph(tg, tbb.bucket_sizes(tg))
    for field in pg._fields:
        ref, got = np.asarray(getattr(jg, field)), getattr(pg, field)
        if field == "prior_frame":
            assert got == int(ref)
            continue
        assert tuple(got.shape) == ref.shape, field
        np.testing.assert_array_equal(got.numpy(), ref, field)
    assert not bool(pg.Xs_valid.all()) and not bool(pg.sp_valid.all())


def test_ratchet_windows_share_buckets(tracked):
    """Two successive windows of the tracked sequence through one store:
    the second lands in the first's bucket set raised to its own counts,
    as JAX's ratchet gives it, and a later window (the first again) in the
    same set, so every window after the first reuses one program.  The
    chain-count sites ratchet too."""
    sys, _, K = tracked
    m = sys.map
    windows = [(0, 5), (2, 7), (0, 5)]
    store, jstore, sets = {}, {}, []
    for f0, f1 in windows:
        tg, meta = tbb.build_graph(m, K, f0, f1, device="cpu",
                                   **_KINDS["window"])
        sizes = tbb.bucket_sizes(tg, store)
        with jbb._ratchet(jstore):
            jg, _ = jbb.build_graph(m, sys.tracker.K, f0, f1,
                                    **_KINDS["window"])
        assert sizes == tuple(int(getattr(jg, g[0]).shape[0])
                              for g in tbb._PAD_GROUPS)
        tbb._padded_chains(sizes[7], meta["tern_prev"], f1 - f0, "xd_nc",
                           store)
        sets.append(sizes)
    assert sets[1] == tuple(max(a, b) for a, b in zip(
        sets[0], tbb.bucket_sizes(tbb.build_graph(
            m, K, 2, 7, device="cpu", **_KINDS["window"])[0])))
    assert sets[2] == sets[1]
    assert {k: v for k, v in store.items() if isinstance(k, int)} == jstore
    assert store["xd_nc"] >= 8


def test_partial_ba_keeps_floors_on_the_map(tracked):
    """``partial_batch_optimization`` keeps its floors on the map: a
    second window builds through the first's store."""
    sys, cfg, K = tracked
    cfg = copy.deepcopy(cfg)
    cfg.ba_local_iterations = 1
    m = copy.deepcopy(sys.map)
    tbb.partial_batch_optimization(m, K, 5, cfg, device="cpu")
    floors = dict(m._ba_bucket_ratchet)
    assert sorted(k for k in floors if isinstance(k, int)) == list(range(13))
    tbb.partial_batch_optimization(m, K, 5, cfg, device="cpu")
    assert all(m._ba_bucket_ratchet[k] >= v for k, v in floors.items())


# ---------------------------------------------------------------------------
# the fused calls against JAX's
# ---------------------------------------------------------------------------


F64_ITERS, F32_ITERS = 5, 3


@pytest.fixture(scope="module")
def jax_float64(window):
    """JAX's fused calls on the window graph in float64 (x64 on around
    them), at gain 1e-12 to the caps F64_ITERS and F32_ITERS (the budgets
    are traced, so one compile a step serves both)."""
    g, chains = window
    jg = jbb._cast_graph(g, jnp.float64)
    with jbb._x64_scope(True):
        return {(step, k): _jax_fused(step, jg, chains, max_iters=k,
                                      gain_threshold=1e-12)
                for step in STEPS for k in (F64_ITERS, F32_ITERS)}


@pytest.mark.parametrize("step", STEPS)
def test_fused_matches_jax_float64(window, jax_float64, step):
    """``run_ba_fused`` / ``run_ba_fused_schur`` on the window graph in
    float64 against JAX's, 5 LM iterations at gain 1e-12 (both run to the
    cap): cost within rtol 1e-9, camera poses and motions within 1e-9
    (measured 1.4e-12 / 2.6e-12 in cost, 1.1e-15 in the poses).  Later
    iterations part by rounding in the dynamic-line vertices
    (tests/test_torch_schur_ba.py).  One host read a call."""
    g, chains = window
    tg = graph_from_jax(jbb._cast_graph(g, jnp.float64), "cpu")
    sj, cj, itj = jax_float64[step, F64_ITERS]
    before = tba.run_ba.host_syncs + tsb.run_ba_schur.host_syncs
    st_, ct, itt = _port_fused(step, tg, chains, max_iters=F64_ITERS,
                               gain_threshold=1e-12)
    assert tba.run_ba.host_syncs + tsb.run_ba_schur.host_syncs == before + 1
    assert itt == itj == F64_ITERS
    assert abs(ct - cj) <= 1e-9 * abs(cj), (ct, cj)
    for k in ("cam_T", "mot_T"):
        np.testing.assert_allclose(getattr(st_, k).numpy(), sj[k], rtol=0,
                                   atol=1e-9, err_msg=k)


@pytest.mark.parametrize("step", STEPS)
def test_fused_matches_jax_float32(window, jax_float64, step):
    """The same calls in float32 against JAX's float64 run, stopped at a
    cap both reach (3 LM iterations, gain 1e-12), where the float32 path
    is still the float64 one: camera poses and motions within 1e-4
    (measured 4.3e-7 and 1.6e-7 by CG, 1.8e-5 in the motions by Schur);
    cost within rtol 1e-2 (measured 7.5e-4 / 8.3e-4: the Huber cost
    2 delta sqrt(chi2) - delta^2 cancels in float32 near its kink, so a
    float32 cost parts from the float64 one there while the state agrees).
    The float32 Schur run leaves the float64 path from the fourth
    iteration on (3.3e-2 in cost at 5)."""
    g, chains = window
    tg = graph_from_jax(g, "cpu")
    sj, cj, itj = jax_float64[step, F32_ITERS]
    st_, ct, itt = _port_fused(step, tg, chains, max_iters=F32_ITERS,
                               gain_threshold=1e-12)
    assert itt == itj == F32_ITERS
    assert abs(ct - cj) <= 1e-2 * abs(cj), (ct, cj)
    for k in ("cam_T", "mot_T"):
        np.testing.assert_allclose(getattr(st_, k).numpy(), sj[k], rtol=0,
                                   atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the body-split loops against the arithmetic they replaced
# ---------------------------------------------------------------------------


def _parent_pcg(hvp, g, pinv, lam, cg_iters, state, cg_rtol=1e-4):
    """The monolithic CG loop the port ran before its loops became state
    plus body: exit tested on the device, read every CG_CHECK_EVERY
    iterations.  Returns (x, gain_den, iterations, reads)."""
    def M(v):
        vv = tba._views(v, state)
        return torch.cat([(pinv[f] @ vv[f][..., None]).reshape(-1)
                          for f, _ in tba._family_sizes(state)])

    b = -g
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    rz0 = rz
    active = rz > cg_rtol * rz0
    n_run = torch.zeros((), dtype=torch.int32)
    reads = 0
    for i in range(cg_iters):
        if i and i % tba.CG_CHECK_EVERY == 0:
            reads += 1
            if not bool(active):
                break
        Ap = hvp(p) + lam * p
        alpha = torch.where(
            active, rz / torch.clamp(torch.dot(p, Ap), min=1e-20), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(active, rz_new / torch.clamp(rz, min=1e-20), 0.0)
        p = z + beta * p
        rz = torch.where(active, rz_new, rz)
        n_run += active
        active = active & (rz > cg_rtol * rz0)
    return x, torch.dot(x, lam * x - g), n_run, reads


def _parent_run(graph, w, step, max_iters, gain_threshold, meta=None,
                cg_iters=40):
    """The LM loop the port ran before (``run_ba`` / ``run_ba_schur``):
    returns (state, cost, iterations, host reads, CG iterations)."""
    state = tba.initial_state(graph)
    cost = tba._cost_only(graph, state, w)
    lam = torch.tensor(1e-5, dtype=graph.cam_T0.dtype)
    nu = torch.tensor(2.0, dtype=graph.cam_T0.dtype)
    it = reads = n_cg = 0
    while it < max_iters:
        if step == "cg":
            lin, prior, _ = tba._linearize(graph, state, w)
            g, hvp, bd = tba._hvp_and_grad(lin, prior, graph, state)
            x, gain_den, n, r = _parent_pcg(
                hvp, g, tba._block_jacobi(bd, lam), lam, cg_iters, state)
            x = tba._views(x, state)
            reads += r
            n_cg += int(n)
        else:
            x, _, gain_den = tsb.dense_schur_step(graph, state, w, lam, meta)
        new_state = tba._retract(state, x)
        new_cost = tba._cost_only(graph, new_state, w)
        rho = (cost - new_cost) / torch.clamp(gain_den, min=1e-20)
        ok = torch.isfinite(new_cost) & (rho > 0)
        gain = (cost - new_cost) / torch.clamp(cost, min=1e-20)
        state = tba.BAState(*(torch.where(ok, b, a)
                              for a, b in zip(state, new_state)))
        cost = torch.where(ok, new_cost, cost)
        lam = torch.where(
            ok, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
            lam * nu)
        nu = torch.where(ok, 2.0, nu * 2.0)
        done = (ok & (gain < gain_threshold)) | (lam > 1e12)
        it += 1
        reads += 1
        if bool(done):
            break
    return state, cost, it, reads, n_cg


def _counters():
    return (tba.run_ba.host_syncs + tsb.run_ba_schur.host_syncs,
            tba.run_ba.iterations + tsb.run_ba_schur.iterations,
            tba.run_ba.cg_iterations)


EAGER_ITERS = 4


@pytest.mark.parametrize("step", STEPS)
def test_eager_loops_match_parent_arithmetic(window, step):
    """``run_ba`` / ``run_ba_schur`` (the same LM and CG bodies driven from
    the host) against the loops they replaced, float32 on the CPU at the
    window BA's gain rule, 4 LM iterations: state and cost bit for bit,
    the same LM and CG iterations and host reads; and the fused call
    (loops to their exits, one read) bit for bit with them."""
    g, chains = window
    tg = graph_from_jax(g, "cpu")
    w = tba.BAWeights()
    meta = tsb._meta(tg, *chains)
    ref = _parent_run(tg, w, step, EAGER_ITERS, 1e-3, meta)
    before = _counters()
    if step == "cg":
        st_, cost, it = tba.run_ba(tg, w, max_iters=EAGER_ITERS,
                                   gain_threshold=1e-3)
    else:
        st_, cost, it = tsb.run_ba_schur(tg, w, *chains,
                                         max_iters=EAGER_ITERS,
                                         gain_threshold=1e-3)
    after = _counters()
    assert (it, after[0] - before[0], after[2] - before[2]) == ref[2:]
    assert after[1] - before[1] == it > 2
    assert torch.equal(cost, ref[1])
    for a, b in zip(st_, ref[0]):
        assert torch.equal(a, b)
    fs, fc, fit = _port_fused(step, tg, chains, max_iters=EAGER_ITERS,
                              gain_threshold=1e-3)
    assert fit == it and fc == float(cost)
    assert _counters()[2] - after[2] == ref[4]
    for a, b in zip(fs, st_):
        assert torch.equal(a, b)


@pytest.mark.parametrize("step", STEPS)
def test_padded_run_matches_unpadded(tracked, step):
    """The window BA on the padded graph against the exact-count graph,
    float64, 3 LM iterations at gain 1e-12: padded rows weigh 0, so only
    the summation order differs: cost within rtol 1e-9, camera poses and
    motions within 1e-9 (measured 1.9e-16 / 3.3e-14 in cost, 2.2e-16 in
    the poses)."""
    sys, _, K = tracked
    m = sys.map
    tg, meta = tbb.build_graph(m, K, _f0(m, "window"), m.n_frames,
                               device="cpu", **_KINDS["window"])
    runs = []
    for g in (tg, tbb.pad_graph(tg, tbb.bucket_sizes(tg))):
        g = tbb._cast_graph(g, torch.float64)
        F = int(g.cam_T0.shape[0])
        if step == "cg":
            st_, cost, it = tba.run_ba(g, tba.BAWeights(), max_iters=3,
                                       gain_threshold=1e-12)
        else:
            chains = [tbb._padded_chains(int(n), links, F, None, None)
                      for n, links in ((g.Xd0.shape[0], meta["tern_prev"]),
                                       (g.Ld_U0.shape[0],
                                        meta["ltern_prev"]))]
            st_, cost, it = tsb.run_ba_schur(g, tba.BAWeights(), *chains,
                                             max_iters=3,
                                             gain_threshold=1e-12)
        runs.append((st_, float(cost), it))
    (s0, c0, i0), (s1, c1, i1) = runs
    assert i0 == i1 == 3
    assert abs(c0 - c1) <= 1e-9 * abs(c0), (c0, c1)
    n_mot = s0.mot_T.shape[0]
    np.testing.assert_allclose(s1.cam_T.numpy(), s0.cam_T.numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(s1.mot_T[:n_mot].numpy(), s0.mot_T.numpy(),
                               rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# the loop runners
# ---------------------------------------------------------------------------


def test_nested_loops_through_host_while():
    """A counted loop inside a counted loop, each handed over by
    ``run_loop``: ``host_while`` runs them as WHILE nodes would (4 outer
    iterations of 5 inner each), and without a runner ``run_loop``
    declines."""
    outer = torch.zeros((), dtype=torch.int32)
    total = torch.zeros((), dtype=torch.int32)
    o_flag = torch.ones((), dtype=torch.bool)

    def outer_body():
        inner = torch.zeros((), dtype=torch.int32)
        i_flag = torch.ones((), dtype=torch.bool)

        def inner_body():
            inner.add_(1)
            total.add_(1)
            i_flag.copy_(inner < 5)

        assert cuda_graphs.run_loop(inner_body, i_flag)
        outer.add_(1)
        o_flag.copy_(outer < 4)

    assert not cuda_graphs.run_loop(outer_body, o_flag)
    with cuda_graphs.loop_runner(cuda_graphs.host_while):
        assert cuda_graphs.run_loop(outer_body, o_flag)
    assert int(outer) == 4 and int(total) == 20


def test_flatten_nests_loops():
    """The recorder's item tree in ``graph_while.cu``'s order: a segment,
    a loop whose body holds a segment, a nested loop and a segment, then
    a segment."""
    a, b, c, d, e = "abcde"
    f1, f2 = object(), object()
    items = [("seg", a),
             ("while", [("seg", b), ("while", [("seg", c)], f2),
                        ("seg", d)], f1),
             ("seg", e)]
    flat = cuda_graphs._flatten(items, [])
    S, O, C = cuda_graphs._SEG, cuda_graphs._OPEN, cuda_graphs._CLOSE
    assert flat == [(S, a, None), (O, None, f1), (S, b, None), (O, None, f2),
                    (S, c, None), (C, None, None), (S, d, None),
                    (C, None, None), (S, e, None)]


def test_program_refuses_the_cpu(window):
    """The captured program is for the card: on a CPU graph it raises
    rather than run anything."""
    g, _ = window
    tg = graph_from_jax(g, "cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tba.BAProgram(tg, tba.BAWeights(), None, ())
