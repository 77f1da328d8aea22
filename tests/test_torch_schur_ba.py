"""sdpl_slam_torch.solvers.schur_ba, the dense-Schur BA step, against the
JAX package's ``schur_ba`` (twins of tests/test_schur_ba.py), and the step
selection of the two ``ba_builder`` modules.

Parity runs in float64 (``jbb._x64_scope``): two float32 LM runs of two
implementations part by rounding after a step or two, so the step, its
cost and ``gain_den`` are held to 1e-8 relative and a whole run to the
same iteration count and 1e-9 in cost.  In float32 the step is held to
what JAX's own test holds it to: it is the exact damped Newton step, its
residual measured with the port's matrix-free HVP.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_ba_golden as golden_fixture
from sdpl_slam_tpu.ops.geometry import Intrinsics as JaxIntrinsics
from sdpl_slam_tpu.solvers import ba_builder as jbb
from sdpl_slam_tpu.solvers import batch_ba as jba
from sdpl_slam_tpu.solvers import schur_ba as jsb
from sdpl_slam_tpu.utils.config import Settings as JaxSettings
from sdpl_slam_torch.ops.geometry import Intrinsics
from sdpl_slam_torch.solvers import ba_builder as tbb
from sdpl_slam_torch.solvers import batch_ba as tba
from sdpl_slam_torch.solvers import schur_ba as tsb
from sdpl_slam_torch.utils.config import Settings
from sdpl_slam_torch.utils.convert import graph_from_jax, settings_from_jax
from test_schur_ba import window_graph  # noqa: F401  (the JAX fixture)

torch.set_num_threads(2)


def _links(rng, n, k, pad):
    """Ternary links over n vertices in runs of at most k (the window
    invariant), then ``pad`` padding zeros."""
    links, i = [], 0
    while i < n:
        run = int(rng.integers(1, k + 1))
        links += list(range(i, min(i + run, n) - 1))
        i += run
    links = np.array(rng.permutation(links), np.int64)
    return (np.concatenate([links, np.zeros(pad, np.int64)]),
            np.concatenate([np.ones(len(links), bool), np.zeros(pad, bool)]))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("masked", [False, True])
def test_chains_from_links_matches_jax(seed, masked):
    rng = np.random.default_rng(seed)
    n, k = int(rng.integers(1, 60)), int(rng.integers(2, 9))
    links, valid = _links(rng, n, k, pad=int(rng.integers(0, 5)))
    v = valid if masked else None
    got = tsb.chains_from_links(n, links, k, valid=v)
    np.testing.assert_array_equal(got, jsb.chains_from_links(n, links, k,
                                                             valid=v))
    assert got.dtype == np.int32
    # every vertex in exactly one row
    ids = np.sort(got[got >= 0])
    np.testing.assert_array_equal(ids, np.arange(n))


def test_chains_from_links_edges():
    """No vertex; and a run longer than the window, which is split without
    ``valid`` and asserted with it, in both packages."""
    for pkg in (tsb, jsb):
        assert pkg.chains_from_links(0, np.zeros(0), 4).tolist() == [[-1] * 4]
    links = np.arange(6)
    np.testing.assert_array_equal(tsb.chains_from_links(7, links, 3),
                                  jsb.chains_from_links(7, links, 3))
    for pkg in (tsb, jsb):
        with pytest.raises(AssertionError, match="exceeds window"):
            pkg.chains_from_links(7, links, 3, valid=np.ones(6, bool))


def _tridiag_problem():
    """tests/test_schur_ba.py's system: two chains, and rows 7 and 8
    outside both (block-diagonal only)."""
    rng = np.random.default_rng(0)
    P, d = 9, 3
    chain = np.full((2, 5), -1, np.int32)
    chain[0, :4] = [0, 1, 2, 3]
    chain[1, :3] = [4, 5, 6]
    Dd = np.zeros((P, d, d))
    Eo = np.zeros((P, d, d))
    for i in range(P):
        a = rng.normal(size=(d, d))
        Dd[i] = a @ a.T + 4 * np.eye(d)
    for i in (0, 1, 2, 4, 5):
        Eo[i] = 0.3 * rng.normal(size=(d, d))
    return chain, Dd, Eo, rng.normal(size=(P, d, 2))


def test_tridiag_solve_matches_dense_and_jax():
    """The port takes rows 7 and 8 as chains of one (every row in a chain,
    as ``chains_from_links`` gives them); JAX's function, on its test's
    chains, solves them block-diagonally: the same solution.  Float64,
    1e-10 relative against JAX and against a dense solve."""
    chain, Dd, Eo, rhs = _tridiag_problem()
    d = Dd.shape[1]
    full = np.concatenate([chain, np.full((2, 5), -1, np.int32)])
    full[2:, 0] = [7, 8]
    np.testing.assert_array_equal(
        full, tsb.chains_from_links(9, np.array([0, 1, 2, 4, 5]), 5))
    got = tsb._tridiag_solve(*(torch.from_numpy(a) for a in
                               (full, Dd, Eo, rhs))).numpy()
    with jbb._x64_scope(True):
        ref = np.asarray(jsb._tridiag_solve(
            jnp.asarray(chain), jnp.asarray(Dd), jnp.asarray(Eo),
            jnp.asarray(rhs)))
    assert ref.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)

    def dense(ids):
        n = len(ids)
        T = np.zeros((n * d, n * d))
        r = np.zeros((n * d, 2))
        for a, vid in enumerate(ids):
            T[a * d:(a + 1) * d, a * d:(a + 1) * d] = Dd[vid]
            r[a * d:(a + 1) * d] = rhs[vid]
            if a + 1 < n:
                T[a * d:(a + 1) * d, (a + 1) * d:(a + 2) * d] = Eo[vid]
                T[(a + 1) * d:(a + 2) * d, a * d:(a + 1) * d] = Eo[vid].T
        return np.linalg.solve(T, r).reshape(n, d, 2)

    for ids in ([0, 1, 2, 3], [4, 5, 6], [7], [8]):
        np.testing.assert_allclose(got[ids], dense(ids), rtol=1e-10,
                                   atol=1e-12)


def _port_weights(w):
    return tba.BAWeights(**{f.name: getattr(w, f.name)
                            for f in dataclasses.fields(tba.BAWeights)})


def _meta(xd, ld, F, M):
    return tsb.SchurMeta(torch.as_tensor(xd, dtype=torch.long),
                         torch.as_tensor(ld, dtype=torch.long), F, M)


def test_dense_schur_step_matches_jax_f64(window_graph):
    """The 8-frame window graph (JAX's padded graph: its padding rows weigh
    0 in both) in float64: delta, cost and gain_den to 1e-8 relative."""
    graph, w, xd, ld, F, M = window_graph
    with jbb._x64_scope(True):
        jg = jbb._cast_graph(graph, jnp.float64)
        state = jba.BAState(cam_T=jg.cam_T0, mot_T=jg.mot_T0, Xs=jg.Xs0,
                            Ls_U=jg.Ls_U0, Ls_w=jg.Ls_w0, Xd=jg.Xd0,
                            Ld_U=jg.Ld_U0, Ld_w=jg.Ld_w0)
        meta = jsb.SchurMeta(xd_chain=jnp.asarray(xd),
                             ld_chain=jnp.asarray(ld), n_frames=F,
                             n_motions=M)
        jd, jc, jgd = jax.jit(
            lambda g, s, lam: jsb.dense_schur_step(g, s, w, lam, meta))(
                jg, state, jnp.asarray(1e-4, jnp.float64))
        jd = {k: np.asarray(v) for k, v in jd.items()}
        jc, jgd = float(jc), float(jgd)
    tg = tbb._cast_graph(graph_from_jax(graph, "cpu"), torch.float64)
    td, tc, tgd = tsb.dense_schur_step(
        tg, tba.initial_state(tg), _port_weights(w),
        torch.tensor(1e-4, dtype=torch.float64), _meta(xd, ld, F, M))
    for k, ref in jd.items():
        assert ref.dtype == np.float64, k
        got = td[k].numpy()
        assert got.shape == ref.shape, k
        scale = max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-8 * scale,
                                   err_msg=k)
    assert abs(float(tc) - jc) <= 1e-8 * abs(jc)
    assert abs(float(tgd) - jgd) <= 1e-8 * abs(jgd)
    assert np.abs(jd["mot"]).max() > 0 and np.abs(jd["xd"]).max() > 0


def _flat(d, state):
    return torch.cat([d[f].reshape(-1) for f, _ in tba._family_sizes(state)])


def test_schur_step_is_exact_f32(window_graph):
    """tests/test_schur_ba.py::test_schur_step_is_exact with the port's
    own HVP: the step's true residual (H + lam I) d + g is under 1e-4 and
    under 0.05 of the CG step's, and its post-step cost no worse."""
    graph, w, xd, ld, F, M = window_graph
    tg, tw = graph_from_jax(graph, "cpu"), _port_weights(w)
    state = tba.initial_state(tg)
    lam = torch.tensor(1e-4)
    d_s, cost_s, _ = tsb.dense_schur_step(tg, state, tw, lam,
                                          _meta(xd, ld, F, M))
    d_cg, cost_cg, _, _ = tba.ba_gn_step(tg, state, tw, lam, cg_iters=120)
    assert abs(float(cost_s) - float(cost_cg)) <= 1e-5 * abs(float(cost_cg))
    lin, prior, _ = tba._linearize(tg, state, tw)
    g, hvp, _ = tba._hvp_and_grad(lin, prior, tg, state)

    def resid(d):
        v = _flat(d, state)
        return float(torch.linalg.norm(hvp(v) + lam * v + g))

    r_s, r_cg = resid(d_s), resid(d_cg)
    assert r_s < 1e-4, r_s
    assert r_s < 0.05 * max(r_cg, 1e-12), (r_s, r_cg)
    c_s = float(tba._cost_only(tg, tba._retract(state, d_s), tw))
    c_cg = float(tba._cost_only(tg, tba._retract(state, d_cg), tw))
    assert c_s <= c_cg * 1.01 + 1e-9, (c_s, c_cg)
    assert c_s < float(cost_s), (c_s, float(cost_s))


@pytest.mark.parametrize("iters", [5, 8])
def test_run_ba_schur_matches_jax_f64(window_graph, iters):
    """``run_ba_schur`` against ``run_ba_fused_schur`` in float64: the same
    iteration count, and the cost to 1e-9 relative after 5 LM iterations.
    The dynamic-line vertices sit in a near-flat valley (the point-to-line
    distance residuals, tests/test_ba_golden.py): there the two runs'
    float64 rounding grows ~10x an iteration (2.5e-9 after 5 iterations,
    5.9e-6 after 8, measured), and with them the cost (1e-5 relative after
    8), so after 8 the other families are held to 1e-9."""
    graph, w, xd, ld, F, M = window_graph
    with jbb._x64_scope(True):
        jg = jbb._cast_graph(graph, jnp.float64)
        js, jc, jit = jsb.run_ba_fused_schur(
            jg, w, jnp.asarray(xd), jnp.asarray(ld), F, M, max_iters=iters)
        jc, jit = float(jc), int(jit)
        js = {k: np.asarray(v) for k, v in js._asdict().items()}
    tg = tbb._cast_graph(graph_from_jax(graph, "cpu"), torch.float64)
    before = tsb.run_ba_schur.iterations
    ts, tc, tit = tsb.run_ba_schur(tg, _port_weights(w), xd, ld,
                                   max_iters=iters)
    assert tit == jit == iters
    assert tsb.run_ba_schur.iterations - before == tit
    with pytest.raises(ValueError, match="each of the family"):
        tsb.run_ba_schur(tg, _port_weights(w), xd[1:], ld)
    if iters == 5:
        assert abs(float(tc) - jc) <= 1e-9 * abs(jc), (float(tc), jc)
    for k in ("cam_T", "mot_T", "Xs", "Ls_U", "Ls_w", "Xd"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), js[k], rtol=0,
                                   atol=1e-9, err_msg=k)


@pytest.mark.parametrize("kind", ["indefinite", "spd"])
def test_cholesky_fallback(kind):
    """``cholesky_ex`` does not raise on a matrix that is not positive
    definite: its ``info`` does, and the LU solve is taken; on an SPD
    matrix the Cholesky solution is.  Both equal a dense solve of the
    symmetrised, 1e-8-regularised system."""
    rng = np.random.default_rng(5)
    n = 12
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    eig = rng.uniform(0.5, 2.0, n)
    if kind == "indefinite":
        eig[[2, 7]] = [-0.3, -1.5]
    S = Q @ np.diag(eig) @ Q.T
    rhs = rng.normal(size=n)
    St, rt = torch.from_numpy(S), torch.from_numpy(rhs)
    info = int(torch.linalg.cholesky_ex(St)[1])
    assert (info != 0) == (kind == "indefinite")
    got = tsb._solve_reduced(St, rt).numpy()
    want = np.linalg.solve(0.5 * (S + S.T) + 1e-8 * np.eye(n), rhs)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


GOLDEN_ITERATIONS = 40
K_GOLDEN = Intrinsics(golden_fixture.FX, golden_fixture.FY,
                      golden_fixture.CX, golden_fixture.CY)


def _golden_cfg(settings_cls):
    cfg = settings_cls()
    cfg.ba_dtype = "float64"
    cfg.ba_gain_threshold = 1e-12
    cfg.ba_global_iterations = GOLDEN_ITERATIONS
    cfg.ba_schur = True
    return cfg


def _golden_state(m):
    return dict(cams=np.stack(m.camera_poses_rf),
                motions=np.stack([m.rigid_motions_rf[f - 1][1]
                                  for f in (1, 2)]),
                dyn_3d=np.stack(m.dyn_3d), stat_3d=np.stack(m.stat_3d))


def test_golden_fixed_point_schur():
    """tests/test_ba_golden.py through the port's Schur path in float64: the
    constructed optimum at that test's bounds (cameras and camera motions
    1e-5; motions, points and the static line 5e-5; dynamic lines 2e-3),
    which the CG step does not reach; and JAX's Schur path to 1e-6."""
    m, gt = golden_fixture.golden.__wrapped__()
    jm = copy.deepcopy(m)
    before = tsb.run_ba_schur.iterations
    cost = tbb.full_batch_optimization(m, K_GOLDEN, _golden_cfg(Settings),
                                       device="cpu")
    assert np.isfinite(cost)
    assert tsb.run_ba_schur.iterations > before
    for f in range(3):
        np.testing.assert_allclose(m.camera_poses_rf[f], gt["cams"][f],
                                   atol=1e-5, err_msg="camera %d" % f)
    for f in range(1, 3):
        want = np.linalg.inv(gt["cams"][f - 1]) @ gt["cams"][f]
        np.testing.assert_allclose(m.rigid_motions_rf[f - 1][0], want,
                                   atol=1e-5)
        np.testing.assert_allclose(m.rigid_motions_rf[f - 1][1], gt["H"],
                                   atol=5e-5, err_msg="motion %d" % f)
    want = golden_fixture._plucker_normed(golden_fixture._plucker(*gt["line"]))
    for f in range(3):
        np.testing.assert_allclose(m.stat_3d[f], gt["Xs"], atol=5e-5)
        np.testing.assert_allclose(m.dyn_3d[f], gt["Xd"][f], atol=5e-5)
        np.testing.assert_allclose(
            golden_fixture._plucker_normed(m.line_plucker[f][0]), want,
            atol=5e-5)
        np.testing.assert_allclose(
            golden_fixture._plucker_normed(m.dline_plucker[f][0]),
            golden_fixture._plucker_normed(
                golden_fixture._plucker(*gt["dlines"][f])), atol=2e-3)

    K = JaxIntrinsics(*(jnp.float32(v) for v in (
        golden_fixture.FX, golden_fixture.FY, golden_fixture.CX,
        golden_fixture.CY)))
    jbb.full_batch_optimization(jm, K, cfg=_golden_cfg(JaxSettings),
                                use_lines=True)
    ref, got = _golden_state(jm), _golden_state(m)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6,
                                   err_msg=k)


class _Chosen(Exception):
    pass


def _spy(name):
    def run(*a, **k):
        raise _Chosen(name)
    return run


@pytest.mark.parametrize("case", [
    "none", "none-over-max", "schur", "schur-over-max", "cg",
    "schur-split", "float64", "mixed"])
@pytest.mark.parametrize("entry", ["full", "partial"])
def test_step_selection_matches_jax(case, entry, monkeypatch):
    """Both packages' ``ba_builder`` take the same step: JAX's rule in
    ``_run_fused``.  With ``cfg=None`` the Schur step where the reduced
    system fits (the fault the port had, ROADMAP C3); CG above
    ``MAX_DENSE_DOF`` (set to 12 dof here, under the golden map's 30), with
    ``ba_schur`` off, or with the split loop (``ba_fused`` off)."""
    jcfg = None
    if not case.startswith("none"):
        jcfg = JaxSettings()
        jcfg.ba_schur = case != "cg"
        jcfg.ba_fused = case != "schur-split"
        if case in ("float64", "mixed"):
            jcfg.ba_dtype = case
    if case.endswith("over-max"):
        monkeypatch.setattr(jsb, "MAX_DENSE_DOF", 12)
        monkeypatch.setattr(tsb, "MAX_DENSE_DOF", 12)
    monkeypatch.setattr(jsb, "run_ba_fused_schur", _spy("schur"))
    monkeypatch.setattr(jba, "run_ba_fused", _spy("cg"))
    monkeypatch.setattr(jba, "run_ba", _spy("cg"))
    monkeypatch.setattr(tsb, "run_ba_schur", _spy("schur"))
    monkeypatch.setattr(tba, "run_ba", _spy("cg"))
    m, _ = golden_fixture.golden.__wrapped__()
    K = JaxIntrinsics(*(jnp.float32(v) for v in (
        golden_fixture.FX, golden_fixture.FY, golden_fixture.CX,
        golden_fixture.CY)))
    tcfg = None if jcfg is None else settings_from_jax(jcfg)
    if entry == "full":
        calls = (lambda: jbb.full_batch_optimization(m, K, cfg=jcfg),
                 lambda: tbb.full_batch_optimization(m, K_GOLDEN, tcfg,
                                                     device="cpu"))
    else:
        calls = (lambda: jbb.partial_batch_optimization(m, K, 3, cfg=jcfg),
                 lambda: tbb.partial_batch_optimization(m, K_GOLDEN, 3, tcfg,
                                                        device="cpu"))
    chosen = []
    for call in calls:
        with pytest.raises(_Chosen) as e:
            call()
        chosen.append(str(e.value))
    want = "schur" if case in ("none", "schur", "float64", "mixed") else "cg"
    assert chosen == [want, want]
