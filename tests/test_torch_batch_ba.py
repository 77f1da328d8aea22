"""sdpl_slam_torch.solvers.batch_ba against sdpl_slam_tpu.solvers.batch_ba
on the same graphs: the JAX package's ``build_graph`` over a map that the
JAX package tracked (the 640x192 synthetic sequence, 7 frames, as in
tests/test_batch_ba.py), carried over by ``utils.convert.graph_from_jax``
with JAX's padding rows flagged invalid.

The component parity runs in float64 on both sides, where it tests the
formulas rather than float32 rounding: block-Jacobi CG at the production
tolerance amplifies rounding along weakly determined directions, so two
float32 LM runs part after a step or two while landing in the same basin
(tests/test_batch_ba.py says the same of JAX's own two LM loops).  Every
tolerance is written at its assertion.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_ba_golden as golden_fixture
from sdpl_slam_tpu.models.system import System as JaxSystem
from sdpl_slam_tpu.ops.geometry import Intrinsics as JaxIntrinsics
from sdpl_slam_tpu.solvers import ba_builder as jbb
from sdpl_slam_tpu.solvers import batch_ba as jba
from sdpl_slam_torch.solvers import ba_builder as tbb
from sdpl_slam_torch.solvers import batch_ba as tba
from sdpl_slam_torch.utils.convert import graph_from_jax
from synthetic import SynthConfig, SynthSequence, synth_settings

torch.set_num_threads(2)

FAMILIES = ("cam", "mot", "xs", "ls", "xd", "ld")


def x64():
    return jbb._x64_scope(True)


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
    return sys


def _pair(graph_np):
    """(JAX graph in float64, the port's graph, JAX state, port state)."""
    jg = jbb._cast_graph(graph_np, jnp.float64)
    tg = graph_from_jax(jg, "cpu")
    with x64():
        js = jba.BAState(*(jnp.asarray(getattr(jg, k)) for k in (
            "cam_T0", "mot_T0", "Xs0", "Ls_U0", "Ls_w0", "Xd0", "Ld_U0",
            "Ld_w0")))
    return jg, tg, js, tba.initial_state(tg)


@pytest.fixture(scope="module")
def full_graph(tracked):
    m = tracked.map
    g, _ = jbb.build_graph(m, tracked.tracker.K, 0, m.n_frames,
                           motion_init_identity=True, prior_info=1e5)
    return _pair(g)


@pytest.fixture(scope="module")
def window_graph(tracked):
    m = tracked.map
    g, _ = jbb.build_graph(m, tracked.tracker.K, m.n_frames - 5, m.n_frames,
                           motion_init_identity=False, prior_info=1e7)
    return _pair(g)


@pytest.fixture(scope="module")
def golden_graph():
    """The golden fixture's map (tests/test_ba_golden.py) moved onto its
    ground truth: every measurement is consistent, so every residual is
    zero up to the float32 rounding of the stored measurements."""
    m, gt = golden_fixture.golden.__wrapped__()
    for f in range(3):
        m.camera_poses[f] = gt["cams"][f].astype(np.float32)
        m.stat_3d[f] = gt["Xs"].astype(np.float32)
        m.dyn_3d[f] = gt["Xd"][f].astype(np.float32)
        m.line_plucker[f] = golden_fixture._plucker(*gt["line"]).astype(
            np.float32)[None]
    for f in range(1, 3):
        m.rigid_motions[f - 1][1] = gt["H"].astype(np.float32)
    K = JaxIntrinsics(*(jnp.float32(v) for v in (
        golden_fixture.FX, golden_fixture.FY, golden_fixture.CX,
        golden_fixture.CY)))
    g, _ = jbb.build_graph(m, K, 0, 3, motion_init_identity=False,
                           prior_info=1e5)
    return _pair(g)


def _weights(tracked):
    """JAX's weights and the port's; the port has no altitude edge (the
    reference compiles it out, and JAX's is off by default)."""
    wj = jbb._weights_from_cfg(tracked.settings if tracked else None)
    assert not wj.use_altitude
    port = {f.name for f in dataclasses.fields(tba.BAWeights)}
    return wj, tba.BAWeights(**{k: v for k, v in dataclasses.asdict(wj).items()
                                if k in port})


EDGE_NAMES = ("odo", "smo", "sp", "sl", "dp", "tern", "dl", "ltern")


def _check_edge(pair, wj, wt, name, zero_residual=False):
    jg, tg, js, ts = pair
    with x64():
        names = [e[0] for e in jba._edges(jg, js, wj)]
        r, jacs, wgt, rho = jba._linearize_edge(jg, js, wj, names.index(name))
        r, wgt, rho = np.asarray(r), np.asarray(wgt), float(rho)
        jacs = tuple(np.asarray(J) for J in jacs)
    lin, _, _ = tba._linearize(tg, ts, wt)
    o = {e["name"]: e for e in lin}[name]
    assert (o["wgt"] > 0).any(), name
    if zero_residual:
        assert np.abs(r).max() < 1e-4, name
    # float64 on both sides: 1e-7 of each block's largest entry (a line
    # distance near 0 is the norm of a difference of ~10 m terms, whose
    # direction float64 gives to ~1e-9 of the block)
    for a, b in zip((r,) + jacs, (o["r"],) + o["jacs"]):
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-7 * max(np.abs(a).max(), 1e-3),
                                   err_msg=name)
    np.testing.assert_allclose(o["wgt"].numpy(), wgt, rtol=1e-9, err_msg=name)
    np.testing.assert_allclose(float(o["rho"]), rho, rtol=1e-9,
                               atol=1e-15, err_msg=name)


@pytest.mark.parametrize("name", EDGE_NAMES)
def test_edge_linearization_matches_jax(tracked, full_graph, name):
    """Residuals, Jacobian blocks, robust weights and cost of each edge
    type against JAX's ``_linearize_edge`` (vmap of jacfwd)."""
    wj, wt = _weights(tracked)
    _check_edge(full_graph, wj, wt, name)


@pytest.mark.parametrize("name", EDGE_NAMES)
def test_edge_linearization_at_zero_residual(golden_graph, name):
    """The same at the golden fixture's ground truth: zero residuals, where
    the clips of so3_log, the parallel branch of the line distance and
    the zero of |.| decide the derivative."""
    wj, wt = _weights(None)
    _check_edge(golden_graph, wj, wt, name, zero_residual=True)


def _jax_lin(pair, wj):
    jg, _, js, _ = pair
    specs = jba._edges(jg, js, wj)
    lin = []
    for i, (name, _, verts, _, _, _, _, _) in enumerate(specs):
        r, jacs, wgt, _ = jba._linearize_edge(jg, js, wj, i)
        lin.append(dict(name=name, verts=verts, r=r, jacs=jacs, wgt=wgt))
    return lin, jba._prior_lin(js, jg.prior_frame, jg.prior_meas)


def test_gradient_hvp_block_diagonal_match_jax(tracked, full_graph):
    jg, tg, js, ts = full_graph
    wj, wt = _weights(tracked)
    rng = np.random.default_rng(11)
    with x64():
        lin, prior = _jax_lin(full_graph, wj)
        template = jba._zeros_delta(js)
        v = {k: rng.normal(size=np.shape(template[k])) for k in FAMILIES}
        g, hvp, bd = jba._hvp_and_grad(lin, prior, jg, template)
        hv = hvp({k: jnp.asarray(v[k]) for k in FAMILIES})
        g, hv, bd = ({k: np.asarray(d[k]) for k in FAMILIES}
                     for d in (g, hv, bd))
    tlin, tprior, _ = tba._linearize(tg, ts, wt)
    tg_, thvp, tbd = tba._hvp_and_grad(tlin, tprior, tg, ts)
    flat_v = torch.cat([torch.from_numpy(v[k]).reshape(-1) for k in FAMILIES])
    got = {"gradient": tba._views(tg_, ts),
           "hvp": tba._views(thvp(flat_v), ts), "block diagonal": tbd}
    for what, ref in (("gradient", g), ("hvp", hv), ("block diagonal", bd)):
        for k in FAMILIES:
            # float64: 1e-9 of the family's largest entry
            np.testing.assert_allclose(
                got[what][k].numpy(), ref[k], rtol=0,
                atol=1e-9 * max(np.abs(ref[k]).max(), 1e-6),
                err_msg="%s %s" % (what, k))


@pytest.mark.parametrize("n", [2, 3, 4, 6])
def test_inv_spd_small_matches_jax(n):
    """Damped SPD blocks (H_ii + lambda), float32: the port against JAX and
    against the float64 inverse, to 1e-5 of each block's largest entry;
    an empty batch too."""
    rng = np.random.default_rng(n)
    B = rng.normal(size=(500, n, n))
    A = (B @ B.transpose(0, 2, 1) + 0.5 * n * np.eye(n)).astype(np.float32)
    got = tba._inv_spd_small(torch.from_numpy(A)).numpy()
    ref = np.asarray(jba._inv_spd_small(jnp.asarray(A)))
    exact = np.linalg.inv(A.astype(np.float64))
    scale = np.abs(exact).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(got - ref) <= 1e-5 * scale)
    assert np.all(np.abs(got - exact) <= 1e-5 * scale)
    empty = tba._inv_spd_small(torch.zeros((0, n, n)))
    assert tuple(empty.shape) == (0, n, n)


def test_gn_step_matches_jax(tracked, full_graph):
    """One damped Gauss-Newton step, CG solved to cg_rtol 1e-9 (the damped
    system's unique solution): JAX's split step (``ba_gn_step_split``;
    tests/test_batch_ba.py holds it equal to ``ba_gn_step``)."""
    jg, tg, js, ts = full_graph
    wj, wt = _weights(tracked)
    with x64():
        d, cost, gain_den = jba.ba_gn_step_split(
            jg, js, wj, jnp.float64(1e-2), cg_iters=300, cg_rtol=1e-9)
        d = {k: np.asarray(d[k]) for k in FAMILIES}
        cost, gain_den = float(cost), float(gain_den)
    x, tcost, tgain, n_cg = tba.ba_gn_step(tg, ts, wt, 1e-2, cg_iters=300,
                                           cg_rtol=1e-9)
    assert 0 < int(n_cg) < 300
    np.testing.assert_allclose(float(tcost), cost, rtol=1e-9)
    np.testing.assert_allclose(float(tgain), gain_den, rtol=1e-6)
    for k in FAMILIES:
        # CG stops at rz <= 1e-9 rz0; what is left of the error lies along
        # the least determined directions: 1e-3 of the family's largest
        # entry (tests/test_batch_ba.py holds JAX's two steps to 5e-3)
        np.testing.assert_allclose(
            x[k].numpy(), d[k], rtol=0,
            atol=1e-3 * max(np.abs(d[k]).max(), 1e-9), err_msg=k)


def test_lm_matches_jax(tracked, window_graph):
    """``run_ba`` against ``run_ba_fused`` on the window graph (the partial
    BA's: motions from their estimates, prior 1e7, gain 1e-3), float64:
    the cost after each of the first three iterations to rtol 1e-3, and the
    converged cost (rtol 5e-3) and state: camera poses (1e-4), motions,
    points and static lines (1e-6), dynamic lines (2e-3: a line vertex is
    pulled only by flat-bottomed point-to-line distances, and its last
    ~1e-3 converges slowly, as tests/test_ba_golden.py says)."""
    jg, tg, js, ts = window_graph
    wj, wt = _weights(tracked)
    before = (tba.run_ba.iterations, tba.run_ba.host_syncs)
    for k in (1, 2, 3):
        with x64():
            _, cj, itj = jba.run_ba_fused(jg, wj, max_iters=k,
                                          gain_threshold=1e-3)
            cj, itj = float(cj), int(itj)
        _, ct, itt = tba.run_ba(tg, wt, max_iters=k, gain_threshold=1e-3)
        assert itt == itj == k
        np.testing.assert_allclose(float(ct), cj, rtol=1e-3, err_msg=str(k))
    assert tba.run_ba.iterations - before[0] == 6
    assert tba.run_ba.host_syncs - before[1] >= 6
    with x64():
        sj, cj, _ = jba.run_ba_fused(jg, wj, max_iters=100,
                                     gain_threshold=1e-3)
        sj, cj = {k: np.asarray(v) for k, v in sj._asdict().items()}, float(cj)
    st, ct, _ = tba.run_ba(tg, wt, max_iters=100, gain_threshold=1e-3)
    np.testing.assert_allclose(float(ct), cj, rtol=5e-3)
    valid = {"cam_T": tg.cam_valid, "mot_T": tg.mot_valid, "Xs": tg.Xs_valid,
             "Ls_U": tg.Ls_valid, "Ls_w": tg.Ls_valid, "Xd": tg.Xd_valid,
             "Ld_U": tg.Ld_valid, "Ld_w": tg.Ld_valid}
    atol = {"cam_T": 1e-4, "Ld_U": 2e-3, "Ld_w": 2e-3}
    for k, v in valid.items():
        v = v.numpy()
        assert v.any(), k
        np.testing.assert_allclose(getattr(st, k).numpy()[v], sj[k][v], rtol=0,
                                   atol=atol.get(k, 1e-6), err_msg=k)


def test_run_ba_without_line_edges(tracked):
    """Lines off: three edge types have no rows (the graph is built at
    exact counts); the LM still runs, and counts its iterations and reads."""
    from sdpl_slam_torch.ops.geometry import Intrinsics

    m = tracked.map
    K = Intrinsics(*(float(v) for v in (tracked.tracker.K.fx,
                                         tracked.tracker.K.fy,
                                         tracked.tracker.K.cx,
                                         tracked.tracker.K.cy)))
    graph, _ = tbb.build_graph(m, K, m.n_frames - 5, m.n_frames,
                               motion_init_identity=False, prior_info=1e7,
                               use_lines=False, device="cpu")
    assert graph.sl_cam.numel() == graph.dl_cam.numel() == 0
    assert graph.ltern_prev.numel() == graph.Ls_U0.shape[0] == 0
    wt = _weights(tracked)[1]
    cost0 = float(tba._cost_only(graph, tba.initial_state(graph), wt))
    before = (tba.run_ba.iterations, tba.run_ba.cg_iterations,
              tba.run_ba.host_syncs)
    state, cost, it = tba.run_ba(graph, wt, max_iters=3)
    assert 1 <= it <= 3 and np.isfinite(float(cost))
    assert float(cost) <= cost0
    assert tba.run_ba.iterations - before[0] == it
    assert 0 < tba.run_ba.cg_iterations - before[1] <= 40 * it
    assert tba.run_ba.host_syncs - before[2] >= it
    assert all(torch.isfinite(x).all() for x in state)
