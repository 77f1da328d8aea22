"""The non-joint frame program of sdpl_slam_torch
(``models/frame_program.py``: ``nonjoint_cam_only`` / ``nonjoint_track``,
run by ``nonjoint_program``) against the JAX package's jitted
``_init_cam``, ``_cam_pose_only`` and object chain, and against the path it
replaced.

Frames of the port's generator (640x192, 2 moving objects, lines
injected) go through a ``System`` with ``use_joint_optimization = False``
on the CPU with JAX's RANSAC draws; every frame's arguments of
``Tracking._solve_frame_nonjoint`` are recorded.  On a recorded frame's
packed input:

- the camera: the JAX package's ``_init_cam`` then ``_cam_pose_only``
  (tests/test_torch_pose_only.py's bounds: pose within 5e-5, inlier masks
  equal, cost within rtol 1e-3);
- the objects on the port's solved pose: JAX's object init and its
  objects' joint LM (``_obj_init_solve``'s parts), the init given the
  last pose and the LM its inverse, where the JAX package's non-joint
  caller hands both the inverse (ROADMAP C4); the bounds of
  tests/test_torch_ransac_solvers.py's flagship step (poses within 1e-4,
  flows within 1e-3, inlier masks and init counts equal);
- the whole run: the map equals, bit for bit, the one the eager non-joint
  solve gave before the program existed (a copy of that path is kept
  here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpl_slam_tpu.models import frame as jfr
from sdpl_slam_tpu.models.tracking import Tracking as JaxTracking
from sdpl_slam_tpu.ops import geometry as jg
from sdpl_slam_tpu.ops import lie as jlie
from sdpl_slam_tpu.ops import ransac as jransac
from sdpl_slam_tpu.solvers import frame_solvers as jfs
from sdpl_slam_tpu.utils.config import Settings as JaxSettings
from sdpl_slam_torch.models import frame_program as fp
from sdpl_slam_torch.models.resident import init_model
from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.models.tracking import Tracking, _np_world_points, _unpack
from sdpl_slam_torch.ops import geometry
from sdpl_slam_torch.solvers import frame_solvers as fs
from sdpl_slam_torch.utils.synthetic import (SynthConfig, SynthSequence,
                                             synth_settings)

torch.set_num_threads(2)

N = 4
CAM_POSE_ATOL, COST_RTOL = 5e-5, 1e-3      # tests/test_torch_pose_only.py
OBJ_POSE_ATOL, FLOW_ATOL = 1e-4, 1e-3      # tests/test_torch_ransac_solvers.py


def jax_uniforms(self, f_id, lane, n_hyp):
    """The JAX tracker's draws (tests/test_torch_chained.py)."""
    key = jax.random.PRNGKey(f_id)
    if lane > 0:
        key = jax.random.fold_in(jax.random.fold_in(key, 7), lane - 1)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n_hyp, 3))))


def _settings():
    s = synth_settings(SynthConfig(n_frames=N, n_objects=2))
    s.use_joint_optimization = False
    s.run_local_ba = False
    s.run_global_ba = False
    s.pipelined_tracking = False
    return s


def _run(monkeypatch, solve=None):
    """N frames through the non-joint path on the CPU with JAX's draws;
    ``solve`` replaces ``Tracking._solve_frame_nonjoint``.  -> (system,
    [(f_id, the solve's arguments)])."""
    seq = SynthSequence(SynthConfig(n_frames=N, n_objects=2))
    rec = []
    plain = solve or Tracking._solve_frame_nonjoint

    def recording(self, *args):
        rec.append((self.f_id, args))
        return plain(self, *args)

    with monkeypatch.context() as mp:
        mp.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
        mp.setattr(Tracking, "_solve_frame_nonjoint", recording)
        s = System(_settings(), verbose=False, device="cpu")
        for t in range(N):
            f = seq.frame(t)
            s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                         f.obj_rows, t * 0.1, N, line_detections=f.lines)
    return s, rec


@pytest.fixture(scope="module")
def recorded():
    mp = pytest.MonkeyPatch()
    try:
        s, rec = _run(mp)
    finally:
        mp.undo()
    assert len(rec) == N - 1
    # the last frame: a camera moved from the origin and two object lanes
    f_id, args = rec[-1]
    assert args[-1] is not None and args[-1]["pt_obs"].shape[0] == 2
    assert not np.allclose(args[1]["pose"], np.eye(4), atol=1e-3)
    tr = Tracking(s.settings, device="cpu")
    tr.f_id = f_id
    js = JaxSettings(**{k: getattr(s.settings, k)
                        for k in JaxSettings.__dataclass_fields__
                        if hasattr(s.settings, k)})
    return dict(system=s, rec=rec, tr=tr, f_id=f_id, args=args,
                jt=JaxTracking(js))


def _packed(recorded, monkeypatch, MB):
    """The recorded frame's packed input with ``MB`` object lanes (none,
    or both as recorded; the tracker's own packing, JAX's draws) and its
    named views."""
    monkeypatch.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
    tr, args = recorded["tr"], recorded["args"]
    buckets = None if MB == 0 else args[-1]
    flat, mb, use_obj_lines = tr._pack_nonjoint(*args[:-1], buckets)
    assert mb == MB and flat.dtype == np.float32
    caps = fp.frame_caps(tr)
    spec = fp.nonjoint_in_spec(caps, MB)
    assert len(flat) == fp.numel(spec)
    views, o = {}, 0
    for name, shape, kind in spec:
        n = int(np.prod(shape))
        views[name] = flat[o:o + n].reshape(shape)
        o += n
        if kind == "bool":
            views[name] = views[name] > 0.5
    return flat, views, caps, use_obj_lines


def test_nonjoint_cam_only_matches_jax(recorded, monkeypatch):
    """``nonjoint_cam_only`` against JAX's ``_init_cam`` (key of the
    frame) then ``_cam_pose_only`` on the same inputs."""
    tr = recorded["tr"]
    flat, a, caps, _ = _packed(recorded, monkeypatch, 0)
    out, reads = fp.nonjoint_cam_only(tr.cfg, tr.K, caps,
                                      torch.from_numpy(flat))
    assert reads == 0
    got = _unpack(out.numpy(), fp.nonjoint_out_spec(caps, 0))

    jt, j = recorded["jt"], jnp.asarray
    T_init, subset = jt._init_cam(
        jax.random.PRNGKey(recorded["f_id"]), j(a["velocity"]), j(a["T_lw"]),
        j(a["s_obs"]), j(a["s_depth"]), j(a["s_cur_uv"]), j(a["s_cur_d"]),
        j(a["s_valid"]))
    lcoef = jg.infinite_line_image(j(a["l_uv"][:, :2]), j(a["l_uv"][:, 2:]))
    ref = jt._cam_pose_only(T_init, j(a["X_w"]), j(a["s_cur_uv"]), subset,
                            j(a["l_Xs"]), j(a["l_Xe"]), lcoef,
                            j(a["l_use"]))
    np.testing.assert_allclose(got["pose"], np.asarray(ref.pose),
                               atol=CAM_POSE_ATOL)
    np.testing.assert_array_equal(got["point_inlier"],
                                  np.asarray(ref.point_inlier))
    np.testing.assert_array_equal(got["line_inlier"],
                                  np.asarray(ref.line_inlier))
    np.testing.assert_allclose(float(got["cost"]), float(ref.final_cost),
                               rtol=COST_RTOL)
    assert got["point_inlier"].sum() > 0.5 * a["s_valid"].sum()


def _jax_obj_init(jt, cfg, n_hyp, key, model, T_lw, last_uv, last_depth,
                  cur_uv, cur_depth, valid):
    """The JAX package's GetInitModelObj for one lane
    (``init_model_obj_one`` inside its ``_obj_init_solve``), from its
    public parts: RANSAC against the motion model."""
    K = jt.K
    X_w = jfr.world_points(K, T_lw, last_uv, last_depth)
    X_c = jg.backproject(K, cur_uv, cur_depth)
    rs = jransac.ransac_rigid_init(
        X_w, cur_uv, X_c, valid & (cur_depth > 0), K, key,
        n_hypotheses=n_hyp, reproj_thresh=cfg.pnp_reproj_error)
    Xm = jlie.transform_point(model, X_w)
    rpe = jnp.linalg.norm(cur_uv - jg.project(K, Xm), axis=-1)
    mm_inl = valid & (Xm[:, 2] > 0) & (rpe < cfg.pnp_reproj_error)
    mm_n = jnp.sum(mm_inl.astype(jnp.int32))
    use = rs.n_inliers > mm_n
    return (jnp.where(use, rs.pose, model), jnp.where(use, rs.inliers, mm_inl),
            jnp.maximum(rs.n_inliers, mm_n))


def test_nonjoint_objects_match_jax(recorded, monkeypatch):
    """The two object lanes of ``nonjoint_track`` against the JAX
    package's object chain on the port's solved camera pose and the same
    draws:
    its init given the last pose (its inlier sets and counts also equal
    those of ``_obj_init_solve`` called with the pose), its objects' LM
    (``_obj_solve``) given the pose's inverse."""
    tr, jt = recorded["tr"], recorded["jt"]
    MB = 2
    flat, a, caps, lines = _packed(recorded, monkeypatch, MB)
    out, _ = fp.nonjoint_track(tr.cfg, tr.K, caps, torch.from_numpy(flat), MB,
                               lines)
    got = _unpack(out.numpy(), fp.nonjoint_out_spec(caps, MB))

    j, cfg = jnp.asarray, tr.cfg
    keys = jnp.stack([
        jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(1000 + recorded["f_id"]), 7), k)
        for k in range(MB)])
    # the draws in the packed input are those keys' (the port's objects
    # draw from the stream 1000 + f_id)
    np.testing.assert_array_equal(
        a["u_obj"], np.stack([np.asarray(jax.random.uniform(
            keys[k], (tr.n_hyp_obj, 3))) for k in range(MB)]))
    models = j(np.einsum("ij,njk->nik", got["pose"], a["H_prev"]).astype(
        np.float32))
    T_lw, T_wl = j(a["T_lw"]), j(a["T_wl"])
    T_inits, init_inl, init_n = jax.jit(jax.vmap(
        lambda k, m, lu, ld, cu, cd, v: _jax_obj_init(
            jt, cfg, tr.n_hyp_obj, k, m, T_lw, lu, ld, cu, cd, v)))(
        keys, models, j(a["pt_obs"]), j(a["pt_depth"]), j(a["pt_cur_uv"]),
        j(a["pt_cur_d"]), j(a["pt_valid"]))
    pts = jfs.PointBundle(obs=j(a["pt_obs"]), flow0=j(a["pt_flow0"]),
                          depth=j(a["pt_depth"]), valid=j(a["pt_valid"]))
    lns = jfs.LineBundle(obs=j(a["ln_obs"]), flow0=j(a["ln_flow0"]),
                         depth=j(a["ln_depth"]), valid=j(a["ln_valid"]))
    # JAX's own chain called with the pose: the init's half of it is right
    _, inl_c, n_c = jt._obj_init_solve(keys, models, T_lw, pts, lns,
                                       j(a["pt_cur_uv"]), j(a["pt_cur_d"]),
                                       lines)
    np.testing.assert_array_equal(np.asarray(init_inl), np.asarray(inl_c))
    np.testing.assert_array_equal(np.asarray(init_n), np.asarray(n_c))
    ref = jt._obj_solve(T_inits, T_wl, pts._replace(valid=pts.valid & init_inl),
                        lns, lines)

    np.testing.assert_array_equal(got["o_init_n"], np.asarray(init_n))
    np.testing.assert_allclose(got["o_pose"], np.asarray(ref.pose),
                               atol=OBJ_POSE_ATOL)
    np.testing.assert_allclose(got["o_flow"], np.asarray(ref.flow),
                               atol=FLOW_ATOL)
    np.testing.assert_allclose(got["o_line_flow"], np.asarray(ref.line_flow),
                               atol=FLOW_ATOL)
    np.testing.assert_array_equal(got["o_point_inlier"],
                                  np.asarray(ref.point_inlier))
    np.testing.assert_array_equal(got["o_line_inlier"],
                                  np.asarray(ref.line_inlier))
    assert got["o_point_inlier"].sum() > 0


def _parent_solve_frame_nonjoint(self, velocity_np, last, s_uv, s_d,
                                 last_s_valid, l_uv, l_use, buckets):
    """``Tracking._solve_frame_nonjoint`` as it was before the non-joint
    program: each input copied apart, the camera init, the pose-only LM
    and the object chain run eagerly, each output copied home."""
    from sdpl_slam_torch.models.frame_program import solve_objects

    cfg, K = self.cfg, self.K

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    T_lw = t(last["pose"])
    u_cam = self._ransac_uniforms(self.f_id, 0, self.n_hyp_cam)[None]
    T_init, subset, _ = init_model(
        K, cfg.pnp_reproj_error, u_cam, (t(velocity_np) @ T_lw)[None], T_lw,
        t(last["stat_uv"])[None], t(last["stat_depth"])[None], t(s_uv)[None],
        t(s_d)[None], t(last_s_valid, torch.bool)[None])
    depth_n = last["stat_depth"]
    if cfg.nonjoint_add_noise:
        nrng = np.random.default_rng(self.f_id)
        sigma = depth_n * depth_n / (725.0 * 0.5) * 0.15
        depth_n = (depth_n + sigma * nrng.standard_normal(depth_n.shape)
                   ).astype(np.float32)
    X_w = _np_world_points(K, last["pose"], last["stat_uv"], depth_n)
    l3d = last["line_3d"]
    l_cur = t(l_uv)
    lcoef = geometry.infinite_line_image(l_cur[:, :2], l_cur[:, 2:])
    cam = fs.solve_pose_only(
        T_init[0], t(X_w), t(s_uv), subset[0], t(l3d[:, :3]), t(l3d[:, 3:]),
        lcoef, t(l_use, torch.bool), K, rp_thres=0.01, line_weight_thr=50,
        use_lines=cfg.use_lines)
    outs = dict(pose=cam.pose, point_inlier=cam.point_inlier,
                line_inlier=cam.line_inlier)
    if buckets is not None:
        b = {k: (t(v, torch.bool) if v.dtype == bool else t(v))
             for k, v in buckets.items() if k != "any_lines"}
        u_obj = torch.stack([
            self._ransac_uniforms(1000 + self.f_id, k + 1, self.n_hyp_obj)
            for k in range(b["pt_obs"].shape[0])])
        objs, syncs = solve_objects(
            cfg, K, cam.pose, T_lw, torch.linalg.inv_ex(T_lw)[0], b, u_obj,
            buckets["any_lines"] and cfg.use_lines)
        self.lm_host_syncs += syncs
        outs.update(objs)
    out = {k: v.cpu().numpy() for k, v in outs.items()}
    if buckets is not None:
        b = buckets
        Xp_w = _np_world_points(K, last["pose"], b["pt_obs"], b["pt_depth"])
        Xc_w = _np_world_points(K, out["pose"], b["pt_cur_uv"], b["pt_cur_d"])
        f3 = Xc_w - Xp_w
        sfn = np.sqrt(f3[..., 0] ** 2 + f3[..., 2] ** 2)
        v = b["pt_sfvalid"].astype(np.float32)
        nv = np.maximum(v.sum(axis=-1), 1.0)
        out["o_static_frac"] = (
            (v * (sfn < cfg.sf_mg_thres)).sum(axis=-1) / nv)
    return out


def _assert_same(a, b, what):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, "%s[%d]" % (what, k))
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)


def test_program_map_equals_parent_path(recorded, monkeypatch):
    """The run through the non-joint program gives, bit for bit, the map of
    the same frames through the eager path it replaced; both make LM host
    reads only in the objects' LM (the CPU runs the programs eagerly)."""
    import dataclasses

    s = recorded["system"]
    ref, rec = _run(monkeypatch, _parent_solve_frame_nonjoint)
    assert len(rec) == N - 1
    assert s.tracker.lm_host_syncs == ref.tracker.lm_host_syncs > 0
    for f in dataclasses.fields(s.map):
        if f.name not in ("frame_times", "lba_times"):
            _assert_same(getattr(s.map, f.name), getattr(ref.map, f.name),
                         f.name)
    assert s.map.n_frames == N and sum(
        1 for mo in s.map.rigid_motions if len(mo) > 1) >= 2
    prog = fp.nonjoint_program(s.tracker.cfg, s.tracker.K,
                               fp.frame_caps(s.tracker), 2, True, "cpu")
    assert not prog.graph and prog.capture_s is None
    assert prog is not fp.frame_program(s.tracker.cfg, s.tracker.K,
                                        fp.frame_caps(s.tracker), 2, True,
                                        "cpu")
