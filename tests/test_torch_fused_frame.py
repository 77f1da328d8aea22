"""The host path's fused frame and detector programs of sdpl_slam_torch
(``models/frame_program.py``) against the JAX package's
``fused_track_packed`` / ``fused_cam_only_packed`` and its detectors.

The packed input the port builds for a frame equals, value for value, the
buffer the JAX package's ``_dispatch_fused`` builds from the same inputs
(its RANSAC draws follow it); that buffer through both packages' fused
frames gives the same outputs within the solver parity bounds of
tests/test_torch_ransac_solvers.py; the eager program gives, bit for bit,
what the tracker's solve gave before the program existed (a copy of that
path is kept here); the detector program equals the eager detectors.

The frames are tests/synthetic.py's (640x192, 2 moving objects) through
the port's ``System`` on the CPU with JAX's RANSAC draws; cam-only and
one-lane inputs are cut from a recorded two-lane frame.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpl_slam_tpu.models.tracking import Tracking as JaxTracking
from sdpl_slam_torch.models import frame_program as fp
from sdpl_slam_torch.models.resident import init_model, scene_flow_static_frac
from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.models.tracking import Tracking, _unpack
from sdpl_slam_torch.ops import fast as fast_ops
from sdpl_slam_torch.ops import lines as line_ops
from sdpl_slam_torch.solvers import frame_solvers as fs
from sdpl_slam_torch.utils import convert
from sdpl_slam_torch.utils.device import host_array
from synthetic import SynthConfig, SynthSequence, synth_settings

torch.set_num_threads(2)

N = 3                       # frames tracked; frame 1 is recorded
POSE_ATOL, FLOW_ATOL = 1e-4, 1e-3     # tests/test_torch_ransac_solvers.py
FRAC_ATOL = 1e-6


def jax_uniforms(self, f_id, lane, n_hyp):
    """The JAX tracker's draws (tests/test_torch_system.py)."""
    key = jax.random.PRNGKey(f_id)
    if lane > 0:
        key = jax.random.fold_in(jax.random.fold_in(key, 7), lane - 1)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n_hyp, 3))))


@pytest.fixture(scope="module")
def recorded():
    """The first tracked frame's arguments of ``Tracking._pack_frame``
    (two object lanes, object lines valid), the JAX settings and a fresh
    port tracker at that frame."""
    cfg = SynthConfig(n_frames=N, n_objects=2)
    seq = SynthSequence(cfg)
    js = synth_settings(cfg)
    js.run_local_ba = False
    js.pipelined_tracking = False
    rec = []
    pack = Tracking._pack_frame

    def recording(self, *args):
        rec.append((self.f_id, args))
        return pack(self, *args)

    mp = pytest.MonkeyPatch()
    mp.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
    mp.setattr(Tracking, "_pack_frame", recording)
    try:
        s = System(convert.settings_from_jax(js), verbose=False, device="cpu")
        for t in range(N):
            f = seq.frame(t)
            s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                         f.obj_rows, t * 0.1, N, line_detections=f.lines)
    finally:
        mp.undo()
    f_id, args = rec[0]
    assert args[-1]["pt_obs"].shape[0] == 2 and args[-1]["any_lines"]
    tr = Tracking(s.settings, device="cpu")
    tr.f_id = f_id
    return dict(js=js, tr=tr, f_id=f_id, args=args, gray=seq.frame(1).gray)


def _variant(args, MB):
    """The recorded frame's arguments with ``MB`` object lanes: none (the
    camera only), the first lane, or both as recorded."""
    b = args[-1]
    if MB == 0:
        return args[:-1] + (None,)
    if MB == b["pt_obs"].shape[0]:
        return args
    cut = {k: v[:MB] for k, v in b.items() if k != "any_lines"}
    cut["any_lines"] = bool(cut["ln_valid"].any())
    return args[:-1] + (cut,)


@pytest.fixture(scope="module")
def jax_tracker(recorded):
    return JaxTracking(recorded["js"])


@pytest.mark.parametrize("MB", [0, 1, 2])
def test_packed_input_matches_jax(recorded, monkeypatch, MB):
    """``_pack_frame``'s buffer = ``_dispatch_fused``'s buffer, then the
    camera's and each lane's RANSAC draws."""
    monkeypatch.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
    tr, args = recorded["tr"], _variant(recorded["args"], MB)
    flat, mb, use_obj_lines = tr._pack_frame(*args)
    assert mb == MB and flat.dtype == np.float32
    assert len(flat) == fp.numel(fp.in_spec(fp.frame_caps(tr), MB))

    jt = JaxTracking(recorded["js"])
    got = {}
    jt._fused_track = lambda key, buf, *static: got.update(buf=buf,
                                                           static=static)
    jt._fused_cam_only = lambda key, buf: got.update(buf=buf, static=())
    velocity, last = args[0], args[1]
    jt._dispatch_fused(jax.random.PRNGKey(recorded["f_id"]), velocity,
                       last["pose"], *args[1:])
    jbuf = np.asarray(got["buf"])
    assert got["static"] == ((MB, args[-1]["any_lines"]) if MB else ())
    np.testing.assert_array_equal(flat[:len(jbuf)], jbuf)
    draws = [jax_uniforms(tr, recorded["f_id"], 0, tr.n_hyp_cam)]
    draws += [jax_uniforms(tr, recorded["f_id"], k + 1, tr.n_hyp_obj)
              for k in range(MB)]
    np.testing.assert_array_equal(
        flat[len(jbuf):], np.concatenate([d.numpy().ravel() for d in draws]))
    assert use_obj_lines == bool(MB and args[-1]["any_lines"])


@pytest.mark.parametrize("MB,lines", [(0, False), (1, False), (1, True),
                                      (2, False), (2, True)])
def test_fused_frame_matches_jax(recorded, jax_tracker, monkeypatch, MB,
                                 lines):
    """One packed buffer through JAX's ``fused_track_packed`` /
    ``fused_cam_only_packed`` and the port's ``fused_track`` /
    ``fused_cam_only``: poses within 1e-4, flows within 1e-3, inlier masks
    and init counts equal, static fractions within 1e-6."""
    monkeypatch.setattr(Tracking, "_ransac_uniforms", jax_uniforms)
    tr, args = recorded["tr"], _variant(recorded["args"], MB)
    flat, _, _ = tr._pack_frame(*args)
    caps = fp.frame_caps(tr)
    n_jax = fp.numel(fp.in_spec(caps, MB)) - 3 * (
        tr.n_hyp_cam + MB * tr.n_hyp_obj)
    key = jax.random.PRNGKey(recorded["f_id"])
    jt = jax_tracker
    if MB:
        jout = jt._fused_track(key, jnp.asarray(flat[:n_jax]), MB, lines)
        out, _ = fp.fused_track(tr.cfg, tr.K, caps, torch.from_numpy(flat),
                                MB, lines)
    else:
        jout = jt._fused_cam_only(key, jnp.asarray(flat[:n_jax]))
        out, _ = fp.fused_cam_only(tr.cfg, tr.K, caps, torch.from_numpy(flat))
    spec = fp.out_spec(caps, MB)
    ref = jt._np_unpack(np.asarray(jout), jt._out_specs(MB))
    got = _unpack(out.numpy(), spec)
    assert len(ref) == len(spec)
    for (name, _, _), want in zip(spec, ref):
        have = got[name]
        assert have.shape == want.shape, name
        if "pose" in name:
            np.testing.assert_allclose(have, want, atol=POSE_ATOL,
                                       err_msg=name)
        elif "flow" in name:
            np.testing.assert_allclose(have, want, atol=FLOW_ATOL,
                                       err_msg=name)
        elif name == "o_static_frac":
            np.testing.assert_allclose(have, want, atol=FRAC_ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(have, want, err_msg=name)


def _parent_solve_frame(tr, velocity_np, last, s_uv, s_d, last_s_valid,
                        l_use, buckets):
    """``Tracking._solve_frame`` as it was before the fused-frame program:
    each input copied apart, the LMs run eagerly by ``solve_flow_pose``.
    -> the outputs by name (numpy)."""
    cfg, K = tr.cfg, tr.K

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    solve = functools.partial(
        fs.solve_flow_pose, K=K, rp_thres=cfg.rp_thres,
        max_iterations=cfg.lm_iterations, rel_tol=cfg.lm_rel_tol)
    T_lw = t(last["pose"])
    s_obs, s_depth = t(last["stat_uv"])[None], t(last["stat_depth"])[None]
    u_cam = tr._ransac_uniforms(tr.f_id, 0, tr.n_hyp_cam)[None]
    T_init, subset, _ = init_model(
        K, cfg.pnp_reproj_error, u_cam, (t(velocity_np) @ T_lw)[None], T_lw,
        s_obs, s_depth, t(s_uv)[None], t(s_d)[None],
        t(last_s_valid, torch.bool)[None])
    T_wl = torch.linalg.inv(T_lw)
    cam = solve(
        T_init, T_wl,
        fs.PointBundle(s_obs, t(last["stat_flow"])[None], s_depth, subset),
        fs.LineBundle(t(last["line_uv"])[None], t(last["line_flow"])[None],
                      t(last["line_depth"])[None],
                      t(l_use, torch.bool)[None]),
        flow_prior_info=cfg.flow_prior_info_cam,
        line_prior_info=cfg.flow_prior_info_cam, use_lines=cfg.use_lines)
    outs = dict(pose=cam.pose[0], flow=cam.flow[0],
                line_flow=cam.line_flow[0], point_inlier=cam.point_inlier[0],
                line_inlier=cam.line_inlier[0])
    if buckets is not None:
        b = {k: (t(v, torch.bool) if v.dtype == bool else t(v))
             for k, v in buckets.items() if k != "any_lines"}
        pose = cam.pose[0]
        outs["o_static_frac"] = scene_flow_static_frac(
            K, cfg.sf_mg_thres, pose, T_wl, b["pt_obs"], b["pt_depth"],
            b["pt_cur_uv"], b["pt_cur_d"], b["pt_sfvalid"])
        T_models = pose @ b["H_prev"]
        u_obj = torch.stack([
            tr._ransac_uniforms(tr.f_id, k + 1, tr.n_hyp_obj)
            for k in range(b["pt_obs"].shape[0])])
        T_is, init_inl, init_n = init_model(
            K, cfg.pnp_reproj_error, u_obj, T_models, T_lw, b["pt_obs"],
            b["pt_depth"], b["pt_cur_uv"], b["pt_cur_d"], b["pt_valid"])
        res = solve(
            T_is, T_wl,
            fs.PointBundle(b["pt_obs"], b["pt_flow0"], b["pt_depth"],
                           b["pt_valid"] & init_inl),
            fs.LineBundle(b["ln_obs"], b["ln_flow0"], b["ln_depth"],
                          b["ln_valid"]),
            flow_prior_info=cfg.flow_prior_info_obj,
            line_prior_info=cfg.flow_prior_info_obj,
            use_lines=buckets["any_lines"] and cfg.use_lines)
        outs.update(o_pose=res.pose, o_flow=res.flow,
                    o_line_flow=res.line_flow,
                    o_point_inlier=res.point_inlier,
                    o_line_inlier=res.line_inlier, o_init_n=init_n)
    return {k: v.numpy() for k, v in outs.items()}


@pytest.mark.parametrize("MB", [0, 1, 2])
def test_eager_program_equals_parent_solve(recorded, MB):
    """The tracker's solve through the eager fused-frame program on the
    CPU gives, bit for bit, the outputs of the path it replaced (the
    tracker's own RANSAC draws in both), and its LM host reads are
    counted."""
    tr, args = recorded["tr"], _variant(recorded["args"], MB)
    want = _parent_solve_frame(tr, *args)
    reads = tr.lm_host_syncs
    host, ready, spec = tr._solve_frame(*args)
    got = _unpack(host_array(host, ready), spec)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert tr.lm_host_syncs > reads
    prog = fp.frame_program(tr.cfg, tr.K, fp.frame_caps(tr), MB,
                            MB and args[-1]["any_lines"], "cpu")
    assert not prog.graph and prog.capture_s is None


def test_detector_program_matches_eager_detectors(recorded):
    """The detector program on the CPU (FAST stage, line stage) equals
    ``detect_keypoints`` + ``detect_lines`` on the same image; programs are
    memoized by image shape and configs."""
    tr, gray = recorded["tr"], recorded["gray"]
    fcfg, lcfg = tr._fast_cfg(), tr._line_cfg()
    prog = fp.detector_program(gray.shape, gray.dtype, fcfg, lcfg, "cpu")
    assert fp.detector_program(gray.shape, gray.dtype, fcfg, lcfg,
                               "cpu") is prog
    prog.load({"img": gray})
    assert prog() == 0
    img = torch.from_numpy(np.ascontiguousarray(gray))
    uv, _, valid = fast_ops.detect_keypoints(img, fcfg)
    seg = line_ops.detect_lines(img, lcfg)
    want = torch.cat([torch.cat([uv, valid[:, None].float()], 1).reshape(-1),
                      torch.cat([seg.uv4, seg.valid[:, None].float()],
                                1).reshape(-1)])
    assert torch.equal(prog.out, want)
    assert prog.sizes == (3 * len(uv), 5 * len(seg.uv4))

    small = gray[::2, ::2]
    other = fp.detector_program(small.shape, small.dtype, fcfg, None, "cpu")
    assert other is not prog and len(other.stages) == 1
    other.load({"img": small})
    other()
    uv, _, valid = fast_ops.detect_keypoints(
        torch.from_numpy(np.ascontiguousarray(small)), fcfg)
    assert torch.equal(other.out,
                       torch.cat([uv, valid[:, None].float()], 1).reshape(-1))

    det, lines = tr._detect(gray, True, True)
    np.testing.assert_array_equal(det[0], prog.out[:prog.sizes[0]].reshape(
        -1, 3)[:, :2].numpy())
    assert lines.shape == (int(seg.valid.sum()), 4)


def test_graph_program_needs_a_card():
    """No fallback: a graph program on the CPU raises at construction."""
    with pytest.raises(RuntimeError, match="CUDA"):
        fp.FrameProgram([lambda inp: (inp["buf"], 0)],
                        {"buf": ((4,), torch.float32)}, [4], "cpu",
                        graph=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        fp.DetectorProgram([], {}, [], "cpu", graph=True)
