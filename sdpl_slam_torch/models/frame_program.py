"""The host tracking path's per-frame programs over static buffers.

Counterpart of the compiled programs of the JAX package's host path
(``models.tracking``): the fused frame, ``fused_track_packed`` /
``fused_cam_only_packed`` (camera init by RANSAC, the camera's joint
flow+pose LM, the scene-flow static test, the object inits and the
objects' joint flow+motion LM, from one packed float32 input to one
packed float32 output); the non-joint frame of ``use_joint_optimization
= False``, its jitted ``_init_cam``, ``_cam_pose_only`` and
``_obj_init_solve`` (camera init, the pose-only LM on fixed structure,
the object inits and the objects' joint LM); and the detector program,
the jitted ``run`` of ``Tracking._dispatch_detectors`` (FAST and the line
detector into one packed output).

:func:`fused_track` / :func:`fused_cam_only` and :func:`nonjoint_track` /
:func:`nonjoint_cam_only` are plain functions of a packed input;
:func:`in_spec` / :func:`out_spec` are the JAX package's layouts
(``CAM_SPECS`` + ``_obj_specs(MB)`` and ``_out_specs(MB)``), the input
followed by the RANSAC draws, which JAX takes as a key;
:func:`nonjoint_in_spec` / :func:`nonjoint_out_spec` the non-joint frame's.

A :class:`FrameProgram` runs such functions (its stages) over static
buffers: the host copies a frame's inputs into ``inp`` (:meth:`load`),
and each stage writes its part of ``out``.  On the CPU the stages run
eagerly.  On the card (``graph=True``) the first call warms them up on a
side stream and captures each into a CUDA graph
(:class:`utils.cuda_graphs.GraphRecorder`: the LMs' loops become WHILE
nodes), so a frame is one graph launch a stage and reads nothing back
until the caller copies ``out`` home behind it on the same stream.  A
failed capture or launch raises; nothing falls back to the eager run.

:func:`frame_program`, :func:`nonjoint_program` and
:func:`detector_program` memoize the programs at module level, one per
static shape, as JAX compiles one program per static argument set: never
on a tracker, which may be copied.
"""

from __future__ import annotations

import contextlib
import functools
import time

import numpy as np
import torch

from ..ops import fast as fast_ops
from ..ops import geometry
from ..ops import lines as line_ops
from ..ops.geometry import Intrinsics
from ..solvers import frame_solvers as fs
from ..utils.cuda_graphs import GraphRecorder, capture_stream, loop_runner
from ..utils.device import copy_in
from .resident import _inv, init_model, scene_flow_static_frac


# ---------------------------------------------------------------------------
# the packed layouts
# ---------------------------------------------------------------------------

def in_spec(caps: dict, MB: int):
    """(name, shape, kind) rows of the fused frame's packed input, kind
    "f" or "bool" (1.0 / 0.0): the JAX package's ``CAM_SPECS`` and, with
    ``MB`` object lanes, ``_obj_specs(MB)``, then the RANSAC draws of the
    camera and of each object lane.  ``caps``: NS, NLS, P, L, n_cam,
    n_obj."""
    NS, NLS = caps["NS"], caps["NLS"]
    spec = [
        ("velocity", (4, 4), "f"), ("T_lw", (4, 4), "f"),
        ("s_obs", (NS, 2), "f"), ("s_flow0", (NS, 2), "f"),
        ("s_depth", (NS,), "f"), ("s_cur_uv", (NS, 2), "f"),
        ("s_cur_d", (NS,), "f"), ("s_valid", (NS,), "bool"),
        ("l_obs", (NLS, 4), "f"), ("l_flow0", (NLS, 4), "f"),
        ("l_depth", (NLS, 2), "f"), ("l_valid", (NLS,), "bool"),
    ]
    return spec + _obj_in_rows(caps, MB) + _draw_rows(caps, MB)


def _obj_in_rows(caps: dict, MB: int):
    """The object buckets' input rows (the JAX package's
    ``_obj_specs(MB)``), none without object lanes."""
    P, L = caps["P"], caps["L"]
    if not MB:
        return []
    return [("pt_obs", (MB, P, 2), "f"), ("pt_flow0", (MB, P, 2), "f"),
            ("pt_depth", (MB, P), "f"), ("pt_cur_uv", (MB, P, 2), "f"),
            ("pt_cur_d", (MB, P), "f"), ("pt_valid", (MB, P), "bool"),
            ("pt_sfvalid", (MB, P), "bool"),
            ("ln_obs", (MB, L, 4), "f"), ("ln_flow0", (MB, L, 4), "f"),
            ("ln_depth", (MB, L, 2), "f"), ("ln_valid", (MB, L), "bool"),
            ("H_prev", (MB, 4, 4), "f")]


def _draw_rows(caps: dict, MB: int):
    """The RANSAC draws of the camera and of each object lane."""
    rows = [("u_cam", (caps["n_cam"], 3), "f")]
    if MB:
        rows.append(("u_obj", (MB, caps["n_obj"], 3), "f"))
    return rows


def _obj_out_rows(caps: dict, MB: int):
    """The object lanes' output rows, but the static fraction."""
    P, L = caps["P"], caps["L"]
    f32, b, i32 = torch.float32, torch.bool, torch.int32
    if not MB:
        return []
    return [("o_pose", (MB, 4, 4), f32), ("o_flow", (MB, P, 2), f32),
            ("o_line_flow", (MB, L, 4), f32), ("o_point_inlier", (MB, P), b),
            ("o_line_inlier", (MB, L), b), ("o_init_n", (MB,), i32)]


def out_spec(caps: dict, MB: int):
    """(name, shape, dtype) rows of the fused frame's packed output, in the
    JAX package's ``_out_specs(MB)`` order; bools and counts are exact in
    float32."""
    NS, NLS = caps["NS"], caps["NLS"]
    f32, b = torch.float32, torch.bool
    spec = [("pose", (4, 4), f32), ("flow", (NS, 2), f32),
            ("line_flow", (NLS, 4), f32), ("point_inlier", (NS,), b),
            ("line_inlier", (NLS,), b)] + _obj_out_rows(caps, MB)
    if MB:
        spec.append(("o_static_frac", (MB,), f32))
    return spec


def nonjoint_in_spec(caps: dict, MB: int):
    """(name, shape, kind) rows of the non-joint frame's packed input: the
    camera init's inputs (as :func:`in_spec`'s, without the flows), the
    pose-only solve's fixed structure (the last frame's noisy world points
    ``X_w``, the line endpoints in the world ``l_Xs`` / ``l_Xe``, the
    current segments ``l_uv`` and their use flags), the object buckets and
    ``T_wl``, the inverse of the last pose, then the RANSAC draws."""
    NS, NLS = caps["NS"], caps["NLS"]
    spec = [
        ("velocity", (4, 4), "f"), ("T_lw", (4, 4), "f"),
        ("s_obs", (NS, 2), "f"), ("s_depth", (NS,), "f"),
        ("s_cur_uv", (NS, 2), "f"), ("s_cur_d", (NS,), "f"),
        ("s_valid", (NS,), "bool"),
        ("X_w", (NS, 3), "f"), ("l_Xs", (NLS, 3), "f"),
        ("l_Xe", (NLS, 3), "f"), ("l_uv", (NLS, 4), "f"),
        ("l_use", (NLS,), "bool"),
    ] + _obj_in_rows(caps, MB)
    if MB:
        spec.append(("T_wl", (4, 4), "f"))
    return spec + _draw_rows(caps, MB)


def nonjoint_out_spec(caps: dict, MB: int):
    """(name, shape, dtype) rows of the non-joint frame's packed output:
    the pose-only solve's pose, inlier masks and final cost, then the
    objects' rows as in :func:`out_spec` (their static test runs on the
    host)."""
    NS, NLS = caps["NS"], caps["NLS"]
    f32, b = torch.float32, torch.bool
    return [("pose", (4, 4), f32), ("point_inlier", (NS,), b),
            ("line_inlier", (NLS,), b),
            ("cost", (), f32)] + _obj_out_rows(caps, MB)


def numel(spec) -> int:
    return sum(int(np.prod(row[1], dtype=np.int64)) for row in spec)


def _unpack(buf: torch.Tensor, spec) -> dict:
    """The packed input's named views (bools as ``> 0.5``)."""
    out, o = {}, 0
    for name, shape, kind in spec:
        n = int(np.prod(shape, dtype=np.int64))
        a = buf[o:o + n].reshape(shape)
        o += n
        out[name] = a > 0.5 if kind == "bool" else a
    return out


def _pack(outs: dict, spec) -> torch.Tensor:
    return torch.cat([outs[name].reshape(-1).to(torch.float32)
                      for name, _, _ in spec])


# ---------------------------------------------------------------------------
# the fused frame
# ---------------------------------------------------------------------------

def _solve(cfg, K, T_init, T_wl, points, lines, prior, use_lines):
    return fs.solve_flow_pose(
        T_init, T_wl, points, lines, K, rp_thres=cfg.rp_thres,
        flow_prior_info=prior, line_prior_info=prior,
        max_iterations=cfg.lm_iterations, use_lines=use_lines,
        rel_tol=cfg.lm_rel_tol)


def solve_objects(cfg, K: Intrinsics, pose, T_lw, T_wl, b: dict, u_obj,
                  use_lines: bool):
    """GetInitModelObj + the joint flow+motion solve over the object lanes
    of the buckets ``b`` given the camera ``pose``; ``u_obj`` (MB, S, 3)
    the lanes' RANSAC draws.  -> (outputs named as in :func:`out_spec`
    but the static fraction, LM host reads)."""
    # motion-model branch of GetInitModelObj: G = T_cw_cur . H_last
    T_models = pose @ b["H_prev"]
    T_is, init_inl, init_n = init_model(
        K, cfg.pnp_reproj_error, u_obj, T_models, T_lw, b["pt_obs"],
        b["pt_depth"], b["pt_cur_uv"], b["pt_cur_d"], b["pt_valid"])
    res = _solve(cfg, K, T_is, T_wl,
                 fs.PointBundle(b["pt_obs"], b["pt_flow0"], b["pt_depth"],
                                b["pt_valid"] & init_inl),
                 fs.LineBundle(b["ln_obs"], b["ln_flow0"], b["ln_depth"],
                               b["ln_valid"]),
                 cfg.flow_prior_info_obj, use_lines)
    return dict(o_pose=res.pose, o_flow=res.flow, o_line_flow=res.line_flow,
                o_point_inlier=res.point_inlier,
                o_line_inlier=res.line_inlier,
                o_init_n=init_n), res.host_syncs


def _fused_cam(cfg, K, a):
    """GetInitModelCam and the camera's joint flow+pose solve from the
    unpacked input ``a`` -> (camera outputs, T_wl, LM host reads)."""
    T_lw = a["T_lw"]
    s_obs, s_depth = a["s_obs"][None], a["s_depth"][None]
    T_init, subset, _ = init_model(
        K, cfg.pnp_reproj_error, a["u_cam"][None],
        (a["velocity"] @ T_lw)[None], T_lw, s_obs, s_depth,
        a["s_cur_uv"][None], a["s_cur_d"][None], a["s_valid"][None])
    T_wl = _inv(T_lw)
    cam = _solve(cfg, K, T_init, T_wl,
                 fs.PointBundle(s_obs, a["s_flow0"][None], s_depth, subset),
                 fs.LineBundle(a["l_obs"][None], a["l_flow0"][None],
                               a["l_depth"][None], a["l_valid"][None]),
                 cfg.flow_prior_info_cam, cfg.use_lines)
    outs = dict(pose=cam.pose[0], flow=cam.flow[0],
                line_flow=cam.line_flow[0], point_inlier=cam.point_inlier[0],
                line_inlier=cam.line_inlier[0])
    return outs, T_wl, cam.host_syncs


def fused_cam_only(cfg, K: Intrinsics, caps: dict, buf: torch.Tensor):
    """``fused_cam_only_packed``: a frame without object lanes, from the
    packed input ``buf`` of :func:`in_spec` (``MB`` = 0) -> (the packed
    output of :func:`out_spec`, LM host reads)."""
    outs, _, syncs = _fused_cam(cfg, K, _unpack(buf, in_spec(caps, 0)))
    return _pack(outs, out_spec(caps, 0)), syncs


def fused_track(cfg, K: Intrinsics, caps: dict, buf: torch.Tensor, MB: int,
                use_obj_lines: bool):
    """``fused_track_packed``: camera init, the camera LM, the scene-flow
    static test, the object inits and the objects' LM over ``MB`` lanes,
    from the packed input ``buf`` of :func:`in_spec` -> (the packed output
    of :func:`out_spec`, LM host reads).  ``use_obj_lines`` (a Python
    bool, static as in JAX) keeps the objects' line terms."""
    a = _unpack(buf, in_spec(caps, MB))
    outs, T_wl, syncs = _fused_cam(cfg, K, a)
    # scene-flow static test (GetSceneFlowObj + DynObjTracking's x-z
    # scene-flow fraction)
    static_frac = scene_flow_static_frac(
        K, cfg.sf_mg_thres, outs["pose"], T_wl, a["pt_obs"], a["pt_depth"],
        a["pt_cur_uv"], a["pt_cur_d"], a["pt_sfvalid"])
    objs, obj_syncs = solve_objects(cfg, K, outs["pose"], a["T_lw"], T_wl, a,
                                    a["u_obj"], use_obj_lines)
    outs.update(objs, o_static_frac=static_frac)
    return _pack(outs, out_spec(caps, MB)), syncs + obj_syncs


# ---------------------------------------------------------------------------
# the non-joint frame (bJoint = false)
# ---------------------------------------------------------------------------

def _nonjoint_cam(cfg, K, a) -> dict:
    """GetInitModelCam, then PoseOptimizationNewWithLines (Optimizer.cc:
    5900) on the last frame's fixed structure, from the unpacked input
    ``a`` of :func:`nonjoint_in_spec` -> the camera outputs by name."""
    T_lw = a["T_lw"]
    T_init, subset, _ = init_model(
        K, cfg.pnp_reproj_error, a["u_cam"][None],
        (a["velocity"] @ T_lw)[None], T_lw, a["s_obs"][None],
        a["s_depth"][None], a["s_cur_uv"][None], a["s_cur_d"][None],
        a["s_valid"][None])
    l_uv = a["l_uv"]
    lcoef = geometry.infinite_line_image(l_uv[:, :2], l_uv[:, 2:])
    cam = fs.solve_pose_only(
        T_init[0], a["X_w"], a["s_cur_uv"], subset[0], a["l_Xs"], a["l_Xe"],
        lcoef, a["l_use"], K, rp_thres=0.01, line_weight_thr=50,
        use_lines=cfg.use_lines)
    return dict(pose=cam.pose, point_inlier=cam.point_inlier,
                line_inlier=cam.line_inlier, cost=cam.final_cost)


def nonjoint_cam_only(cfg, K: Intrinsics, caps: dict, buf: torch.Tensor):
    """The JAX package's ``_init_cam`` then ``_cam_pose_only``: a non-joint
    frame without object lanes, from the packed input ``buf`` of
    :func:`nonjoint_in_spec` (``MB`` = 0) -> (the packed output of
    :func:`nonjoint_out_spec`, LM host reads: none, the pose-only LM runs
    a fixed count)."""
    outs = _nonjoint_cam(cfg, K, _unpack(buf, nonjoint_in_spec(caps, 0)))
    return _pack(outs, nonjoint_out_spec(caps, 0)), 0


def nonjoint_track(cfg, K: Intrinsics, caps: dict, buf: torch.Tensor,
                   MB: int, use_obj_lines: bool):
    """A non-joint frame with ``MB`` object lanes: :func:`nonjoint_cam_only`'s
    camera, then the JAX package's ``_obj_init_solve`` (the object inits
    and the objects' joint flow+motion LM) on the solved pose -> (the
    packed output of :func:`nonjoint_out_spec`, LM host reads).

    One departure from the JAX package (ROADMAP C4): its non-joint object
    chain hands the init the inverse of the last pose where the init
    expects the pose itself; here the init takes the pose, as on the
    joint path."""
    a = _unpack(buf, nonjoint_in_spec(caps, MB))
    outs = _nonjoint_cam(cfg, K, a)
    objs, syncs = solve_objects(cfg, K, outs["pose"], a["T_lw"], a["T_wl"],
                                a, a["u_obj"], use_obj_lines)
    outs.update(objs)
    return _pack(outs, nonjoint_out_spec(caps, MB)), syncs


# ---------------------------------------------------------------------------
# programs over static buffers
# ---------------------------------------------------------------------------

class FrameProgram:
    """Stage functions over static buffers: the inputs ``inp`` (name ->
    buffer) and the packed output ``out``, each stage ``fn(inp) -> (part,
    LM host reads)`` writing the next ``sizes[i]`` values of ``out``.
    :meth:`load` copies a frame's host arrays into the inputs; calling the
    program runs every stage and returns the LM host reads.

    Eager, a stage runs its function (the plain version; on the CPU and as
    the card's reference).  With ``graph=True`` (the card) the first call
    warms every stage up on ``stream``, then captures each into CUDA
    graphs (the LM loops as WHILE nodes) and stitches it (``stream``: by
    default the device's capture stream); every call then
    launches the stages' graphs on the current stream and reads nothing on
    the host.  ``captures`` counts the programs of the class captured in
    this process."""

    captures = 0

    def __init__(self, stages, inputs: dict, sizes, device, graph=False,
                 stream=None):
        dev = torch.device(device)
        if graph and dev.type != "cuda":
            raise RuntimeError("%s(graph=True) needs a CUDA device, got %s"
                               % (type(self).__name__, dev))
        if graph and stream is None:
            stream = capture_stream(dev)
        self.stages, self.sizes = tuple(stages), tuple(sizes)
        self.device, self.graph, self._stream = dev, graph, stream
        self.inp = {k: torch.zeros(shape, dtype=dt, device=dev)
                    for k, (shape, dt) in inputs.items()}
        self.out = torch.zeros(sum(self.sizes), dtype=torch.float32,
                               device=dev)
        self._graphs = None
        self.capture_s = self.node_counts = None

    def load(self, arrays: dict):
        """Copy host arrays into the input buffers (pinned and
        non-blocking on the card)."""
        copy_in(self.inp, arrays)

    def _eager(self, i: int) -> int:
        part, syncs = self.stages[i](self.inp)
        o = sum(self.sizes[:i])
        self.out[o:o + self.sizes[i]].copy_(part.reshape(-1))
        return syncs

    def run_stage(self, i: int) -> int:
        """Stage ``i`` alone (the caller may time one stage apart)."""
        if not self.graph:
            return self._eager(i)
        if self._graphs is None:
            self._capture()
        self._graphs[i].launch()
        return 0

    def __call__(self) -> int:
        return sum(self.run_stage(i) for i in range(len(self.stages)))

    def eager_twin(self) -> "FrameProgram":
        """An eager program of the same stages over buffers of its own on
        the same device: the plain version a graph is held to."""
        return type(self)(
            self.stages,
            {k: (tuple(t.shape), t.dtype) for k, t in self.inp.items()},
            self.sizes, self.device)

    def _capture(self):
        dev = self.device
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        launches = fast_ops.fast_score_pyramid.launches
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # warm-up: library handles, workspaces and cached constants are
            # made outside the capture
            for i in range(len(self.stages)):
                self._eager(i)
        fast_ops.fast_score_pyramid.launches = launches
        torch.cuda.synchronize(dev)
        graphs = []
        for i in range(len(self.stages)):
            rec = GraphRecorder(counters=[(fast_ops.fast_score_pyramid,
                                           "launches")])
            with torch.cuda.stream(side):
                with rec, loop_runner(rec.loop):
                    self._eager(i)
            graphs.append(rec.stitch())
        torch.cuda.synchronize(dev)
        self._graphs = graphs
        self.node_counts = [g.node_counts() for g in graphs]
        self.capture_s = time.perf_counter() - t0
        type(self).captures += 1


class DetectorProgram(FrameProgram):
    """The detector program: a FAST stage and a line-detector stage (each
    where the frame needs it) over a static grey image ``inp["img"]``;
    ``out`` holds FAST's (uv, valid) rows, then the segments' (uv4,
    valid) rows.  Its own ``captures``."""

    captures = 0


def _fast_stage(cfg):
    def stage(inp):
        uv, _, valid = fast_ops.detect_keypoints(inp["img"], cfg)
        return torch.cat([uv, valid[:, None].to(uv.dtype)], 1), 0
    return stage


def _line_stage(cfg):
    def stage(inp):
        seg = line_ops.detect_lines(inp["img"], cfg)
        return torch.cat([seg.uv4, seg.valid[:, None].to(seg.uv4.dtype)],
                         1), 0
    return stage


@functools.lru_cache(maxsize=None)
def detector_stream(device: torch.device):
    """The side CUDA stream the detectors of ``device`` run on (one a
    card, so trackers and their copies share it)."""
    return torch.cuda.Stream(device)


# programs shared across identically configured trackers (on the card a
# capture takes a second); the key holds every static argument
_FRAME_PROGRAMS: dict = {}
_DETECT_PROGRAMS: dict = {}


def frame_caps(tracker) -> dict:
    """A tracker's capacities and RANSAC hypothesis counts, as
    :func:`in_spec` takes them."""
    return dict(NS=tracker.NS, NLS=tracker.NLS, P=tracker.P_OBJ,
                L=tracker.L_OBJ, n_cam=tracker.n_hyp_cam,
                n_obj=tracker.n_hyp_obj)


def _solve_settings(cfg) -> tuple:
    """The settings the fused frame reads (the JAX package's
    ``Tracking._jit_key``): programs are shared across settings that
    differ elsewhere (the tracking mode, the BA cadence)."""
    return (float(cfg.rp_thres), float(cfg.flow_prior_info_cam),
            float(cfg.flow_prior_info_obj), int(cfg.lm_iterations),
            float(cfg.lm_rel_tol), bool(cfg.use_lines),
            float(cfg.sf_mg_thres), float(cfg.pnp_reproj_error))


def _solve_program(nonjoint: bool, cfg, K: Intrinsics, caps: dict, MB: int,
                   use_obj_lines: bool, device) -> FrameProgram:
    dev = torch.device(device)
    use_obj_lines = bool(use_obj_lines and MB and cfg.use_lines)
    key = (nonjoint, _solve_settings(cfg), (K.fx, K.fy, K.cx, K.cy),
           tuple(sorted(caps.items())), MB, use_obj_lines, str(dev))
    prog = _FRAME_PROGRAMS.get(key)
    if prog is None:
        specs = ((nonjoint_in_spec, nonjoint_out_spec) if nonjoint
                 else (in_spec, out_spec))
        track, cam_only = ((nonjoint_track, nonjoint_cam_only) if nonjoint
                           else (fused_track, fused_cam_only))
        if MB:
            fn = functools.partial(track, cfg, K, caps, MB=MB,
                                   use_obj_lines=use_obj_lines)
        else:
            fn = functools.partial(cam_only, cfg, K, caps)
        prog = _FRAME_PROGRAMS[key] = FrameProgram(
            [lambda inp: fn(inp["buf"])],
            {"buf": ((numel(specs[0](caps, MB)),), torch.float32)},
            [numel(specs[1](caps, MB))], dev, graph=dev.type == "cuda")
    return prog


def frame_program(cfg, K: Intrinsics, caps: dict, MB: int,
                  use_obj_lines: bool, device) -> FrameProgram:
    """The memoized fused-frame program on ``device``: one per (the
    settings it reads, K, caps, ``MB`` object lanes (0:
    :func:`fused_cam_only`), ``use_obj_lines``, device).  A graph program
    on the card, captured at its first call; an eager one on the CPU."""
    return _solve_program(False, cfg, K, caps, MB, use_obj_lines, device)


def nonjoint_program(cfg, K: Intrinsics, caps: dict, MB: int,
                     use_obj_lines: bool, device) -> FrameProgram:
    """The memoized non-joint frame program on ``device``
    (:func:`nonjoint_track`, or :func:`nonjoint_cam_only` for ``MB`` = 0),
    the counterpart of the JAX package's jitted ``_init_cam``,
    ``_cam_pose_only`` and ``_obj_init_solve``; keyed as
    :func:`frame_program`, apart from it.  On the card one graph a frame:
    the pose-only LM's 130 iterations unrolled, the objects' LM a WHILE
    node."""
    return _solve_program(True, cfg, K, caps, MB, use_obj_lines, device)


def detector_program(shape, dtype: np.dtype, fast_cfg, line_cfg,
                     device) -> DetectorProgram:
    """The memoized detector program on ``device`` for a grey image of
    ``shape`` and ``dtype``: FAST where ``fast_cfg`` is given, the line
    detector where ``line_cfg`` is; one per (shape, dtype, the two
    configs, device).  On the card a graph program whose buffers are made
    on :func:`detector_stream` and which is captured there at its first
    call; callers load and launch it on that stream.  An eager one on
    the CPU."""
    dev = torch.device(device)
    h, w = shape
    key = (tuple(shape), np.dtype(dtype).str, repr(fast_cfg), repr(line_cfg),
           str(dev))
    prog = _DETECT_PROGRAMS.get(key)
    if prog is None:
        stages, sizes = [], []
        if fast_cfg is not None:
            stages.append(_fast_stage(fast_cfg))
            sizes.append(3 * fast_ops.n_keypoints(h, w, fast_cfg))
        if line_cfg is not None:
            stages.append(_line_stage(line_cfg))
            sizes.append(5 * line_ops.n_segments(h, w, line_cfg))
        cuda = dev.type == "cuda"
        img_dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        stream = detector_stream(dev) if cuda else None
        # its buffers are made on the stream it runs on
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            prog = _DETECT_PROGRAMS[key] = DetectorProgram(
                stages, {"img": (tuple(shape), img_dtype)}, sizes, dev,
                graph=cuda, stream=stream)
    return prog
