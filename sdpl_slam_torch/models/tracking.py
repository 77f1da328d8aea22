"""Tracking: the per-frame dynamic-SLAM pipeline (host tracking path).

Counterpart of the JAX package's ``models.tracking`` (the reference
``Tracking``, Tracking.cc):

  GrabImageRGBD (Tracking.cc:179)  ->  Tracking.grab_rgbd
    FAST pyramid on the device        ops.fast.detect_keypoints
    line detector on the device       ops.lines.detect_lines
    depth preprocess (:195-219)       _np_preprocess_depth (host)
    UpdateMask (:4730)                _update_mask (host)
    selections, inheritance           frame_host (host numpy)
  Track (:1028)                       _track_dispatch, _track_finish
    camera init (:2738) + joint flow+pose LM (Optimizer.cc:6409),
    scene flow (:1989), DynObjTracking (:2077), per-object init + joint
    flow+motion LMs (Optimizer.cc:7603) batched over objects: _solve_frame
    on the device, one copy of its outputs home per frame; with
    ``use_joint_optimization = False`` the camera takes the pose-only LM
    on fixed structure instead (Optimizer.cc:5900): _solve_frame_nonjoint
    RenewFrameInfo (:3959), map appends (:1605-1786) on the host
  batch optimisation triggers (:1793-1884): the window BA
    (``partial_batch_optimization``) at the reference cadence and the full
    BA (``full_batch_optimization``) at the stop frame, on ``self.device``

Per-frame tensors live on ``self.device``; host bookkeeping stays numpy,
as in the JAX package.  Fixed capacities come from the reference's caps
(1200 static points, 400 static lines, 800 points and 100 lines per
object).

With ``pipelined_tracking`` (the default, as in the JAX package) a frame
runs in two halves: :meth:`Tracking._track_dispatch` (inherit, grouping,
the solves, the start of the results' copy home, the selections) in its
own call, :meth:`Tracking._track_finish` (commit, renewal, map push, BA
triggers) at the start of the next call or at a flush; the last frame
finishes in its own call.  The detectors run on a side CUDA stream, and
with the next frame's image given they run for that frame during this
one.  Without pipelining both halves run in one call.

With ``resident_tracking`` every frame after the first runs through
:class:`.resident.ResidentDriver`: the whole frame on the device against
device state, the map rows two frames behind; with ``chained_tracking``
through :class:`.chained.ChainedDriver`, the same device core fed by
samples the host takes from its planes.  Where the drivers are not
eligible (no joint optimiser, or lens distortion) the frames take the host
path, as in the JAX package.  The batch BAs take the dense-Schur step or
the CG step by the JAX package's rule (``ba_builder``), and ``ba_runs``
records which.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import List, Optional

import numpy as np
import torch

from ..io import native as _native
from ..ops import fast as fast_ops
from ..ops import geometry
from ..ops import lines as line_ops
from ..ops.geometry import Intrinsics
from ..solvers import ba_builder
from ..solvers import batch_ba as bb
from ..solvers import schur_ba
from ..utils import trace
from ..utils.config import KITTI, OMD, Settings
from ..utils.device import checked_device, host_array, to_host_async
from . import frame as fr
from . import frame_host as fh
from .chained import ChainedDriver
from .frame_program import (detector_program, detector_stream, frame_caps,
                            frame_program, in_spec, nonjoint_in_spec,
                            nonjoint_out_spec, nonjoint_program, out_spec)
from .map_state import MapState
from .resident import ResidentDriver, n_hypotheses

_EYE4 = np.eye(4, dtype=np.float32)


def _global_ba_on(cfg: Settings) -> bool:
    """``run_global_ba``, or, when it is None, KITTI data (Tracking.cc:1870)."""
    return (cfg.run_global_ba if cfg.run_global_ba is not None
            else cfg.choose_data == KITTI)


def check_supported(cfg: Settings) -> None:
    """The settings this package cannot run yet: none.  Every setting of the
    JAX package's ``Settings`` runs (the chained and pipelined modes were
    the last refused, until ROADMAP A14 and A5); ``System`` still calls
    this first, the one place a refusal would go."""


def _unpack(flat: np.ndarray, spec) -> dict:
    """The host copy of a packed float32 output -> named arrays, by its
    spec of (name, shape, dtype) rows (``frame_program.out_spec``)."""
    out, o = {}, 0
    for name, shape, dtype in spec:
        n = int(np.prod(shape, dtype=np.int64))
        a = flat[o:o + n].reshape(shape)
        o += n
        if dtype == torch.bool:
            a = a > 0.5
        elif not dtype.is_floating_point:
            a = a.astype(np.int32)
        out[name] = np.array(a)
    return out


def _np_backproject(K: Intrinsics, uv: np.ndarray, z: np.ndarray):
    fx, fy, cx, cy = float(K.fx), float(K.fy), float(K.cx), float(K.cy)
    x = (uv[..., 0] - cx) * z / fx
    y = (uv[..., 1] - cy) * z / fy
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def _np_world_points(K: Intrinsics, T_cw: np.ndarray, uv: np.ndarray,
                     z: np.ndarray):
    Xc = _np_backproject(K, uv, z)
    T_wc = np.linalg.inv(T_cw)
    return (Xc @ T_wc[:3, :3].T + T_wc[:3, 3]).astype(np.float32)


def _np_world_lines(K: Intrinsics, T_cw: np.ndarray, uv4: np.ndarray,
                    d2: np.ndarray):
    s = _np_world_points(K, T_cw, uv4[..., :2], d2[..., 0])
    e = _np_world_points(K, T_cw, uv4[..., 2:], d2[..., 1])
    return np.concatenate([s, e], axis=-1)


def _np_plucker(p: np.ndarray, q: np.ndarray):
    d = q - p
    n = np.linalg.norm(d, axis=-1, keepdims=True)
    d = d / np.maximum(n, 1e-12)
    return np.concatenate([np.cross(p, d), d], axis=-1).astype(np.float32)


def _np_preprocess_depth(depth_raw: np.ndarray, choose_data: int,
                         factor: float, bf: float) -> np.ndarray:
    """Depth conversion on the host (Tracking.cc:192-219): renewal and map
    logic read the preprocessed depth, and the solvers take sampled
    depths only."""
    d = depth_raw if depth_raw.dtype == np.float32 else depth_raw.astype(
        np.float32
    )
    out = _native.depth_preprocess(d, choose_data, factor, bf)
    if out is not None:
        return out
    if choose_data == KITTI:
        with np.errstate(divide="ignore", invalid="ignore"):
            out = (np.float32(bf * factor) / d).astype(np.float32)
        # d <= 0 (invalid or negative disparity) -> 0
        np.place(out, ~np.isfinite(out) | (out < 0), 0.0)
    elif choose_data == OMD:
        out = np.where(d < 0, np.float32(0.0), d) * np.float32(1.0 / factor)
    else:
        # VirtualKITTI (3) matches neither reference branch: values stay
        # unscaled, negatives -> 0 (Tracking.cc:199-216)
        out = np.where(d < 0, np.float32(0.0), d)
    return out


def obj_pose_parsing_kt(row: np.ndarray) -> np.ndarray:
    """KITTI object-pose row -> 4x4 pose in CAMERA coordinates
    (``ObjPoseParsingKT``, reference src/Tracking.cc:3134-3241):
    row = [frame, track_id, B1..B4, t1, t2, t3, yaw].  The reference sets
    y = yaw + pi/2, x = z = 0 (Tracking.cc:3147-3150) and composes
    R = Ry*Rx*Rz (:3172-3180), which with x=z=0 reduces to Ry(yaw + pi/2);
    t = row[6:9] is used directly (:3232-3235)."""
    t = row[6:9].astype(np.float64)
    yaw = float(row[9]) + np.pi / 2.0
    cy, sy = np.cos(yaw), np.sin(yaw)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array(
        [[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]], np.float32
    )
    pose[:3, 3] = t.astype(np.float32)
    return pose


def obj_pose_parsing_ox(row: np.ndarray,
                        origin_inv: np.ndarray = None) -> np.ndarray:
    """OMD object-pose row -> 4x4 origin-aligned WORLD pose
    (``ObjPoseParsingOX``, reference src/Tracking.cc:3243-3323):
    row = [frame, id, t(3), axis-angle(3)]; the pose is composed as
    inv(origin) @ [Rodrigues(aa), t] so it lives in the frame-0 camera
    frame like the internal trajectory."""
    pose = np.eye(4, dtype=np.float32)
    t = row[2:5].astype(np.float64)
    aa = row[5:8].astype(np.float64)
    angle = float(np.linalg.norm(aa))
    if angle > 0:
        x, y, z = aa / angle
        s, c = np.sin(angle), np.cos(angle)
        v = 1.0 - c
        pose[:3, :3] = np.array([
            [x * x * v + c, x * y * v - z * s, x * z * v + y * s],
            [x * y * v + z * s, y * y * v + c, y * z * v - x * s],
            [x * z * v - y * s, y * z * v + x * s, z * z * v + c],
        ], np.float32)
    pose[:3, 3] = t.astype(np.float32)
    if origin_inv is not None:
        pose = (np.linalg.inv(origin_inv) @ pose).astype(np.float32)
    return pose


class Tracking:
    """Host orchestrator holding the per-sequence state; the solvers and
    the FAST pyramid run on ``device``."""

    def __init__(self, settings: Settings, device="cuda"):
        self.cfg = settings
        self.device = checked_device(device, "Tracking")
        self.K = Intrinsics.from_config(settings)
        # capacities
        self.NS = int(settings.max_track_point_bg)       # static points
        self.NLS = int(settings.max_static_lines)        # static lines
        self.P_OBJ = int(settings.max_track_point_obj)   # points per object
        self.L_OBJ = int(settings.max_object_lines)      # lines per object
        self.MAXO = int(settings.max_objects)
        self.NO = self.MAXO * self.P_OBJ                 # total object points
        self.NLO = self.MAXO * self.L_OBJ
        self.N_CAND = 3000                               # static candidates
        self.NL_CAND = max(2 * self.NLS, 64)             # line candidates
        # GetInitModelCam's RANSAC budget (the JAX package's tracking.py)
        self.n_hyp_cam, self.n_hyp_obj = n_hypotheses(settings)

        self.f_id = 0
        self.max_id = 1                                  # object id counter
        self.velocity: Optional[np.ndarray] = None       # mVelocity
        self.origin_inv: Optional[np.ndarray] = None     # mOriginInv
        self.last: Optional[dict] = None                 # last frame dict
        self.last_meta: dict = {"sem_position": [], "mod_label": [],
                                "obj_stat": [], "obj_motion": {}}
        self.map = MapState()
        self.mask_np: Optional[np.ndarray] = None        # current (possibly
        #                                                  recovered) mask
        self.depth_np: Optional[np.ndarray] = None       # preprocessed depth
        self.last_mask_np: Optional[np.ndarray] = None   # mSegMapLast
        self.last_flow_np: Optional[np.ndarray] = None   # mFlowMapLast
        self._oline_label = np.full(self.NLO, -2, np.int32)
        self._grid_cache = None
        self.lm_host_syncs = 0                           # LM loop-exit reads
        # one dict per batch BA run: kind ("local" / "global"), frame, wall
        # ms, LM and CG iterations, host reads (batch_ba.run_ba's counters)
        self.ba_runs: List[dict] = []
        self._res: Optional[ResidentDriver] = None       # device loops
        self._host_draws = False                         # see host_draws
        # the pipelined host path: the frame in flight, its deferred map
        # push, and the next frame's predispatched detectors
        self._inflight: Optional[dict] = None
        self._deferred_push: Optional[tuple] = None
        self._pending_det: Optional[tuple] = None
        self._next_gray: Optional[np.ndarray] = None

    def flush(self) -> None:
        """Finish the frame in flight (pipelined: pull, renewal, map push,
        BA triggers) and drain the device loops' map stream, so the map
        holds every tracked frame.  Idempotent; ``System`` calls it before
        any reader of the map.  With the span recorder on, the card's clock
        is anchored to the host's again here (``trace.anchor``)."""
        if self._res is not None:
            self._res.drain_all()
        self._run_deferred_push()     # always older than the frame in flight
        if self._inflight is not None:
            fl, self._inflight = self._inflight, None
            self._track_finish(fl)
        if self.device.type == "cuda":
            trace.anchor()

    def sync_host_state(self) -> None:
        """Write the device-resident state back to the host ``last`` dict
        (for a checkpoint or a switch to the host path)."""
        if self._res is not None:
            self._res.exit()
            self._res = None

    def _ransac_uniforms(self, f_id: int, lane: int, n_hyp: int) -> torch.Tensor:
        """(n_hyp, 3) uniforms in [0, 1) for one RANSAC problem: lane 0 is
        the camera, lane k + 1 the k-th object bucket (the non-joint
        path's objects pass ``1000 + f_id``, a stream of their own as in
        the JAX package).  Drawn from a
        ``torch.Generator`` seeded from ``(f_id, lane)``, so a frame's
        draws depend on nothing else (the JAX package folds the frame key
        by lane index for the same reason).  The generator is a CPU one
        and the draws are copied to the tracker's device: CUDA and CPU
        generators give different streams from one seed, and this way a
        CPU run and a CUDA run take the same samples.  Tests override
        this to feed JAX's draws."""
        gen = torch.Generator()
        gen.manual_seed(int(f_id) * 100003 + int(lane))
        u = torch.rand((n_hyp, 3), generator=gen)
        if self.device.type == "cuda" and not self._host_draws:
            # from pinned memory: no blocking copy, no host synchronisation
            return u.pin_memory().to(self.device, non_blocking=True)
        return u

    @contextlib.contextmanager
    def host_draws(self):
        """Inside the block :meth:`_ransac_uniforms` leaves its draws on
        the host: the resident driver packs them with the frame's other
        small inputs into one copy."""
        self._host_draws = True
        try:
            yield
        finally:
            self._host_draws = False

    def _fast_cfg(self):
        cfg = self.cfg
        return fast_ops.FastPyramidConfig(
            n_features=min(cfg.orb_n_features, self.N_CAND),
            scale_factor=cfg.orb_scale_factor,
            n_levels=cfg.orb_n_levels,
            ini_threshold=float(cfg.orb_ini_th_fast),
            min_threshold=float(cfg.orb_min_th_fast),
        )

    def _line_cfg(self):
        """Line detector settings from the yaml line keys: min segment
        length 0.02*min(w, h), the reference's LSD option
        (Lineextractor.cc:70), floored at 8 px; ``line_levels`` octaves;
        ``line_extractor`` 0 = LSD-style, 1 = EDLines-style
        (Tracking.cc:113-118); ``lsd_nfeatures`` caps the count (0 =
        unlimited); ``lsd_refine = 0`` disables endpoint refinement.
        ``lsd_scale`` is inert (see utils/config.py)."""
        cfg = self.cfg
        base = line_ops.LineDetectConfig()
        return line_ops.LineDetectConfig(
            max_lines=self.NL_CAND,
            min_length=max(8.0, 0.02 * min(cfg.width, cfg.height)),
            n_octaves=max(1, cfg.line_levels),
            mode=1 if cfg.line_extractor == 1 else 0,
            n_features=max(0, int(cfg.lsd_nfeatures)),
            refine_steps=0 if cfg.lsd_refine == 0 else base.refine_steps,
        )

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def grab_rgbd(
        self,
        gray: np.ndarray,
        depth_raw: np.ndarray,
        flow: np.ndarray,
        mask: np.ndarray,
        gt_pose: np.ndarray,
        obj_poses_gt: List[np.ndarray],
        timestamp: float,
        n_images: int,
        line_detections: Optional[np.ndarray] = None,
        point_detections: Optional[np.ndarray] = None,
        next_gray: Optional[np.ndarray] = None,
        next_gray2: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Process one frame; returns the estimated camera pose T_cw (with
        ``pipelined_tracking``, the previous frame's until the last frame).

        ``line_detections``: optional (L, 4) segments replacing the line
        detector; ``point_detections``: optional (P, 2) corners replacing
        the FAST pyramid.  With neither, both detectors run on ``gray`` on
        the tracker's device.  ``next_gray`` / ``next_gray2``: the grey
        images of frames t+1 and t+2, if the caller has them: with
        ``pipelined_tracking`` frame t+1's detectors are dispatched during
        this frame, and the chained driver takes both.
        """
        cfg = self.cfg
        h, w = gray.shape
        timing = np.zeros(5, np.float32)

        # --- stop frame semantics (Tracking.cc:184) ---
        stop_frame = (
            cfg.stop_frame if cfg.stop_frame is not None else n_images - 1
        )

        # --- GT pose handling (Tracking.cc:477-489) ---
        if self.f_id == 0 or self.origin_inv is None:
            self.origin_inv = np.asarray(gt_pose, np.float32)
            pose_gt = np.linalg.inv(self.origin_inv).astype(np.float32)
        else:
            pose_gt = (
                np.linalg.inv(np.asarray(gt_pose, np.float32))
                @ self.origin_inv
            ).astype(np.float32)

        # --- the device loops (models/resident.py, models/chained.py): from
        # the second frame on, the whole frame runs on the device against
        # device state and the map rows stream back behind it ---
        driver_cls = ChainedDriver if cfg.chained_tracking else ResidentDriver
        if ((cfg.resident_tracking or cfg.chained_tracking)
                and driver_cls.eligible(cfg) and self.f_id > 0
                and (self._res is not None or self.last is not None)):
            if self._res is None:
                self.flush()
                self._res = driver_cls(self)
                self._res.enter()
            kw = {}
            if cfg.chained_tracking:
                kw = dict(next_gray=next_gray, next_gray2=next_gray2)
            pose = self._res.track(
                gray, depth_raw, flow, mask, pose_gt,
                [np.asarray(r, np.float32) for r in obj_poses_gt],
                timing, self.f_id, n_images, stop_frame,
                line_detections=line_detections,
                point_detections=point_detections, **kw)
            if self._res.state is None:    # left at the global BA
                self._res = None
            self.f_id += 1
            return pose
        self.sync_host_state()

        # --- this frame's detectors: taken from the previous call's
        # dispatch where it ran them with the same needs, else run now ---
        t0 = time.perf_counter()
        need_fast = cfg.use_sample_fea == 0 and point_detections is None
        need_lines = line_detections is None and cfg.use_lines
        pend, self._pending_det = self._pending_det, None
        if (pend is not None and pend[0] == self.f_id
                and pend[1] == (need_fast, need_lines)):
            det, detected_lines = self._take_detections(pend[2])
        else:
            det, detected_lines = self._detect(gray, need_fast, need_lines)
        if need_lines:
            line_detections = detected_lines
        self._next_gray = next_gray if cfg.pipelined_tracking else None
        depth_now = _np_preprocess_depth(
            np.asarray(depth_raw, np.float32), cfg.choose_data,
            cfg.depth_map_factor, cfg.bf,
        )
        flow_np = np.ascontiguousarray(flow, dtype=np.float32)

        # --- finish the previous frame in flight (pipelined): before this
        # frame's images replace self.mask_np / depth_np.  Its map push
        # waits until this frame is dispatched, unless a BA fires ---
        if self._inflight is not None:
            fl, self._inflight = self._inflight, None
            self._track_finish(fl, defer_push=True)

        # --- mask recovery (UpdateMask, Tracking.cc:4730-4810) ---
        self.mask_np = np.asarray(mask, np.int32).copy()
        if self.f_id > 0 and self.last is not None:
            self._update_mask()
        self.depth_np = depth_now
        # object candidates come from the stride-4 mask grid, not the
        # detector (Frame.cc:769-809)
        obj_tmp = fh.select_object_points(
            self.depth_np, flow_np, self.mask_np, cfg.th_depth_obj, self.NO,
        )
        timing[0] = (time.perf_counter() - t0) * 1e3

        gt_objs = [np.asarray(r, np.float32) for r in obj_poses_gt]
        if self.f_id == 0 or self.last is None:
            self._predispatch_next_detectors(need_fast, need_lines)
            stat_tmp, line_tmp, oline_tmp = self._finish_selection(
                det, point_detections, line_detections, flow_np, h, w,
            )
            self._initialize(stat_tmp, line_tmp, obj_tmp,
                             oline_tmp, pose_gt, gt_objs)
            pose = np.asarray(self.last["pose"])
        else:
            fl = self._track_dispatch(
                flow_np, obj_tmp, pose_gt, gt_objs, timing, stop_frame,
                det, point_detections, line_detections, need_fast,
                need_lines,
            )
            # the previous frame's map push after this frame's dispatch
            self._run_deferred_push()
            last_frame = self.f_id >= stop_frame or self.f_id >= n_images - 1
            if (cfg.pipelined_tracking and fl["legacy"] is None
                    and not last_frame):
                # one frame behind: this frame's pose lands in the map when
                # the next call (or a flush) finishes it
                self._inflight = fl
                pose = np.asarray(self.last["pose"])
            else:
                pose = self._track_finish(fl)
        self.last_mask_np = self.mask_np.copy()
        self.last_flow_np = np.asarray(flow, np.float32)
        self.f_id += 1
        return pose

    # ------------------------------------------------------------------
    def _dispatch_detectors(self, gray: np.ndarray, need_fast: bool,
                            need_lines: bool, timed: bool = False):
        """Run the detectors this frame needs on the tracker's device and
        start the copy of their packed results home: the detector program
        of the image's shape and the configs (``frame_program.
        detector_program``; on the card two graph launches on a side
        stream, FAST and the line detector), without waiting for it.  -> a
        handle for :meth:`_take_detections`, or None.  A
        ``detector.dispatch`` span.  ``timed`` and the span recorder on:
        the line stage is a ``detector.lines`` span of its own, between
        two synchronisations of that stream."""
        if not (need_fast or need_lines):
            return None
        with trace.span("detector.dispatch"):
            gray = np.ascontiguousarray(gray)
            prog = detector_program(
                gray.shape, gray.dtype,
                self._fast_cfg() if need_fast else None,
                self._line_cfg() if need_lines else None, self.device)
            cuda = self.device.type == "cuda"
            stream = detector_stream(self.device) if cuda else None
            # the program reads nothing the default stream writes (its
            # buffers are made and loaded on its own stream), so it does
            # not wait for the frame in flight: with ``pipelined_tracking``
            # the next frame's detectors run beside this frame's solve
            with (torch.cuda.stream(stream) if cuda
                  else contextlib.nullcontext()):
                prog.load({"img": gray})
                if need_fast:
                    prog.run_stage(0)
                if need_lines:
                    timed = timed and trace.ON
                    if timed and cuda:
                        stream.synchronize()
                    with (trace.span("detector.lines") if timed
                          else contextlib.nullcontext()):
                        prog.run_stage(len(prog.stages) - 1)
                        if timed and cuda:
                            stream.synchronize()
                # on the stream of the launch: the copy is taken before the
                # next frame's launch overwrites the output buffer
                host, ready = to_host_async(prog.out)
            n_fast = prog.sizes[0] // 3 if need_fast else 0
            return need_fast, need_lines, n_fast, host, ready

    @staticmethod
    def _take_detections(handle):
        """Wait for a :meth:`_dispatch_detectors` handle -> ((uv, valid) or
        None, (L, 4) valid segments or None)."""
        if handle is None:
            return None, None
        need_fast, need_lines, n, host, ready = handle
        with trace.span("detector.take"):
            flat = host_array(host, ready)
        det = lines = None
        if need_fast:
            fast = flat[:3 * n].reshape(n, 3)
            det = (fast[:, :2], fast[:, 2] > 0.5)
            flat = flat[3 * n:]
        if need_lines:
            packed = flat.reshape(-1, 5)
            # the global collinear merge already ran inside detect_lines;
            # the host only compacts the valid rows
            lines = packed[packed[:, 4] > 0.5, :4]
        return det, lines

    def _detect(self, gray: np.ndarray, need_fast: bool, need_lines: bool):
        """The detectors this frame needs, run and brought home now: a
        ``detector.run`` span, counted in ``detector.sync_detects``."""
        if not (need_fast or need_lines):
            return None, None
        trace.count("detector.sync_detects")
        with trace.span("detector.run"):
            return self._take_detections(self._dispatch_detectors(
                gray, need_fast, need_lines, timed=True))

    def _predispatch_next_detectors(self, need_fast: bool, need_lines: bool):
        """With ``pipelined_tracking`` and the next frame's image given,
        dispatch that frame's detectors now: their device work overlaps the
        rest of this frame, and the next call takes them where its needs
        match."""
        g, self._next_gray = self._next_gray, None
        cfg = self.cfg
        if ((cfg.resident_tracking or cfg.chained_tracking)
                and ResidentDriver.eligible(cfg)):
            return            # the next frame runs in a device loop
        if g is None or not (need_fast or need_lines):
            return
        self._pending_det = (self.f_id + 1, (need_fast, need_lines),
                             self._dispatch_detectors(g, need_fast,
                                                      need_lines))

    def _finish_selection(self, det, point_detections,
                          line_detections, flow_np, h, w):
        """Static point / static line / object line selections
        (Frame.cc:491-718, :814-875) from this frame's detections."""
        cfg = self.cfg
        cand = np.zeros((self.N_CAND, 2), np.float32)
        cand_valid = np.zeros(self.N_CAND, bool)
        if det is not None:
            d_uv, d_valid = det
            # keypoint undistortion (Frame::UndistortKeyPoints,
            # Frame.cc:1037-1081): identity when all coefficients are zero
            d_uv = geometry.undistort_points_np(
                d_uv, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                cfg.k1, cfg.k2, cfg.p1, cfg.p2, cfg.k3,
            )
            n = min(len(d_uv), self.N_CAND)
            cand[:n] = d_uv[:n]
            cand_valid[:n] = d_valid[:n]
        elif point_detections is not None and cfg.use_sample_fea == 0:
            n = min(len(point_detections), self.N_CAND)
            cand[:n] = point_detections[:n]
            cand_valid[:n] = True
        else:
            # constant per image size: cached
            if self._grid_cache is None or self._grid_cache[0] != (h, w):
                self._grid_cache = ((h, w), fr.grid_sample_uv(
                    h, w, n_points=self.N_CAND, device="cpu").numpy())
            cand = self._grid_cache[1]
            cand_valid = np.ones(self.N_CAND, bool)

        lcand = np.zeros((self.NL_CAND, 4), np.float32)
        lcand_valid = np.zeros(self.NL_CAND, bool)
        if line_detections is not None and len(line_detections):
            n = min(len(line_detections), self.NL_CAND)
            lcand[:n] = line_detections[:n]
            lcand_valid[:n] = True

        stat_tmp = _native.select_static_points(
            cand, cand_valid, self.depth_np, flow_np, self.mask_np,
            cfg.th_depth_bg, self.NS,
        )
        if stat_tmp is None:
            stat_tmp = fh.select_static_points(
                cand, cand_valid, self.depth_np, flow_np, self.mask_np,
                cfg.th_depth_bg, self.NS,
            )
        line_tmp = _native.select_static_lines(
            lcand, lcand_valid, self.depth_np, flow_np, self.mask_np,
            cfg.th_depth_bg, self.NLS,
        )
        if line_tmp is None:
            line_tmp = fh.select_static_lines(
                lcand, lcand_valid, self.depth_np, flow_np, self.mask_np,
                cfg.th_depth_bg, self.NLS,
            )
        oline_tmp = _native.select_object_lines(
            lcand, lcand_valid, self.depth_np, flow_np, self.mask_np,
            cfg.th_depth_obj, self.NLO,
        )
        if oline_tmp is None:
            oline_tmp = fh.select_object_lines(
                lcand, lcand_valid, self.depth_np, flow_np, self.mask_np,
                cfg.th_depth_obj, self.NLO,
            )
        return stat_tmp, line_tmp, oline_tmp

    # ------------------------------------------------------------------
    def _track_dispatch(self, flow_np, obj_tmp, pose_gt, gt_objs, timing,
                        stop_frame, det, point_detections, line_detections,
                        need_fast, need_lines):
        """The first half of a tracked frame: inherit, group objects,
        solve camera and objects on the device and start the copy of the
        results home, run this frame's selections and dispatch the next
        frame's detectors.  Returns the in-flight frame dict that
        :meth:`_track_finish` consumes: every input of the finish is in
        it, since with ``pipelined_tracking`` the finish runs at the start
        of the next call, after ``self.depth_np`` / ``mask_np`` hold the
        next frame's images."""
        cfg = self.cfg
        last = self.last
        h, w = self.mask_np.shape

        # ---- inherit from last frame (host; Tracking.cc:269-473) ----
        (s_uv, s_d, l_uv, l_d, o_uv, o_d, o_sem, ol_uv, ol_d,
         ol_sem) = fh.inherit(
            last["stat_corres"], last["line_corres"], last["obj_corres"],
            last["oline_corres"], self.depth_np, self.mask_np,
            cfg.th_depth_obj,
        )
        s_v = last["stat_valid"]
        l_v = last["line_valid"]
        o_v = last["obj_valid"]
        ol_v = last["oline_valid"]
        last_s_valid = s_v & (last["stat_depth"] > 0) & (s_d > 0)
        line_ok = fh.line_track_filter(l_uv, l_v, self.depth_np, self.mask_np)
        l_use = l_v & (last["line_depth"].min(axis=-1) > 0) & line_ok
        velocity_np = self.velocity if self.velocity is not None else _EYE4

        # ---- group objects by semantic label (the mask-only parts of
        # DynObjTracking: Tracking.cc:2112-2523) ----
        t0 = time.perf_counter()
        sf_valid = (
            o_v & last["obj_valid"] & (last["obj_sem"] > 0) & (o_sem > 0)
        )
        groups = self._group_objects(
            o_uv, o_d, o_sem, sf_valid, ol_uv, ol_sem, ol_v
        )
        buckets = self._build_buckets(groups, o_uv, o_d, ol_uv, sf_valid)
        timing[2] = (time.perf_counter() - t0) * 1e3

        # ---- camera + objects on the device; the results come home in
        # one copy that the finish waits for ----
        t0 = time.perf_counter()
        pulled = legacy = None
        if cfg.use_joint_optimization:
            pulled = self._solve_frame(velocity_np, last, s_uv, s_d,
                                       last_s_valid, l_use, buckets)
        else:
            legacy = self._solve_frame_nonjoint(velocity_np, last, s_uv, s_d,
                                                last_s_valid, l_uv, l_use,
                                                buckets)
        t_solve = time.perf_counter() - t0

        # ---- selections from this frame's detections ----
        t0 = time.perf_counter()
        stat_tmp, line_tmp, oline_tmp = self._finish_selection(
            det, point_detections, line_detections, flow_np, h, w,
        )
        timing[0] += (time.perf_counter() - t0) * 1e3
        self._predispatch_next_detectors(need_fast, need_lines)
        return dict(
            pulled=pulled, legacy=legacy, t_solve=t_solve,
            buckets=buckets, groups=groups, last=last,
            s_uv=s_uv, s_d=s_d, l_uv=l_uv, l_d=l_d,
            o_uv=o_uv, o_d=o_d, o_sem=o_sem,
            ol_uv=ol_uv, ol_d=ol_d, ol_sem=ol_sem, ol_v=ol_v,
            stat_tmp=stat_tmp, line_tmp=line_tmp, oline_tmp=oline_tmp,
            flow_np=flow_np, obj_tmp=obj_tmp, pose_gt=pose_gt,
            gt_objs=gt_objs, timing=timing, stop_frame=stop_frame,
            f_id=self.f_id, depth_np=self.depth_np, mask_np=self.mask_np,
        )

    def _track_finish(self, fin, defer_push=False):
        """The second half of a tracked frame, from the in-flight dict
        ``fin``: take the solve's results, commit labels, renew features,
        push the map and fire the BA triggers.  ``defer_push``: leave the
        map push for :meth:`_run_deferred_push` when no BA fires (the
        pipelined path runs it after the next frame's dispatch).  Returns
        the frame's pose (refined, when its window BA ran)."""
        cfg = self.cfg
        last, buckets, groups = fin["last"], fin["buckets"], fin["groups"]
        s_uv, l_uv = fin["s_uv"], fin["l_uv"]
        timing, f_id = fin["timing"], fin["f_id"]

        t0 = time.perf_counter()
        out = fin["legacy"]
        if out is None:
            host, ready, spec = fin["pulled"]
            out = _unpack(host_array(host, ready), spec)
        pose_np = out["pose"]
        stat_track_ok, line_track_ok = out["point_inlier"], out["line_inlier"]
        if cfg.use_joint_optimization:
            # update tracked positions from optimised flow
            # (Optimizer.cc:6796)
            s_uv = np.where(stat_track_ok[:, None],
                            last["stat_uv"] + out["flow"], s_uv)
            l_uv = np.where(line_track_ok[:, None],
                            last["line_uv"] + out["line_flow"], l_uv)
        obj_pulled = None
        if buckets is not None:
            n_obj = len(groups)
            obj_pulled = tuple(out[k][:n_obj] for k in (
                "o_pose", "o_flow", "o_line_flow", "o_point_inlier",
                "o_line_inlier", "o_init_n", "o_static_frac"))
        timing[1] = (fin["t_solve"] + time.perf_counter() - t0) * 1e3

        # velocity (Tracking.cc:1177-1183)
        self.velocity = (pose_np @ np.linalg.inv(last["pose"])).astype(
            np.float32)

        # ---- commit object labels + per-object meta (the pose-dependent
        # tail of DynObjTracking + Tracking.cc:1277-1528) ----
        t0 = time.perf_counter()
        obj_label, oline_label, obj_meta = self._commit_objects(
            groups, obj_pulled, pose_np, fin["pose_gt"], fin["gt_objs"],
            last)
        self._oline_label = oline_label
        obj_track_ok = np.zeros(self.NO, bool)
        oline_track_ok = np.zeros(self.NLO, bool)
        o_uv_np = np.array(fin["o_uv"])
        ol_uv_np = np.array(fin["ol_uv"])
        for om in obj_meta:
            if not om["stat"]:
                continue
            idx = om["pt_idx"]
            fl = om["flow"][: len(idx)]
            inl = om["pt_inlier"][: len(idx)]
            o_uv_np[idx[inl]] = last["obj_uv"][idx[inl]] + fl[inl]
            obj_track_ok[idx[inl]] = True
            lidx = om["ln_idx"]
            if len(lidx):
                lfl = om["ln_flow"][: len(lidx)]
                linl = om["ln_inlier"][: len(lidx)]
                ol_uv_np[lidx[linl]] = last["oline_uv"][lidx[linl]] + lfl[linl]
                oline_track_ok[lidx[linl]] = True
        timing[3] = (time.perf_counter() - t0) * 1e3

        # ================= RENEW =================
        t0 = time.perf_counter()
        new_state = self._renew_frame_info(
            fin["depth_np"], fin["mask_np"],
            pose_np, fin["flow_np"], fin["stat_tmp"], fin["line_tmp"],
            fin["obj_tmp"], fin["oline_tmp"],
            s_uv, fin["s_d"], stat_track_ok,
            l_uv, fin["l_d"], line_track_ok,
            o_uv_np, fin["o_d"], fin["o_sem"], obj_label, obj_track_ok,
            ol_uv_np, fin["ol_d"], fin["ol_sem"], fin["ol_v"],
            oline_track_ok, fin["pose_gt"], fin["gt_objs"],
        )
        timing[4] = (time.perf_counter() - t0) * 1e3

        # ================= MAP =================
        self.last = new_state
        # the next frame's grouping reads the meta: set here, not in the
        # deferrable push
        self.last_meta = {
            "sem_position": [om["sem"] for om in obj_meta],
            "mod_label": [om["label"] for om in obj_meta],
            "obj_stat": [om["stat"] for om in obj_meta],
            "obj_motion": {
                om["label"]: om["H"] for om in obj_meta if om["stat"]
            },
        }
        # ===== batch optimisation triggers (Tracking.cc:1793-1884) =====
        lba_fires = (cfg.run_local_ba
                     and (f_id - cfg.overlap_size + 1)
                     % max(cfg.window_size - cfg.overlap_size, 1) == 0
                     and f_id >= cfg.window_size - 1)
        global_fires = _global_ba_on(cfg) and f_id == fin["stop_frame"]
        push = (new_state, pose_np, fin["pose_gt"], last["pose_gt"],
                self.velocity, obj_meta, timing)
        if defer_push and not (lba_fires or global_fires):
            self._deferred_push = push
            return pose_np
        self._push_map(*push)
        if lba_fires:
            self.map.lba_times.append(self._batch_ba(
                "local", ba_builder.partial_batch_optimization,
                cfg.window_size, frame=f_id))
            # the next frame starts from the refined pose
            pose_np = np.linalg.inv(self.map.camera_poses[-1]).astype(
                np.float32)
            self.last["pose"] = pose_np
        if global_fires:
            self._batch_ba("global", ba_builder.full_batch_optimization,
                           frame=f_id)
        return pose_np

    def _run_deferred_push(self) -> None:
        """The map push a pipelined finish left for later, if any."""
        if self._deferred_push is not None:
            push, self._deferred_push = self._deferred_push, None
            self._push_map(*push)

    def _batch_ba(self, kind: str, entry, *args, frame=None) -> float:
        """Run one batch BA entry point on the map; log it in ``ba_runs``
        (at ``frame``, by default the current one) and return its wall ms.
        The entry's step ("schur" or "cg") is read off the two LM loops'
        counters; ``captures`` counts the fused programs it captured (on
        the card, the first call of each bucket set).  The run is a
        ``<kind>_ba`` span."""
        rb, rs = bb.run_ba, schur_ba.run_ba_schur
        before = (rb.iterations, rb.cg_iterations, rb.host_syncs,
                  rs.iterations, rs.host_syncs, bb.BAProgram.captures)
        t0 = time.perf_counter()
        with trace.span(kind + "_ba"):
            entry(self.map, self.K, *args, self.cfg,
                  use_lines=self.cfg.use_lines, device=self.device)
        ms = (time.perf_counter() - t0) * 1e3
        schur_its = rs.iterations - before[3]
        self.ba_runs.append(dict(
            kind=kind, frame=self.f_id if frame is None else frame, ms=ms,
            step="schur" if schur_its else "cg",
            iterations=rb.iterations - before[0] + schur_its,
            cg_iterations=rb.cg_iterations - before[1],
            host_syncs=rb.host_syncs - before[2] + rs.host_syncs - before[4],
            captures=bb.BAProgram.captures - before[5]))
        return ms

    # ------------------------------------------------------------------
    def _pack_frame(self, velocity_np, last, s_uv, s_d, last_s_valid, l_use,
                    buckets):
        """The fused frame's packed float32 input in the layout of
        ``frame_program.in_spec`` (the JAX package's ``_dispatch_fused``
        layout, then this frame's RANSAC draws: the camera lane and the
        ``MB`` object lanes) -> (flat, MB, use_obj_lines)."""
        MB = 0 if buckets is None else buckets["pt_obs"].shape[0]
        arrays = dict(
            velocity=velocity_np, T_lw=last["pose"], s_obs=last["stat_uv"],
            s_flow0=last["stat_flow"], s_depth=last["stat_depth"],
            s_cur_uv=s_uv, s_cur_d=s_d, s_valid=last_s_valid,
            l_obs=last["line_uv"], l_flow0=last["line_flow"],
            l_depth=last["line_depth"], l_valid=l_use)
        if MB:
            arrays.update(buckets)
        with self.host_draws():
            arrays["u_cam"] = self._ransac_uniforms(
                self.f_id, 0, self.n_hyp_cam).cpu().numpy()
            arrays["u_obj"] = [self._ransac_uniforms(
                self.f_id, k + 1, self.n_hyp_obj).cpu().numpy()
                for k in range(MB)]
        flat = np.concatenate([
            np.asarray(arrays[name], np.float32).ravel()
            for name, _, _ in in_spec(frame_caps(self), MB)])
        return flat, MB, bool(MB and buckets["any_lines"])

    def _solve_frame(self, velocity_np, last, s_uv, s_d, last_s_valid,
                     l_use, buckets):
        """Camera init -> joint camera solve -> scene-flow static test ->
        object inits -> joint object solves on ``self.device``: the frame's
        inputs packed into one buffer, copied in once, and one call of the
        fused-frame program of its ``MB`` and line mode (on the card one
        graph launch, the LMs ending on the device); returns the started
        copy of its packed output home (host buffer, event, spec) for
        :func:`_unpack`."""
        flat, MB, use_obj_lines = self._pack_frame(
            velocity_np, last, s_uv, s_d, last_s_valid, l_use, buckets)
        caps = frame_caps(self)
        prog = frame_program(self.cfg, self.K, caps, MB, use_obj_lines,
                             self.device)
        prog.load({"buf": flat})
        self.lm_host_syncs += prog()
        # on the stream of the launch: the copy is taken before the next
        # frame's launch overwrites the output buffer
        return to_host_async(prog.out) + (out_spec(caps, MB),)

    def _pack_nonjoint(self, velocity_np, last, s_uv, s_d, last_s_valid,
                       l_uv, l_use, buckets):
        """The non-joint frame's packed float32 input in the layout of
        ``frame_program.nonjoint_in_spec`` -> (flat, MB, use_obj_lines).
        The last frame's fixed structure is unprojected with the
        reference's Gaussian depth noise (UnprojectStereoStat(..,
        addnoise=1), Optimizer.cc:5982), drawn from
        ``np.random.default_rng(f_id)``; the camera's RANSAC draws are
        lane 0 of the frame, the objects' lane k + 1 of a stream of their
        own (``1000 + f_id``), as in the JAX package."""
        cfg, K = self.cfg, self.K
        MB = 0 if buckets is None else buckets["pt_obs"].shape[0]
        depth_n = last["stat_depth"]
        if cfg.nonjoint_add_noise:
            nrng = np.random.default_rng(self.f_id)
            sigma = depth_n * depth_n / (725.0 * 0.5) * 0.15
            depth_n = (
                depth_n + sigma * nrng.standard_normal(depth_n.shape)
            ).astype(np.float32)
        l3d = last["line_3d"]
        arrays = dict(
            velocity=velocity_np, T_lw=last["pose"], s_obs=last["stat_uv"],
            s_depth=last["stat_depth"], s_cur_uv=s_uv, s_cur_d=s_d,
            s_valid=last_s_valid,
            X_w=_np_world_points(K, last["pose"], last["stat_uv"], depth_n),
            l_Xs=l3d[:, :3], l_Xe=l3d[:, 3:], l_uv=l_uv, l_use=l_use)
        if MB:
            arrays.update(buckets)
            T_lw = torch.as_tensor(np.asarray(last["pose"], np.float32))
            arrays["T_wl"] = torch.linalg.inv_ex(T_lw)[0].numpy()
        with self.host_draws():
            arrays["u_cam"] = self._ransac_uniforms(
                self.f_id, 0, self.n_hyp_cam).cpu().numpy()
            arrays["u_obj"] = [self._ransac_uniforms(
                1000 + self.f_id, k + 1, self.n_hyp_obj).cpu().numpy()
                for k in range(MB)]
        flat = np.concatenate([
            np.asarray(arrays[name], np.float32).ravel()
            for name, _, _ in nonjoint_in_spec(frame_caps(self), MB)])
        return flat, MB, bool(MB and buckets["any_lines"])

    def _solve_frame_nonjoint(self, velocity_np, last, s_uv, s_d,
                              last_s_valid, l_uv, l_use, buckets):
        """``bJoint = false``: PoseOptimizationNewWithLines
        (Optimizer.cc:5900) for the camera on the last frame's fixed 3D
        structure (:meth:`_pack_nonjoint`); the objects keep the joint
        flow+motion solve, with RANSAC draws of their own stream, and
        their static test runs on the host.  The inputs go in as one
        packed buffer, one call of the non-joint program of the frame's
        ``MB`` and line mode runs them (on the card one graph launch), and
        the output comes home in one copy.  Same keys as
        :meth:`_solve_frame` without the camera flows, and the pose-only
        solve's final ``cost``.

        One departure from the JAX package: its non-joint object chain
        hands the init the inverse of the last pose where the init
        expects the pose itself (the JAX package's models/tracking.py
        ``_dispatch_objects_legacy``), so its object inlier sets are taken
        against misplaced world points from the second tracked frame on.
        Here the init takes the pose, as on the joint path."""
        flat, MB, use_obj_lines = self._pack_nonjoint(
            velocity_np, last, s_uv, s_d, last_s_valid, l_uv, l_use,
            buckets)
        caps = frame_caps(self)
        prog = nonjoint_program(self.cfg, self.K, caps, MB, use_obj_lines,
                                self.device)
        prog.load({"buf": flat})
        self.lm_host_syncs += prog()
        out = _unpack(host_array(*to_host_async(prog.out)),
                      nonjoint_out_spec(caps, MB))
        if buckets is not None:
            # host static test (scene flow with the already-known pose)
            b = buckets
            Xp_w = _np_world_points(self.K, last["pose"], b["pt_obs"],
                                    b["pt_depth"])
            Xc_w = _np_world_points(self.K, out["pose"], b["pt_cur_uv"],
                                    b["pt_cur_d"])
            f3 = Xc_w - Xp_w
            sfn = np.sqrt(f3[..., 0] ** 2 + f3[..., 2] ** 2)
            v = b["pt_sfvalid"].astype(np.float32)
            nv = np.maximum(v.sum(axis=-1), 1.0)
            out["o_static_frac"] = (
                (v * (sfn < self.cfg.sf_mg_thres)).sum(axis=-1) / nv)
        return out

    # ------------------------------------------------------------------
    def _update_mask(self):
        """Mask recovery (Tracking.cc:4730-4810): per last-frame semantic
        label, sample the current mask at the flow-warped object points; if
        the majority vote (over >= 100 samples) is background, the segmenter
        lost the object -- splat the last mask forward along the last flow."""
        last = self.last
        if self.last_mask_np is None or self.last_flow_np is None:
            return
        h, w = self.mask_np.shape
        sem = last["obj_sem"]
        valid = last["obj_valid"]
        corres = last["obj_corres"]
        for lab in np.unique(sem[valid & (sem > 0)]):
            idx = np.nonzero(valid & (sem == lab))[0]
            u = corres[idx, 0].astype(np.int32)
            v = corres[idx, 1].astype(np.int32)
            inb = (u > 0) & (u < w) & (v > 0) & (v < h)
            if inb.sum() < 100:
                continue
            samples = self.mask_np[v[inb], u[inb]]
            vals, counts = np.unique(samples, return_counts=True)
            if vals[np.argmax(counts)] != 0:
                continue
            # splat: current mask at (pixel + last flow) = label
            ys, xs = np.nonzero(self.last_mask_np == lab)
            fx = self.last_flow_np[ys, xs, 0].astype(np.int32)
            fy = self.last_flow_np[ys, xs, 1].astype(np.int32)
            nx, ny = xs + fx, ys + fy
            ok = (nx > 0) & (nx < w) & (ny > 0) & (ny < h)
            self.mask_np[ny[ok], nx[ok]] = lab

    # ------------------------------------------------------------------
    def _initialize(self, stat_tmp, line_tmp, obj_tmp,
                    oline_tmp, pose_gt, gt_objs):
        """First frame (Tracking.cc:1888-1984): identity pose, stash features
        + 3D, push frame-0 map entries."""
        s_uv, s_d, s_f, s_c, s_v = stat_tmp
        l_uv, l_d, l_f, l_c, l_v = line_tmp
        o_uv, o_d, o_f, o_c, o_s, o_v = obj_tmp
        ol_uv, ol_d, ol_f, ol_c, ol_s, ol_v = oline_tmp

        pose = _EYE4
        stat_3d = _np_world_points(self.K, pose, s_uv, s_d)
        line_3d = _np_world_lines(self.K, pose, l_uv, l_d)
        obj_3d = _np_world_points(self.K, pose, o_uv, o_d)
        oline_3d = _np_world_lines(self.K, pose, ol_uv, ol_d)

        self.last = dict(
            pose=_EYE4.copy(), pose_gt=pose_gt,
            stat_uv=np.asarray(s_uv), stat_depth=np.asarray(s_d),
            stat_flow=np.asarray(s_f), stat_corres=np.asarray(s_c),
            stat_valid=np.asarray(s_v), stat_3d=np.asarray(stat_3d),
            line_uv=np.asarray(l_uv), line_depth=np.asarray(l_d),
            line_flow=np.asarray(l_f), line_corres=np.asarray(l_c),
            line_valid=np.asarray(l_v), line_3d=np.asarray(line_3d),
            obj_uv=np.asarray(o_uv), obj_depth=np.asarray(o_d),
            obj_flow=np.asarray(o_f), obj_corres=np.asarray(o_c),
            obj_sem=np.asarray(o_s), obj_valid=np.asarray(o_v),
            obj_3d=np.asarray(obj_3d),
            obj_label=np.full(self.NO, -2, np.int32),
            oline_uv=np.asarray(ol_uv), oline_depth=np.asarray(ol_d),
            oline_flow=np.asarray(ol_f), oline_corres=np.asarray(ol_c),
            oline_sem=np.asarray(ol_s), oline_valid=np.asarray(ol_v),
            oline_3d=np.asarray(oline_3d),
            oline_label=np.full(self.NLO, -2, np.int32),
            gt_objs=gt_objs,
        )
        self.last_meta = {"sem_position": [], "mod_label": [],
                          "obj_stat": [], "obj_motion": {}}

        # frame-0 map entries (Initialization, Tracking.cc:1921-1954):
        # features + identity camera poses (GT identity: origin-aligned)
        m = self.map
        st = self.last
        m.stat_uv.append(st["stat_uv"]); m.stat_depth.append(st["stat_depth"])
        m.stat_3d.append(st["stat_3d"]); m.stat_valid.append(st["stat_valid"])
        m.stat_asso.append(np.full(self.NS, -1, np.int32))
        m.line_uv.append(st["line_uv"]); m.line_depth.append(st["line_depth"])
        m.line_3d.append(st["line_3d"]); m.line_valid.append(st["line_valid"])
        m.line_asso.append(np.full(self.NLS, -1, np.int32))
        m.line_plucker.append(_np_plucker(st["line_3d"][:, :3], st["line_3d"][:, 3:]))
        m.dyn_uv.append(st["obj_uv"]); m.dyn_depth.append(st["obj_depth"])
        m.dyn_3d.append(st["obj_3d"]); m.dyn_valid.append(st["obj_valid"])
        m.dyn_asso.append(np.full(self.NO, -1, np.int32))
        m.dyn_label.append(st["obj_label"])
        m.dline_uv.append(st["oline_uv"]); m.dline_depth.append(st["oline_depth"])
        m.dline_3d.append(st["oline_3d"]); m.dline_valid.append(st["oline_valid"])
        m.dline_asso.append(np.full(self.NLO, -1, np.int32))
        m.dline_label.append(st["oline_label"])
        m.dline_plucker.append(_np_plucker(st["oline_3d"][:, :3], st["oline_3d"][:, 3:]))
        m.camera_poses.append(_EYE4.copy())
        m.camera_poses_rf.append(_EYE4.copy())
        m.camera_poses_gt.append(_EYE4.copy())

    # ------------------------------------------------------------------
    def _group_objects(self, o_uv, o_d, o_sem, sf_valid, ol_uv, ol_sem,
                       ol_valid):
        """Mask-only half of DynObjTracking (Tracking.cc:2077-2523): group
        candidate object points by semantic label, reject
        boundary-dominated groups, and precompute the far/small flags plus
        the tentative tracking-label association (last-frame majority
        semantic label -> last motion model, Tracking.cc:2631-2699).  The
        pose-dependent scene-flow static test runs on device inside the
        fused step and is applied in :meth:`_commit_objects`."""
        cfg = self.cfg
        h, w = self.mask_np.shape
        last = self.last
        cand = sf_valid & (o_sem > 0)
        uniq = np.unique(o_sem[cand])
        uniq = uniq[uniq > 0]

        shr_c, shr_r = cfg.boundary_shrink_x, cfg.boundary_shrink_y
        if cfg.choose_data != KITTI:
            shr_c, shr_r = 0, 0

        last_sem = last["obj_sem"]
        groups = []
        for lab in uniq:
            pidx = np.nonzero(cand & (o_sem == lab))[0]
            lidx = np.nonzero(ol_valid & (ol_sem == lab))[0]
            if len(pidx) == 0:
                continue
            # boundary rejection (Tracking.cc:2460-2500)
            u, v = o_uv[pidx, 0], o_uv[pidx, 1]
            near = (
                (v < shr_r) | (v > h - shr_r) | (u < shr_c) | (u > w - shr_c)
            ).sum()
            if len(lidx):
                lu = ol_uv[lidx]
                near += (
                    (lu[:, 1] < shr_r) | (lu[:, 1] > h - shr_r)
                    | (lu[:, 0] < shr_c) | (lu[:, 0] > w - shr_c)
                    | (lu[:, 3] < shr_r) | (lu[:, 3] > h - shr_r)
                    | (lu[:, 2] < shr_c) | (lu[:, 2] > w - shr_c)
                ).sum()
            if near / max(len(pidx) + len(lidx), 1) > 0.5:
                continue
            # far / small flags (Tracking.cc:2575-2590); applied after the
            # static-test result arrives (static precedes far/small)
            far_small = (
                o_d[pidx].mean() > cfg.th_depth_obj
                or len(pidx) < cfg.min_object_points
            )
            # tentative association (committed in _commit_objects; new ids
            # are allocated only for objects that survive the static test)
            lb_last = last_sem[pidx]
            if len(lidx):
                lb_last = np.concatenate(
                    [lb_last, last["oline_sem"][lidx]]
                )
            vals, counts = np.unique(lb_last, return_counts=True)
            assoc_sem = int(vals[np.argmax(counts)])
            assigned = None
            if self.max_id > 1:
                for k, sem_pos in enumerate(self.last_meta["sem_position"]):
                    if (
                        sem_pos == assoc_sem
                        and self.last_meta["obj_stat"][k]
                    ):
                        assigned = self.last_meta["mod_label"][k]
                        break
            H_prev = (
                self.last_meta["obj_motion"].get(assigned)
                if assigned is not None else None
            )
            groups.append(dict(
                sem=int(lab), pidx=pidx, lidx=lidx, far_small=far_small,
                assigned=assigned, H_prev=H_prev,
            ))
        return groups[: self.MAXO]

    # ------------------------------------------------------------------
    def _build_buckets(self, groups, o_uv, o_d, ol_uv, sf_valid):
        """Pack the object groups into fixed (MB, P)/(MB, L) device buckets
        (MB = next power of two).  Returns None when there are no groups."""
        n_obj = len(groups)
        if n_obj == 0:
            return None
        last = self.last
        P, L = self.P_OBJ, self.L_OBJ
        # smallest power-of-two bucket (RANSAC draws are seeded by lane
        # index, so they are identical for any MB)
        MB = min(1 << max(n_obj - 1, 0).bit_length(), self.MAXO)
        b = dict(
            pt_obs=np.zeros((MB, P, 2), np.float32),
            pt_flow0=np.zeros((MB, P, 2), np.float32),
            pt_depth=np.ones((MB, P), np.float32),
            pt_cur_uv=np.zeros((MB, P, 2), np.float32),
            pt_cur_d=np.zeros((MB, P), np.float32),
            pt_valid=np.zeros((MB, P), bool),
            pt_sfvalid=np.zeros((MB, P), bool),
            ln_obs=np.zeros((MB, L, 4), np.float32),
            ln_flow0=np.zeros((MB, L, 4), np.float32),
            ln_depth=np.ones((MB, L, 2), np.float32),
            ln_valid=np.zeros((MB, L), bool),
            H_prev=np.tile(_EYE4, (MB, 1, 1)),
        )
        o_uv_np = np.asarray(o_uv)
        o_d_np = np.asarray(o_d)
        ol_uv_np = np.asarray(ol_uv)
        for k, g in enumerate(groups):
            pidx = g["pidx"][:P]
            lidx = g["lidx"][:L]
            n, m = len(pidx), len(lidx)
            # the edge unprojects LAST-frame pixels at last depths
            b["pt_obs"][k, :n] = last["obj_uv"][pidx]
            b["pt_depth"][k, :n] = last["obj_depth"][pidx]
            b["pt_flow0"][k, :n] = o_uv_np[pidx] - last["obj_uv"][pidx]
            b["pt_cur_uv"][k, :n] = o_uv_np[pidx]
            b["pt_cur_d"][k, :n] = o_d_np[pidx]
            b["pt_valid"][k, :n] = last["obj_depth"][pidx] > 0
            b["pt_sfvalid"][k, :n] = sf_valid[pidx]
            if m:
                b["ln_obs"][k, :m] = last["oline_uv"][lidx]
                b["ln_depth"][k, :m] = last["oline_depth"][lidx]
                b["ln_flow0"][k, :m] = (
                    ol_uv_np[lidx] - last["oline_uv"][lidx]
                )
                b["ln_valid"][k, :m] = (
                    last["oline_depth"][lidx].min(axis=1) > 0
                )
            if g["H_prev"] is not None:
                b["H_prev"][k] = g["H_prev"]
        b["any_lines"] = bool(b["ln_valid"].any())
        return b

    # ------------------------------------------------------------------
    def _commit_objects(self, groups, obj_pulled, pose_np, pose_gt,
                        gt_objs, last):
        """Apply the static test, commit tracking labels (allocating new
        ids for unassociated dynamic objects), and build the per-object
        meta consumed by renewal and the map (Tracking.cc:2528-2736 +
        :1277-1528)."""
        cfg = self.cfg
        obj_label = np.full(self.NO, -1, np.int32)
        oline_label = np.full(self.NLO, -1, np.int32)
        obj_meta = []
        if obj_pulled is None or not groups:
            return obj_label, oline_label, obj_meta
        (o_G, o_flow, o_lflow, o_pinl, o_linl, init_n_np,
         static_frac) = obj_pulled

        inv_pose = np.linalg.inv(pose_np)
        curr_twc_gt = np.linalg.inv(pose_gt)
        last_twc_gt = np.linalg.inv(last["pose_gt"])
        P, L = self.P_OBJ, self.L_OBJ

        for k, g in enumerate(groups):
            pidx, lidx = g["pidx"], g["lidx"]
            # static test (Tracking.cc:2528-2560): frac of x-z scene flow
            # below SFMgThres -> background label 0
            if float(static_frac[k]) > cfg.sf_ds_thres:
                obj_label[pidx] = 0
                oline_label[lidx] = 0
                continue
            # far / small rejection (Tracking.cc:2575-2590): label stays -1
            if g["far_small"]:
                continue
            assigned = g["assigned"]
            if assigned is None:
                assigned = self.max_id
                self.max_id += 1
            obj_label[pidx] = assigned
            oline_label[lidx] = assigned

            pidx_c, lidx_c = pidx[:P], lidx[:L]
            n = len(pidx_c)
            sem_lab = g["sem"]
            L_w_p = self._gt_obj_pose(last.get("gt_objs", []), sem_lab,
                                      last_twc_gt)
            L_w_c = self._gt_obj_pose(gt_objs, sem_lab, curr_twc_gt)
            stat = True
            H_gt_body = _EYE4.copy()
            pose_pre = _EYE4.copy()
            H_gt_world = _EYE4.copy()
            if L_w_p is None or L_w_c is None:
                stat = False           # Tracking.cc:1317-1334
            else:
                H_gt_body = (np.linalg.inv(L_w_p) @ L_w_c).astype(np.float32)
                H_gt_world = (L_w_c @ np.linalg.inv(L_w_p)).astype(np.float32)
                pose_pre = L_w_p
            if int(init_n_np[k]) < cfg.min_pnp_inliers_obj:
                stat = False           # init failure, Tracking.cc:1387-1399
            H = (inv_pose @ o_G[k]).astype(np.float32)
            if not stat:
                H = _EYE4.copy()
            centre = (
                _np_world_points(
                    self.K, last["pose"], last["obj_uv"][pidx_c],
                    last["obj_depth"][pidx_c],
                ).mean(axis=0)
                if n
                else np.zeros(3, np.float32)
            )
            # GT speed (Tracking.cc:1404-1409): v = t - (I-R) c, km/h x36
            sp_gt_v = H_gt_world[:3, 3] - (
                np.eye(3) - H_gt_world[:3, :3]
            ) @ centre[:3]
            speed_gt = float(np.linalg.norm(sp_gt_v)) * 36.0
            obj_meta.append(dict(
                label=assigned, sem=sem_lab, stat=stat, H=H,
                speed_gt=speed_gt, H_gt_body=H_gt_body, pose_pre=pose_pre,
                centre=centre, pt_idx=pidx_c, ln_idx=lidx_c,
                pt_inlier=o_pinl[k], ln_inlier=o_linl[k],
                flow=o_flow[k], ln_flow=o_lflow[k],
            ))
        return obj_label, oline_label, obj_meta

    def _gt_obj_pose(self, gt_rows, sem_label, twc_gt):
        """Find the GT pose row matching a semantic label; KITTI rows are in
        camera coords and lifted to world by Twc_gt (Tracking.cc:1289-1311)."""
        for row in gt_rows:
            if int(row[1]) == sem_label:
                if self.cfg.choose_data == OMD:
                    return obj_pose_parsing_ox(row, self.origin_inv)
                L = obj_pose_parsing_kt(row)
                return (twc_gt @ L).astype(np.float32)
        return None

    # ------------------------------------------------------------------
    def _renew_frame_info(self, depth_np, mask_np,
                          pose_np, flow_np, stat_tmp, line_tmp,
                          obj_tmp, oline_tmp,
                          s_uv, s_d, stat_ok, l_uv, l_d, line_ok,
                          o_uv, o_d, o_sem, obj_label, obj_ok,
                          ol_uv, ol_d, ol_sem, ol_valid, oline_ok,
                          pose_gt, gt_objs):
        """RenewFrameInfo (Tracking.cc:3959-4730): keep inliers, top-up from
        this frame's detections with dedup, recompute depth/3D, rebuild
        association ids.  ``depth_np``/``mask_np`` are the frame's images."""
        cfg = self.cfg
        h, w = mask_np.shape

        def filt_point(uv):
            x = uv[:, 0].astype(np.int32)
            y = uv[:, 1].astype(np.int32)
            inb = (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1)
            xc, yc = np.clip(x, 0, w - 1), np.clip(y, 0, h - 1)
            m = mask_np[yc, xc]
            d = depth_np[yc, xc]
            f = flow_np[yc, xc]
            corr = uv + f
            ok = (
                inb & (m == 0) & (d > 0) & (d <= 40.0)
                & (f[:, 0] != 0) & (f[:, 1] != 0)
                & (corr[:, 0] < w) & (corr[:, 0] > 0)
                & (corr[:, 1] < h) & (corr[:, 1] > 0)
            )
            return ok, d, f, corr

        # ---- static points: keep inliers ----
        keep_ok, kd, kf, kc = filt_point(s_uv)
        keep = stat_ok & keep_ok
        kept_idx = np.nonzero(keep)[0][: self.NS]

        new_uv = np.zeros((self.NS, 2), np.float32)
        new_d = np.zeros(self.NS, np.float32)
        new_f = np.zeros((self.NS, 2), np.float32)
        new_c = np.zeros((self.NS, 2), np.float32)
        new_asso = np.full(self.NS, -1, np.int32)
        nk = len(kept_idx)
        new_uv[:nk] = s_uv[kept_idx]
        new_d[:nk] = kd[kept_idx]
        new_f[:nk] = kf[kept_idx]
        new_c[:nk] = kc[kept_idx]
        new_asso[:nk] = kept_idx

        # ---- top-up from detections (strided order + 1px dedup against the
        # kept set, Tracking.cc:4091-4140) ----
        cs_uv, cs_d, cs_f, cs_c, cs_v = [np.asarray(a) for a in stat_tmp]
        if nk < self.NS:
            cand_ok, cd, cf, cc = filt_point(cs_uv)
            cand_ok &= cs_v
            if nk:
                cand_ok &= ~self._near_occupied(new_uv[:nk], cs_uv, h, w)
            order = self._strided_order(len(cs_uv), 10)
            pick = order[cand_ok[order]][: self.NS - nk]
            np_new = len(pick)
            new_uv[nk:nk + np_new] = cs_uv[pick]
            new_d[nk:nk + np_new] = cd[pick]
            new_f[nk:nk + np_new] = cf[pick]
            new_c[nk:nk + np_new] = cc[pick]
            nk += np_new
        stat_valid = np.arange(self.NS) < nk

        # ---- static lines: keep + top-up (Tracking.cc:4002-4261) ----
        new_l = np.zeros((self.NLS, 4), np.float32)
        new_ld = np.zeros((self.NLS, 2), np.float32)
        new_lf = np.zeros((self.NLS, 4), np.float32)
        new_lc = np.zeros((self.NLS, 4), np.float32)
        new_lasso = np.full(self.NLS, -1, np.int32)

        def filt_line(uv4):
            xs = uv4[:, 0].astype(np.int32); ys = uv4[:, 1].astype(np.int32)
            xe = uv4[:, 2].astype(np.int32); ye = uv4[:, 3].astype(np.int32)
            inb = (
                (xs > 0) & (xs < w - 1) & (ys > 0) & (ys < h - 1)
                & (xe > 0) & (xe < w - 1) & (ye > 0) & (ye < h - 1)
            )
            xsc, ysc = np.clip(xs, 0, w - 1), np.clip(ys, 0, h - 1)
            xec, yec = np.clip(xe, 0, w - 1), np.clip(ye, 0, h - 1)
            ms = mask_np[ysc, xsc]; me = mask_np[yec, xec]
            ds = depth_np[ysc, xsc]; de = depth_np[yec, xec]
            xm = ((xs + xe) // 2).clip(0, w - 1)
            ym = ((ys + ye) // 2).clip(0, h - 1)
            dm = depth_np[ym, xm]
            ln = np.sqrt((xs - xe) ** 2 + (ys - ye) ** 2).astype(np.float32)
            disc = np.abs(dm - 0.5 * (ds + de)) <= 10.0 * ln / 1000.0
            fs_ = flow_np[ysc, xsc]; fe_ = flow_np[yec, xec]
            f4 = np.concatenate([fs_, fe_], axis=1)
            corr = uv4 + f4
            degen = (np.abs(uv4[:, 0] - uv4[:, 2]) < 1e-6) & (
                np.abs(uv4[:, 1] - uv4[:, 3]) < 1e-6
            )
            ok = (
                inb & ~degen & (ms == 0) & (me == 0)
                & (ds > 0) & (ds <= 40.0) & (de > 0) & (de <= 40.0)
                & disc
                & (corr[:, 0] > 0) & (corr[:, 0] < w)
                & (corr[:, 1] > 0) & (corr[:, 1] < h)
                & (corr[:, 2] > 0) & (corr[:, 2] < w)
                & (corr[:, 3] > 0) & (corr[:, 3] < h)
            )
            d2 = np.stack([ds, de], axis=1)
            return ok, d2, f4, corr

        lk_ok, lkd, lkf, lkc = filt_line(l_uv)
        lkeep = line_ok & lk_ok
        lkept = np.nonzero(lkeep)[0][: self.NLS]
        nlk = len(lkept)
        new_l[:nlk] = l_uv[lkept]
        new_ld[:nlk] = lkd[lkept]
        new_lf[:nlk] = lkf[lkept]
        new_lc[:nlk] = lkc[lkept]
        new_lasso[:nlk] = lkept

        cl_uv, cl_d, cl_f, cl_c, cl_v = [np.asarray(a) for a in line_tmp]
        if nlk < self.NLS and cl_v.any():
            cok, cld, clf, clc = filt_line(cl_uv)
            cok &= cl_v
            if nlk:
                cok &= ~self._line_dup(cl_uv, new_l[:nlk])
            pick = np.nonzero(cok)[0][: self.NLS - nlk]
            nn = len(pick)
            new_l[nlk:nlk + nn] = cl_uv[pick]
            new_ld[nlk:nlk + nn] = cld[pick]
            new_lf[nlk:nlk + nn] = clf[pick]
            new_lc[nlk:nlk + nn] = clc[pick]
            nlk += nn
        line_valid = np.arange(self.NLS) < nlk

        # ---- objects: keep inliers per object, top-up to cap per object,
        # add new-label candidates (Tracking.cc:4381-4692) ----
        co_uv, co_d, co_f, co_c, co_s, co_v = [np.asarray(a) for a in obj_tmp]
        no_uv = np.zeros((self.NO, 2), np.float32)
        no_d = np.zeros(self.NO, np.float32)
        no_f = np.zeros((self.NO, 2), np.float32)
        no_c = np.zeros((self.NO, 2), np.float32)
        no_sem = np.zeros(self.NO, np.int32)
        no_label = np.full(self.NO, -2, np.int32)
        no_asso = np.full(self.NO, -1, np.int32)
        cursor = 0

        def obj_filt(uv):
            x = uv[:, 0].astype(np.int32); y = uv[:, 1].astype(np.int32)
            inb = (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1)
            xc, yc = np.clip(x, 0, w - 1), np.clip(y, 0, h - 1)
            m = mask_np[yc, xc]
            d = depth_np[yc, xc]
            f = flow_np[yc, xc]
            corr = uv + f
            ok = (
                inb & (m != 0) & (d > 0) & (d < cfg.th_depth_obj)
                & (corr[:, 0] < w) & (corr[:, 0] > 0)
                & (corr[:, 1] < h) & (corr[:, 1] > 0)
            )
            return ok, m, d, f, corr

        ok_o, m_o, d_o, f_o, c_o = obj_filt(o_uv)
        tracked_labels = [int(x) for x in np.unique(obj_label) if x > 0]
        live_sems = set()
        label_sem = {}
        for lab in tracked_labels:
            idx = np.nonzero((obj_label == lab) & obj_ok & ok_o)[0]
            sem_now = (
                int(np.bincount(m_o[idx]).argmax()) if len(idx) else 0
            )
            live_sems.add(sem_now)
            label_sem[lab] = sem_now
            take = idx[: self.P_OBJ]
            n = len(take)
            if cursor + n > self.NO:
                n = self.NO - cursor
                take = take[:n]
            no_uv[cursor:cursor + n] = o_uv[take]
            no_d[cursor:cursor + n] = d_o[take]
            no_f[cursor:cursor + n] = f_o[take]
            no_c[cursor:cursor + n] = c_o[take]
            no_sem[cursor:cursor + n] = m_o[take]
            no_label[cursor:cursor + n] = lab
            no_asso[cursor:cursor + n] = take
            cursor += n
            # top-up from this frame's stride-4 candidates on the same mask
            # label (Tracking.cc:4468-4562)
            if n < self.P_OBJ and co_v.any():
                cok, cm, cdd, cff, ccc = obj_filt(co_uv)
                cok &= co_v & (cm == sem_now) & (sem_now != 0)
                if n:
                    cok &= ~self._near_occupied(o_uv[take], co_uv, h, w)
                pick = np.nonzero(cok)[0][: self.P_OBJ - n]
                nn = min(len(pick), self.NO - cursor)
                pick = pick[:nn]
                no_uv[cursor:cursor + nn] = co_uv[pick]
                no_d[cursor:cursor + nn] = cdd[pick]
                no_f[cursor:cursor + nn] = cff[pick]
                no_c[cursor:cursor + nn] = ccc[pick]
                no_sem[cursor:cursor + nn] = cm[pick]
                no_label[cursor:cursor + nn] = lab
                cursor += nn

        # new semantic labels not currently tracked enter as fresh
        # candidates (next frame's DynObjTracking will classify them,
        # Tracking.cc:4627-4692)
        if co_v.any() and cursor < self.NO:
            cok, cm, cdd, cff, ccc = obj_filt(co_uv)
            cok &= co_v
            for sem_new in [int(x) for x in np.unique(cm[cok]) if x != 0]:
                if sem_new in live_sems:
                    continue
                pick = np.nonzero(cok & (cm == sem_new))[0][: self.P_OBJ]
                nn = min(len(pick), self.NO - cursor)
                pick = pick[:nn]
                no_uv[cursor:cursor + nn] = co_uv[pick]
                no_d[cursor:cursor + nn] = cdd[pick]
                no_f[cursor:cursor + nn] = cff[pick]
                no_c[cursor:cursor + nn] = ccc[pick]
                no_sem[cursor:cursor + nn] = cm[pick]
                no_label[cursor:cursor + nn] = -2
                cursor += nn
        obj_valid = np.arange(self.NO) < cursor

        # ---- object lines: keep + top-up per object ----
        nol_uv = np.zeros((self.NLO, 4), np.float32)
        nol_d = np.zeros((self.NLO, 2), np.float32)
        nol_f = np.zeros((self.NLO, 4), np.float32)
        nol_c = np.zeros((self.NLO, 4), np.float32)
        nol_sem = np.zeros(self.NLO, np.int32)
        nol_label = np.full(self.NLO, -2, np.int32)
        nol_asso = np.full(self.NLO, -1, np.int32)
        lcursor = 0
        col_uv, col_d, col_f, col_c, col_s, col_v = [
            np.asarray(a) for a in oline_tmp
        ]
        oline_label_arr = self._oline_label
        def _obj_line_dup(cand_uv4, kept_uv4):
            """Reference object-line dedup gate (Tracking.cc:4584-4602):
            angle difference < 1 rad AND midpoint distance < 1 px."""
            if not len(kept_uv4):
                return np.zeros(len(cand_uv4), bool)
            a1 = np.arctan2(cand_uv4[:, 3] - cand_uv4[:, 1],
                            cand_uv4[:, 2] - cand_uv4[:, 0])
            a2 = np.arctan2(kept_uv4[:, 3] - kept_uv4[:, 1],
                            kept_uv4[:, 2] - kept_uv4[:, 0])
            ad = np.abs(a1[:, None] - a2[None, :])
            ad = np.where(ad > np.pi, 2 * np.pi - ad, ad)
            m1 = 0.5 * (cand_uv4[:, :2] + cand_uv4[:, 2:])
            m2 = 0.5 * (kept_uv4[:, :2] + kept_uv4[:, 2:])
            md = np.linalg.norm(m1[:, None] - m2[None], axis=2)
            return ((ad < 1.0) & (md < 1.0)).any(axis=1)

        col_ok_all, _, _, _ = (
            filt_line(col_uv) if col_v.any()
            else (np.zeros(len(col_uv), bool), None, None, None)
        )
        for lab in tracked_labels:
            lidx = np.nonzero(
                (oline_label_arr == lab) & oline_ok & ol_valid
            )[0][: self.L_OBJ]
            n = min(len(lidx), self.NLO - lcursor)
            lidx = lidx[:n]
            kept_start = lcursor
            nol_uv[lcursor:lcursor + n] = ol_uv[lidx]
            nol_d[lcursor:lcursor + n] = ol_d[lidx]
            nol_sem[lcursor:lcursor + n] = ol_sem[lidx]
            nol_label[lcursor:lcursor + n] = lab
            nol_asso[lcursor:lcursor + n] = lidx
            lcursor += n
            # top-up to the per-object cap from this frame's detections on
            # the SAME semantic label, under this object's tracking label
            # (Tracking.cc:4562-4608, max_num_obj_line = 100/object)
            sem_now = label_sem.get(lab, 0)
            if n < self.L_OBJ and sem_now != 0 and col_v.any():
                cok = col_v & col_ok_all & (col_s == sem_now)
                cok &= ~_obj_line_dup(col_uv, nol_uv[kept_start:lcursor])
                pick = np.nonzero(cok)[0][: self.L_OBJ - n]
                nn = min(len(pick), self.NLO - lcursor)
                pick = pick[:nn]
                nol_uv[lcursor:lcursor + nn] = col_uv[pick]
                nol_d[lcursor:lcursor + nn] = col_d[pick]
                nol_f[lcursor:lcursor + nn] = col_f[pick]
                nol_c[lcursor:lcursor + nn] = col_c[pick]
                nol_sem[lcursor:lcursor + nn] = col_s[pick]
                nol_label[lcursor:lcursor + nn] = lab
                lcursor += nn
        # lines of NEW semantic labels enter with label -2 alongside the
        # new-object points (Tracking.cc:4668-4684)
        if col_v.any() and lcursor < self.NLO:
            for sem_new in [int(x) for x in np.unique(col_s[col_v])
                            if x != 0]:
                if sem_new in live_sems:
                    continue
                pick = np.nonzero(col_v & (col_s == sem_new))[0]
                nn = min(len(pick), self.NLO - lcursor)
                pick = pick[:nn]
                nol_uv[lcursor:lcursor + nn] = col_uv[pick]
                nol_d[lcursor:lcursor + nn] = col_d[pick]
                nol_f[lcursor:lcursor + nn] = col_f[pick]
                nol_c[lcursor:lcursor + nn] = col_c[pick]
                nol_sem[lcursor:lcursor + nn] = col_s[pick]
                nol_label[lcursor:lcursor + nn] = -2
                lcursor += nn
        oline_valid = np.arange(self.NLO) < lcursor
        # recompute flows/corres for kept object lines at their new positions
        lok, _, _, _ = filt_line(nol_uv)
        lf_s = flow_np[
            np.clip(nol_uv[:, 1].astype(np.int32), 0, h - 1),
            np.clip(nol_uv[:, 0].astype(np.int32), 0, w - 1),
        ]
        lf_e = flow_np[
            np.clip(nol_uv[:, 3].astype(np.int32), 0, h - 1),
            np.clip(nol_uv[:, 2].astype(np.int32), 0, w - 1),
        ]
        nol_f = np.concatenate([lf_s, lf_e], axis=1).astype(np.float32)
        nol_c = nol_uv + nol_f

        # world-3D recompute happens in _push_map (nothing on the joint
        # tracking path reads it)
        return dict(
            pose=pose_np, pose_gt=pose_gt,
            stat_uv=new_uv, stat_depth=new_d, stat_flow=new_f,
            stat_corres=new_c, stat_valid=stat_valid,
            stat_asso=new_asso,
            line_uv=new_l, line_depth=new_ld, line_flow=new_lf,
            line_corres=new_lc, line_valid=line_valid,
            line_asso=new_lasso,
            obj_uv=no_uv, obj_depth=no_d, obj_flow=no_f, obj_corres=no_c,
            obj_sem=no_sem, obj_valid=obj_valid,
            obj_label=no_label, obj_asso=no_asso,
            oline_uv=nol_uv, oline_depth=nol_d, oline_flow=nol_f,
            oline_corres=nol_c, oline_sem=nol_sem, oline_valid=oline_valid,
            oline_label=nol_label, oline_asso=nol_asso,
            gt_objs=gt_objs,
        )

    @staticmethod
    @functools.lru_cache(maxsize=8)
    def _strided_order_cached(n: int, step: int):
        order = []
        for start in range(step):
            order.extend(range(start, n, step))
        return np.asarray(order, np.int64)

    def _strided_order(self, n, step):
        return self._strided_order_cached(n, step)

    @staticmethod
    def _near_occupied(kept_uv, cand_uv, h, w):
        """O(N) 1px-radius dedup (replaces the reference's O(N^2) scan,
        Tracking.cc:4105-4123): occupancy bitmap of kept positions dilated
        by one pixel, candidates tested by lookup."""
        occ = np.zeros((h + 2, w + 2), bool)
        kx = np.clip(kept_uv[:, 0].astype(np.int32), 0, w - 1)
        ky = np.clip(kept_uv[:, 1].astype(np.int32), 0, h - 1)
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                occ[ky + dy, kx + dx] = True
        cx = np.clip(cand_uv[:, 0].astype(np.int32), 0, w - 1)
        cy = np.clip(cand_uv[:, 1].astype(np.int32), 0, h - 1)
        return occ[cy + 1, cx + 1]

    @staticmethod
    def _line_dup(cand_uv4, kept_uv4):
        """Reference line dedup (Tracking.cc:4174-4203 / Frame.cc:1582):
        near-parallel (angle < pi/30) and midpoint distance < max(len)/2."""
        c_dir = cand_uv4[:, 2:] - cand_uv4[:, :2]
        k_dir = kept_uv4[:, 2:] - kept_uv4[:, :2]
        c_mid = 0.5 * (cand_uv4[:, 2:] + cand_uv4[:, :2])
        k_mid = 0.5 * (kept_uv4[:, 2:] + kept_uv4[:, :2])
        c_len = np.linalg.norm(c_dir, axis=1) + 1e-9
        k_len = np.linalg.norm(k_dir, axis=1) + 1e-9
        cosang = (
            c_dir @ k_dir.T / (c_len[:, None] * k_len[None, :])
        )
        # |a-b|^2 = |a|^2 + |b|^2 - 2 a.b  (no (C,K,2) intermediate)
        middist2 = (
            np.sum(c_mid * c_mid, 1)[:, None]
            + np.sum(k_mid * k_mid, 1)[None, :]
            - 2.0 * (c_mid @ k_mid.T)
        )
        r = 0.5 * np.maximum(c_len[:, None], k_len[None, :])
        dup = (cosang > np.cos(np.pi / 30)) & (middist2 < r * r)
        return dup.any(axis=1)

    # ------------------------------------------------------------------
    def _push_map(self, st, pose_np, pose_gt, prev_pose_gt, velocity,
                  obj_meta, timing):
        """Map appends (Tracking.cc:1578-1786); only the map mutates."""
        m = self.map
        if "stat_3d" not in st:
            st["stat_3d"] = _np_world_points(
                self.K, pose_np, st["stat_uv"], st["stat_depth"]
            )
            st["line_3d"] = _np_world_lines(
                self.K, pose_np, st["line_uv"], st["line_depth"]
            )
            st["obj_3d"] = _np_world_points(
                self.K, pose_np, st["obj_uv"], st["obj_depth"]
            )
            st["oline_3d"] = _np_world_lines(
                self.K, pose_np, st["oline_uv"], st["oline_depth"]
            )
        m.stat_uv.append(st["stat_uv"]); m.stat_depth.append(st["stat_depth"])
        m.stat_3d.append(st["stat_3d"]); m.stat_valid.append(st["stat_valid"])
        m.stat_asso.append(st["stat_asso"])
        m.line_uv.append(st["line_uv"]); m.line_depth.append(st["line_depth"])
        m.line_3d.append(st["line_3d"]); m.line_valid.append(st["line_valid"])
        m.line_asso.append(st["line_asso"])
        m.line_plucker.append(_np_plucker(st["line_3d"][:, :3], st["line_3d"][:, 3:]))
        m.dyn_uv.append(st["obj_uv"]); m.dyn_depth.append(st["obj_depth"])
        m.dyn_3d.append(st["obj_3d"]); m.dyn_valid.append(st["obj_valid"])
        m.dyn_asso.append(st["obj_asso"]); m.dyn_label.append(st["obj_label"])
        m.dline_uv.append(st["oline_uv"]); m.dline_depth.append(st["oline_depth"])
        m.dline_3d.append(st["oline_3d"]); m.dline_valid.append(st["oline_valid"])
        m.dline_asso.append(st["oline_asso"]); m.dline_label.append(st["oline_label"])
        m.dline_plucker.append(_np_plucker(st["oline_3d"][:, :3], st["oline_3d"][:, 3:]))

        m.camera_poses.append(np.linalg.inv(pose_np).astype(np.float32))
        m.camera_poses_rf.append(np.linalg.inv(pose_np).astype(np.float32))
        m.camera_poses_gt.append(np.linalg.inv(pose_gt).astype(np.float32))

        cam_motion = np.linalg.inv(velocity).astype(np.float32)
        motions = [cam_motion]
        pose_pres = [cam_motion]
        labels = [0]
        sems = [0]
        stats = [True]
        centres = [np.zeros(3, np.float32)]
        motions_gt = [
            (prev_pose_gt @ np.linalg.inv(pose_gt)).astype(np.float32)
        ]
        speeds = [1.0]
        for om in obj_meta:
            if not om["stat"]:
                continue
            motions.append(om["H"])
            pose_pres.append(om["pose_pre"])
            labels.append(om["label"])
            sems.append(om["sem"])
            stats.append(True)
            centres.append(om["centre"])
            motions_gt.append(om["H_gt_body"])
            speeds.append(om["speed_gt"])
        m.rigid_motions.append(motions)
        m.rigid_motions_rf.append([x.copy() for x in motions])
        m.rigid_motions_gt.append(motions_gt)
        m.obj_pose_pre.append(pose_pres)
        m.rigid_centres.append(centres)
        m.rm_labels.append(labels)
        m.sm_labels.append(sems)
        m.obj_stat.append(stats)
        m.speeds_gt.append(speeds)
        m.frame_times.append(timing.copy())
