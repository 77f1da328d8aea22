"""Synthetic dynamic RGB-D sequence generator with EXACT ground truth.

The numpy generator of the JAX package's tests (``tests/synthetic.py``),
carried into the package so a machine without JAX can make frames; the
parity test holds the two to the same arrays (the grey image's strokes,
drawn here in numpy and there with OpenCV, by overlap).  Large sequences are cached
under ``build/synth_cache`` beside the package.

Real KITTI/OMD data is not available in this environment (SURVEY.md section
4: the reference has no tests; its GT-evaluation machinery is the oracle).
This generator renders dense depth / optical-flow / instance-mask maps for a
scene with a static background (ground plane + walls) and moving boxes, plus
optional line detections -- everything the pipeline consumes, with exact
camera/object motions to evaluate ATE/RPE against.

Conventions match the reference dataset: poses handed to the system are
T_wc (camera-to-world, example/sdpl_slam.cc pose_gt format); object GT rows
are the 10-float KITTI format [frame, track_id, B(4), t(3), yaw] with t in
CAMERA coordinates (Tracking.cc:3134 ObjPoseParsingKT).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

import torch

from ..ops import lie


@dataclasses.dataclass
class SynthConfig:
    width: int = 640
    height: int = 192
    fx: float = 360.0
    fy: float = 360.0
    cx: float = 320.0
    cy: float = 96.0
    n_frames: int = 8
    n_objects: int = 1
    seed: int = 0
    cam_speed: float = 0.6        # m/frame forward
    obj_speed: float = 0.9        # m/frame
    noise_flow: float = 0.0       # px std on flow maps
    noise_depth: float = 0.0      # relative depth noise
    # --- stress knobs (VERDICT r4 item 8: the reference's ugly paths) ---
    obj_birth: tuple = ()         # (k, first_frame): object absent before
    obj_death: tuple = ()         # (k, last_frame): object absent after
    occl_frames: tuple = ()       # (k, frame): segmenter dropout -- the
    #   mask loses object k at that frame while depth/flow keep it (the
    #   UpdateMask recovery scenario, Tracking.cc:4763-4810)
    depth_hole_frames: tuple = () # frames with a rectangular depth hole
    #   (sensor dropout; features there must be dropped, not NaN)


def _cam_pose(cfg: SynthConfig, t: int) -> np.ndarray:
    """T_wc at frame t: forward motion with gentle yaw."""
    yaw = 0.012 * t
    xi = np.array([0.0, yaw, 0.0, 0.25 * t * cfg.cam_speed, 0.0,
                   cfg.cam_speed * t], np.float32)
    return lie.se3_exp(torch.from_numpy(xi)).numpy().astype(np.float32)


def _obj_pose(cfg: SynthConfig, k: int, t: int) -> np.ndarray:
    """Object k pose in WORLD at frame t (box centre), moving forward."""
    base = np.eye(4, dtype=np.float32)
    base[:3, 3] = np.array(
        [(-2.5 if k % 2 == 0 else 3.0) + 0.2 * k, 0.6, 9.0 + 3.0 * k],
        np.float32,
    )
    drift = np.eye(4, dtype=np.float32)
    drift[:3, 3] = np.array([0.05 * t * (1 if k % 2 else -1), 0.0,
                             cfg.obj_speed * t], np.float32)
    return drift @ base


def draw_strokes(gray: np.ndarray, lines, value: int = 20) -> None:
    """Rasterise each segment (sx, sy, ex, ey) into ``gray`` in place as a
    2-px-wide stroke of ``value``: one sample per pixel of the longer axis
    (endpoints truncated to integers), each stamped on the 2x2 block
    whose top-left corner it is.  Pure numpy, so every machine draws the
    same images (close to ``cv2.line(..., thickness=2)``, not equal to it
    pixel for pixel)."""
    H, W = gray.shape
    for sx, sy, ex, ey in np.asarray(lines).reshape(-1, 4):
        x0, y0, x1, y1 = int(sx), int(sy), int(ex), int(ey)
        n = max(abs(x1 - x0), abs(y1 - y0)) + 1
        xs = np.rint(np.linspace(x0, x1, n)).astype(np.int64)
        ys = np.rint(np.linspace(y0, y1, n)).astype(np.int64)
        for dy in (-1, 0):
            for dx in (-1, 0):
                gray[np.clip(ys + dy, 0, H - 1),
                     np.clip(xs + dx, 0, W - 1)] = value


@dataclasses.dataclass
class SynthFrame:
    gray: np.ndarray
    depth: np.ndarray           # float32 metric depth (DepthMapFactor=1,OMD)
    flow: np.ndarray            # (H, W, 2) to next frame
    mask: np.ndarray            # (H, W) int32 instance labels
    gt_pose: np.ndarray         # T_wc
    obj_rows: List[np.ndarray]  # 10-float KITTI rows
    lines: Optional[np.ndarray] = None   # (L, 4) injected line detections


class SynthSequence:
    def __init__(self, cfg: SynthConfig = SynthConfig(),
                 cache: bool = None):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        # disk cache for LARGE sequences: the f64 ray-traced render costs
        # seconds per KITTI-res frame -- bench.py's 54-frame sequence is
        # minutes of setup that has nothing to do with what is measured.
        # Keyed by the full config; stored uncompressed under
        # build/synth_cache (gitignored).
        if cache is None:
            cache = cfg.n_frames * cfg.width * cfg.height > 6e6
        path = None
        if cache:
            import dataclasses as _dc
            import hashlib
            import os
            key = hashlib.sha1(
                repr(sorted(_dc.asdict(cfg).items())).encode()
            ).hexdigest()[:16]
            d = os.path.join(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
                "build", "synth_cache")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, key + ".npz")
            if os.path.exists(path):
                self._frames = self._load(path)
                return
        self._frames = [self._render(t) for t in range(cfg.n_frames)]
        if path is not None:
            self._save(path)

    def _save(self, path):
        import os
        arrs = {}
        for t, f in enumerate(self._frames):
            arrs[f"g{t}"] = f.gray
            arrs[f"d{t}"] = f.depth
            arrs[f"f{t}"] = f.flow
            arrs[f"m{t}"] = f.mask
            arrs[f"p{t}"] = f.gt_pose
            arrs[f"o{t}"] = (
                np.stack(f.obj_rows) if f.obj_rows
                else np.zeros((0, 10), np.float32)
            )
            arrs[f"l{t}"] = (
                f.lines if f.lines is not None
                else np.zeros((0, 4), np.float32)
            )
        tmp = path + ".tmp.npz"
        np.savez(tmp, **arrs)
        os.replace(tmp, path)

    def _load(self, path):
        z = np.load(path)
        frames = []
        for t in range(self.cfg.n_frames):
            rows = z[f"o{t}"]
            lines = z[f"l{t}"]
            frames.append(SynthFrame(
                gray=z[f"g{t}"], depth=z[f"d{t}"], flow=z[f"f{t}"],
                mask=z[f"m{t}"], gt_pose=z[f"p{t}"],
                obj_rows=[r for r in rows],
                lines=lines if len(lines) else None,
            ))
        return frames

    @property
    def n_frames(self):
        return self.cfg.n_frames

    def frame(self, t: int) -> SynthFrame:
        return self._frames[t]

    # ------------------------------------------------------------------
    def _backproject_grid(self, cfg):
        grid = getattr(self, "_grid", None)
        if grid is None:
            us, vs = np.meshgrid(np.arange(cfg.width),
                                 np.arange(cfg.height))
            grid = self._grid = (us.astype(np.float64),
                                 vs.astype(np.float64))
        return grid

    def _render(self, t: int) -> SynthFrame:
        cfg = self.cfg
        H, W = cfg.height, cfg.width
        us, vs = self._backproject_grid(cfg)
        T_wc = _cam_pose(cfg, t).astype(np.float64)
        T_cw = np.linalg.inv(T_wc)
        T_wc_next = _cam_pose(cfg, t + 1).astype(np.float64)
        T_cw_next = np.linalg.inv(T_wc_next)

        # --- background geometry in WORLD: ground plane y=1.6 and a wall
        # z_w = 60, plus side walls x_w = +-14 ---
        # ray in camera frame
        rx = (us - cfg.cx) / cfg.fx
        ry = (vs - cfg.cy) / cfg.fy
        rz = np.ones_like(rx)
        R = T_wc[:3, :3]
        o = T_wc[:3, 3]
        d = np.stack([rx, ry, rz], -1) @ R.T    # ray dirs in world
        # intersect ground plane y=1.6 (camera at y=0 looking forward)
        with np.errstate(divide="ignore", invalid="ignore"):
            t_ground = (1.6 - o[1]) / d[..., 1]
        t_ground = np.where((t_ground > 0.1), t_ground, np.inf)
        with np.errstate(divide="ignore", invalid="ignore"):
            t_wall = (60.0 - o[2]) / d[..., 2]
        t_wall = np.where(t_wall > 0.1, t_wall, np.inf)
        with np.errstate(divide="ignore", invalid="ignore"):
            t_left = (-14.0 - o[0]) / d[..., 0]
            t_right = (14.0 - o[0]) / d[..., 0]
        t_left = np.where(t_left > 0.1, t_left, np.inf)
        t_right = np.where(t_right > 0.1, t_right, np.inf)
        t_hit = np.minimum.reduce([t_ground, t_wall, t_left, t_right])
        X_w = o + d * t_hit[..., None]          # world hit points
        Xc = (X_w - o) @ R                      # back to camera frame
        depth = Xc[..., 2]
        mask = np.zeros((H, W), np.int32)

        # flow for background: project X_w into next camera
        def project(T_cw_, Xw_):
            Xc_ = Xw_ @ T_cw_[:3, :3].T + T_cw_[:3, 3]
            z = np.maximum(Xc_[..., 2], 1e-6)
            u = cfg.fx * Xc_[..., 0] / z + cfg.cx
            v = cfg.fy * Xc_[..., 1] / z + cfg.cy
            return np.stack([u, v], -1)

        uv_next = project(T_cw_next, X_w)
        flow = uv_next - np.stack([us, vs], -1)

        # --- objects: world-space box front faces (exact ray-plane hits, so
        # depth/flow/mask stay rigid-consistent under camera rotation) ---
        obj_rows = []
        birth = dict(cfg.obj_birth)
        death = dict(cfg.obj_death)
        for k in range(cfg.n_objects):
            if t < birth.get(k, 0) or t > death.get(k, 10 ** 9):
                continue
            L_w = _obj_pose(cfg, k, t).astype(np.float64)
            L_w_next = _obj_pose(cfg, k, t + 1).astype(np.float64)
            centre_c = T_cw[:3, :3] @ L_w[:3, 3] + T_cw[:3, 3]
            if centre_c[2] < 2.0:
                continue
            half = np.array([1.0, 0.8, 0.8])
            c_w = L_w[:3, 3]
            zf_w = c_w[2] - half[2]          # face plane z_w = const
            with np.errstate(divide="ignore", invalid="ignore"):
                s_face = (zf_w - o[2]) / d[..., 2]
            X_face = o + d * s_face[..., None]
            sel = (
                (s_face > 0.5)
                & (np.abs(X_face[..., 0] - c_w[0]) <= half[0])
                & (np.abs(X_face[..., 1] - c_w[1]) <= half[1])
                & (s_face < t_hit)           # in front of the background
            )
            if sel.sum() < 20:
                continue
            # camera-frame depth of the hit: rays have unit z in cam frame
            depth = np.where(sel, s_face, depth)
            mask = np.where(sel, k + 1, mask)
            # the face point moves rigidly with the object
            H_w = L_w_next @ np.linalg.inv(L_w)   # world-frame object motion
            X_w_moved = X_face @ H_w[:3, :3].T + H_w[:3, 3]
            uv_obj_next = project(T_cw_next, X_w_moved)
            flow = np.where(
                sel[..., None], uv_obj_next - np.stack([us, vs], -1), flow
            )
            # GT row in OMD format (ObjPoseParsingOX consumes WORLD poses):
            # [frame, id, t_world(3), quat xyzw(4)] -- our boxes don't rotate
            obj_rows.append(np.array(
                [t, k + 1, L_w[0, 3], L_w[1, 3], L_w[2, 3],
                 0.0, 0.0, 0.0, 1.0], np.float32,
            ))

        # segmenter dropout: mask loses the object this frame; depth/flow
        # keep it (tests UpdateMask recovery, Tracking.cc:4763-4810)
        for (k, fr) in cfg.occl_frames:
            if fr == t:
                mask = np.where(mask == k + 1, 0, mask)
        # sensor depth hole: a dead rectangle (zeros, the invalid-depth
        # convention) in the lower-middle of the image
        if t in cfg.depth_hole_frames:
            hy0, hy1 = int(H * 0.55), int(H * 0.8)
            hx0, hx1 = int(W * 0.3), int(W * 0.55)
            depth[hy0:hy1, hx0:hx1] = 0.0

        if cfg.noise_flow > 0:
            flow = flow + self.rng.normal(0, cfg.noise_flow, flow.shape)
        if cfg.noise_depth > 0:
            depth = depth * (
                1.0 + self.rng.normal(0, cfg.noise_depth, depth.shape)
            )

        depth = np.where(np.isfinite(depth), depth, 0.0).astype(np.float32)
        depth = np.clip(depth, 0.0, 80.0)

        # injected line detections: static structure lines on the wall/
        # ground (exact 3D lines projected into this frame)
        lines = self._line_detections(T_cw)

        # gray image: low-frequency base (gentle gradients, below the line
        # detector's threshold) + sparse high-contrast dots (FAST corners)
        # + the scene's structure lines as dark strokes so the in-pipeline
        # detectors find the same structure the injected detections describe
        gray = (
            (np.sin(us * 0.03) + np.cos(vs * 0.029)) * 25 + 128
        ).astype(np.uint8)
        dot_rng = np.random.default_rng(17)
        n_dots = (H * W) // 300
        dy = dot_rng.integers(1, H - 2, n_dots)
        dx = dot_rng.integers(1, W - 2, n_dots)
        val = dot_rng.choice([30, 220], n_dots).astype(np.uint8)
        for ddy in (0, 1):
            for ddx in (0, 1):
                gray[np.clip(dy + ddy, 0, H - 1),
                     np.clip(dx + ddx, 0, W - 1)] = val
        draw_strokes(gray, lines)

        return SynthFrame(
            gray=gray,
            depth=depth,
            flow=flow.astype(np.float32),
            mask=mask,
            gt_pose=T_wc.astype(np.float32),
            obj_rows=obj_rows,
            lines=lines,
        )

    def _line_detections(self, T_cw) -> np.ndarray:
        """Project a fixed set of static world 3D segments (building edges)
        into the frame -> (L, 4) detections, standing in for LSD."""
        cfg = self.cfg
        rng = np.random.default_rng(123)
        segs = []
        # lines ON the rendered surfaces so unprojection at map depth is
        # consistent: vertical/horizontal segments on the back wall (z=60)
        # and across-x segments on the ground plane (y=1.6, constant z)
        for i in range(30):
            x = rng.uniform(-12, 12)
            y0 = rng.uniform(-4.0, 1.2)
            if i % 2 == 0:
                a = np.array([x, y0, 59.9])
                b = np.array([x, y0 + rng.uniform(1.0, 3.0), 59.9])
            else:
                a = np.array([x, y0, 59.9])
                b = a + np.array([rng.uniform(1.5, 5.0), 0.0, 0.0])
            segs.append((a, b))
        for i in range(12):
            z = rng.uniform(12, 40)
            x = rng.uniform(-10, 6)
            a = np.array([x, 1.6, z])
            b = np.array([x + rng.uniform(2.0, 6.0), 1.6, z])
            segs.append((a, b))
        out = []
        for a, b in segs:
            pa = T_cw[:3, :3] @ a + T_cw[:3, 3]
            pb = T_cw[:3, :3] @ b + T_cw[:3, 3]
            if pa[2] < 2.0 or pb[2] < 2.0:
                continue
            ua = cfg.fx * pa[0] / pa[2] + cfg.cx
            va = cfg.fy * pa[1] / pa[2] + cfg.cy
            ub = cfg.fx * pb[0] / pb[2] + cfg.cx
            vb = cfg.fy * pb[1] / pb[2] + cfg.cy
            m = 6
            if (
                m < ua < cfg.width - m and m < va < cfg.height - m
                and m < ub < cfg.width - m and m < vb < cfg.height - m
            ):
                # snap to integer pixels: the pipeline's nearest-neighbour
                # depth/flow lookups are then exact for the detection frame
                out.append([round(ua), round(va), round(ub), round(vb)])
        return np.asarray(out, np.float32).reshape(-1, 4)


def kitti_obj_rows(cfg: SynthConfig, t: int, rows) -> List[np.ndarray]:
    """The generator's object rows of frame ``t`` (``rows``, OMD-style:
    world position) as KITTI rows, ``[frame, id, B(4), t_camera(3), yaw]``
    with a zero box: ``ObjPoseParsingKT`` reads them as ``Ry(yaw + pi/2)``
    at ``t_camera`` (Tracking.cc:3134-3241), which the tracker lifts to the
    world by the GT camera pose, so the row's yaw is the object's rotation
    in the camera (the camera only yaws here, and the boxes do not rotate)
    less the reference's pi/2."""
    T_cw = np.linalg.inv(_cam_pose(cfg, t).astype(np.float64))
    out = []
    for row in rows:
        L_c = T_cw @ _obj_pose(cfg, int(row[1]) - 1, t).astype(np.float64)
        R = L_c[:3, :3]
        yaw = np.arctan2(R[0, 2], R[0, 0])
        if not np.allclose(R, [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                               [-np.sin(yaw), 0, np.cos(yaw)]], atol=1e-6):
            raise ValueError("object %d at frame %d turns about more than "
                             "the camera's y axis" % (int(row[1]), t))
        out.append(np.array([t, row[1], 0, 0, 0, 0, *L_c[:3, 3],
                             yaw - np.pi / 2], np.float32))
    return out


def synth_settings(cfg: SynthConfig) -> "Settings":
    from .config import OMD, Settings

    s = Settings()
    s.fx, s.fy, s.cx, s.cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy
    s.width, s.height = cfg.width, cfg.height
    s.bf, s.fps = 120.0, 10.0
    s.choose_data = OMD          # depth = raw/factor with factor 1 = metric
    s.depth_map_factor = 1.0
    s.th_depth_bg = 70.0
    s.th_depth_obj = 30.0
    s.max_track_point_bg = 600
    s.max_track_point_obj = 200
    s.max_static_lines = 64
    s.max_object_lines = 16
    s.max_objects = 4
    s.sf_mg_thres = 0.12
    s.sf_ds_thres = 0.3
    s.use_sample_fea = 1     # grid-sampled background features (deterministic)
    s.window_size = 5
    s.overlap_size = 2
    s.min_object_points = 50
    s.boundary_shrink_x = 0
    s.boundary_shrink_y = 0
    return s


def kitti_config(n_frames: int = 11, noise_flow: float = 0.2) -> SynthConfig:
    """The JAX bench's KITTI-scale sequence (``bench.py``): 1242x375 with
    KITTI intrinsics, 2 moving objects, 0.2 px flow noise."""
    return SynthConfig(
        n_frames=n_frames, n_objects=2, width=1242, height=375,
        fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854,
        noise_flow=noise_flow,
    )


def slice_settings(cfg: SynthConfig) -> "Settings":
    """Settings of the tracking slice this package runs: the bench's
    reference caps (1200 background points, 800 per object, 400 static
    lines, 8 objects), FAST in the loop (``use_sample_fea = 0``),
    synchronous frames, no batch BA."""
    s = synth_settings(cfg)
    s.max_track_point_bg = 1200
    s.max_track_point_obj = 800
    s.max_static_lines = 400
    s.max_objects = 8
    s.th_depth_bg = 40.0
    s.th_depth_obj = 25.0
    s.min_object_points = 150
    s.use_sample_fea = 0
    s.pipelined_tracking = False
    s.run_local_ba = False
    s.run_global_ba = False
    return s


def lba_settings(cfg: SynthConfig) -> "Settings":
    """The JAX bench's configuration (``bench.py:251-259`` without chained
    mode): :func:`slice_settings` with the window BA on at the reference
    cadence, window 20 and overlap 4."""
    s = slice_settings(cfg)
    s.run_local_ba = True
    s.window_size = 20
    s.overlap_size = 4
    return s


def synth_big_graph(F: int = 120, stat_per_frame: int = 150,
                    obs_per_stat: int = 4, dyn_per_frame: int = 150,
                    n_objects: int = 2, seed: int = 0, device="cuda"):
    """A KITTI-length global BA graph made directly, without running the
    tracker (the copy of ``tests/test_sharded_ba.py``'s ``_synth_big_graph``
    with this package's Lie ops): a forward camera trajectory with a gentle
    yaw and its odometry; static points born each frame and observed in
    the next ``obs_per_stat`` frames; ``n_objects`` motions a frame with
    their smoothness pairs; dynamic points chained across adjacent frames
    by ternary edges.  No line vertices (each line family holds one invalid
    vertex and no edge).  Measurements carry 1 cm noise and the point
    vertices start 2 cm off.  Returns (BAGraph on ``device``, the edge
    count ~F*(stat*obs + 2*dyn))."""
    from ..solvers.batch_ba import BAGraph
    from .device import checked_device

    dev = checked_device(device, "synth_big_graph")
    rng = np.random.default_rng(seed)
    f32 = np.float32

    # camera trajectory: forward motion, gentle yaw
    t = np.arange(F, dtype=np.float64)
    xi = np.stack([0 * t, 0.005 * t, 0 * t, 0.1 * t, 0 * t, 0.6 * t], 1)
    cam_T = lie.se3_exp(torch.from_numpy(xi.astype(f32))).numpy()

    # static points: born per frame, observed in the next obs_per_stat
    Ps = F * stat_per_frame
    Xs = rng.uniform([-12, -2, 4], [12, 2, 50], (Ps, 3)).astype(f32)
    born = np.repeat(np.arange(F), stat_per_frame)
    sp_cam, sp_pt = [], []
    for k in range(obs_per_stat):
        fidx = born + k
        ok = fidx < F
        sp_cam.append(fidx[ok])
        sp_pt.append(np.nonzero(ok)[0])
    sp_cam = np.concatenate(sp_cam)
    sp_pt = np.concatenate(sp_pt)
    T_cw = np.linalg.inv(cam_T)
    sp_meas = np.einsum("eij,ej->ei", T_cw[sp_cam, :3, :3], Xs[sp_pt]) \
        + T_cw[sp_cam, :3, 3]
    sp_meas = (sp_meas + rng.normal(0, 0.01, sp_meas.shape)).astype(f32)

    # objects: F * n_objects motions; dynamic points chained across
    # adjacent frames by ternary edges
    M = F * n_objects
    mot_T = np.tile(np.eye(4, dtype=f32), (M, 1, 1))
    mot_T[:, 2, 3] = 0.9
    smo_i = np.arange(M - n_objects)
    smo_j = smo_i + n_objects

    Pd = F * dyn_per_frame
    obj_of = np.repeat(
        np.tile(np.arange(n_objects), dyn_per_frame // n_objects), F)[:Pd]
    frame_of = np.repeat(np.arange(F), dyn_per_frame)
    base = rng.uniform([-3, -1, 8], [3, 1, 30],
                       (dyn_per_frame, 3)).astype(f32)
    shift = np.zeros((F, 1, 3), f32)
    shift[:, 0, 2] = 0.9 * np.arange(F)
    Xd = (base[None] + shift).reshape(Pd, 3)
    dp_cam = frame_of
    dp_pt = np.arange(Pd)
    dp_meas = np.einsum("eij,ej->ei", T_cw[dp_cam, :3, :3], Xd[dp_pt]) \
        + T_cw[dp_cam, :3, 3]
    dp_meas = (dp_meas + rng.normal(0, 0.01, dp_meas.shape)).astype(f32)
    # ternary: point at frame t-1 -> the same row at frame t via motion(t, obj)
    cur = np.nonzero(frame_of > 0)[0]
    tern_prev = cur - dyn_per_frame
    tern_mot = frame_of[cur] * n_objects + obj_of[cur % dyn_per_frame]

    # the test's graph draws a camera perturbation it multiplies by 0; the
    # draw is kept so that the point perturbations below are the same
    rng.normal(0, 1e-3, cam_T.shape)
    Xs0 = (Xs + rng.normal(0, 0.02, Xs.shape)).astype(f32)
    Xd0 = (Xd + rng.normal(0, 0.02, Xd.shape)).astype(f32)

    def ft(a, *shape):
        return torch.as_tensor(np.asarray(a, f32).reshape((-1,) + shape),
                               device=dev)

    def it(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    def ones(n):
        return torch.ones(n, dtype=torch.bool, device=dev)

    def none(n=0):
        return torch.zeros(n, dtype=torch.bool, device=dev)

    empty = it(np.zeros(0))
    eye3 = ft(np.eye(3), 3, 3)
    g = BAGraph(
        cam_T0=ft(cam_T, 4, 4), cam_valid=ones(F),
        prior_frame=0, prior_meas=ft(cam_T[0], 4, 4)[0],
        prior_info=torch.tensor(1e5, dtype=torch.float32, device=dev),
        odo_i=it(np.arange(F - 1)), odo_j=it(np.arange(1, F)),
        odo_meas=ft(np.einsum("eij,ejk->eik", T_cw[:-1], cam_T[1:]), 4, 4),
        odo_valid=ones(F - 1),
        mot_T0=ft(mot_T, 4, 4), mot_valid=ones(M),
        smo_i=it(smo_i), smo_j=it(smo_j), smo_valid=ones(len(smo_i)),
        Xs0=ft(Xs0, 3), Xs_valid=ones(Ps),
        sp_cam=it(sp_cam), sp_pt=it(sp_pt), sp_meas=ft(sp_meas, 3),
        sp_valid=ones(len(sp_cam)),
        Ls_U0=eye3, Ls_w0=ft([[1.0, 0.1]], 2), Ls_valid=none(1),
        sl_cam=empty, sl_line=empty, sl_meas=ft(np.zeros((0, 6)), 6),
        sl_valid=none(),
        Xd0=ft(Xd0, 3), Xd_valid=ones(Pd),
        dp_cam=it(dp_cam), dp_pt=it(dp_pt), dp_meas=ft(dp_meas, 3),
        dp_valid=ones(Pd),
        tern_prev=it(tern_prev), tern_cur=it(cur), tern_mot=it(tern_mot),
        tern_valid=ones(len(cur)),
        Ld_U0=eye3.clone(), Ld_w0=ft([[1.0, 0.1]], 2), Ld_valid=none(1),
        dl_cam=empty, dl_line=empty, dl_meas=ft(np.zeros((0, 6)), 6),
        dl_valid=none(),
        ltern_prev=empty, ltern_cur=empty, ltern_mot=empty,
        ltern_valid=none(),
    )
    n_edges = len(sp_cam) + len(dp_cam) + len(cur) + len(smo_i) + F - 1
    return g, n_edges
