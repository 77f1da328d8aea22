"""The benchmark's scene generator: the street of the program's synthetic
sequences (a ground plane, a back wall, two side walls and moving boxes),
rendered with exact ground truth, in NumPy alone.

A frozen copy of ``sdpl_slam_torch.utils.synthetic``'s renderer, kept here
so that a later change to the program cannot move the yardstick.  Two
departures: the poses are made in float64 NumPy (the program's generator
takes its poses through its own float32 Lie ops), and the flow noise is no
part of the render.  The noise-free frames of a configuration are rendered
once per checkout and kept in a fixed directory; the seed draws only the
flow noise (:class:`FlowNoise`).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

# bump when the render changes: the cache key holds it
RENDER_VERSION = 1

GEOMETRY_KEYS = ("width", "height", "fx", "fy", "cx", "cy", "n_objects",
                 "cam_speed", "obj_speed")


def _hat(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def se3_exp(xi) -> np.ndarray:
    """SE(3) exponential of ``xi = [omega, v]`` (Rodrigues, and t = V v)."""
    w, v = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th = float(np.linalg.norm(w))
    W = _hat(w)
    if th < 1e-5:
        A, B, C = 1.0 - th * th / 6.0, 0.5 - th * th / 24.0, 1.0 / 6.0
    else:
        A = np.sin(th) / th
        B = (1.0 - np.cos(th)) / (th * th)
        C = (1.0 - A) / (th * th)
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + A * W + B * (W @ W)
    T[:3, 3] = (np.eye(3) + B * W + C * (W @ W)) @ v
    return T


def cam_pose(g: dict, t: int) -> np.ndarray:
    """T_wc at frame t: forward motion with a gentle yaw (float32 values)."""
    yaw = 0.012 * t
    xi = [0.0, yaw, 0.0, 0.25 * t * g["cam_speed"], 0.0, g["cam_speed"] * t]
    return se3_exp(np.asarray(xi, np.float32)).astype(np.float32)


def obj_pose(g: dict, k: int, t: int) -> np.ndarray:
    """Object k's box centre in the world at frame t (float32 values)."""
    base = np.eye(4, dtype=np.float32)
    base[:3, 3] = np.array(
        [(-2.5 if k % 2 == 0 else 3.0) + 0.2 * k, 0.6, 9.0 + 3.0 * k],
        np.float32)
    drift = np.eye(4, dtype=np.float32)
    drift[:3, 3] = np.array([0.05 * t * (1 if k % 2 else -1), 0.0,
                             g["obj_speed"] * t], np.float32)
    return drift @ base


def _draw_strokes(gray, lines, value=20):
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


def _structure_lines(g, T_cw):
    """The fixed static 3-D segments on the wall and the ground, projected
    and snapped to whole pixels: the dark strokes of the grey image."""
    rng = np.random.default_rng(123)
    segs = []
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
        segs.append((np.array([x, 1.6, z]),
                     np.array([x + rng.uniform(2.0, 6.0), 1.6, z])))
    out = []
    for a, b in segs:
        pa = T_cw[:3, :3] @ a + T_cw[:3, 3]
        pb = T_cw[:3, :3] @ b + T_cw[:3, 3]
        if pa[2] < 2.0 or pb[2] < 2.0:
            continue
        ua = g["fx"] * pa[0] / pa[2] + g["cx"]
        va = g["fy"] * pa[1] / pa[2] + g["cy"]
        ub = g["fx"] * pb[0] / pb[2] + g["cx"]
        vb = g["fy"] * pb[1] / pb[2] + g["cy"]
        m = 6
        if (m < ua < g["width"] - m and m < va < g["height"] - m
                and m < ub < g["width"] - m and m < vb < g["height"] - m):
            out.append([round(ua), round(va), round(ub), round(vb)])
    return np.asarray(out, np.float32).reshape(-1, 4)


def render(g: dict, t: int) -> dict:
    """Frame t without noise: grey (uint8), metric depth (float32), flow to
    frame t + 1 (float32, H x W x 2), instance mask (uint8, object k is
    k + 1), T_wc, and the objects' ground-truth rows
    ``[t, k + 1, x, y, z, 0, 0, 0, 1]`` (world position, OMD style)."""
    H, W = g["height"], g["width"]
    us, vs = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    T_wc = cam_pose(g, t).astype(np.float64)
    T_cw = np.linalg.inv(T_wc)
    T_cw_next = np.linalg.inv(cam_pose(g, t + 1).astype(np.float64))
    rx = (us - g["cx"]) / g["fx"]
    ry = (vs - g["cy"]) / g["fy"]
    R, o = T_wc[:3, :3], T_wc[:3, 3]
    d = np.stack([rx, ry, np.ones_like(rx)], -1) @ R.T

    def hit(num, den):
        with np.errstate(divide="ignore", invalid="ignore"):
            s = num / den
        return np.where(s > 0.1, s, np.inf)

    t_hit = np.minimum.reduce([
        hit(1.6 - o[1], d[..., 1]), hit(60.0 - o[2], d[..., 2]),
        hit(-14.0 - o[0], d[..., 0]), hit(14.0 - o[0], d[..., 0])])
    X_w = o + d * t_hit[..., None]
    depth = ((X_w - o) @ R)[..., 2]
    mask = np.zeros((H, W), np.int32)

    def project(T, Xw):
        Xc = Xw @ T[:3, :3].T + T[:3, 3]
        z = np.maximum(Xc[..., 2], 1e-6)
        return np.stack([g["fx"] * Xc[..., 0] / z + g["cx"],
                         g["fy"] * Xc[..., 1] / z + g["cy"]], -1)

    grid = np.stack([us, vs], -1)
    flow = project(T_cw_next, X_w) - grid
    rows = []
    for k in range(g["n_objects"]):
        L_w = obj_pose(g, k, t).astype(np.float64)
        L_next = obj_pose(g, k, t + 1).astype(np.float64)
        centre_c = T_cw[:3, :3] @ L_w[:3, 3] + T_cw[:3, 3]
        if centre_c[2] < 2.0:
            continue
        half = np.array([1.0, 0.8, 0.8])
        c_w = L_w[:3, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            s_face = (c_w[2] - half[2] - o[2]) / d[..., 2]
        X_face = o + d * s_face[..., None]
        sel = ((s_face > 0.5)
               & (np.abs(X_face[..., 0] - c_w[0]) <= half[0])
               & (np.abs(X_face[..., 1] - c_w[1]) <= half[1])
               & (s_face < t_hit))
        if sel.sum() < 20:
            continue
        depth = np.where(sel, s_face, depth)
        mask = np.where(sel, k + 1, mask)
        H_w = L_next @ np.linalg.inv(L_w)
        moved = X_face @ H_w[:3, :3].T + H_w[:3, 3]
        flow = np.where(sel[..., None], project(T_cw_next, moved) - grid,
                        flow)
        rows.append(np.array([t, k + 1, *L_w[:3, 3], 0.0, 0.0, 0.0, 1.0],
                             np.float32))
    depth = np.clip(np.where(np.isfinite(depth), depth, 0.0).astype(
        np.float32), 0.0, 80.0)
    gray = ((np.sin(us * 0.03) + np.cos(vs * 0.029)) * 25 + 128).astype(
        np.uint8)
    dot_rng = np.random.default_rng(17)
    n_dots = (H * W) // 300
    dy = dot_rng.integers(1, H - 2, n_dots)
    dx = dot_rng.integers(1, W - 2, n_dots)
    val = dot_rng.choice([30, 220], n_dots).astype(np.uint8)
    for ddy in (0, 1):
        for ddx in (0, 1):
            gray[np.clip(dy + ddy, 0, H - 1), np.clip(dx + ddx, 0, W - 1)] = val
    _draw_strokes(gray, _structure_lines(g, T_cw))
    return dict(gray=gray, depth=depth, flow=flow.astype(np.float32),
                mask=mask.astype(np.uint8), pose=T_wc.astype(np.float32),
                rows=np.stack(rows) if rows else np.zeros((0, 9), np.float32))


def cache_key(g: dict, n_frames: int) -> str:
    blob = json.dumps(dict({k: g[k] for k in GEOMETRY_KEYS},
                           n_frames=n_frames, version=RENDER_VERSION),
                      sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


class Sequence:
    """The noise-free frames 0..n-1 of a configuration's scene, from the
    cache directory when they are there, else rendered and written there
    (one uncompressed ``.npz``, replaced atomically)."""

    def __init__(self, g: dict, n_frames: int, cache_dir):
        self.g, self.n = dict(g), int(n_frames)
        path = os.path.join(cache_dir, "frames-%s.npz" % cache_key(g, n_frames))
        if os.path.exists(path):
            with np.load(path) as z:
                arrs = {k: z[k] for k in z.files}
        else:
            frames = [render(self.g, t) for t in range(self.n)]
            arrs = {k: np.stack([f[k] for f in frames])
                    for k in ("gray", "depth", "flow", "mask", "pose")}
            for t, f in enumerate(frames):
                arrs["rows%d" % t] = f["rows"]
            os.makedirs(cache_dir, exist_ok=True)
            tmp = "%s.%d.tmp.npz" % (path[:-4], os.getpid())
            np.savez(tmp, **arrs)
            os.replace(tmp, path)
        self.gray, self.depth = arrs["gray"], arrs["depth"]
        self.flow, self.pose = arrs["flow"], arrs["pose"]
        self.mask = arrs["mask"].astype(np.int32)
        self.rows = [list(arrs["rows%d" % t]) for t in range(self.n)]

    def object_pixels(self, t: int, k: int) -> int:
        """Pixels of object k in frame t's mask."""
        return int(np.count_nonzero(self.mask[t] == k + 1))


class FlowNoise:
    """Gaussian flow noise of std ``sigma`` px, drawn from the seed: one
    bank of normals made on ``device`` by a seeded ``torch.Generator`` in a
    single call, and per (sequence, frame) an offset into it drawn by
    NumPy from (seed, sequence, frame).  A frame's field is then a window
    of the bank: independent from pixel to pixel, the same for the same
    seed, and added into one of a ring of preallocated buffers, so no
    frame pays a draw or an allocation."""

    RING = 8    # the program keeps a frame's flow for at most 4 frames

    def __init__(self, seed: int, shape, sigma: float, device):
        import torch

        self.seed = int(seed) % (1 << 63)
        self.shape = tuple(shape)
        self.n = int(np.prod(self.shape))
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        bank = torch.randn(4 * self.n, generator=gen, device=device)
        self.bank = (bank * float(sigma)).cpu().numpy()
        self.ring = [np.zeros(self.shape, np.float32) for _ in range(self.RING)]
        self.used = 0

    def offset(self, seq: int, t: int) -> int:
        rng = np.random.default_rng([self.seed, seq + 1, t])
        return int(rng.integers(0, len(self.bank) - self.n + 1))

    def field(self, seq: int, t: int) -> np.ndarray:
        o = self.offset(seq, t)
        return self.bank[o:o + self.n].reshape(self.shape)

    def noisy(self, clean: np.ndarray, seq: int, t: int) -> np.ndarray:
        out = self.ring[self.used % self.RING]
        self.used += 1
        np.add(clean, self.field(seq, t), out=out)
        return out
