"""ORB descriptors: intensity-centroid orientation and rotated BRIEF, and
Hamming matching as a +/-1 matmul (counterpart of the JAX package's
``ops.orb``).

* Orientation is the intensity-centroid angle over the umax-bounded
  circular patch (``IC_Angle``, ORBextractor.cc:66-95; umax setup
  :443-457), with the reference's integer column bounds.
* The 256 BRIEF point pairs are OpenCV's learned ``bit_pattern_31_``
  (:mod:`.orb_pattern`).  Bit i is ``I(rot(p1)) < I(rot(p2))`` with the
  reference's rotation convention (``computeOrbDescriptor``,
  ORBextractor.cc:97-137): col = round(x cos - y sin), row = round(x sin +
  y cos), round half to even as cvRound (``torch.round``).
* The pre-smoothing is a 7x7 Gaussian, sigma 2, reflect-101 borders
  (``F.pad(mode="reflect")``), like the reference's GaussianBlur
  (ORBextractor.cc:1105).
* Matching: Hamming distance through the +/-1 encoding,
  ham = (256 - A B^T) / 2, one float32 matmul (exact: TF32 is off, and the
  sums are integers under 2^24); mutual nearest neighbours, first index on
  ties as ``jnp.argmin``.

The IC moments are summed in float64, where every term is exact and the
sum all but exact, and the angle is rounded once to float32: the card and
the CPU give the same angle whatever order their reductions take, and it
agrees with the JAX package's float32 sums within 1e-5 rad.  Each blur tap
is a float32 multiply and a float32 add in the JAX function's order, so
the blurred image equals JAX's on the CPU.  A bit compares two blurred
samples at positions rounded from the angle, so a bit can differ from
JAX's only where two samples are near equal or a rotated sample
coordinate lies at a rounding half.
Descriptors are a dead output of the tracker, which matches by optical
flow (SURVEY.md section 2.1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .orb_pattern import BIT_PATTERN_31

PATCH = 31
HALF = PATCH // 2
N_BITS = 256
# the learned pattern's max point radius is ~18.38 (rotations reach offset
# 18), so descriptor sampling needs an extended patch
R_EXT = 18
PATCH_EXT = 2 * R_EXT + 1


def _gather_patches(img: torch.Tensor, uv: torch.Tensor,
                    radius: int = HALF) -> torch.Tensor:
    """(N, 2r+1, 2r+1) patches centred at integral uv (clamped), from the
    edge-padded image; centres at cvRound(pt) (ORBextractor.cc:70,105)."""
    h, w = img.shape
    side = 2 * radius + 1
    pad = radius + 1
    p = F.pad(img.to(torch.float32)[None, None], (pad, pad, pad, pad),
              mode="replicate")[0, 0]
    base_u = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, w - 1)
    base_v = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, h - 1)
    off = torch.arange(side, device=img.device)
    rows = (base_v + pad - radius)[:, None, None] + off[None, :, None]
    cols = (base_u + pad - radius)[:, None, None] + off[None, None, :]
    return p[rows, cols]


@functools.lru_cache()
def _umax() -> np.ndarray:
    """Integer circular-patch column bounds, as the reference builds them
    (ORBextractor.cc:443-457): rows 0..vmax from the circle equation with
    cvRound, rows vmin..HALF forced symmetric."""
    umax = np.zeros(HALF + 2, np.int64)
    vmax = int(np.floor(HALF * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF * np.sqrt(2.0) / 2))
    hp2 = float(HALF * HALF)
    for v in range(vmax + 1):
        # cvRound = round-half-to-even; sqrt values here are never .5
        umax[v] = int(np.rint(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    # for HALF=15 this is the canonical ORB table
    # [15,15,15,15,14,14,14,13,13,12,11,10,9,8,6,3]
    return umax[: HALF + 1]


@functools.lru_cache()
def _circular_mask() -> np.ndarray:
    """(31, 31) {0,1} mask of the IC_Angle summation region: row v
    (|v| <= 15) spans columns |u| <= umax[|v|]."""
    um = _umax()
    ys, xs = np.mgrid[-HALF:HALF + 1, -HALF:HALF + 1]
    return (np.abs(xs) <= um[np.abs(ys)]).astype(np.float32)


@functools.lru_cache()
def _device_consts(device: torch.device):
    """The (961, 2) float64 (y, x) moment weights of the circular patch,
    row-major, and the (256, 4) pattern on ``device``."""
    ys, xs = np.mgrid[-HALF:HALF + 1, -HALF:HALF + 1]
    mask = _circular_mask()
    wts = np.stack([(mask * ys).reshape(-1), (mask * xs).reshape(-1)], 1)
    return (torch.as_tensor(wts, dtype=torch.float64, device=device),
            torch.as_tensor(BIT_PATTERN_31, dtype=torch.float32,
                            device=device))


def ic_angle(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (radians, float32) per keypoint
    (``IC_Angle``, ORBextractor.cc:66-95): both moments in one float64
    product, the angle rounded once to float32."""
    wts, _ = _device_consts(img.device)
    patches = _gather_patches(img, uv).reshape(uv.shape[0], -1)
    m = patches.to(torch.float64) @ wts
    return torch.atan2(m[:, 0], m[:, 1]).to(torch.float32)


def rotated_pattern(ang: torch.Tensor) -> torch.Tensor:
    """(N,) angles -> (N, 256, 4) float32 rotated pattern coordinates
    (col1, row1, col2, row2) before rounding: col = x cos - y sin,
    row = x sin + y cos (``computeOrbDescriptor``, ORBextractor.cc:97-137)."""
    pat = _device_consts(ang.device)[1]
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]     # (N, 1)
    out = []
    for x, y in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
        out += [c * x[None] - s * y[None], s * x[None] + c * y[None]]
    return torch.stack(out, -1)


def descriptor_samples_at_angle(patches: torch.Tensor, ang: torch.Tensor):
    """(N, 37, 37) smoothed patches + (N,) angles -> the two compared
    intensities of every bit, (N, 256) each: the patch at (row +
    round(row offset), col + round(col offset)) of each rotated point,
    rounded half to even as cvRound."""
    xy = torch.round(rotated_pattern(ang)).to(torch.int64) + R_EXT
    flat = patches.reshape(patches.shape[0], -1)
    v1 = torch.gather(flat, 1, xy[..., 1] * PATCH_EXT + xy[..., 0])
    v2 = torch.gather(flat, 1, xy[..., 3] * PATCH_EXT + xy[..., 2])
    return v1, v2


def descriptor_bits_at_angle(patches: torch.Tensor,
                             ang: torch.Tensor) -> torch.Tensor:
    """(N, 37, 37) smoothed patches + (N,) angles (radians) -> (N, 256)
    uint8 bits, the ``computeOrbDescriptor`` formula: a bit is set when
    the first intensity of its learned pair is strictly below the second."""
    v1, v2 = descriptor_samples_at_angle(patches, ang)
    return (v1 < v2).to(torch.uint8)


@functools.lru_cache()
def _gauss7() -> np.ndarray:
    """OpenCV getGaussianKernel(7, 2): normalized 7-tap Gaussian."""
    k = np.exp(-((np.arange(7) - 3.0) ** 2) / (2.0 * 2.0 ** 2))
    return (k / k.sum()).astype(np.float32)


def _gaussian_blur_7x7(img: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 sigma-2 Gaussian with reflect-101 borders, like the
    reference's GaussianBlur(Size(7,7), 2, 2, BORDER_REFLECT_101)
    (ORBextractor.cc:1105): horizontal then vertical, taps added in
    order."""
    k = [float(v) for v in _gauss7()]
    h, w = img.shape
    p = F.pad(img.to(torch.float32)[None, None], (3, 3, 3, 3),
              mode="reflect")[0, 0]
    hz = p[:, 0:w] * k[0]
    for i in range(1, 7):
        hz = hz + p[:, i:i + w] * k[i]
    out = hz[0:h] * k[0]
    for i in range(1, 7):
        out = out + hz[i:i + h] * k[i]
    return out


def brief_descriptors(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """256-bit rotated-BRIEF descriptors -> (N, 256) uint8 bits: smooth the
    image (ORBextractor.cc:1105), IC-angle orientation, then the learned
    bit_pattern_31_ comparisons under the rotated sampling grid."""
    img_s = _gaussian_blur_7x7(img)
    ang = ic_angle(img_s, uv)
    patches = _gather_patches(img_s, uv, radius=R_EXT)        # (N, 37, 37)
    return descriptor_bits_at_angle(patches, ang)


def hamming_distance_matrix(a_bits: torch.Tensor,
                            b_bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) x (M, 256) bit arrays -> (N, M) float32 Hamming distances
    through the +/-1-encoding matmul: ham = (256 - A B^T) / 2."""
    a = a_bits.to(torch.float32) * 2.0 - 1.0
    b = b_bits.to(torch.float32) * 2.0 - 1.0
    return 0.5 * (a_bits.shape[1] - a @ b.T)


def match_descriptors(a_bits: torch.Tensor, b_bits: torch.Tensor,
                      max_distance: int = 64):
    """Mutual nearest-neighbour Hamming matching -> (idx_b_for_a, valid)."""
    d = hamming_distance_matrix(a_bits, b_bits)
    # torch.argmin returns the first index of a tied minimum, as jnp.argmin
    best_ab = torch.argmin(d, 1)
    best_ba = torch.argmin(d, 0)
    mutual = best_ba[best_ab] == torch.arange(a_bits.shape[0],
                                              device=d.device)
    dist = torch.gather(d, 1, best_ab[:, None])[:, 0]
    return best_ab, mutual & (dist <= max_distance)
