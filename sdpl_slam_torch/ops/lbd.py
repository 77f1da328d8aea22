"""Line Band Descriptor (LBD): batched band-gradient statistics
(counterpart of the JAX package's ``ops.lbd``).

The reference's BinaryDescriptor
(3rdparty/line_descriptor/src/binary_descriptor_custom.cpp):

- a line-support region of NUM_OF_BANDS = 9 bands x widthOfBand = 7 rows
  across the line (:57, :113), each row sampled along the line direction;
- per row, separate sums of the positive / negative parts of the gradient
  projected on the line direction dL and its orthogonal dO (:1165-1180);
- a global Gaussian weight over the 63 cross-line rows (sigma = (63-1)/2,
  :162-175) on the row sums (:1185-1193);
- band aggregation with local Gaussian weights (sigma = (2w+1)/2,
  :144-160): each row adds to its own band and to the two adjacent bands
  (:1196-1241); squared sums take the squared coefficient;
- per-band mean / std with invN = 1/(2w) for the edge bands, 1/(3w)
  inside (:1252-1259); the per-band 8-vector
  [m_pL, m_nL, m_pO, m_nO, s_pL, s_nL, s_pO, s_nO] (:1262-1279);
- the mean part and the std part L2-normalised apart (:1286-1314), then
  clamped at 0.4 and renormalised jointly (:1316-1340);
- binarisation over the fixed 32 band-pair ``combinations`` table
  (:74-106): byte c has bit i set iff desVec[8*b1+i] > desVec[8*b2+i]
  (binaryConversion, :401-412; assembly :660-666) -> 256 bits, which
  :func:`.orb.hamming_distance_matrix` compares.

As in the JAX package, each row is sampled at ``N_SAMPLES`` fixed
positions spanning the segment (fixed shapes) where the reference walks
every pixel; the row sums then carry a constant factor, which cancels in
the L2 normalisations.  Descriptors are a dead output of the tracker
(SURVEY.md section 2.1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

N_SAMPLES = 32        # fixed samples along the line
N_BANDS = 9           # NUM_OF_BANDS (:57)
BAND_WIDTH = 7        # widthOfBand_ (:113)
_N_ROWS = N_BANDS * BAND_WIDTH

# the reference's 32 band-pair combinations (:74-106)
_COMBINATIONS = np.array([
    [0, 1], [0, 2], [0, 3], [0, 4], [0, 5], [0, 6],
    [1, 2], [1, 3], [1, 4], [1, 5], [1, 6],
    [2, 3], [2, 4], [2, 5], [2, 6], [2, 7], [2, 8],
    [3, 4], [3, 5], [3, 6], [3, 7], [3, 8],
    [4, 5], [4, 6], [4, 7], [4, 8],
    [5, 6], [5, 7], [5, 8],
    [6, 7], [6, 8],
    [7, 8],
], np.int32)


def _gauss_coefs():
    """(global (63,), local (21,)) Gaussian weights (:144-175)."""
    w = BAND_WIDTH
    u_l = (w * 3 - 1) / 2.0
    sigma_l = (w * 2 + 1) / 2.0
    i = np.arange(w * 3, dtype=np.float64)
    coef_l = np.exp(-((i - u_l) ** 2) / (2 * sigma_l * sigma_l))
    u_g = (_N_ROWS - 1) / 2.0
    sigma_g = u_g
    j = np.arange(_N_ROWS, dtype=np.float64)
    coef_g = np.exp(-((j - u_g) ** 2) / (2 * sigma_g * sigma_g))
    return coef_g.astype(np.float32), coef_l.astype(np.float32)


_COEF_G, _COEF_L = _gauss_coefs()


def _band_matrices():
    """(9, 63) coef / coef^2 matrices mapping weighted row sums to band
    sums: the own / above / below contributions (:1196-1241)."""
    w = BAND_WIDTH
    A = np.zeros((N_BANDS, _N_ROWS), np.float32)
    for h in range(_N_ROWS):
        band = h // w
        A[band, h] += _COEF_L[h % w + w]              # own band
        if band - 1 >= 0:
            A[band - 1, h] += _COEF_L[h % w + 2 * w]  # band above
        if band + 1 < N_BANDS:
            A[band + 1, h] += _COEF_L[h % w]          # band below
    return A, A * A


_BAND_A, _BAND_A2 = _band_matrices()

# invN per band: edge bands only see 2w rows, inner bands 3w (:1252-1259)
_INV_N = np.full(N_BANDS, 1.0 / (BAND_WIDTH * 3.0), np.float32)
_INV_N[0] = _INV_N[-1] = 1.0 / (BAND_WIDTH * 2.0)


@functools.lru_cache()
def _device_consts(device: torch.device):
    """Sample fractions, row offsets, the band matrices, invN, the global
    row weights and the combination table on ``device``."""
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return dict(
        # jnp.linspace's float32 values: i * (1 / (S - 1))
        ts=t(np.arange(N_SAMPLES, dtype=np.float32)
             * np.float32(1.0 / (N_SAMPLES - 1))),
        hs=t(np.arange(_N_ROWS) - (_N_ROWS - 1) / 2.0),
        band_a=t(_BAND_A), band_a2=t(_BAND_A2), inv_n=t(_INV_N),
        coef_g=t(_COEF_G), b1=t(_COMBINATIONS[:, 0], torch.int64),
        b2=t(_COMBINATIONS[:, 1], torch.int64),
        is_mean=t((np.arange(72) % 8) < 4, torch.bool))


def _grad(img: torch.Tensor):
    """3x3 Sobel with edge padding (the reference's cv::Sobel inputs,
    :393-396)."""
    p = F.pad(img.to(torch.float32)[None, None], (1, 1, 1, 1),
              mode="replicate")[0, 0]
    gx = ((p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:])
          - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2]))
    gy = ((p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:])
          - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:]))
    return gx, gy


def _bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear samples of ``img`` at (u, v), clamped inside the image."""
    h, w = img.shape
    u = torch.clamp(u, 0.0, w - 1.001)
    v = torch.clamp(v, 0.0, h - 1.001)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    du = u - u0
    dv = v - v0
    a = img[v0, u0]
    b = img[v0, u0 + 1]
    c = img[v0 + 1, u0]
    d = img[v0 + 1, u0 + 1]
    return (a * (1 - du) * (1 - dv) + b * du * (1 - dv)
            + c * (1 - du) * dv + d * du * dv)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def lbd_float_descriptors(img: torch.Tensor,
                          uv4: torch.Tensor) -> torch.Tensor:
    """(L, 4) segments -> (L, 72) float LBD descriptors (normalised and
    clamped; the reference's returnFloatDescr output, :668-681)."""
    k = _device_consts(img.device)
    gx, gy = _grad(img)
    uv4 = uv4.to(torch.float32)
    s = uv4[:, :2]
    d = uv4[:, 2:] - s
    dL = d / (_norm(d) + 1e-9)                        # along-line unit
    dO = torch.stack([-dL[:, 1], dL[:, 0]], -1)       # orthogonal unit

    # sample grid (L, R=63, S, 2): row h offset across, t along
    base = s[:, None, :] + k["ts"][None, :, None] * d[:, None, :]
    pts = base[:, None] + k["hs"][None, :, None, None] * dO[:, None, None, :]
    pu, pv = pts[..., 0], pts[..., 1]
    sgx = _bilinear(gx, pu, pv)                       # (L, R, S)
    sgy = _bilinear(gy, pu, pv)
    gDL = sgx * dL[:, None, None, 0] + sgy * dL[:, None, None, 1]
    gDO = sgx * dO[:, None, None, 0] + sgy * dO[:, None, None, 1]

    # per-row sums of the 4 signed components (:1165-1180), then the global
    # Gaussian row weight (:1185-1193)
    comps = torch.stack([torch.clamp(gDL, min=0), torch.clamp(-gDL, min=0),
                         torch.clamp(gDO, min=0), torch.clamp(-gDO, min=0)],
                        -1)                           # (L, R, S, 4)
    row = comps.sum(2) * k["coef_g"][None, :, None]   # (L, R, 4)
    row2 = row * row

    # band aggregation with the local Gaussian coefficients (:1196-1241)
    band = torch.einsum("br,lrc->lbc", k["band_a"], row)
    band2 = torch.einsum("br,lrc->lbc", k["band_a2"], row2)
    inv_n = k["inv_n"][None, :, None]
    mean = band * inv_n                               # (L, 9, 4)
    std = torch.sqrt(torch.clamp(band2 * inv_n - mean * mean, min=0.0))

    # per-band [m_pL, m_nL, m_pO, m_nO, s_pL, s_nL, s_pO, s_nO]
    des = torch.cat([mean, std], -1).reshape(uv4.shape[0], -1)   # (L, 72)

    # the mean part and the std part normalised apart (:1286-1314)
    is_mean = k["is_mean"]
    zero = des.new_zeros(())
    nm = _norm(torch.where(is_mean, des, zero))
    ns = _norm(torch.where(is_mean, zero, des))
    des = torch.where(is_mean, des / (nm + 1e-12), des / (ns + 1e-12))
    # clamp at 0.4 and renormalise (:1316-1340)
    des = torch.clamp(des, max=0.4)
    return des / (_norm(des) + 1e-12)


def lbd_descriptors(img: torch.Tensor, uv4: torch.Tensor) -> torch.Tensor:
    """(L, 4) segments -> (L, 256) uint8 bit descriptors through the 32
    band-pair combinations (:74-106, :401-412, :660-666)."""
    k = _device_consts(img.device)
    des = lbd_float_descriptors(img, uv4).reshape(-1, N_BANDS, 8)
    bits = des[:, k["b1"], :] > des[:, k["b2"], :]    # bit i of byte c
    return bits.to(torch.uint8).reshape(-1, 256)
