// The line detector's two unrolled chains, one launch each: the NFA gate
// of every candidate (ops/lines.py::_nfa_significance_torch) and the tile
// merge rounds (ops/lines.py::_merge_rounds_torch).
//
// Replaces no TPU kernel: the JAX package leaves both to XLA
// (ops/lines.py::_nfa_significance, with jax.scipy.special.betainc, and
// ::_merge_rounds).  They were added because, as plain PyTorch inside the
// captured detector graph, the two functions are ~9,400 of the line
// stage's ~10,500 kernel nodes (64 unrolled Lentz steps of betainc, 16
// merge passes of ~100 elementwise ops), each node paying ~1.6 us on an
// H100 while the work is a few microseconds (PERF.md).
//
// Both kernels follow the plain chain's float32 rounding op for op:
// __fadd_rn / __fmul_rn / __fdiv_rn / __fsqrt_rn where PyTorch runs one
// elementwise kernel an op (nvcc would otherwise contract a multiply and
// an add into one FMA), sums of two terms starting from +0 as PyTorch's
// reductions do, its NaN-propagating min / max and clamp, and every
// threshold a float32 argument converted from the Python float as PyTorch
// converts a scalar.  Built without --use_fast_math.
//
// nfa_kernel: per candidate, 24 points along the segment on 3 rows (the
// normal offsets -1, 0, 1), floor-sampled; per row the in-bounds and the
// aligned counts, scaled by min(1, length/S); per subset of the 3 rows the
// binomial tail I_p0(k, n-k+1) by the continued fraction of _betacf (64
// fixed modified-Lentz steps); the best significance -log10(tail) - logNT.
// What bounds it: operations, ~7,130 candidates x 7 subsets x 64 steps x
// ~30 float ops at KITTI octave 0 (~3 us at 33.5 T/s; the gathers ~4 MB,
// ~1.2 us).  What the design does:
//   * A block takes 32 candidates.  Each of its 8 warps samples 4 of them,
//     a lane a point of the segment, all 3 rows; ballots and popcounts
//     make the exact integer counts.
//   * Then a thread a (candidate, subset) pair, 224 of the 256 threads:
//     the prefactor (lgammaf, logf, log1pf, expf) and the continued
//     fraction in registers, the result into shared memory, and a thread
//     a candidate takes the max over its 7 subsets.
//   * The subsets' sums add the row counts in row order from +0, as the
//     plain chain's (N, 3) @ (3, 7) product accumulates them.
//
// merge_kernel: the 4 rounds x 4 directions of _merge_rounds in one block.
// Pass (r, d) merges each tile's segment with its neighbour at stride 2^r
// in direction d (right, down, down-right, down-left) by _merge_pairs'
// gates and length-weighted blended direction, on the even slot of the
// stride only, and clears the consumed neighbour.  What bounds it: the
// 16 dependent passes (latency), not bytes (~121 KB of state at KITTI
// octave 0) nor operations (~100 a tile a pass).  What the design does:
//   * The state (a tile's 4 floats and its flag) lives in dynamic shared
//     memory while it fits (227 KB: up to ~13,600 tiles), else in the
//     output buffers in device memory, where L2 holds it.
//   * One block barrier a pass.  A tile that merges (an even slot) is
//     never read as another's neighbour in that pass (its neighbour sits
//     on an odd slot), and the neighbour it consumes has one absorber, so
//     the merged segment and the cleared flag are written in place at
//     once.  Tiles on odd slots do no arithmetic: the plain chain computes
//     and discards it.
//   * Every op is elementwise float32 with no sum across tiles, so the
//     result equals the plain chain's bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NFA_CANDS = 32;          // candidates a block
constexpr int NFA_THREADS = 256;       // 8 warps
constexpr int NFA_COMBOS = 7;
constexpr int BETACF_ITERS = 64;       // ops/lines.py::_BETACF_ITERS
constexpr int MERGE_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

// the 7 row subsets of ops/lines.py::_NFA_COMBOS, bit j = row j
__constant__ int kCombos[NFA_COMBOS] = {1, 2, 4, 3, 6, 5, 7};
// ops/lines.py::_MERGE_DIRS (dy, dx) for stride 1
__constant__ int kDirY[4] = {0, 1, 1, 1};
__constant__ int kDirX[4] = {1, 0, 1, -1};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.sum over a last dimension of 2: the reduction starts from +0
__device__ __forceinline__ float sum2(float a, float b) {
  return add(add(0.0f, a), b);
}
// torch.sqrt(torch.sum(x * x, -1)): ops/lines.py::_norm of 2 components
__device__ __forceinline__ float norm2(float x, float y) {
  return __fsqrt_rn(sum2(mul(x, x), mul(y, y)));
}
// torch's min / max reductions (amin, amax): NaN propagates
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}
// torch.clamp with scalar bounds: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// ops/lines.py::_betacf, op for op; 1.0 / v is torch.reciprocal(v) * 1.0
__device__ float betacf(float a, float b, float x) {
  const float tiny = (float)1e-30;
  auto guard = [tiny](float v) { return fabsf(v) < tiny ? tiny : v; };
  const float qab = add(a, b), qap = add(a, 1.0f), qam = sub(a, 1.0f);
  float c = 1.0f;
  float d = dvd(1.0f, guard(sub(1.0f, dvd(mul(qab, x), qap))));
  float h = d;
#pragma unroll 1
  for (int m = 1; m <= BETACF_ITERS; ++m) {
    const float fm = (float)m, m2 = (float)(2 * m);
    float aa = dvd(mul(mul(fm, sub(b, fm)), x),
                   mul(add(qam, m2), add(a, m2)));
    d = dvd(1.0f, guard(add(1.0f, mul(aa, d))));
    c = guard(add(1.0f, dvd(aa, c)));
    h = mul(mul(h, d), c);
    aa = dvd(mul(mul(-add(a, fm), add(qab, fm)), x),
             mul(add(a, m2), add(qap, m2)));
    d = dvd(1.0f, guard(add(1.0f, mul(aa, d))));
    c = guard(add(1.0f, dvd(aa, c)));
    h = mul(mul(h, d), c);
  }
  return h;
}

// ops/lines.py::betainc for a, b > 0 and a scalar x in [0, 1]
__device__ float betainc(float a, float b, float x) {
  const float xs = clamp(x, (float)1e-30, (float)(1.0 - 1e-7));
  const float log_bt = add(add(sub(sub(lgammaf(add(a, b)), lgammaf(a)),
                                   lgammaf(b)),
                               mul(a, logf(xs))),
                           mul(b, log1pf(-xs)));
  const float bt = expf(log_bt);
  const bool swap = x >= dvd(add(a, 1.0f), add(add(a, b), 2.0f));
  const float a1 = swap ? b : a, b1 = swap ? a : b;
  const float x1 = swap ? sub(1.0f, xs) : xs;
  const float part = dvd(mul(bt, betacf(a1, b1, x1)), a1);
  float out = swap ? sub(1.0f, part) : part;
  if (x <= 0.0f) out = 0.0f;
  if (x >= 1.0f) out = 1.0f;
  return out;
}

struct NfaArgs {
  const float* uv4;   // (N, 4) candidates sx, sy, ex, ey
  const float* gx;    // (h, w) Sobel gradients
  const float* gy;
  const float* t;     // (S,) torch.linspace(0, 1, S) on the device
  float* best;        // (N,)
  float* k;           // (N, 7)
  float* n;           // (N, 7)
  int N, h, w, S;
  float grad_thr2;    // grad_threshold ** 2
  float sin_prec;     // sin(pi p0) in float32
  float inv_S;        // 1 / S in float32: PyTorch's division by a scalar
  float p0;           // ang_tol / 180
  float log_nt;
};

__global__ void __launch_bounds__(NFA_THREADS)
nfa_kernel(const NfaArgs a) {
  __shared__ int counts[NFA_CANDS][6];          // n_row[3], k_row[3]
  __shared__ float scale_s[NFA_CANDS];
  __shared__ float sig_s[NFA_CANDS][NFA_COMBOS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * NFA_CANDS;

  for (int c = warp; c < NFA_CANDS; c += NFA_THREADS / 32) {
    const int i = first + c;
    if (i >= a.N) break;                        // uniform in the warp
    const float sx = a.uv4[4 * i], sy = a.uv4[4 * i + 1];
    const float dx = sub(a.uv4[4 * i + 2], sx), dy = sub(a.uv4[4 * i + 3], sy);
    const float length = norm2(dx, dy);
    const float len_c = clamp_min(length, (float)1e-6);
    const float ux = dvd(dx, len_c), uy = dvd(dy, len_c);
    const float nx = -uy, ny = ux;
    int n_in[3] = {0, 0, 0}, k_in[3] = {0, 0, 0};
    for (int s0 = 0; s0 < a.S; s0 += 32) {
      const int s = s0 + lane;
      const bool live = s < a.S;
      const float ts = live ? a.t[s] : 0.0f;
      const float bx = add(sx, mul(ts, dx)), by = add(sy, mul(ts, dy));
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const float off = (float)(o - 1);
        const float px = add(bx, mul(off, nx)), py = add(by, mul(off, ny));
        // floor, then the float -> int64 conversion of .to(torch.int64)
        const long long ix = (long long)floorf(px);
        const long long iy = (long long)floorf(py);
        const bool inb = live && ix >= 0 && ix < a.w && iy >= 0 && iy < a.h;
        bool aligned = false;
        if (inb) {
          const long long at = iy * a.w + ix;
          const float gxs = a.gx[at], gys = a.gy[at];
          const float g2 = add(mul(gxs, gxs), mul(gys, gys));
          const float gdot = add(mul(gxs, ux), mul(gys, uy));
          aligned = g2 > a.grad_thr2 &&
                    fabsf(gdot) <= add(mul(__fsqrt_rn(g2), a.sin_prec),
                                       (float)1e-6);
        }
        n_in[o] += __popc(__ballot_sync(FULL, inb));
        k_in[o] += __popc(__ballot_sync(FULL, aligned));
      }
    }
    if (lane == 0) {
      for (int o = 0; o < 3; ++o) {
        counts[c][o] = n_in[o];
        counts[c][3 + o] = k_in[o];
      }
      scale_s[c] = clamp_max(mul(length, a.inv_S), 1.0f);
    }
  }
  __syncthreads();

  const int c = threadIdx.x / NFA_COMBOS, m = threadIdx.x % NFA_COMBOS;
  if (c < NFA_CANDS && first + c < a.N) {
    const int i = first + c;
    const float scale = scale_s[c];
    float n = 0.0f, k = 0.0f;
    for (int j = 0; j < 3; ++j) {
      if (kCombos[m] >> j & 1) {
        n = add(n, mul((float)counts[c][j], scale));
        k = add(k, mul((float)counts[c][3 + j], scale));
      }
    }
    const float q = dvd(k, clamp_min(n, 1.0f));
    const float alpha = clamp_min(k, 0.5f);
    const float beta = add(clamp_min(sub(n, k), 0.0f), 1.0f);
    const float tail = clamp(betainc(alpha, beta, a.p0), (float)1e-30, 1.0f);
    const float sig = sub(-log10f(tail), a.log_nt);
    sig_s[c][m] = (k > 0.0f && q > a.p0) ? sig : -INFINITY;
    a.k[NFA_COMBOS * i + m] = k;
    a.n[NFA_COMBOS * i + m] = n;
  }
  __syncthreads();

  if (threadIdx.x < NFA_CANDS && first + threadIdx.x < a.N) {
    float b = sig_s[threadIdx.x][0];
    for (int j = 1; j < NFA_COMBOS; ++j) b = max_nan(b, sig_s[threadIdx.x][j]);
    a.best[first + threadIdx.x] = b;
  }
}

struct MergeArgs {
  const float* seg_in;   // (gh, gw, 4)
  const uint8_t* ok_in;  // (gh, gw) bool
  float* seg_out;
  uint8_t* ok_out;
  int gh, gw, rounds;
  float angle_cos, lateral, gap;   // merge_angle_cos, merge_lateral, merge_gap
};

// ops/lines.py::_merge_pairs for one tile (s) and its neighbour (q), both
// valid and allowed: whether they merge, and into what (out)
__device__ __forceinline__ bool merge_pair(const float* s, const float* q,
                                           const MergeArgs& a, float* out) {
  const float d1x = sub(s[2], s[0]), d1y = sub(s[3], s[1]);
  const float d2x = sub(q[2], q[0]), d2y = sub(q[3], q[1]);
  const float l1 = add(norm2(d1x, d1y), (float)1e-9);
  const float l2 = add(norm2(d2x, d2y), (float)1e-9);
  const float cosang = dvd(fabsf(sum2(mul(d1x, d2x), mul(d1y, d2y))),
                           mul(l1, l2));
  const float m2x = mul(0.5f, add(q[0], q[2])), m2y = mul(0.5f, add(q[1], q[3]));
  const float n1x = dvd(-d1y, l1), n1y = dvd(d1x, l1);
  const float lat = fabsf(sum2(mul(sub(m2x, s[0]), n1x),
                               mul(sub(m2y, s[1]), n1y)));
  float gaps = norm2(sub(s[2], q[0]), sub(s[3], q[1]));
  gaps = min_nan(gaps, norm2(sub(s[0], q[2]), sub(s[1], q[3])));
  gaps = min_nan(gaps, norm2(sub(s[2], q[2]), sub(s[3], q[3])));
  gaps = min_nan(gaps, norm2(sub(s[0], q[0]), sub(s[1], q[1])));
  if (!(cosang > a.angle_cos && lat < a.lateral && gaps < a.gap)) return false;
  const float u1x = dvd(d1x, l1), u1y = dvd(d1y, l1);
  const float u2x = dvd(d2x, l2), u2y = dvd(d2y, l2);
  const float dot = sum2(mul(u1x, u2x), mul(u1y, u2y));
  const float sign = (float)((dot > 0.0f) - (dot < 0.0f));   // torch.sign
  float ubx = add(mul(u1x, l1), mul(mul(sign, u2x), l2));
  float uby = add(mul(u1y, l1), mul(mul(sign, u2y), l2));
  const float ubn = add(norm2(ubx, uby), (float)1e-9);
  ubx = dvd(ubx, ubn);
  uby = dvd(uby, ubn);
  const float m1x = mul(0.5f, add(s[0], s[2])), m1y = mul(0.5f, add(s[1], s[3]));
  const float lsum = add(l1, l2);
  const float cx = dvd(add(mul(m1x, l1), mul(m2x, l2)), lsum);
  const float cy = dvd(add(mul(m1y, l1), mul(m2y, l2)), lsum);
  const float px[4] = {s[0], s[2], q[0], q[2]}, py[4] = {s[1], s[3], q[1], q[3]};
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float t = sum2(mul(sub(px[j], cx), ubx), mul(sub(py[j], cy), uby));
    tmin = j ? min_nan(tmin, t) : t;
    tmax = j ? max_nan(tmax, t) : t;
  }
  out[0] = add(cx, mul(tmin, ubx));
  out[1] = add(cy, mul(tmin, uby));
  out[2] = add(cx, mul(tmax, ubx));
  out[3] = add(cy, mul(tmax, uby));
  return true;
}

__global__ void __launch_bounds__(MERGE_THREADS, 1)
merge_kernel(const MergeArgs a, int in_shared) {
  extern __shared__ float smem[];
  const int T = a.gh * a.gw;
  float* seg = a.seg_out;
  uint8_t* ok = a.ok_out;
  if (in_shared) {
    seg = smem;
    ok = reinterpret_cast<uint8_t*>(smem + 4 * T);
  }
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    for (int j = 0; j < 4; ++j) seg[4 * i + j] = a.seg_in[4 * i + j];
    ok[i] = a.ok_in[i];
  }
  __syncthreads();
  for (int r = 0; r < a.rounds; ++r) {
    const int stride = 1 << r;
    for (int d = 0; d < 4; ++d) {
      const int dy = kDirY[d] * stride, dx = kDirX[d] * stride;
      if (dy >= a.gh || abs(dx) >= a.gw) continue;       // as the plain loop
      for (int i = threadIdx.x; i < T; i += blockDim.x) {
        const int row = i / a.gw, col = i - row * a.gw;
        // parity-disjoint absorbers: the even slot of the stride only
        if (((kDirX[d] != 0 ? col : row) / stride) % 2) continue;
        const int nr = row + dy, nc = col + dx;
        if (nr >= a.gh || nc < 0 || nc >= a.gw) continue;   // no wrap
        const int j = nr * a.gw + nc;
        if (!ok[i] || !ok[j]) continue;
        float s[4], q[4], out[4];
        for (int e = 0; e < 4; ++e) {
          s[e] = seg[4 * i + e];
          q[e] = seg[4 * j + e];
        }
        if (merge_pair(s, q, a, out)) {
          for (int e = 0; e < 4; ++e) seg[4 * i + e] = out[e];
          ok[j] = 0;                         // consumed
        }
      }
      __syncthreads();
    }
  }
  if (in_shared) {
    for (int i = threadIdx.x; i < T; i += blockDim.x) {
      for (int j = 0; j < 4; ++j) a.seg_out[4 * i + j] = seg[4 * i + j];
      a.ok_out[i] = ok[i];
    }
  }
}

}  // namespace

extern "C" {

// Plain C entry point (bound with ctypes): _nfa_significance of N
// candidates, one launch on `stream`.  Returns the cudaError_t of the
// launch; never synchronises or allocates.
int sdpl_nfa_significance(const float* uv4, const float* gx, const float* gy,
                          const float* t, float* best, float* k, float* n,
                          int N, int h, int w, int S, float grad_thr2,
                          float sin_prec, float inv_S, float p0, float log_nt,
                          void* stream) {
  if (N < 0 || h < 0 || w < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const NfaArgs a = {uv4, gx, gy, t, best, k, n, N, h, w, S,
                     grad_thr2, sin_prec, inv_S, p0, log_nt};
  const int blocks = (N + NFA_CANDS - 1) / NFA_CANDS;
  nfa_kernel<<<blocks, NFA_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Plain C entry point (bound with ctypes): _merge_rounds of a (gh, gw)
// tile grid, `rounds` rounds, from seg_in / ok_in into seg_out / ok_out,
// one launch of one block on `stream`.  Returns the cudaError_t of the
// launch; never synchronises or allocates.
int sdpl_merge_rounds(const float* seg_in, const uint8_t* ok_in,
                      float* seg_out, uint8_t* ok_out, int gh, int gw,
                      int rounds, float angle_cos, float lateral, float gap,
                      void* stream) {
  if (gh < 0 || gw < 0 || rounds < 0 || rounds > 30)
    return (int)cudaErrorInvalidValue;
  if (gh == 0 || gw == 0) return 0;
  const MergeArgs a = {seg_in, ok_in, seg_out, ok_out, gh, gw, rounds,
                       angle_cos, lateral, gap};
  // the largest dynamic shared memory a block may take on this device,
  // granted to the kernel once a device
  static int granted[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (granted[dev] == 0) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = most;
  }
  const size_t T = (size_t)gh * (size_t)gw;
  const size_t bytes = 17 * T;                  // 4 floats and a flag a tile
  const int in_shared = bytes <= (size_t)granted[dev];
  merge_kernel<<<1, MERGE_THREADS, in_shared ? bytes : 0,
                 (cudaStream_t)stream>>>(a, in_shared);
  return (int)cudaGetLastError();
}

}  // extern "C"
