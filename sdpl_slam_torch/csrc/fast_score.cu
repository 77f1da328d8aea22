// FAST-9/16 corner response for Hopper (sm_90a): every level of one or
// more image pyramids, both thresholds, in one launch.
//
// Replaces the JAX package's Pallas TPU kernel ops/fast.py::
// fast_score_map_pallas (pallas_call at :119), which detect_keypoints calls
// twice per pyramid level.  For every pixel, with d_i = ring_i - centre
// over the 16 Bresenham radius-3 ring offsets (OpenCV FAST_9_16 order):
//   bright_i = d_i > t, dark_i = d_i < -t;
//   corner   = some circular run of 9 consecutive ring entries is all
//              bright or all dark;
//   score    = sum_i max(|d_i| - t, 0) over i = 0..15 in ring order on
//              corners, 0 elsewhere.
// Ring samples outside the image read 0 (the JAX version zero-pads its
// shifted planes), so pixels within 3 px of the border compare against 0.
// Each level gets two maps, at t_hi and at t_lo (t_hi >= t_lo).
//
// What bounds it on the card: memory bytes.  A KITTI pyramid (1242x375 and
// 7 levels down to 347x105, 1,441,432 pixels) reads 4 B and writes 2 x 4 B
// per pixel: 17.3 MB, 5.2 us at 3.35 TB/s.  The operations the data needs
// take far less: ~12 per pixel for the compass test below, and the full
// test (~200) on the ~7 % of pixels that pass it.  What the design does:
//   * One launch for a whole pyramid (or several): the levels come in a
//     table passed by value; the work is a 1-D list of 32x8-pixel units
//     over all levels, and a warp finds its unit's level from the prefix
//     of unit counts.  The grid is persistent (as many blocks as fit), so
//     the small levels fill the tail of one launch instead of each paying
//     a launch of its own.
//   * Early exit: a circular run of 9 among 16 ring entries covers at
//     least 2 of the compass entries {0, 4, 8, 12}.  So a pixel whose 4
//     compass differences hold fewer than 2 bright and fewer than 2 dark
//     at t_lo is no corner at either threshold: both its scores are 0,
//     written at once.  "At least 2 bright" is "the second largest compass
//     difference > t"; x -> fl(x - c) is monotone, so that is the second
//     largest compass sample less the centre: 8 min/max, 2 subtractions.
//   * A lane walks down one column of its unit holding the column's window
//     (north sample, centre, south sample) in registers: 3 loads a pixel,
//     all issued for the whole unit before its tests.
//   * The pixels that pass go to a shared queue, and the block's threads
//     run the full test over the queues of all its warps together.  A
//     block's 4 units lie a quarter of the pyramid apart, so the dense
//     corner regions that would leave one warp with 8 rounds of full tests
//     (and the rest of the grid idle) spread over many blocks.
//   * Full test on window minima: the largest, over the 16 circular
//     windows of 9 samples, of the window's minimum, less the centre, is
//     > t iff a bright run exists at t (min, max and fl(x - c) commute);
//     on the negated samples it tests the dark runs.  The compass test
//     says which of the two can exist, so most candidates take one pass
//     (depth 4 by doubling) that answers both thresholds.  t_hi corners
//     are t_lo corners, so a non-corner at t_lo stops there.
//   * Each SAD is summed in ring order i = 0..15 with __fadd_rn/__fsub_rn
//     (never contracted or reordered), the order of the plain PyTorch
//     version, so kernel and plain agree bit for bit.
//   * Loads are 4-byte __ldg through L1, not cp.async or TMA into shared
//     tiles.  TMA and 16-byte copies need 16-byte-aligned rows, and of the
//     KITTI level widths only 416 floats is a multiple of 4.  Block tiles
//     staged with 4-byte cp.async (double-buffered) measured slower: their
//     block barriers held every warp to the slowest warp's full tests
//     (PERF.md, Findings).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UH = 8;                 // unit height: rows a lane walks
constexpr int NWARPS = 4;             // units per block round
constexpr int NTHREADS = 32 * NWARPS;
constexpr int MAX_LEVELS = 64;
constexpr int MAX_SIDE = 1 << 13;     // y and x share a 32-bit queue entry

struct Level {
  const float* src;   // (h, w) contiguous
  float* out;         // (2, h, w): the t_hi map, then the t_lo map
  int h, w, units_x, unit_start;
};

struct Table {
  Level lv[MAX_LEVELS];
  int n_levels, n_units;
  float t_hi, t_lo;
};

// Where unit u lies: its level (searched upward from 0) and origin.
__device__ __forceinline__ void locate(const Table& T, int u, int& l,
                                       int& y0, int& x0) {
  l = 0;
  while (l + 1 < T.n_levels && u >= T.lv[l + 1].unit_start) ++l;
  const int local = u - T.lv[l].unit_start;
  const int ux = T.lv[l].units_x;
  const int uy = local / ux;
  y0 = uy * UH;
  x0 = (local - uy * ux) * 32;
}

__device__ __forceinline__ float load(const float* p, bool ok) {
  return ok ? __ldg(p) : 0.0f;
}

// The largest, over the 16 circular windows of 9 consecutive ring
// samples, of the window's minimum.  Some window is all bright at t iff it
// less the centre is > t: min, max and x -> fl(x - c) commute, as all are
// monotone.  Windows by doubling (2, 4, 8, then 9).
__device__ __forceinline__ float best_arc(const float r[16]) {
  float a[16], a4[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = fminf(r[i], r[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) a4[i] = fminf(a[i], a[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    a[i] = fminf(fminf(a4[i], a4[(i + 4) & 15]), r[(i + 8) & 15]);
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = fmaxf(a[i], a[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = fmaxf(a[i], a[i + 4]);
  return fmaxf(fmaxf(a[0], a[2]), fmaxf(a[1], a[3]));
}

// best_arc less the centre, on the samples as they are (flip 0: > t iff a
// bright run) or negated (flip = sign bit: > t iff a dark run; negation is
// exact and swaps min and max).
__device__ __forceinline__ float arc_margin(const float r[16], float c,
                                            uint32_t flip) {
  float s[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    s[i] = __uint_as_float(__float_as_uint(r[i]) ^ flip);
  return __fsub_rn(best_arc(s), __uint_as_float(__float_as_uint(c) ^ flip));
}

// Both scores of the pixel (y, x) of an (h, w) level.  t_hi corners are
// t_lo corners (d > t_hi implies d > t_lo), so a non-corner at t_lo stops
// early.  Each SAD is summed in ring order, unfused, as the plain version
// sums it; the two sums run side by side.
__device__ __forceinline__ float2 score(const float* src, int h, int w,
                                        int y, int x, float t_hi,
                                        float t_lo) {
  // element offsets in 32 bits (a level holds at most 2^26 pixels): one
  // wide multiply-add per address
  bool row_ok[7], col_ok[7];
  int row[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    row_ok[k] = (unsigned)(y + k - 3) < (unsigned)h;
    col_ok[k] = (unsigned)(x + k - 3) < (unsigned)w;
    row[k] = (y + k - 3) * w + x;
  }
  float r[16];
  // _CIRCLE entry i at (du, dv)
#define SDPL_RING(i, du, dv)                     \
  r[i] = load(src + row[(dv) + 3] + (du),        \
              row_ok[(dv) + 3] && col_ok[(du) + 3])
  SDPL_RING(0, 0, -3);
  SDPL_RING(1, 1, -3);
  SDPL_RING(2, 2, -2);
  SDPL_RING(3, 3, -1);
  SDPL_RING(4, 3, 0);
  SDPL_RING(5, 3, 1);
  SDPL_RING(6, 2, 2);
  SDPL_RING(7, 1, 3);
  SDPL_RING(8, 0, 3);
  SDPL_RING(9, -1, 3);
  SDPL_RING(10, -2, 2);
  SDPL_RING(11, -3, 1);
  SDPL_RING(12, -3, 0);
  SDPL_RING(13, -3, -1);
  SDPL_RING(14, -2, -2);
  SDPL_RING(15, -1, -3);
#undef SDPL_RING
  const float c = __ldg(src + row[3]);
  // the compass test again says which runs can exist; most candidates can
  // only be bright or only dark, and test that one polarity
  const float u = fminf(fmaxf(r[0], r[4]), fmaxf(r[8], r[12]));
  const float v = fmaxf(fminf(r[0], r[4]), fminf(r[8], r[12]));
  const bool bright = __fsub_rn(fmaxf(u, v), c) > t_lo;
  const bool dark = __fsub_rn(fminf(u, v), c) < -t_lo;
  float m = arc_margin(r, c, bright ? 0u : 0x80000000u);
  if (bright && dark) m = fmaxf(m, arc_margin(r, c, 0x80000000u));
  if (!(m > t_lo)) return make_float2(0.0f, 0.0f);
  float s_hi = 0.0f, s_lo = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float d = fabsf(__fsub_rn(r[i], c));
    const float e_hi = fmaxf(__fsub_rn(d, t_hi), 0.0f);
    const float e_lo = fmaxf(__fsub_rn(d, t_lo), 0.0f);
    s_hi = i ? __fadd_rn(s_hi, e_hi) : e_hi;
    s_lo = i ? __fadd_rn(s_lo, e_lo) : e_lo;
  }
  return make_float2(m > t_hi ? s_hi : 0.0f, s_lo);
}

// The compass test of one unit by one warp: rows y0 .. y0 + UH - 1,
// columns x0 .. x0 + 31 of level l.  Writes both zeros of every pixel that
// fails it and queues the others as (level, y, x); returns how many.
__device__ __forceinline__ int compass_unit(const Level& L, int l, int y0,
                                            int x0, float t_lo,
                                            uint32_t* queue, int lane) {
  const int h = L.h, w = L.w;
  const int x = x0 + lane;
  // this lane's column; rows by 32-bit element offsets
  const float* __restrict__ src = L.src + x;
  float* __restrict__ out_hi = L.out + x;
  float* __restrict__ out_lo = out_hi + (size_t)h * w;
  const bool x_ok = x < w, e_ok = x + 3 < w, w_ok = x >= 3 && x_ok;
  float col[UH + 6], east[UH], west[UH];   // col: rows y0 - 3 .. y0 + UH + 2
#pragma unroll
  for (int k = 0; k < UH + 6; ++k) {
    const int y = y0 - 3 + k;
    col[k] = load(src + y * w, x_ok && y >= 0 && y < h);
  }
#pragma unroll
  for (int s = 0; s < UH; ++s) {
    const int o = (y0 + s) * w;
    east[s] = load(src + o + 3, y0 + s < h && e_ok);
    west[s] = load(src + o - 3, y0 + s < h && w_ok);
  }
  int n = 0;
#pragma unroll
  for (int s = 0; s < UH; ++s) {
    const int y = y0 + s;
    const float a = col[s], b = east[s], e = col[s + 6], f = west[s];
    const float c = col[s + 3];
    // second largest / smallest of the 4 compass samples
    const float u = fminf(fmaxf(a, b), fmaxf(e, f));
    const float v = fmaxf(fminf(a, b), fminf(e, f));
    const bool in = y < h && x_ok;
    const bool cand = in && (__fsub_rn(fmaxf(u, v), c) > t_lo ||
                             __fsub_rn(fminf(u, v), c) < -t_lo);
    if (in && !cand) {
      out_hi[y * w] = 0.0f;
      out_lo[y * w] = 0.0f;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, cand);
    if (cand) queue[n + __popc(ballot & ((1u << lane) - 1u))] =
        (uint32_t)l << 26 | (uint32_t)y << 13 | (uint32_t)x;
    n += __popc(ballot);
  }
  return n;
}

// The units come in block rounds of NWARPS: round k's warp w takes unit
// k + w * n_rounds.  Each warp runs the compass test over its unit; then
// the block's threads run the full test over all the round's queues.
__global__ void __launch_bounds__(NTHREADS)
fast_pyramid_kernel(const __grid_constant__ Table T) {
  __shared__ uint32_t queues[NWARPS][UH * 32];
  __shared__ int counts[NWARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rounds = (T.n_units + NWARPS - 1) / NWARPS;
  for (int k = blockIdx.x; k < n_rounds; k += gridDim.x) {
    const int u = k + warp * n_rounds;
    int n = 0;
    if (u < T.n_units) {
      int l, y0, x0;
      locate(T, u, l, y0, x0);
      n = compass_unit(T.lv[l], l, y0, x0, T.t_lo, queues[warp], lane);
    }
    if (lane == 0) counts[warp] = n;
    __syncthreads();
    int w = 0, i = threadIdx.x;       // i-th entry of queue w
    while (true) {
      while (w < NWARPS && i >= counts[w]) i -= counts[w++];
      if (w == NWARPS) break;
      const uint32_t q = queues[w][i];
      const Level& L = T.lv[q >> 26];
      const int y = q >> 13 & (MAX_SIDE - 1), x = q & (MAX_SIDE - 1);
      const float2 r = score(L.src, L.h, L.w, y, x, T.t_hi, T.t_lo);
      float* o = L.out + (y * L.w + x);
      o[0] = r.x;
      o[(size_t)L.h * L.w] = r.y;
      i += NTHREADS;
    }
    __syncthreads();                  // queues are refilled next round
  }
}

}  // namespace

// One level as the caller describes it.
struct SdplFastLevel {
  const float* src;   // (h, w) float32, contiguous, on the device
  float* out;         // (2, h, w) float32: t_hi map then t_lo map
  int h, w;
};

extern "C" int sdpl_fast_max_levels() { return MAX_LEVELS; }

// Plain C entry point (bound with ctypes): both FAST score maps of every
// level in `levels` (host array of n <= MAX_LEVELS, each side at most
// 8192), one launch on `stream`.  Returns the cudaError_t of the launch;
// never synchronises or allocates.
extern "C" int sdpl_fast_score_pyramid(const SdplFastLevel* levels, int n,
                                       float t_hi, float t_lo,
                                       void* stream) {
  if (n < 0 || n > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Table T = {};
  int units = 0;
  for (int i = 0; i < n; ++i) {
    const SdplFastLevel& L = levels[i];
    if (L.h < 0 || L.w < 0 || L.h > MAX_SIDE || L.w > MAX_SIDE)
      return (int)cudaErrorInvalidValue;
    const int ux = (L.w + 31) / 32, uy = (L.h + UH - 1) / UH;
    T.lv[i] = Level{L.src, L.out, L.h, L.w, ux, units};
    units += ux * uy;
  }
  T.n_levels = n;
  T.n_units = units;
  T.t_hi = t_hi;
  T.t_lo = t_lo;
  if (units == 0) return 0;
  static int per_sm = 0;              // same kernel, same block: query once
  cudaError_t err;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fast_pyramid_kernel, NTHREADS, 0);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int rounds = (units + NWARPS - 1) / NWARPS;
  const int grid = rounds < per_sm * sms ? rounds : per_sm * sms;
  fast_pyramid_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(T);
  return (int)cudaGetLastError();
}
