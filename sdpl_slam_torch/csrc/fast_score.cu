// FAST-9/16 corner response for Hopper (sm_90a), both thresholds in one pass.
//
// Replaces the Pallas TPU kernel sdpl_slam_tpu/ops/fast.py::
// fast_score_map_pallas.  For every pixel, with d_i = ring_i - centre over
// the 16 Bresenham radius-3 ring offsets (OpenCV FAST_9_16 order):
//   bright_i = d_i > t, dark_i = d_i < -t;
//   corner   = some circular run of 9 consecutive ring entries is all
//              bright or all dark;
//   score    = sum_i max(|d_i| - t, 0) over i = 0..15 in ring order on
//              corners, 0 elsewhere.
// Ring samples outside the image read 0 (the JAX version zero-pads its
// shifted planes), so pixels within 3 px of the border compare against 0.
//
// What bounds it on the card: memory bytes.  A level-0 KITTI frame
// (1242x375 f32) is about 1.9 MB read and 2 x 1.9 MB written per call,
// against roughly 60 integer/float operations per pixel and threshold --
// far below the card's operations-per-byte balance point.  The design
// keeps the traffic at one read of the image and one write per output map:
//   * each block stages its tile plus a 3-px halo in shared memory (zero
//     outside the image), so the 16 ring reads per pixel hit shared memory
//     and device memory is read about once per pixel;
//   * the two thresholds of the detector's two-pass scheme (ini and min)
//     come from the same 16 differences, so one launch writes both maps:
//     the pyramid costs 8 launches per frame instead of 16;
//   * the comparisons become two 16-bit masks and the 9-run test is 8
//     shifts and ANDs on a doubled 32-bit mask.
// One thread per pixel, 32x8 threads per block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int R = 3;

__constant__ int kDu[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDv[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ bool has_run9(uint32_t m) {
  uint32_t m32 = m | (m << 16);
  uint32_t r = m32;
#pragma unroll
  for (int k = 1; k < 9; ++k) r &= m32 >> k;
  return (r & 0xFFFFu) != 0u;
}

__device__ __forceinline__ float score_one(const float d[16], float t) {
  uint32_t bright = 0u, dark = 0u;
  float sad = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    bright |= (d[i] > t ? 1u : 0u) << i;
    dark |= (d[i] < -t ? 1u : 0u) << i;
    sad = sad + fmaxf(fabsf(d[i]) - t, 0.0f);
  }
  return (has_run9(bright) || has_run9(dark)) ? sad : 0.0f;
}

__global__ void fast_score2_kernel(const float* __restrict__ img,
                                   float* __restrict__ out_hi,
                                   float* __restrict__ out_lo,
                                   int h, int w, float t_hi, float t_lo) {
  __shared__ float tile[BY + 2 * R][BX + 2 * R];
  const int x0 = blockIdx.x * BX - R;
  const int y0 = blockIdx.y * BY - R;
  for (int i = threadIdx.y * BX + threadIdx.x; i < (BY + 2 * R) * (BX + 2 * R);
       i += BX * BY) {
    const int ty = i / (BX + 2 * R);
    const int tx = i % (BX + 2 * R);
    const int gx = x0 + tx;
    const int gy = y0 + ty;
    tile[ty][tx] = (gx >= 0 && gx < w && gy >= 0 && gy < h)
                       ? img[(size_t)gy * w + gx] : 0.0f;
  }
  __syncthreads();

  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int cx = threadIdx.x + R;
  const int cy = threadIdx.y + R;
  const float c = tile[cy][cx];
  float d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = tile[cy + kDv[i]][cx + kDu[i]] - c;
  const size_t o = (size_t)y * w + x;
  out_hi[o] = score_one(d, t_hi);
  out_lo[o] = score_one(d, t_lo);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on ``stream`` and
// returns the cudaError_t of the launch; never synchronises or allocates.
extern "C" int sdpl_fast_score2(const float* img, float* out_hi, float* out_lo,
                                int h, int w, float t_hi, float t_lo,
                                void* stream) {
  if (h <= 0 || w <= 0) return 0;
  dim3 block(BX, BY);
  dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY);
  fast_score2_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, out_hi, out_lo, h, w, t_hi, t_lo);
  return (int)cudaGetLastError();
}
