// One iteration of the joint flow+pose LM for every lane, in one launch:
// the body of solvers/frame_solvers.py::lm_iteration on the card.
//
// Replaces no TPU kernel: the JAX package leaves this loop body to XLA
// (solvers/frame_solvers.py::solve_flow_pose, lax.while_loop under vmap).
// It was added because a profile of the captured chained step on an H100
// named it: as plain PyTorch, one iteration is ~700 small kernels, each a
// graph node paying ~1.5-1.8 us, while the work is under 1 MFLOP and
// ~150 KB a lane (PERF.md).  The mathematics is _FlowPoseProblem's:
//
//   points (2-dof flow f):  r_p = (obs + f) - pi(T Xw),  r_f = f - flow0
//   lines  (4-dof flow g):  r_l = [l(P, Q) . pi_h(T Xs), 0],  r_g = g - flow0
//     with P = obs[:2] + g[:2], Q = obs[2:] + g[2:], l = (P_h x Q_h) / |.|;
//     the residual's second component is zero while both Jacobian rows
//     (start and end point) add curvature: the reference's quirk, kept.
//   cost = sum valid * (huber_rho(info * |r|^2) + prior * |r_prior|^2)
//
// Each feature's flow block (2x2 points: (w_p + w_f + lam) I; 4x4 lines)
// is eliminated in closed form into the lane's damped 6x6 system, which is
// solved for the pose step dxi; then df, dg, the gain's denominator and
// the cost at (exp(dxi) T, f + df, g + dg) decide acceptance, the damping
// lam / nu and the lane's exit exactly as lm_iteration does.  A lane that
// is done or out of iterations changes nothing.
//
// What bounds it on the card: a dependent chain, not bytes or FLOPs.  A
// camera iteration (1 lane, 1200 points, 400 lines) reads ~0.1 MB and
// does ~1 MFLOP; the chain is pass 1 (each thread's features), a block
// reduction of 28 sums, one thread's 6x6 solve and exponential map, pass 2
// and a block reduction of 2 sums.  What the design does about it:
//   * One block a lane, all lanes in one launch: the WHILE body of the
//     captured step is this one kernel node.
//   * Threads stride over the lane's lines, then its points (lines cost
//     ~4x a point, so they are spread over the first threads).
//   * Pass 2 recomputes each feature's linearisation (the same code on the
//     same inputs) instead of storing it, and writes the trial flows to
//     scratch; a third loop copies them in only if the step is accepted.
//   * Sums are fixed-order: per thread in stride order, warp shuffles,
//     then the warps' partial sums in warp order.  No float atomics: a
//     launch repeats bit for bit.
//   * Each line's 4x4 block is SPD ((w_g + lam) I plus a Gram matrix), so
//     it is eliminated through its Cholesky factor L: with Y = L^-1 Hxg^T
//     and z = L^-1 bg, Hxx -= Y^T Y, bx -= Y^T z, dg = L^-T (z - Y dxi).
//   * The 6x6 system is solved by one thread in registers, by Gaussian
//     elimination with partial pivoting (the LU that torch.linalg.solve_ex
//     takes).
//   * The loop flag (some lane still active) is set by the last block to
//     finish, found by an integer ticket that it resets for the next
//     launch.  That block also counts the run in a device variable, so
//     runs replayed by a graph are counted as they happen
//     (sdpl_flow_pose_lm_runs).
// Built without --use_fast_math: division and sqrt are IEEE, as in
// PyTorch's kernels.  Padded lines that would give NaN are zeroed where
// the PyTorch body zeroes them (nan_to_num); invalid points and lines
// contribute nothing and keep their flows.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

extern "C" {
// The kernel's arguments (bound field by field with ctypes in
// solvers/frame_solvers.py).  Every array is contiguous, row-major, on one
// device; B lanes, N points and M lines a lane.
typedef struct {
  const float* Xw;           // (B, N, 3) points unprojected through T_wl
  const float* p_obs;        // (B, N, 2)
  const float* p_flow0;      // (B, N, 2)
  const uint8_t* p_valid;    // (B, N) bool
  const float* Xs;           // (B, M, 3) line start points, world
  const float* Xe;           // (B, M, 3) line end points, world
  const float* l_obs;        // (B, M, 4)
  const float* l_flow0;      // (B, M, 4)
  const uint8_t* l_valid;    // (B, M) bool
  const float* delta_line;   // (B,) Huber delta of the lines
  float* T;                  // (B, 4, 4)  state, updated in place
  float* f;                  // (B, N, 2)
  float* g;                  // (B, M, 4)
  float* cost;               // (B,)
  float* lam;                // (B,)
  float* nu;                 // (B,)
  int32_t* it;               // (B,)
  uint8_t* done;             // (B,) bool
  uint8_t* active_any;       // () bool: some lane still active
  float* f_try;              // (B, N, 2) scratch: the trial flows
  float* g_try;              // (B, M, 4)
  unsigned int* ticket;      // () 0 between launches
  int B, N, M, max_iterations, use_lines;
  float fx, fy, cx, cy;
  float proj_info, flow_prior_info, line_proj_info, line_prior_info;
  float delta_mono, rel_tol;
} SdplFlowPoseLM;
}

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int NRED = 28;   // Hxx's upper triangle (21), bx (6), the cost

// Runs of the kernel on this device (one a launch, however it was
// launched); read by sdpl_flow_pose_lm_runs.
__device__ unsigned long long g_runs = 0;

__host__ __device__ constexpr int sym(int i, int j) {   // i <= j
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// torch.clamp(x, min=m): NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float m) {
  return x < m ? m : x;
}

__device__ __forceinline__ float nan_to_num(float x) {
  return x != x ? 0.0f : fminf(fmaxf(x, -FLT_MAX), FLT_MAX);
}

// g2o RobustKernelHuber rho and rho'
__device__ __forceinline__ float huber_rho(float chi2, float d) {
  return chi2 <= d * d ? chi2
                       : 2.0f * d * sqrtf(clamp_min(chi2, 1e-20f)) - d * d;
}

__device__ __forceinline__ float huber_weight(float chi2, float d) {
  return chi2 <= d * d ? 1.0f : d / sqrtf(clamp_min(chi2, 1e-20f));
}

// T (3x4, row-major) applied to a point
__device__ __forceinline__ void xform(const float* P, float X0, float X1,
                                      float X2, float& x, float& y,
                                      float& z) {
  x = P[0] * X0 + P[1] * X1 + P[2] * X2 + P[3];
  y = P[4] * X0 + P[5] * X1 + P[6] * X2 + P[7];
  z = P[8] * X0 + P[9] * X1 + P[10] * X2 + P[11];
}

// geometry.project (depths below 1e-8 guarded)
__device__ __forceinline__ void project(const SdplFlowPoseLM& a, float x,
                                        float y, float z, float& u,
                                        float& v) {
  const float sz = fabsf(z) < 1e-8f ? 1e-8f : z;
  u = a.fx * x / sz + a.cx;
  v = a.fy * y / sz + a.cy;
}

// _point_proj_jacobian: d[(obs + f) - pi(T X)] / d dxi at 0, [omega, v]
__device__ __forceinline__ void proj_jac(const SdplFlowPoseLM& a, float x,
                                         float y, float z, float* Ju,
                                         float* Jv) {
  const float zz = fabsf(z) < 1e-6f ? 1e-6f : z;
  const float z2 = zz * zz;
  Ju[0] = x * y / z2 * a.fx;
  Ju[1] = -(1.0f + x * x / z2) * a.fx;
  Ju[2] = y / zz * a.fx;
  Ju[3] = -1.0f / zz * a.fx;
  Ju[4] = 0.0f;
  Ju[5] = x / z2 * a.fx;
  Jv[0] = (1.0f + y * y / z2) * a.fy;
  Jv[1] = -x * y / z2 * a.fy;
  Jv[2] = -x / zz * a.fy;
  Jv[3] = 0.0f;
  Jv[4] = -1.0f / zz * a.fy;
  Jv[5] = y / z2 * a.fy;
}

// ---- points ---------------------------------------------------------------

// The cost term of point i (a global index) at pose P and flow (f0, f1);
// also its camera-frame position, residual and chi2.
__device__ __forceinline__ float point_cost(const SdplFlowPoseLM& a,
                                            const float* P, int i, float f0,
                                            float f1, float* xyz, float* r,
                                            float* rf, float& chi2p) {
  xform(P, a.Xw[3 * i], a.Xw[3 * i + 1], a.Xw[3 * i + 2], xyz[0], xyz[1],
        xyz[2]);
  float u, v;
  project(a, xyz[0], xyz[1], xyz[2], u, v);
  r[0] = (a.p_obs[2 * i] + f0) - u;
  r[1] = (a.p_obs[2 * i + 1] + f1) - v;
  chi2p = a.proj_info * (r[0] * r[0] + r[1] * r[1]);
  rf[0] = f0 - a.p_flow0[2 * i];
  rf[1] = f1 - a.p_flow0[2 * i + 1];
  const float chi2f = a.flow_prior_info * (rf[0] * rf[0] + rf[1] * rf[1]);
  return huber_rho(chi2p, a.delta_mono) + chi2f;
}

struct PointLin {
  float Ju[6], Jv[6];   // d r_p / d dxi
  float wp, inv;        // robust weight * info; 1 / hff
  float r[2], bf[2];    // r_p; the flow block's right-hand side
  float cost;
};

__device__ __forceinline__ void point_lin(const SdplFlowPoseLM& a,
                                          const float* P, int i, float lam,
                                          PointLin& o) {
  float xyz[3], rf[2], chi2p;
  o.cost = point_cost(a, P, i, a.f[2 * i], a.f[2 * i + 1], xyz, o.r, rf,
                      chi2p);
  proj_jac(a, xyz[0], xyz[1], xyz[2], o.Ju, o.Jv);
  const float wf = a.flow_prior_info;
  o.wp = huber_weight(chi2p, a.delta_mono) * a.proj_info;
  o.inv = 1.0f / (o.wp + wf + lam);
  o.bf[0] = -(o.wp * o.r[0] + wf * rf[0]);
  o.bf[1] = -(o.wp * o.r[1] + wf * rf[1]);
}

// ---- lines ----------------------------------------------------------------

// The cost term of line j at pose P and flow g; also what the Jacobians
// need: the endpoints in the camera, their projections, P_h x Q_h, its
// norm and the (nan_to_num-ed) residual.
struct LineRes {
  float xs[3], xe[3], ps[2], pe[2], Pp[2], Qp[2], l[3], n, e0, rg[4], chi2l;
};

__device__ __forceinline__ float line_cost(const SdplFlowPoseLM& a,
                                           const float* P, int j,
                                           const float* g, float dl,
                                           LineRes& o) {
  xform(P, a.Xs[3 * j], a.Xs[3 * j + 1], a.Xs[3 * j + 2], o.xs[0], o.xs[1],
        o.xs[2]);
  xform(P, a.Xe[3 * j], a.Xe[3 * j + 1], a.Xe[3 * j + 2], o.xe[0], o.xe[1],
        o.xe[2]);
  project(a, o.xs[0], o.xs[1], o.xs[2], o.ps[0], o.ps[1]);
  project(a, o.xe[0], o.xe[1], o.xe[2], o.pe[0], o.pe[1]);
  const float* ob = a.l_obs + 4 * j;
  o.Pp[0] = ob[0] + g[0];
  o.Pp[1] = ob[1] + g[1];
  o.Qp[0] = ob[2] + g[2];
  o.Qp[1] = ob[3] + g[3];
  // (P, 1) x (Q, 1)
  const float c0 = o.Pp[1] - o.Qp[1];
  const float c1 = o.Qp[0] - o.Pp[0];
  const float c2 = o.Pp[0] * o.Qp[1] - o.Pp[1] * o.Qp[0];
  o.n = sqrtf(c0 * c0 + c1 * c1 + c2 * c2 + 1e-12f);
  o.l[0] = c0 / o.n;
  o.l[1] = c1 / o.n;
  o.l[2] = c2 / o.n;
  o.e0 = nan_to_num(o.l[0] * o.ps[0] + o.l[1] * o.ps[1] + o.l[2]);
  o.chi2l = a.line_proj_info * (o.e0 * o.e0);
  const float* fl = a.l_flow0 + 4 * j;
  float chi2g = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o.rg[k] = g[k] - fl[k];
    chi2g += o.rg[k] * o.rg[k];
  }
  return huber_rho(o.chi2l, dl) + a.line_prior_info * chi2g;
}

struct LineLin {
  float Jx[2][6];       // d r_l / d dxi, start and end rows
  float e0, wl;
  float L10, L20, L21, L30, L31, L32, rd[4];   // Cholesky of Hgg, 1 / L_kk
  float Y[4][6];        // L^-1 Hxg^T
  float z[4];           // L^-1 bg
  float bg[4];
  float cost;
};

__device__ __forceinline__ void line_lin(const SdplFlowPoseLM& a,
                                         const float* P, int j, float dl,
                                         float lam, LineLin& o) {
  const float* g = a.g + 4 * j;
  LineRes r;
  o.cost = line_cost(a, P, j, g, dl, r);
  o.e0 = r.e0;
  // d r_l / d dxi: -(l0 d pi_u + l1 d pi_v) at each endpoint
  float G[2][4];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float* X = k == 0 ? r.xs : r.xe;
    const float* p = k == 0 ? r.ps : r.pe;
    float Ju[6], Jv[6];
    proj_jac(a, X[0], X[1], X[2], Ju, Jv);
#pragma unroll
    for (int i = 0; i < 6; ++i)
      o.Jx[k][i] = nan_to_num(-(r.l[0] * Ju[i] + r.l[1] * Jv[i]));
    // d e_k / d g (line_flow_jacobian): v = (h - l (l.h)) / n,
    // dP = ((Q, 1) x v)[:2], dQ = (v x (P, 1))[:2]
    const float lh = r.l[0] * p[0] + r.l[1] * p[1] + r.l[2];
    const float v0 = (p[0] - r.l[0] * lh) / r.n;
    const float v1 = (p[1] - r.l[1] * lh) / r.n;
    const float v2 = (1.0f - r.l[2] * lh) / r.n;
    G[k][0] = nan_to_num(r.Qp[1] * v2 - v1);
    G[k][1] = nan_to_num(v0 - r.Qp[0] * v2);
    G[k][2] = nan_to_num(v1 - v2 * r.Pp[1]);
    G[k][3] = nan_to_num(v2 * r.Pp[0] - v0);
  }
  o.wl = huber_weight(r.chi2l, dl) * a.line_proj_info;
  const float wl = o.wl, wg = a.line_prior_info;
  // Hgg = wl (G0 G0^T + G1 G1^T) + (wg + lam) I, its Cholesky factor
  float H[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q <= p; ++q)
      H[p][q] = wl * (G[0][p] * G[0][q] + G[1][p] * G[1][q]) +
                (p == q ? wg + lam : 0.0f);
  const float L00 = sqrtf(H[0][0]);
  o.rd[0] = 1.0f / L00;
  o.L10 = H[1][0] * o.rd[0];
  o.L20 = H[2][0] * o.rd[0];
  o.L30 = H[3][0] * o.rd[0];
  const float L11 = sqrtf(H[1][1] - o.L10 * o.L10);
  o.rd[1] = 1.0f / L11;
  o.L21 = (H[2][1] - o.L20 * o.L10) * o.rd[1];
  o.L31 = (H[3][1] - o.L30 * o.L10) * o.rd[1];
  const float L22 = sqrtf(H[2][2] - o.L20 * o.L20 - o.L21 * o.L21);
  o.rd[2] = 1.0f / L22;
  o.L32 = (H[3][2] - o.L30 * o.L20 - o.L31 * o.L21) * o.rd[2];
  const float L33 =
      sqrtf(H[3][3] - o.L30 * o.L30 - o.L31 * o.L31 - o.L32 * o.L32);
  o.rd[3] = 1.0f / L33;
  // bg = -(wl e0 G0 + wg r_g); Hxg^T column i = wl (G0 Jx0_i + G1 Jx1_i)
  float rhs[7][4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    o.bg[p] = -(wl * r.e0 * G[0][p] + wg * r.rg[p]);
    rhs[6][p] = o.bg[p];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      rhs[i][p] = wl * (G[0][p] * o.Jx[0][i] + G[1][p] * o.Jx[1][i]);
  }
#pragma unroll
  for (int c = 0; c < 7; ++c) {   // forward substitution, L y = rhs
    const float y0 = rhs[c][0] * o.rd[0];
    const float y1 = (rhs[c][1] - o.L10 * y0) * o.rd[1];
    const float y2 = (rhs[c][2] - o.L20 * y0 - o.L21 * y1) * o.rd[2];
    const float y3 =
        (rhs[c][3] - o.L30 * y0 - o.L31 * y1 - o.L32 * y2) * o.rd[3];
    if (c < 6) {
      o.Y[0][c] = y0;
      o.Y[1][c] = y1;
      o.Y[2][c] = y2;
      o.Y[3][c] = y3;
    } else {
      o.z[0] = y0;
      o.z[1] = y1;
      o.z[2] = y2;
      o.z[3] = y3;
    }
  }
}

// dg = L^-T (z - Y dxi)
__device__ __forceinline__ void line_step(const LineLin& o, const float* dxi,
                                          float* dg) {
  float q[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) s += o.Y[p][i] * dxi[i];
    q[p] = o.z[p] - s;
  }
  dg[3] = q[3] * o.rd[3];
  dg[2] = (q[2] - o.L32 * dg[3]) * o.rd[2];
  dg[1] = (q[1] - o.L21 * dg[2] - o.L31 * dg[3]) * o.rd[1];
  dg[0] = (q[0] - o.L10 * dg[1] - o.L20 * dg[2] - o.L30 * dg[3]) * o.rd[0];
}

// ---- the lane's 6x6 system and the pose update ---------------------------

// A x = b by Gaussian elimination with partial pivoting (the first largest
// pivot, as LAPACK's getrf); A | b in registers.
__device__ __forceinline__ void solve6(float (&A)[6][7], float* x) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      const float v = fabsf(A[r][k]);
      if (v > best) {
        best = v;
        p = r;
      }
    }
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      if (r == p) {
#pragma unroll
        for (int c = k; c < 7; ++c) {
          const float t = A[k][c];
          A[k][c] = A[r][c];
          A[r][c] = t;
        }
      }
    }
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      const float m = A[r][k] / A[k][k];
#pragma unroll
      for (int c = k + 1; c < 7; ++c) A[r][c] -= m * A[k][c];
    }
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    float s = A[k][6];
#pragma unroll
    for (int c = k + 1; c < 6; ++c) s -= A[k][c] * x[c];
    x[k] = s / A[k][k];
  }
}

// lie.se3_retract: exp(xi) T, xi = [omega, v]; T and the result 3x4
__device__ __forceinline__ void se3_retract(const float* xi, const float* T,
                                            float* Tn) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float th = sqrtf(w0 * w0 + w1 * w1 + w2 * w2 + 1e-24f);
  const bool small = th < 1e-5f;
  const float t2 = th * th;
  const float sinc = small ? 1.0f - t2 / 6.0f : sinf(th) / th;
  const float cosc = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(th)) / t2;
  const float cv = small ? 1.0f / 6.0f - t2 / 120.0f : (1.0f - sinc) / t2;
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float R[3][3], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float W2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] +
                       W[i][2] * W[2][j];
      const float id = i == j ? 1.0f : 0.0f;
      R[i][j] = id + sinc * W[i][j] + cosc * W2;
      t[i] += (id + cosc * W[i][j] + cv * W2) * xi[3 + j];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Tn[4 * i + j] = R[i][0] * T[j] + R[i][1] * T[4 + j] +
                      R[i][2] * T[8 + j] + (j == 3 ? t[i] : 0.0f);
}

// Fixed-order block sum of K values a thread: shuffles within each warp,
// then the warps' sums in warp order.  The totals land in out[0..K).
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K],
                                          float (*part)[NRED], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) part[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = part[0][threadIdx.x];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      s += part[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

template <bool LINES>
__global__ void __launch_bounds__(MAX_THREADS)
    flow_pose_lm_kernel(const SdplFlowPoseLM a) {
  __shared__ float part[MAX_WARPS][NRED];
  __shared__ float tot[NRED];
  __shared__ float s_Tn[12], s_dxi[6], s_gd0, s_step, s_c;
  __shared__ int s_take;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int N = a.N, M = LINES ? a.M : 0;
  const bool active = !a.done[b] && a.it[b] < a.max_iterations;
  if (active) {   // the same for every thread of the block
    float T[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = a.T[16 * b + k];
    const float lam = a.lam[b];
    const float dl = a.delta_line[b];

    // ---- pass 1: the reduced damped system and the cost at (T, f, g) ----
    float acc[NRED];
#pragma unroll
    for (int k = 0; k < NRED; ++k) acc[k] = 0.0f;
    for (int q = tid; q < M + N; q += nt) {
      if (q < M) {
        const int j = b * M + q;
        if (!a.l_valid[j]) continue;
        LineLin o;
        line_lin(a, T, j, dl, lam, o);
        const float wl = o.wl;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int k = i; k < 6; ++k) {
            float yy = 0.0f;
#pragma unroll
            for (int p = 0; p < 4; ++p) yy += o.Y[p][i] * o.Y[p][k];
            acc[sym(i, k)] += wl * (o.Jx[0][i] * o.Jx[0][k] +
                                    o.Jx[1][i] * o.Jx[1][k]) - yy;
          }
          float yz = 0.0f;
#pragma unroll
          for (int p = 0; p < 4; ++p) yz += o.Y[p][i] * o.z[p];
          acc[21 + i] -= wl * o.e0 * o.Jx[0][i] + yz;
        }
        acc[27] += o.cost;
      } else {
        const int i = b * N + (q - M);
        if (!a.p_valid[i]) continue;
        PointLin o;
        point_lin(a, T, i, lam, o);
        // Hxx += (wp - wp^2 / hff) J^T J;  bx -= wp J^T (r + bf / hff)
        const float h = o.wp - o.wp * o.wp * o.inv;
        const float s0 = o.r[0] + o.inv * o.bf[0];
        const float s1 = o.r[1] + o.inv * o.bf[1];
#pragma unroll
        for (int r = 0; r < 6; ++r) {
#pragma unroll
          for (int c = r; c < 6; ++c)
            acc[sym(r, c)] += h * (o.Ju[r] * o.Ju[c] + o.Jv[r] * o.Jv[c]);
          acc[21 + r] -= o.wp * (o.Ju[r] * s0 + o.Jv[r] * s1);
        }
        acc[27] += o.cost;
      }
    }
    block_sum<NRED>(acc, part, tot);

    // ---- one thread: the pose step and the new pose ----
    if (tid == 0) {
      float A[6][7], dxi[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int k = 0; k < 6; ++k)
          A[i][k] = tot[i <= k ? sym(i, k) : sym(k, i)];
        A[i][i] += lam;
        A[i][6] = tot[21 + i];
      }
      solve6(A, dxi);
      float gd0 = 0.0f, step = 0.0f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        gd0 += dxi[i] * (lam * dxi[i] + tot[21 + i]);
        step += dxi[i] * dxi[i];
        s_dxi[i] = dxi[i];
      }
      s_gd0 = gd0;
      s_step = step;
      s_c = tot[27];
      se3_retract(dxi, T, s_Tn);
    }
    __syncthreads();

    // ---- pass 2: the flow steps, the gain's denominator, the new cost ----
    float dxi[6], Tn[12];
#pragma unroll
    for (int i = 0; i < 6; ++i) dxi[i] = s_dxi[i];
#pragma unroll
    for (int k = 0; k < 12; ++k) Tn[k] = s_Tn[k];
    float acc2[2] = {0.0f, 0.0f};   // gain denominator, new cost
    for (int q = tid; q < M + N; q += nt) {
      if (q < M) {
        const int j = b * M + q;
        if (!a.l_valid[j]) continue;
        LineLin o;
        line_lin(a, T, j, dl, lam, o);
        float dg[4], gn[4];
        line_step(o, dxi, dg);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          acc2[0] += dg[p] * (lam * dg[p] + o.bg[p]);
          gn[p] = a.g[4 * j + p] + dg[p];
          a.g_try[4 * j + p] = gn[p];
        }
        LineRes r;
        acc2[1] += line_cost(a, Tn, j, gn, dl, r);
      } else {
        const int i = b * N + (q - M);
        if (!a.p_valid[i]) continue;
        PointLin o;
        point_lin(a, T, i, lam, o);
        float ju = 0.0f, jv = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          ju += o.Ju[k] * dxi[k];
          jv += o.Jv[k] * dxi[k];
        }
        const float df0 = o.inv * (o.bf[0] - o.wp * ju);
        const float df1 = o.inv * (o.bf[1] - o.wp * jv);
        acc2[0] += df0 * (lam * df0 + o.bf[0]) + df1 * (lam * df1 + o.bf[1]);
        const float fn0 = a.f[2 * i] + df0, fn1 = a.f[2 * i + 1] + df1;
        a.f_try[2 * i] = fn0;
        a.f_try[2 * i + 1] = fn1;
        float xyz[3], rr[2], rf[2], chi2p;
        acc2[1] += point_cost(a, Tn, i, fn0, fn1, xyz, rr, rf, chi2p);
      }
    }
    block_sum<2>(acc2, part, tot);

    // ---- one thread: accept, damping, exit (lm_iteration's rules) ----
    if (tid == 0) {
      const float c = s_c, nc = tot[1];
      const float gain_den = s_gd0 + tot[0];
      const float rho = (c - nc) / clamp_min(gain_den, 1e-12f);
      const bool accept = rho > 0.0f && isfinite(nc);
      const float nu = a.nu[b];
      const float q = 2.0f * rho - 1.0f;
      const float lam_acc = lam * clamp_min(1.0f - q * q * q, 1.0f / 3.0f);
      const float lam_n = accept ? lam_acc : lam * nu;
      const bool done_n =
          (accept && (c - nc) < a.rel_tol * clamp_min(c, 1.0f)) ||
          (accept && s_step < 1e-16f) || lam_n > 1e30f;
      if (accept) {
#pragma unroll
        for (int k = 0; k < 12; ++k) a.T[16 * b + k] = Tn[k];
        a.cost[b] = nc;
      }
      a.lam[b] = lam_n;
      a.nu[b] = accept ? 2.0f : nu * 2.0f;
      a.it[b] += 1;
      a.done[b] = done_n;
      s_take = accept;
    }
    __syncthreads();

    // ---- an accepted step's flows ----
    if (s_take) {
      for (int q = tid; q < M + N; q += nt) {
        if (q < M) {
          const int j = b * M + q;
          if (!a.l_valid[j]) continue;
#pragma unroll
          for (int p = 0; p < 4; ++p) a.g[4 * j + p] = a.g_try[4 * j + p];
        } else {
          const int i = b * N + (q - M);
          if (!a.p_valid[i]) continue;
          a.f[2 * i] = a.f_try[2 * i];
          a.f[2 * i + 1] = a.f_try[2 * i + 1];
        }
      }
    }
  }

  // ---- the loop flag: the last block to get here sets it ----
  __syncthreads();
  if (tid == 0) {
    __threadfence();                    // this lane's state before the ticket
    const unsigned int t = atomicAdd(a.ticket, 1u);
    if (t == gridDim.x - 1) {
      __threadfence();
      const volatile uint8_t* done = a.done;
      const volatile int32_t* it = a.it;
      bool any = false;
      for (int l = 0; l < a.B; ++l)
        any = any || (!done[l] && it[l] < a.max_iterations);
      *a.active_any = any;
      *a.ticket = 0u;
      atomicAdd(&g_runs, 1ull);         // launches on other streams too
    }
  }
}

}  // namespace

extern "C" int sdpl_flow_pose_lm_max_threads() { return MAX_THREADS; }

// The kernel's runs so far on the current device, into *runs.  A copy on
// the legacy default stream: the caller synchronises the streams that
// launch the kernel first.  Returns the cudaError_t of the copy.
extern "C" int sdpl_flow_pose_lm_runs(unsigned long long* runs) {
  return (int)cudaMemcpyFromSymbol(runs, g_runs, sizeof(*runs));
}

// Plain C entry point (bound with ctypes): one LM iteration of every lane
// of *args, one launch of `threads` threads a lane (a multiple of 32, at
// most MAX_THREADS) on `stream`.  Returns the cudaError_t of the launch;
// never synchronises or allocates.
extern "C" int sdpl_flow_pose_lm_iteration(const SdplFlowPoseLM* args,
                                           int threads, void* stream) {
  if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      args->B < 0 || args->N < 0 || args->M < 0)
    return (int)cudaErrorInvalidValue;
  if (args->B == 0) return 0;
  const SdplFlowPoseLM a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.use_lines)
    flow_pose_lm_kernel<true><<<a.B, threads, 0, s>>>(a);
  else
    flow_pose_lm_kernel<false><<<a.B, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
