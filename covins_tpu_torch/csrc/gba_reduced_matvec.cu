// GBA reduced camera system: the observation part of its matrix-vector
// product, and the whole block-Jacobi PCG of one Gauss-Newton step.
//
// Replaces: the observation terms of reduced_Hv in covins_tpu/ops/gba.py::
// _gn_schur_step (Hpp_v's reprojection block :278-290, Hlp_v :305-309,
// Hpl_w :311-316, Hll_inv_apply :318-319, composed at :338-341), b_red's
// Hpl Hll^-1 b_l (:343), the ladder's Hlp dx (:426), and the Chronopoulos-
// Gear PCG loop that applies reduced_Hv 60 times per Gauss-Newton step
// (its `jax.lax.scan` at :399), which the reference runs inside one device
// program.
//
// The product is four phases over the observations' fixed CSRs and chunk
// layout (obs_graph in covins_tpu_torch/ops/gba.py):
//   Y  one thread per observation: y_o = J_pose,o v[kf_o], into scratch;
//   L  four lanes per landmark (three components): t = sum J_lm,o^T y_o
//      over the landmark's observations in lm_rowptr/lm_obs order, then
//      w = Hll^-1 (t + c) with the three components exchanged by shuffles;
//   K  one thread per (chunk, component): a keyframe's row of kf_obs is cut
//      into chunks of at most eight consecutive observations; each thread
//      sums its chunk's J_pose^T y_o and J_pose^T (J_lm,o w[lm_o]) apart;
//   N  one thread per (keyframe, component) adds its chunks' partials in
//      chunk order and subtracts, as the plain version does.
// Every thread loads the indices and blocks of four observations (eight
// chunk partials) before it adds any of them, so a dependent gather costs
// one memory latency per group rather than one per observation.
//
// Two entries, each one cooperative launch with grid-wide barriers
// between the phases:
// * covins_gba_reduced_matvec: Hpp(reproj) v - Hpl Hll^-1 (Hlp v + c)
//   (phases Y, L, K, N), or t = Hlp v alone (Y, L);
// * covins_gba_pcg: the `fused` branch of _gn_schur_step's PCG whole, for
//   n_cg iterations.  Each iteration:
//   A  per keyframe (16 lanes, 15 components): p = u + beta p,
//      s = w + beta s, x += alpha p, r -= alpha s, u = (M_inv r) f,
//      v = u f, with r exchanged by shuffles              (node-local)
//   B  phase Y on v; and per loop edge (8 lanes) and IMU factor (16
//      lanes) the rows of y = Ji v_i + Jj v_j, exchanged by shuffles, and
//      both ends' J^T y, into scratch
//   C  phase L;  D  phase K
//   E  per (keyframe, component): phase N, then the loop and IMU ends'
//      J^T y in the order of node -> factor CSRs built once per step (each
//      node's i ends in factor order, then its j ends: the order of the
//      plain version's index_adds), w = out f + lam_diag v, and the
//      block's partial sums of gamma = r.u and delta = w.u into its slot
//   F  every block adds all slots in index order, so every block holds
//      the same scalars without another barrier; beta and alpha follow,
//      and the next iteration's phase A at once.
//   The grid is the kernel's occupancy times the SM count, capped at the
//   blocks the largest phase can use; a refused cooperative launch returns
//   its error and the caller raises.
//
// Bound on the H100, at the main path's bench.py problem (53.9k
// observations, 8192 landmarks, 256 keyframes, 255 IMU factors): the
// inputs read once are about 10 MB (each observation's whitened 2x6 and
// 2x3 Jacobians and indices, the 3x3 and 15x15 inverse blocks, the IMU
// factors' 15x15 Jacobians), 3 us at 3.35 TB/s; one iteration is about
// 96 float64 operations per observation, 1800 per IMU factor and 700 per
// keyframe, 6 MFLOP, so 60 iterations take at least 10.5 us at 34 TFLOP/s:
// bound by operations.  One product alone (0.3 MFLOP, 8 MB) is bound by
// bytes, 2.8 us.  In practice each phase is a few dependent gathers and
// each barrier about a microsecond: latency, not bandwidth, sets the time.
//
// The float64 tensor cores (DMMA, 8x8x4 tiles) are not used: each product
// is a 2x6, 2x3, 3x3, 6x6 or 15x15 block times one vector, with no reuse of
// the block, so a tile would be padded and still do a matrix-vector
// product; the phases are bound by dependent gathers and barriers, not by
// the FMA rate.
//
// Determinism: the reference scatter-adds in both directions; float64
// atomics would add in an order that changes between runs, which 60 CG
// steps amplify.  Here there are none: every sum runs in an order fixed by
// the CSRs and the chunk layout built once per problem and the factor
// CSRs built once per step, and the dot products add per-thread sums,
// per-block tree sums and the block slots in index order.  Two launches
// on the same card give the same bits.  The source is built without FMA
// contraction.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int KF_DOF = 15;
constexpr int STAGE = 4;  // observations whose loads are issued together
constexpr int PART_STAGE = 8;  // chunk partials likewise

int span32(int n) { return (n + 31) & ~31; }
__device__ inline int span32_d(int n) { return (n + 31) & ~31; }

// the observations, their CSRs and chunk layout, and the scratch of one
// product
struct Obs {
  const double* Jp;       // (O, 2, 6)
  const double* Jl;       // (O, 2, 3)
  const double* Hll_inv;  // (M, 3, 3)
  const int32_t* obs_kf;  // (O,)
  const int32_t* obs_lm;
  const int32_t* lm_rowptr;  // (M + 1,)
  const int32_t* lm_obs;     // (O,)
  int M;
  const int32_t* kf_obs;        // (O,)
  const int32_t* chunk_ptr;     // (C + 1,) into kf_obs
  const int32_t* kf_chunk_ptr;  // (N + 1,)
  int C;
  int N;
  int O;
  double* y;     // (O, 2): J_pose v
  double* t;     // (M, 3) or null
  double* w;     // (M, 3)
  double* part;  // (C, 12): [sum J_pose^T y, sum J_pose^T J_lm w]
};

// phase Y for observation ob: v (N, vstride)
__device__ inline void obs_y(const Obs& o, int ob, const double* __restrict__ v,
                             int vstride) {
  const double* J = o.Jp + 12 * (int64_t)ob;
  const double* vk = v + vstride * (int64_t)o.obs_kf[ob];
  for (int r = 0; r < 2; ++r) {
    double s = 0.0;
    for (int k = 0; k < 6; ++k) s += J[6 * r + k] * vk[k];
    o.y[2 * (int64_t)ob + r] = s;
  }
}

// phase L for lane q of the landmark span (a whole warp calls it); has_v
// false stands for v = 0, c (M, 3) or null for zeros
__device__ inline void landmark_lane(const Obs& o, int q, bool has_v,
                                     const double* __restrict__ c, bool t_only) {
  const int l = q >> 2;
  const int i = q & 3;
  const bool on = l < o.M && i < 3;
  double t = 0.0;
  if (on && has_v) {
    const int end = o.lm_rowptr[l + 1];
    for (int k = o.lm_rowptr[l]; k < end; k += STAGE) {
      int ob[STAGE];
      double a0[STAGE], a1[STAGE], y0[STAGE], y1[STAGE];
#pragma unroll
      for (int j = 0; j < STAGE; ++j) ob[j] = k + j < end ? o.lm_obs[k + j] : -1;
#pragma unroll
      for (int j = 0; j < STAGE; ++j) {
        if (ob[j] < 0) continue;
        const double* J = o.Jl + 6 * (int64_t)ob[j];
        a0[j] = J[i];
        a1[j] = J[3 + i];
        y0[j] = o.y[2 * (int64_t)ob[j]];
        y1[j] = o.y[2 * (int64_t)ob[j] + 1];
      }
#pragma unroll
      for (int j = 0; j < STAGE; ++j)
        if (ob[j] >= 0) t += a0[j] * y0[j] + a1[j] * y1[j];
    }
  }
  if (on && o.t != nullptr) o.t[3 * (int64_t)l + i] = t;
  if (t_only) return;  // uniform: the same for the whole launch
  const double u = on && c != nullptr ? t + c[3 * (int64_t)l + i] : t;
  const double u0 = __shfl_sync(FULL, u, 0, 4);
  const double u1 = __shfl_sync(FULL, u, 1, 4);
  const double u2 = __shfl_sync(FULL, u, 2, 4);
  if (on) {
    const double* H = o.Hll_inv + 9 * (int64_t)l + 3 * i;
    o.w[3 * (int64_t)l + i] = (H[0] * u0 + H[1] * u1) + H[2] * u2;
  }
}

// phase K for (chunk, component k)
__device__ inline void chunk_item(const Obs& o, int q, bool has_v) {
  const int ch = q / 6;
  const int k = q - 6 * ch;
  const int end = o.chunk_ptr[ch + 1];
  double a = 0.0;
  double b = 0.0;
  for (int pos = o.chunk_ptr[ch]; pos < end; pos += STAGE) {
    int ob[STAGE], lm[STAGE];
    double j0[STAGE], j1[STAGE], y0[STAGE], y1[STAGE], L[STAGE][6];
#pragma unroll
    for (int j = 0; j < STAGE; ++j) ob[j] = pos + j < end ? o.kf_obs[pos + j] : -1;
#pragma unroll
    for (int j = 0; j < STAGE; ++j) {
      if (ob[j] < 0) continue;
      const int64_t e = ob[j];
      lm[j] = o.obs_lm[e];
      j0[j] = o.Jp[12 * e + k];
      j1[j] = o.Jp[12 * e + 6 + k];
      for (int r = 0; r < 6; ++r) L[j][r] = o.Jl[6 * e + r];
      if (has_v) {
        y0[j] = o.y[2 * e];
        y1[j] = o.y[2 * e + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < STAGE; ++j) {
      if (ob[j] < 0) continue;
      const double* wl = o.w + 3 * (int64_t)lm[j];
      const double w0 = wl[0], w1 = wl[1], w2 = wl[2];
      const double z0 = (L[j][0] * w0 + L[j][1] * w1) + L[j][2] * w2;
      const double z1 = (L[j][3] * w0 + L[j][4] * w1) + L[j][5] * w2;
      if (has_v) a += j0[j] * y0[j] + j1[j] * y1[j];
      b += j0[j] * z0 + j1[j] * z1;
    }
  }
  o.part[12 * (int64_t)ch + k] = a;
  o.part[12 * (int64_t)ch + 6 + k] = b;
}

// phase N for (keyframe, component k < 6): the chunks' partials in order
__device__ inline double keyframe_sum(const Obs& o, int kf, int k) {
  double a = 0.0;
  double b = 0.0;
  const int end = o.kf_chunk_ptr[kf + 1];
  for (int ch = o.kf_chunk_ptr[kf]; ch < end; ch += PART_STAGE) {
    double pa[PART_STAGE], pb[PART_STAGE];
#pragma unroll
    for (int j = 0; j < PART_STAGE; ++j) {
      if (ch + j >= end) continue;
      pa[j] = o.part[12 * (int64_t)(ch + j) + k];
      pb[j] = o.part[12 * (int64_t)(ch + j) + 6 + k];
    }
#pragma unroll
    for (int j = 0; j < PART_STAGE; ++j) {
      if (ch + j >= end) continue;
      a += pa[j];
      b += pb[j];
    }
  }
  return a - b;
}

__global__ void __launch_bounds__(THREADS) matvec_kernel(Obs o, const double* __restrict__ v,
                                                         const double* __restrict__ c,
                                                         int t_only, double* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const bool has_v = v != nullptr;
  if (has_v)
    for (int q = tid; q < o.O; q += nthreads) obs_y(o, q, v, 6);
  grid.sync();
  const int lm_span = span32_d(4 * o.M);
  for (int q = tid; q < lm_span; q += nthreads) landmark_lane(o, q, has_v, c, t_only != 0);
  if (t_only) return;  // the whole grid
  grid.sync();
  for (int q = tid; q < 6 * o.C; q += nthreads) chunk_item(o, q, has_v);
  grid.sync();
  for (int q = tid; q < 6 * o.N; q += nthreads) out[q] = keyframe_sum(o, q / 6, q % 6);
}

// ------------------------------------------------------------------ PCG
// a loop-edge (D = 6) or IMU (D = 15) factor set: Jacobians w.r.t. the
// first D components of its two keyframes, and its node -> entry CSR
struct Factors {
  const int32_t* fi;  // (F,)
  const int32_t* fj;
  const double* Ji;  // (F, D, D)
  const double* Jj;
  int F;
  const int32_t* rowptr;   // (N + 1,)
  const int32_t* entries;  // (2F,): f < F is factor f's i end, F + f its j end
  double* contrib;         // (2F, D): entry e's J^T y
};

// lane q of a factor set's span (whole warps; LANES per factor, a power of
// two >= D): lane r forms row r of y = Ji v_i + Jj v_j, then, with the rows
// exchanged, component r of Ji^T y and Jj^T y
template <int D, int LANES>
__device__ inline void factor_lane(const Factors& f, int q, const double* __restrict__ v) {
  const int e = q / LANES;
  const int r = q % LANES;
  const bool on = e < f.F && r < D;
  const double* A = f.Ji + D * D * (int64_t)e;
  const double* B = f.Jj + D * D * (int64_t)e;
  double y = 0.0;
  if (on) {
    const double* vi = v + KF_DOF * (int64_t)f.fi[e];
    const double* vj = v + KF_DOF * (int64_t)f.fj[e];
    double yi = 0.0;
    double yj = 0.0;
    for (int s = 0; s < D; ++s) {
      yi += A[D * r + s] * vi[s];
      yj += B[D * r + s] * vj[s];
    }
    y = yi + yj;
  }
  double ci = 0.0;
  double cj = 0.0;
  for (int s = 0; s < D; ++s) {
    const double ys = __shfl_sync(FULL, y, s, LANES);
    if (on) {
      ci += A[D * s + r] * ys;
      cj += B[D * s + r] * ys;
    }
  }
  if (on) {
    f.contrib[D * (int64_t)e + r] = ci;
    f.contrib[D * ((int64_t)f.F + e) + r] = cj;
  }
}

// component k < D of node's factor ends, added to acc in CSR order
template <int D>
__device__ inline double factor_terms(const Factors& f, int node, int k, double acc) {
  const int end = f.rowptr[node + 1];
  for (int q = f.rowptr[node]; q < end; q += STAGE) {
    double cv[STAGE];
#pragma unroll
    for (int j = 0; j < STAGE; ++j)
      if (q + j < end) cv[j] = f.contrib[D * (int64_t)f.entries[q + j] + k];
#pragma unroll
    for (int j = 0; j < STAGE; ++j)
      if (q + j < end) acc += cv[j];
  }
  return acc;
}

__device__ inline double safe_div(double a, double b) {
  return a / (fabs(b) < 1e-30 ? 1e-30 : b);
}

// the block's sums of a and b, the same value in every thread, in a
// fixed order
__device__ inline void block_sum2(double& a, double& b, double (*red)[WARPS]) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(FULL, a, off);
    b += __shfl_down_sync(FULL, b, off);
  }
  __syncthreads();  // earlier readers of red are done
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  a = red[0][0];
  b = red[1][0];
  for (int k = 1; k < WARPS; ++k) {
    a += red[0][k];
    b += red[1][k];
  }
}

struct Pcg {
  Obs o;
  Factors loop;  // D = 6
  Factors imu;   // D = 15, F = 0 when visual only
  const double* b;         // (N, 15)
  const double* M_inv;     // (N, 15, 15)
  const double* free_;     // (N, 15)
  const double* lam_diag;  // (N, 15)
  int n_cg;
  double* x;  // (N, 15) each
  double* r;
  double* u;
  double* v;  // u * free, the vector the product is applied to
  double* p;
  double* s;
  double* w;
  double* slots;  // (gridDim.x, 2)
};

__global__ void __launch_bounds__(THREADS) pcg_kernel(Pcg a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double red[2][WARPS];
  const Obs& o = a.o;
  const int N = o.N;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int node_span = span32_d(16 * N);  // 16 lanes per keyframe
  const int lm_span = span32_d(4 * o.M);
  const int obs_span = span32_d(o.O);
  const int loop_span = span32_d(8 * a.loop.F);
  const int b_span = obs_span + loop_span + span32_d(16 * a.imu.F);
  double alpha = 0.0, beta = 0.0, gamma = 0.0;
  for (int it = 0;; ++it) {
    // A
    for (int q = tid; q < node_span; q += nthreads) {
      const int node = q >> 4;
      const int k = q & 15;
      const bool on = node < N && k < KF_DOF;
      const int64_t idx = KF_DOF * (int64_t)node + k;
      double rk = 0.0;
      if (on) {
        if (it == 0) {
          rk = a.b[idx];
          a.x[idx] = 0.0;
        } else {
          const double pk = it == 1 ? a.u[idx] : a.u[idx] + beta * a.p[idx];
          const double sk = it == 1 ? a.w[idx] : a.w[idx] + beta * a.s[idx];
          a.p[idx] = pk;
          a.s[idx] = sk;
          a.x[idx] = a.x[idx] + alpha * pk;
          rk = a.r[idx] - alpha * sk;
        }
        a.r[idx] = rk;
      }
      const double* Mk = a.M_inv + KF_DOF * KF_DOF * (int64_t)node + KF_DOF * k;
      double uk = 0.0;
      for (int c = 0; c < KF_DOF; ++c) {
        const double rc = __shfl_sync(FULL, rk, c, 16);
        if (on) uk += Mk[c] * rc;
      }
      if (on) {
        const double f = a.free_[idx];
        uk = uk * f;
        a.u[idx] = uk;
        a.v[idx] = uk * f;
      }
    }
    if (it == a.n_cg) break;
    grid.sync();
    // B
    for (int q = tid; q < b_span; q += nthreads) {
      if (q < obs_span) {
        if (q < o.O) obs_y(o, q, a.v, KF_DOF);
      } else if (q < obs_span + loop_span) {
        factor_lane<6, 8>(a.loop, q - obs_span, a.v);  // whole warps
      } else {
        factor_lane<KF_DOF, 16>(a.imu, q - obs_span - loop_span, a.v);  // whole warps
      }
    }
    grid.sync();
    // C
    for (int q = tid; q < lm_span; q += nthreads) landmark_lane(o, q, true, nullptr, false);
    grid.sync();
    // D
    for (int q = tid; q < 6 * o.C; q += nthreads) chunk_item(o, q, true);
    grid.sync();
    // E
    double gp = 0.0, dp = 0.0;
    for (int q = tid; q < node_span; q += nthreads) {
      const int node = q >> 4;
      const int k = q & 15;
      if (node < N && k < KF_DOF) {
        const int64_t idx = KF_DOF * (int64_t)node + k;
        double out = 0.0;
        if (k < 6) out = factor_terms<6>(a.loop, node, k, keyframe_sum(o, node, k));
        out = factor_terms<KF_DOF>(a.imu, node, k, out);
        const double uk = a.u[idx];
        const double wk = out * a.free_[idx] + a.lam_diag[idx] * a.v[idx];
        a.w[idx] = wk;
        gp += a.r[idx] * uk;
        dp += wk * uk;
      }
    }
    block_sum2(gp, dp, red);
    if (threadIdx.x == 0) {
      a.slots[2 * blockIdx.x] = gp;
      a.slots[2 * blockIdx.x + 1] = dp;
    }
    grid.sync();
    // F
    double g1 = 0.0, d1 = 0.0;
    for (int q = threadIdx.x; q < (int)gridDim.x; q += THREADS) {
      g1 += a.slots[2 * q];
      d1 += a.slots[2 * q + 1];
    }
    block_sum2(g1, d1, red);
    if (it == 0) {
      alpha = safe_div(g1, d1);
    } else {
      beta = safe_div(g1, gamma);
      alpha = safe_div(g1, d1 - safe_div(beta * g1, alpha));
    }
    gamma = g1;
  }
}

Obs make_obs(const void* Jp, const void* Jl, const void* Hll_inv, const void* obs_kf,
              const void* obs_lm, const void* lm_rowptr, const void* lm_obs, int M,
              const void* kf_obs, const void* chunk_ptr, const void* kf_chunk_ptr, int C,
              int N, int O, void* y, void* t, void* w, void* part) {
  return Obs{static_cast<const double*>(Jp),        static_cast<const double*>(Jl),
             static_cast<const double*>(Hll_inv),   static_cast<const int32_t*>(obs_kf),
             static_cast<const int32_t*>(obs_lm),   static_cast<const int32_t*>(lm_rowptr),
             static_cast<const int32_t*>(lm_obs),   M,
             static_cast<const int32_t*>(kf_obs),   static_cast<const int32_t*>(chunk_ptr),
             static_cast<const int32_t*>(kf_chunk_ptr),
             C,                                     N,
             O,                                     static_cast<double*>(y),
             static_cast<double*>(t),               static_cast<double*>(w),
             static_cast<double*>(part)};
}

}  // namespace

// v6 (N, 6) or null (zeros), c (M, 3) or null (zeros), Jp (O, 2, 6),
// Jl (O, 2, 3), Hll_inv (M, 3, 3) float64; obs_kf, obs_lm (O,) int32;
// lm_rowptr (M + 1,), lm_obs (O,), kf_obs (O,) int32, the CSRs; chunk_ptr
// (C + 1,), kf_chunk_ptr (N + 1,) int32, the chunk layout; y (O, 2),
// w (M, 3) and part (C, 12) scratch; t_out (M, 3) = Hlp v6; out (N, 6)
// unless t_only.
extern "C" int covins_gba_reduced_matvec(const void* v6, const void* c, const void* Jp,
                                         const void* Jl, const void* Hll_inv,
                                         const void* obs_kf, const void* obs_lm,
                                         const void* lm_rowptr, const void* lm_obs, int M,
                                         const void* kf_obs, const void* chunk_ptr,
                                         const void* kf_chunk_ptr, int C, int N, int O,
                                         int t_only, void* y, void* t_out, void* w,
                                         void* part, void* out, void* stream) {
  if (N <= 0 && M <= 0) return 0;
  Obs o = make_obs(Jp, Jl, Hll_inv, obs_kf, obs_lm, lm_rowptr, lm_obs, M, kf_obs, chunk_ptr,
                   kf_chunk_ptr, C, N, O, y, t_out, w, part);
  const double* v = static_cast<const double*>(v6);
  const double* cc = static_cast<const double*>(c);
  double* o_ = static_cast<double*>(out);
  void* args[] = {&o, &v, &cc, &t_only, &o_};
  const int items = std::max(std::max(O, span32(4 * M)), std::max(6 * C, 6 * N));
  return coop::launch(matvec_kernel, THREADS, 0, items, 1 << 30, coop::Slots::kRefuse, args,
                      static_cast<cudaStream_t>(stream));
}

// b (N, 15), M_inv (N, 15, 15), free (N, 15), lam_diag (N, 15) float64;
// the observations as above; loop factors: loop_i, loop_j (L,) int32,
// Ji_l, Jj_l (L, 6, 6), loop_rowptr (N + 1,), loop_entries (2L,) int32;
// IMU factors the same with (F, 15, 15) Jacobians (F = 0 when visual
// only); work (7, N, 15) holds x (the result, first), r, u, v, p, s, w;
// y (O, 2), w_lm (M, 3), part (C, 12), contrib_l (2L, 6), contrib_f
// (2F, 15), slots (slot_cap, 2) scratch.
extern "C" int covins_gba_pcg(const void* b, const void* M_inv, const void* free_,
                              const void* lam_diag, const void* Jp, const void* Jl,
                              const void* Hll_inv, const void* obs_kf, const void* obs_lm,
                              const void* lm_rowptr, const void* lm_obs, int M,
                              const void* kf_obs, const void* chunk_ptr,
                              const void* kf_chunk_ptr, int C, int N, int O,
                              const void* loop_i, const void* loop_j, const void* Ji_l,
                              const void* Jj_l, int L, const void* loop_rowptr,
                              const void* loop_entries, const void* imu_i, const void* imu_j,
                              const void* Ji_f, const void* Jj_f, int F,
                              const void* imu_rowptr, const void* imu_entries, int n_cg,
                              void* work, void* y, void* w_lm, void* part, void* contrib_l,
                              void* contrib_f, void* slots, int slot_cap, void* stream) {
  if (N <= 0) return 0;
  double* wk = static_cast<double*>(work);
  const int64_t vec = KF_DOF * (int64_t)N;
  Pcg a{make_obs(Jp, Jl, Hll_inv, obs_kf, obs_lm, lm_rowptr, lm_obs, M, kf_obs, chunk_ptr,
                 kf_chunk_ptr, C, N, O, y, nullptr, w_lm, part),
        Factors{static_cast<const int32_t*>(loop_i), static_cast<const int32_t*>(loop_j),
                static_cast<const double*>(Ji_l), static_cast<const double*>(Jj_l), L,
                static_cast<const int32_t*>(loop_rowptr),
                static_cast<const int32_t*>(loop_entries), static_cast<double*>(contrib_l)},
        Factors{static_cast<const int32_t*>(imu_i), static_cast<const int32_t*>(imu_j),
                static_cast<const double*>(Ji_f), static_cast<const double*>(Jj_f), F,
                static_cast<const int32_t*>(imu_rowptr),
                static_cast<const int32_t*>(imu_entries), static_cast<double*>(contrib_f)},
        static_cast<const double*>(b),
        static_cast<const double*>(M_inv),
        static_cast<const double*>(free_),
        static_cast<const double*>(lam_diag),
        n_cg,
        wk,
        wk + vec,
        wk + 2 * vec,
        wk + 3 * vec,
        wk + 4 * vec,
        wk + 5 * vec,
        wk + 6 * vec,
        static_cast<double*>(slots)};
  void* args[] = {&a};
  const int items = std::max(std::max(span32(O) + span32(8 * L) + span32(16 * F),
                                      span32(4 * M)),
                             std::max(6 * C, span32(16 * N)));
  return coop::launch(pcg_kernel, THREADS, 0, items, slot_cap, coop::Slots::kRefuse, args,
                      static_cast<cudaStream_t>(stream));
}
