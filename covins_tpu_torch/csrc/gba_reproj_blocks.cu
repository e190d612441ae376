// GBA reprojection factors: residuals, Jacobians and their per-keyframe and
// per-landmark normal-equation blocks; the reprojection cost of S states;
// or the outlier norm.
//
// Replaces: covins_tpu/ops/gba.py::_reproj_r_J (line 115, jax.jacfwd of
// the reprojection residual per observation under jax.vmap) with the
// observation scatter-adds of _gn_schur_step (:255-275 for b and the 6x6
// blocks, :317-322 for the landmark side), the reprojection part of
// total_cost (:406-415) under the step ladder's jax.vmap (:434-438), and
// _reproj_outlier_mask (:470-482).
//
// Bound on the H100, at the main path's 52.6k observations: a
// linearisation reads 7 + 3 + 2 + 3 float64 values per observation and
// writes 2 + 12 + 6, about 14 MB with the blocks, 4 us at 3.35 TB/s, and
// its function needs about 433 float64 operations per observation and 90
// per keyframe (0.023 GFLOP, 0.7 us at 34 TFLOP/s): bound by bytes.  A
// cost evaluation of S states reads the observations once and S states;
// its function needs about 111 operations per observation and state (122
// with the Huber weight) and 54 per keyframe and state for the inverse of
// T_w_s, which the kernel recomputes per observation.  chip_smoke.py's
// gba_bytes_ops counts both from each input.
//
// Design, one launch per call:
// * linearise, one cooperative launch: phase 1 gives each chunk of a
//   keyframe's observations (at most eight consecutive kf_obs entries,
//   ObsGraph.chunk_ptr in covins_tpu_torch/ops/gba.py) eight lanes, one
//   observation each: the residual in the plain version's operation order
//   (ops/residuals.py, geometry.cuh), the written-out Jacobians d uv / d
//   p_c * R_c_s * [[p_s]x | -I] and ... * R_w_s^T, the reference's weights
//   (1/sigma, validity, landmark and keyframe masks, Huber sqrt(min(1, k /
//   |r w|))), stored as r, J_pose, J_lm; then the chunk's 6 + 21 partial
//   sums of b = -J^T r and the 6x6 block's upper triangle, added across
//   the eight lanes by a fixed shuffle tree.  Grid barrier.  Phase 2: one
//   thread per (keyframe, entry) adds its chunks' partials in
//   kf_chunk_ptr order; one thread per (landmark, row) adds its
//   observations' terms in lm_obs order.  No atomics: two launches give
//   the same bits.  (The design it replaces summed each keyframe in one
//   warp, 42 doubles of state per lane, by 32 serial shuffles per
//   observation group.)
// * cost, one cooperative launch over S stacked states: every thread sums
//   its grid-stride observations' |r w|^2 per state, each block adds its
//   threads by a fixed tree into its slot; grid barrier; one thread per
//   state adds the slots in block order.
// * outlier: one thread per observation, ||r|| / sigma.
// The norms use IEEE sqrt, as the plain version's correctly rounded square
// root, and the source is built without FMA contraction, so an
// observation falls on the same side of th_gba_outlier_global.
// The projection above is the pinhole camera's with no or radtan
// distortion.  For the other cameras (the unified model; equidistant or FOV
// distortion) the caller computes each observation's pixel, validity and,
// to linearise, d uv / d p_c in PyTorch (cameras.project3_jacobian) and
// the kernel reads them in place of its projection: every mode, the same
// sums.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"
#include "geometry.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 8;  // lanes per chunk: ObsGraph's KF_CHUNK
constexpr int KF_TERMS = 6 + 21;  // b and the 6x6 block's upper triangle

// the problem and its observation graph
struct Problem {
  const double* poses;  // (N, 7), or (S, N, 7) in the cost mode
  const double* lms;    // (M, 3), or (S, M, 3)
  const double* cam;    // [fx, fy, cx, cy, k1, k2, p1, p2, T_s_c(7)]
  int dist_model;
  const double* uv;    // (O, 2)
  const double* w;     // (O,) obs_w * obs_mask (obs_w alone in the outlier mode)
  const double* kf_m;  // (N,)
  const double* lm_m;  // (M,)
  const int32_t* obs_kf;
  const int32_t* obs_lm;
  int O, N, M;
  const int32_t* kf_obs;        // (O,)
  const int32_t* chunk_ptr;     // (C + 1,)
  const int32_t* kf_chunk_ptr;  // (N + 1,)
  int C;
  const int32_t* lm_rowptr;  // (M + 1,)
  const int32_t* lm_obs;     // (O,)
  double huber_k;
  // the projection given by the caller, or null: uv (O, 2), valid (O,)
  // (both with a leading S in the cost mode) and d uv / d p_c (O, 2, 3)
  const double* guv;
  const uint8_t* gvalid;
  const double* gP;
};

// one observation's whitened residual, validity and weight, and with JAC
// its whitened Jacobians; OUTLIER gives the raw norm times w instead
struct Term {
  double r0, r1, ww;
  bool valid;
  double Jp[12], Jl[6];
};

// guv, gvalid: the given projection of this state (null: project here)
template <bool JAC, bool OUTLIER>
__device__ inline Term observe(const Problem& a, const double* poses, const double* lms,
                              const double* guv, const uint8_t* gvalid, int o) {
  Term t;
  const int kf = a.obs_kf[o];
  const int lm = a.obs_lm[o];
  const double* T = poses + 7 * (int64_t)kf;
  const double* cam = a.cam;
  const double fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3];
  const bool given = guv != nullptr;
  // p_s = T_w_s^-1 X, p_c = T_s_c^-1 p_s
  double qsw[4], qcs[4];
  V3 tsw, tcs, ps{0.0, 0.0, 0.0};
  if (JAC || !given) {
    pose_inverse(T, qsw, tsw);
    pose_inverse(cam + 8, qcs, tcs);
    const V3 X{lms[3 * (int64_t)lm], lms[3 * (int64_t)lm + 1], lms[3 * (int64_t)lm + 2]};
    const V3 rs = qrot(qsw, X);
    ps = V3{rs.x + tsw.x, rs.y + tsw.y, rs.z + tsw.z};
  }
  double P[6];  // d uv / d p_c
  double r0, r1;
  if (given) {
    t.valid = gvalid[o] != 0;
    r0 = guv[2 * (int64_t)o] - a.uv[2 * (int64_t)o];
    r1 = guv[2 * (int64_t)o + 1] - a.uv[2 * (int64_t)o + 1];
    if (JAC)
      for (int e = 0; e < 6; ++e) P[e] = a.gP[6 * (int64_t)o + e];
  } else {
    const V3 rc = qrot(qcs, ps);
    const V3 pc{rc.x + tcs.x, rc.y + tcs.y, rc.z + tcs.z};
    // pinhole projection
    t.valid = pc.z > 1e-6;
    const double zs = t.valid ? pc.z : 1.0;
    const double xn = pc.x / zs, yn = pc.y / zs;
    double xd = xn, yd = yn, dxx = 1.0, dxy = 0.0, dyx = 0.0, dyy = 1.0;
    if (a.dist_model != 0) {
      if (JAC)
        radtan_with_jacobian(cam + 4, xn, yn, xd, yd, dxx, dxy, dyx, dyy);
      else
        distort_radtan(cam + 4, xn, yn, xd, yd);
    }
    r0 = (fx * xd + cx) - a.uv[2 * (int64_t)o];
    r1 = (fy * yd + cy) - a.uv[2 * (int64_t)o + 1];
    if (JAC) {  // project3_jacobian's pinhole form
      const double iz = 1.0 / zs;
      const double vz = t.valid ? iz : 0.0;
      P[0] = fx * (dxx * iz);
      P[1] = fx * (dxy * iz);
      P[2] = fx * (-(dxx * xn + dxy * yn) * vz);
      P[3] = fy * (dyx * iz);
      P[4] = fy * (dyy * iz);
      P[5] = fy * (-(dyx * xn + dyy * yn) * vz);
    }
  }
  if (OUTLIER) {  // ||r|| / sigma
    t.r0 = sqrt(r0 * r0 + r1 * r1) * a.w[o];
    return t;
  }
  double ww = ((a.w[o] * (t.valid ? 1.0 : 0.0)) * a.lm_m[lm]) * a.kf_m[kf];
  if (a.huber_k > 0.0) {
    const double ra = r0 * ww, rb = r1 * ww;
    const double rn = sqrt(ra * ra + rb * rb);
    ww = ww * sqrt(fmin(a.huber_k / fmax(rn, 1e-12), 1.0));
  }
  t.ww = ww;
  t.r0 = r0 * ww;
  t.r1 = r1 * ww;
  if (!JAC) return t;
  // d uv / d p_c through R_c_s
  double Rcs[9], Rws[9];
  qmat(qcs, Rcs);
  qmat(T, Rws);
  double PR[6];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 3; ++j)
      PR[3 * i + j] = (P[3 * i] * Rcs[j] + P[3 * i + 1] * Rcs[3 + j]) + P[3 * i + 2] * Rcs[6 + j];
  // [[p_s]x | -I] and R_w_s^T
  const double H[9] = {0.0, -ps.z, ps.y, ps.z, 0.0, -ps.x, -ps.y, ps.x, 0.0};
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 3; ++j) {
      t.Jp[6 * i + j] =
          ((PR[3 * i] * H[j] + PR[3 * i + 1] * H[3 + j]) + PR[3 * i + 2] * H[6 + j]) * ww;
      t.Jp[6 * i + 3 + j] = -PR[3 * i + j] * ww;
      t.Jl[3 * i + j] =
          ((PR[3 * i] * Rws[3 * j] + PR[3 * i + 1] * Rws[3 * j + 1]) + PR[3 * i + 2] * Rws[3 * j + 2]) * ww;
    }
  }
  return t;
}

struct Blocks {
  double* r;     // (O, 2)
  double* Jp;    // (O, 2, 6)
  double* Jl;    // (O, 2, 3)
  double* part;  // (C, 27) chunk partials
  double* b6;    // (N, 6)
  double* M6;    // (N, 6, 6)
  double* bl;    // (M, 3)
  double* Hll;   // (M, 3, 3)
};

__global__ void __launch_bounds__(THREADS) linearize_kernel(Problem a, Blocks out) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (CHUNK - 1);
  // phase 1: a warp takes 32 / CHUNK chunks at a time, the same count of
  // iterations in every lane, so the shuffles see the whole warp
  constexpr int PER_WARP = 32 / CHUNK;
  const int nwarps = gridDim.x * WARPS;
  for (int c0 = PER_WARP * (blockIdx.x * WARPS + (threadIdx.x >> 5)); c0 < a.C;
       c0 += PER_WARP * nwarps) {
    const int ch = c0 + lane / CHUNK;
    double s[KF_TERMS];
#pragma unroll
    for (int e = 0; e < KF_TERMS; ++e) s[e] = 0.0;
    if (ch < a.C) {
      const int pos = a.chunk_ptr[ch] + sub;
      if (pos < a.chunk_ptr[ch + 1]) {
        const int o = a.kf_obs[pos];
        const Term t = observe<true, false>(a, a.poses, a.lms, a.guv, a.gvalid, o);
        out.r[2 * (int64_t)o] = t.r0;
        out.r[2 * (int64_t)o + 1] = t.r1;
        for (int e = 0; e < 12; ++e) out.Jp[12 * (int64_t)o + e] = t.Jp[e];
        for (int e = 0; e < 6; ++e) out.Jl[6 * (int64_t)o + e] = t.Jl[e];
        int e = 6;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          s[i] = -(t.Jp[i] * t.r0 + t.Jp[6 + i] * t.r1);
#pragma unroll
          for (int j = i; j < 6; ++j) s[e++] = t.Jp[i] * t.Jp[j] + t.Jp[6 + i] * t.Jp[6 + j];
        }
      }
    }
#pragma unroll
    for (int off = CHUNK / 2; off > 0; off >>= 1)
#pragma unroll
      for (int e = 0; e < KF_TERMS; ++e) s[e] += __shfl_down_sync(FULL, s[e], off, CHUNK);
    if (ch < a.C && sub == 0)
#pragma unroll
      for (int e = 0; e < KF_TERMS; ++e) out.part[KF_TERMS * (int64_t)ch + e] = s[e];
  }
  grid.sync();

  // phase 2: keyframes (27 entries each), then landmarks (3 rows each)
  for (int q = tid; q < KF_TERMS * a.N + 3 * a.M; q += nthreads) {
    if (q < KF_TERMS * a.N) {
      const int kf = q / KF_TERMS;
      const int e = q - KF_TERMS * kf;
      double v = 0.0;
      for (int ch = a.kf_chunk_ptr[kf]; ch < a.kf_chunk_ptr[kf + 1]; ++ch)
        v += out.part[KF_TERMS * (int64_t)ch + e];
      if (e < 6) {
        out.b6[6 * (int64_t)kf + e] = v;
      } else {  // entry (i, j), i <= j, of the upper triangle, row by row
        int i = 0, k = e - 6;
        while (k >= 6 - i) {
          k -= 6 - i;
          ++i;
        }
        const int j = i + k;
        out.M6[36 * (int64_t)kf + 6 * i + j] = v;
        out.M6[36 * (int64_t)kf + 6 * j + i] = v;
      }
    } else {
      const int ql = q - KF_TERMS * a.N;
      const int l = ql / 3;
      const int i = ql - 3 * l;
      double b = 0.0, h0 = 0.0, h1 = 0.0, h2 = 0.0;
      for (int k = a.lm_rowptr[l]; k < a.lm_rowptr[l + 1]; ++k) {
        const int64_t o = a.lm_obs[k];
        const double* J = out.Jl + 6 * o;
        const double r0 = out.r[2 * o], r1 = out.r[2 * o + 1];
        b += J[i] * r0 + J[3 + i] * r1;
        h0 += J[i] * J[0] + J[3 + i] * J[3];
        h1 += J[i] * J[1] + J[3 + i] * J[4];
        h2 += J[i] * J[2] + J[3 + i] * J[5];
      }
      out.bl[3 * (int64_t)l + i] = -b;
      double* H = out.Hll + 9 * (int64_t)l + 3 * i;
      H[0] = h0;
      H[1] = h1;
      H[2] = h2;
    }
  }
}

// the cost of S stacked states: slots (S, gridDim.x), out (S,)
__global__ void __launch_bounds__(THREADS) cost_kernel(Problem a, int S, double* slots,
                                                       double* out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double warp_sum[WARPS];
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (int st = 0; st < S; ++st) {
    const double* poses = a.poses + 7 * (int64_t)a.N * st;
    const double* lms = a.lms + 3 * (int64_t)a.M * st;
    const double* guv = a.guv ? a.guv + 2 * (int64_t)a.O * st : nullptr;
    const uint8_t* gvalid = a.gvalid ? a.gvalid + (int64_t)a.O * st : nullptr;
    double acc = 0.0;
    for (int o = tid; o < a.O; o += nthreads) {
      const Term t = observe<false, false>(a, poses, lms, guv, gvalid, o);
      acc += t.r0 * t.r0 + t.r1 * t.r1;
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(FULL, acc, off);
    if (lane == 0) warp_sum[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      double b = 0.0;
      for (int w = 0; w < WARPS; ++w) b += warp_sum[w];
      slots[(int64_t)gridDim.x * st + blockIdx.x] = b;
    }
    __syncthreads();
  }
  grid.sync();
  if (blockIdx.x == 0) {
    for (int st = threadIdx.x; st < S; st += blockDim.x) {
      double c = 0.0;
      for (int b = 0; b < gridDim.x; ++b) c += slots[(int64_t)gridDim.x * st + b];
      out[st] = c;
    }
  }
}

__global__ void outlier_kernel(Problem a, double* __restrict__ val, uint8_t* __restrict__ valid) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= a.O) return;
  const Term t = observe<false, true>(a, a.poses, a.lms, a.guv, a.gvalid, o);
  val[o] = t.r0;
  valid[o] = t.valid;
}

}  // namespace

// poses (N, 7) f64, or (S, N, 7) in mode 1; lms (M, 3), or (S, M, 3);
// cam = [fx, fy, cx, cy, k1, k2, p1, p2, T_s_c(7)], dist_model 0 (none) or
// 1 (radtan); uv (O, 2); w (O,) = obs_w * obs_mask (obs_w alone in mode
// 2); kf_m (N,), lm_m (M,) the masks as float64; obs_kf, obs_lm (O,) int32;
// guv, gvalid, gP: the given projection (uv, valid uint8 and, in mode 0,
// d uv / d p_c (O, 2, 3); in mode 1 uv (S, O, 2) and valid (S, O)), or
// null to project here (then dist_model says the distortion);
// the graph (ObsGraph): kf_obs (O,), chunk_ptr (C + 1,), kf_chunk_ptr
// (N + 1,), lm_rowptr (M + 1,), lm_obs (O,) int32.
// mode 0 (linearise): r (O, 2), Jp (O, 2, 6), Jl (O, 2, 3), b6 (N, 6),
// M6 (N, 6, 6), bl (M, 3), Hll (M, 3, 3); scratch (C, 27).
// mode 1 (cost of S states): out (S,); scratch (S, slot_cap).
// mode 2 (outlier): out (O,) ||r|| * obs_w, valid (O,) uint8.
// Returns 0 or the CUDA error.
extern "C" int covins_gba_reproj_blocks(
    int mode, int S, const void* poses, const void* lms, const void* cam, int dist_model,
    const void* uv, const void* w, const void* kf_m, const void* lm_m, const void* obs_kf,
    const void* obs_lm, int O, int N, int M, const void* kf_obs, const void* chunk_ptr,
    const void* kf_chunk_ptr, int C, const void* lm_rowptr, const void* lm_obs, double huber_k,
    const void* guv, const void* gvalid, const void* gP, void* r, void* Jp, void* Jl, void* b6,
    void* M6, void* bl, void* Hll, void* out, void* valid, void* scratch, int slot_cap,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Problem a{static_cast<const double*>(poses),     static_cast<const double*>(lms),
            static_cast<const double*>(cam),       dist_model,
            static_cast<const double*>(uv),        static_cast<const double*>(w),
            static_cast<const double*>(kf_m),      static_cast<const double*>(lm_m),
            static_cast<const int32_t*>(obs_kf),   static_cast<const int32_t*>(obs_lm),
            O,                                     N,
            M,                                     static_cast<const int32_t*>(kf_obs),
            static_cast<const int32_t*>(chunk_ptr), static_cast<const int32_t*>(kf_chunk_ptr),
            C,                                     static_cast<const int32_t*>(lm_rowptr),
            static_cast<const int32_t*>(lm_obs),   huber_k,
            static_cast<const double*>(guv),       static_cast<const uint8_t*>(gvalid),
            static_cast<const double*>(gP)};
  if (mode == 0) {
    Blocks b{static_cast<double*>(r),  static_cast<double*>(Jp),      static_cast<double*>(Jl),
             static_cast<double*>(scratch), static_cast<double*>(b6), static_cast<double*>(M6),
             static_cast<double*>(bl), static_cast<double*>(Hll)};
    void* args[] = {&a, &b};
    const int items = std::max(CHUNK * C, KF_TERMS * N + 3 * M);
    return coop::launch(linearize_kernel, THREADS, 0, items, 1 << 30, coop::Slots::kRefuse, args,
                        st);
  }
  if (mode == 1) {
    double* slots = static_cast<double*>(scratch);
    double* o = static_cast<double*>(out);
    void* args[] = {&a, &S, &slots, &o};
    return coop::launch(cost_kernel, THREADS, 0, O, slot_cap, coop::Slots::kCap, args, st);
  }
  outlier_kernel<<<std::max(1, (O + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      a, static_cast<double*>(out), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}
