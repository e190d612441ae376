// GBA reduced camera system: the observation part of its matrix-vector
// product, Hpp(reproj) v - Hpl Hll^-1 (Hlp v + c).
//
// Replaces: the observation terms of reduced_Hv in covins_tpu/ops/gba.py::
// _gn_schur_step (Hpp_v's reprojection block :278-290, Hlp_v :305-309,
// Hpl_w :311-316, Hll_inv_apply :318-319, composed at :338-341), the
// operator the reduced-camera PCG applies once per iteration (60 per
// Gauss-Newton step), plus b_red's Hpl Hll^-1 b_l (:343) and the ladder's
// Hlp dx (:426).
//
// Bound on the H100: it reads each observation's whitened 2x6 and 2x3
// Jacobians (144 bytes) and its two indices, each landmark's 3x3 inverse
// block and the (N, 6) vector: about 8 MB at the main path's 52.6k
// observations and 8192 landmarks, 2.4 us at 3.35 TB/s; about 100 float64
// operations per observation, so bound by bytes.
//
// Design: the reference scatter-adds in both directions; float64 atomics
// would add in an order that changes between runs, which 60 CG steps
// amplify.  Two launches, each summing in the fixed order of a CSR built
// once per problem:
// 1. one thread per landmark walks its observations in ascending order,
//    recomputes y_o = J_pose,o v[kf_o] and sums t = J_lm,o^T y_o, then
//    applies the landmark's Hll^-1 to t + c (w, kept in a scratch buffer);
// 2. one warp per keyframe sums J_pose,o^T y_o and J_pose,o^T J_lm,o
//    w[lm_o] over the keyframe's observations apart, subtracting at the
//    end, as the plain version does: the lanes compute 32 observations'
//    terms at once and add them in ascending order (a keyframe has about
//    200 observations; one thread per keyframe output walking them
//    serially made this pass 0.7 ms).
// The source is built without FMA contraction.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ inline void y_of(const double* Jp, const double* v6, double y[2]) {
  for (int r = 0; r < 2; ++r) {
    double s = 0.0;
    for (int k = 0; k < 6; ++k) s += Jp[6 * r + k] * v6[k];
    y[r] = s;
  }
}

__global__ void landmark_kernel(const double* __restrict__ v6, const double* __restrict__ c,
                                const double* __restrict__ Jp,
                                const double* __restrict__ Jl,
                                const double* __restrict__ Hll_inv,
                                const int32_t* __restrict__ obs_kf,
                                const int32_t* __restrict__ lm_rowptr,
                                const int32_t* __restrict__ lm_obs, int M, int t_only,
                                double* __restrict__ t_out, double* __restrict__ w_out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= M) return;
  double t[3] = {0.0, 0.0, 0.0};
  if (v6 != nullptr) {
    for (int k = lm_rowptr[l]; k < lm_rowptr[l + 1]; ++k) {
      const int64_t o = lm_obs[k];
      double y[2];
      y_of(Jp + 12 * o, v6 + 6 * (int64_t)obs_kf[o], y);
      const double* J = Jl + 6 * o;
      for (int i = 0; i < 3; ++i) t[i] += J[i] * y[0] + J[3 + i] * y[1];
    }
  }
  for (int i = 0; i < 3; ++i) t_out[3 * (int64_t)l + i] = t[i];
  if (t_only) return;
  double u[3];
  for (int i = 0; i < 3; ++i) u[i] = c != nullptr ? t[i] + c[3 * (int64_t)l + i] : t[i];
  const double* H = Hll_inv + 9 * (int64_t)l;
  for (int i = 0; i < 3; ++i)
    w_out[3 * (int64_t)l + i] = (H[3 * i] * u[0] + H[3 * i + 1] * u[1]) + H[3 * i + 2] * u[2];
}

// one warp per keyframe: each lane computes the terms of one of 32
// consecutive observations, then every lane adds the 32 terms in
// ascending order (broadcast by shuffles), so the sums run over the
// observations in sequence, as the plain version's scatter-add does
__global__ void keyframe_kernel(const double* __restrict__ v6,
                                const double* __restrict__ Jp,
                                const double* __restrict__ Jl,
                                const double* __restrict__ w,
                                const int32_t* __restrict__ obs_lm,
                                const int32_t* __restrict__ kf_rowptr,
                                const int32_t* __restrict__ kf_obs, int N,
                                double* __restrict__ out) {
  const int kf = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (kf >= N) return;  // uniform across the warp
  double a[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  double b[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const int end = kf_rowptr[kf + 1];
  for (int base = kf_rowptr[kf]; base < end; base += 32) {
    double ta[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    double tb[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    if (base + lane < end) {
      const int64_t o = kf_obs[base + lane];
      const double* J = Jp + 12 * o;
      if (v6 != nullptr) {
        double y[2];
        y_of(J, v6 + 6 * (int64_t)kf, y);
        for (int k = 0; k < 6; ++k) ta[k] = J[k] * y[0] + J[6 + k] * y[1];
      }
      const double* L = Jl + 6 * o;
      const double* wl = w + 3 * (int64_t)obs_lm[o];
      double y2[2];
      for (int r = 0; r < 2; ++r) y2[r] = (L[3 * r] * wl[0] + L[3 * r + 1] * wl[1]) + L[3 * r + 2] * wl[2];
      for (int k = 0; k < 6; ++k) tb[k] = J[k] * y2[0] + J[6 + k] * y2[1];
    }
    const int n = min(32, end - base);
    for (int j = 0; j < n; ++j)
      for (int k = 0; k < 6; ++k) {
        a[k] += __shfl_sync(0xffffffffu, ta[k], j);
        b[k] += __shfl_sync(0xffffffffu, tb[k], j);
      }
  }
  if (lane < 6) {
    double ak = a[0], bk = b[0];
    for (int k = 1; k < 6; ++k)
      if (lane == k) {
        ak = a[k];
        bk = b[k];
      }
    out[6 * (int64_t)kf + lane] = ak - bk;
  }
}

}  // namespace

// v6 (N, 6) or null (zeros), c (M, 3) or null (zeros), Jp (O, 2, 6),
// Jl (O, 2, 3), Hll_inv (M, 3, 3) float64; obs_kf, obs_lm (O,) int32;
// kf_rowptr (N + 1,), kf_obs (O,), lm_rowptr (M + 1,), lm_obs (O,) int32,
// the CSRs; t_out (M, 3) = Hlp v6 and w (M, 3) scratch; out (N, 6) unless
// t_only.
extern "C" int covins_gba_reduced_matvec(const void* v6, const void* c, const void* Jp,
                                         const void* Jl, const void* Hll_inv,
                                         const void* obs_kf, const void* obs_lm, int O,
                                         const void* kf_rowptr, const void* kf_obs, int N,
                                         const void* lm_rowptr, const void* lm_obs, int M,
                                         int t_only, void* t_out, void* w, void* out,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  if (M > 0) {
    landmark_kernel<<<(M + threads - 1) / threads, threads, 0, st>>>(
        static_cast<const double*>(v6), static_cast<const double*>(c),
        static_cast<const double*>(Jp), static_cast<const double*>(Jl),
        static_cast<const double*>(Hll_inv), static_cast<const int32_t*>(obs_kf),
        static_cast<const int32_t*>(lm_rowptr), static_cast<const int32_t*>(lm_obs), M,
        t_only, static_cast<double*>(t_out), static_cast<double*>(w));
  }
  if (!t_only && N > 0) {
    keyframe_kernel<<<(32 * N + threads - 1) / threads, threads, 0, st>>>(
        static_cast<const double*>(v6), static_cast<const double*>(Jp),
        static_cast<const double*>(Jl), static_cast<const double*>(w),
        static_cast<const int32_t*>(obs_lm), static_cast<const int32_t*>(kf_rowptr),
        static_cast<const int32_t*>(kf_obs), N, static_cast<double*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
