// P3P RANSAC scoring: angular-error inlier counts and the best hypothesis.
//
// Replaces: the scoring half of covins_tpu/ops/pnp.py::absolute_pose_ransac
// (lines 369-377, via reprojection_angular_error at :314), stage 2 of the
// COVINS loop verification: every candidate pose T_c_w (H*4 = 1200 on the
// main path: 300 hypotheses x 4 P3P roots) is scored against every
// 2D-3D correspondence (N = 1024), err = acos(clip(<pred, bearing>)) with
// pred = (R p + t) / max(|R p + t|, 1e-12) and pi where the norm is
// <= 1e-9; inliers are err < thr on valid correspondences; counts of
// invalid poses are -1; the best pose is the FIRST maximum (jnp.argmax),
// and its (N,) inlier mask is returned with max(count, 0).
//
// Bound on the H100: H*4*N float64 evaluations of about 60 operations
// (rotation, norm, division, dot, acos); the inputs are a few tens of KB.
// So it is bound by float64 operations.
//
// Design: the reference materialises the (1200, N) error matrix.  Here
// the first launch runs one block per pose: the block's threads stride
// over the correspondences, each evaluating the error in registers, and a
// block reduction writes the pose's count.  The second launch is one
// block: it takes the first maximum over the counts (each thread keeps a
// strict '>' over ascending poses, the reduction breaks ties toward the
// lower pose) and rebuilds the best pose's inlier mask.  The rotation is
// the reference's quaternion form (two cross products), written in the
// same order as the plain version's separate tensor operations; the
// source is built with --fmad=false so both round alike.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool is_inlier(const double* __restrict__ T,
                                          const double* __restrict__ P,
                                          const double* __restrict__ B,
                                          const uint8_t* __restrict__ mask,
                                          int n, double thr) {
  const double w = T[0], x = T[1], y = T[2], z = T[3];
  const double v0 = P[3 * n], v1 = P[3 * n + 1], v2 = P[3 * n + 2];
  // uv = u x v, then u x uv, with u = (x, y, z)
  const double uv0 = y * v2 - z * v1;
  const double uv1 = z * v0 - x * v2;
  const double uv2 = x * v1 - y * v0;
  const double c0 = y * uv2 - z * uv1;
  const double c1 = z * uv0 - x * uv2;
  const double c2 = x * uv1 - y * uv0;
  const double p0 = (v0 + 2.0 * (w * uv0 + c0)) + T[4];
  const double p1 = (v1 + 2.0 * (w * uv1 + c1)) + T[5];
  const double p2 = (v2 + 2.0 * (w * uv2 + c2)) + T[6];
  const double nrm = sqrt((p0 * p0 + p1 * p1) + p2 * p2);
  const double den = fmax(nrm, 1e-12);
  const double cosang = ((p0 / den) * B[3 * n] + (p1 / den) * B[3 * n + 1]) +
                        (p2 / den) * B[3 * n + 2];
  const double err = nrm > 1e-9 ? acos(fmin(fmax(cosang, -1.0), 1.0))
                                 : 3.141592653589793;
  return err < thr && mask[n] != 0;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const double* __restrict__ T, const double* __restrict__ P,
             const double* __restrict__ B, const uint8_t* __restrict__ mask,
             const uint8_t* __restrict__ valid, int N, double thr,
             int32_t* __restrict__ counts) {
  __shared__ int partial[kThreads / 32];
  const int h = blockIdx.x;
  const double* Th = T + 7 * (int64_t)h;
  int c = 0;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    c += is_inlier(Th, P, B, mask, n, thr) ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kThreads / 32; ++i) total += partial[i];
    counts[h] = valid[h] ? total : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
best_kernel(const int32_t* __restrict__ counts, int H, const double* __restrict__ T,
            const double* __restrict__ P, const double* __restrict__ B,
            const uint8_t* __restrict__ mask, int N, double thr,
            int64_t* __restrict__ best, uint8_t* __restrict__ inliers,
            int32_t* __restrict__ n_inliers) {
  __shared__ int s_count[kThreads];
  __shared__ int s_idx[kThreads];
  int bc = -2;  // below every count (counts are >= -1)
  int bi = H;
  for (int h = threadIdx.x; h < H; h += kThreads) {
    const int c = counts[h];
    if (c > bc) {
      bc = c;
      bi = h;
    }
  }
  s_count[threadIdx.x] = bc;
  s_idx[threadIdx.x] = bi;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      const int oc = s_count[threadIdx.x + stride];
      const int oi = s_idx[threadIdx.x + stride];
      if (oc > s_count[threadIdx.x] ||
          (oc == s_count[threadIdx.x] && oi < s_idx[threadIdx.x])) {
        s_count[threadIdx.x] = oc;
        s_idx[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  const int b = s_idx[0];
  if (threadIdx.x == 0) {
    best[0] = b;
    n_inliers[0] = max(s_count[0], 0);
  }
  const double* Tb = T + 7 * (int64_t)b;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    inliers[n] = is_inlier(Tb, P, B, mask, n, thr) ? 1 : 0;
  }
}

}  // namespace

// T: (H, 7) f64 poses T_c_w; P: (N, 3) f64 world points; B: (N, 3) f64
// unit bearings; mask (N,) bool; valid (H,) bool.  Outputs: counts (H,)
// int32, best (1,) int64, inliers (N,) bool, n_inliers (1,) int32.
extern "C" int covins_p3p_score(const void* T, const void* P, const void* B,
                                const void* mask, const void* valid, int H, int N,
                                double thr, void* counts, void* best,
                                void* inliers, void* n_inliers, void* stream) {
  if (H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  count_kernel<<<H, kThreads, 0, s>>>(
      static_cast<const double*>(T), static_cast<const double*>(P),
      static_cast<const double*>(B), static_cast<const uint8_t*>(mask),
      static_cast<const uint8_t*>(valid), N, thr, static_cast<int32_t*>(counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  best_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const int32_t*>(counts), H, static_cast<const double*>(T),
      static_cast<const double*>(P), static_cast<const double*>(B),
      static_cast<const uint8_t*>(mask), N, thr, static_cast<int64_t*>(best),
      static_cast<uint8_t*>(inliers), static_cast<int32_t*>(n_inliers));
  return static_cast<int>(cudaGetLastError());
}
