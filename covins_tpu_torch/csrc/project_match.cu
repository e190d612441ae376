// Project-and-match: gated descriptor argmin and feature-conflict pass.
//
// Replaces: the O(L*F) part of covins_tpu/ops/projmatch.py::
// _project_match_impl (lines 104-137), which stages 3 and 5 of the COVINS
// loop verification run (loopverify.py:115, 173): for every landmark l and
// every keyframe feature f, the pixel-radius gate (scaled by the feature's
// octave), the predicted-octave gate, the feature-free gate and the
// landmark's own gates select the Hamming distance or 1e9; each landmark
// takes its gated argmin (lowest f on ties), accepts it if it is within
// max_dist, and when several landmarks pick one feature only the lowest
// score best_d + l*1e-7 (float32) keeps it.  The O(L) prologue
// (projection, depth, image, view-angle and distance gates, predicted
// octave) stays batched float64 torch and hands this kernel its results.
//
// Bound on the H100: L*F pairs (up to 10070 x 1024 on the main path) of
// one float64 distance with its gates and one 256-bit popcount; the
// inputs are O(L + F).  So the work is bound by operations, the float64
// part first.
//
// Design: the reference builds (L, F) float64 pixel-distance and float32
// descriptor-distance matrices and reduces them.  Here one warp owns one
// landmark: its lanes walk the features (neighbouring lanes, neighbouring
// features), evaluate every gate in registers and keep a running
// (distance, feature) minimum with a strict '<' over ascending f; a warp
// shuffle reduction then breaks ties toward the lower f, so the result is
// jnp.argmin's.  The Hamming distance is a popcount of the packed words,
// which equals the reference's float32 128 - 0.5 * dot exactly.  Lane 0
// computes the landmark's float32 score and, when it is valid, takes an
// atomicMin of the score's bits into the feature's column minimum (the
// scores are non-negative, so their bit patterns order as the floats do);
// the column minima start at 1e9 (the wrapper fills them).  A second
// launch keeps each landmark whose score is <= its feature's minimum:
// when two landmarks' float32 scores round equal both win, as in the
// reference.  This source is built with --fmad=false so the float64 gate
// arithmetic rounds as the plain version's separate operations do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // landmarks per block
constexpr float kBig = 1e9f;

__device__ __forceinline__ int popc_desc(const uint4* __restrict__ a,
                                         const uint4* __restrict__ b) {
  const uint4 a0 = a[0], a1 = a[1], b0 = b[0], b1 = b[1];
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__device__ __forceinline__ float landmark_score(float best_d, int l) {
  return __fadd_rn(best_d, __fmul_rn(static_cast<float>(l), 1e-7f));
}

__global__ void __launch_bounds__(32 * kWarps)
gated_argmin_kernel(const double* __restrict__ uv, const uint8_t* __restrict__ lm_ok,
                    const double* __restrict__ pred, const uint8_t* __restrict__ has_rng,
                    const uint4* __restrict__ lm_desc, int L,
                    const double* __restrict__ kp_uv, const double* __restrict__ kp_oct,
                    const double* __restrict__ radius, const uint8_t* __restrict__ kp_free,
                    const uint4* __restrict__ kp_desc, int F, float max_dist,
                    int32_t* __restrict__ best_f, float* __restrict__ best_d,
                    int32_t* __restrict__ col_min) {
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (l >= L) return;  // a whole warp leaves together
  const bool ok = lm_ok[l] != 0;
  const bool rng = has_rng[l] != 0;
  const double u = uv[2 * (int64_t)l];
  const double v = uv[2 * (int64_t)l + 1];
  const double p = pred[l];
  const uint4* dl = lm_desc + 2 * (int64_t)l;
  float best = __int_as_float(0x7f800000);  // +inf: any entry replaces it
  int bf = F;
  for (int f = lane; f < F; f += 32) {
    float d = kBig;
    if (ok && kp_free[f]) {
      const double dx = u - kp_uv[2 * f];
      const double dy = v - kp_uv[2 * f + 1];
      const double dpx = sqrt(dx * dx + dy * dy);
      const bool oct_ok = !rng || fabs(kp_oct[f] - p) <= 1.0;
      if (dpx <= radius[f] && oct_ok) {
        d = static_cast<float>(popc_desc(dl, kp_desc + 2 * f));
      }
    }
    if (d < best) {
      best = d;
      bf = f;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int of = __shfl_down_sync(0xffffffffu, bf, off);
    if (ob < best || (ob == best && of < bf)) {
      best = ob;
      bf = of;
    }
  }
  if (lane == 0) {
    best_f[l] = bf;
    best_d[l] = best;
    if (best <= max_dist) {
      atomicMin(col_min + bf, __float_as_int(landmark_score(best, l)));
    }
  }
}

__global__ void conflict_kernel(const int32_t* __restrict__ best_f,
                                const float* __restrict__ best_d,
                                const int32_t* __restrict__ col_min, int L,
                                float max_dist, int32_t* __restrict__ match_feat,
                                float* __restrict__ match_dist) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const float d = best_d[l];
  const int f = best_f[l];
  const bool win = d <= max_dist &&
                   landmark_score(d, l) <= __int_as_float(col_min[f]);
  match_feat[l] = win ? f : -1;
  match_dist[l] = win ? d : kBig;
}

}  // namespace

// Landmark side (L rows): uv (L, 2) f64, lm_ok (L,) bool, pred (L,) f64,
// has_rng (L,) bool, lm_desc (L, 32) u8.  Feature side (F columns): kp_uv
// (F, 2) f64, kp_oct (F,) f64, radius (F,) f64, kp_free (F,) bool, kp_desc
// (F, 32) u8.  Scratch: best_f (L,) int32, best_d (L,) f32, col_min (F,)
// int32 filled with the bits of 1e9f.  Outputs: match_feat (L,) int32,
// match_dist (L,) f32.  Descriptors contiguous and 16-byte aligned.
extern "C" int covins_project_match(
    const void* uv, const void* lm_ok, const void* pred, const void* has_rng,
    const void* lm_desc, int L, const void* kp_uv, const void* kp_oct,
    const void* radius, const void* kp_free, const void* kp_desc, int F,
    float max_dist, void* best_f, void* best_d, void* col_min,
    void* match_feat, void* match_dist, void* stream) {
  if (L <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gated_argmin_kernel<<<(L + kWarps - 1) / kWarps, 32 * kWarps, 0, s>>>(
      static_cast<const double*>(uv), static_cast<const uint8_t*>(lm_ok),
      static_cast<const double*>(pred), static_cast<const uint8_t*>(has_rng),
      static_cast<const uint4*>(lm_desc), L, static_cast<const double*>(kp_uv),
      static_cast<const double*>(kp_oct), static_cast<const double*>(radius),
      static_cast<const uint8_t*>(kp_free), static_cast<const uint4*>(kp_desc), F,
      max_dist, static_cast<int32_t*>(best_f), static_cast<float*>(best_d),
      static_cast<int32_t*>(col_min));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conflict_kernel<<<(L + 255) / 256, 256, 0, s>>>(
      static_cast<const int32_t*>(best_f), static_cast<const float*>(best_d),
      static_cast<const int32_t*>(col_min), L, max_dist,
      static_cast<int32_t*>(match_feat), static_cast<float*>(match_dist));
  return static_cast<int>(cudaGetLastError());
}
