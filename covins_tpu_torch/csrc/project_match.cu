// Project-and-match, whole: the landmark prologue, the gated descriptor
// argmin and the feature-conflict pass in one cooperative launch.
//
// Replaces: covins_tpu/ops/projmatch.py::_project_match_impl (lines
// 43-137), which stages 3 and 5 of the COVINS loop verification run
// (loopverify.py:115, 173).  Per landmark l (the prologue, :66-103):
// pose_apply of T_cw, project3 (pinhole, no or radtan distortion), the
// depth, image, view-angle (when check_view_angle) and distance-invariance
// gates, and the predicted octave ceil(log(max(rng1, 1e-9) /
// max(dist, 1e-9)) / log 1.2) clipped to [0, 16].  Per feature f the
// pixel radius radius_px * scale_factor^octave.  Per pair the pixel-
// radius, octave, free-feature and landmark gates select the Hamming
// distance or 1e9; each landmark takes its gated argmin (lowest f on
// ties) and accepts it within max_dist; when several landmarks pick one
// feature only those whose float32 score best_d + l * 1e-7 equals the
// feature's minimum keep it (two scores that round equal both win).
//
// Bound on the H100: the inputs are O(L + F) (97 bytes per landmark, 57 per
// feature; 8 bytes out per landmark), about 1.1 MB at stage 5's largest
// 10,245 x 1,024; the work is about 110 float64 operations per landmark
// for the prologue, and per passing landmark x free feature one float64
// distance with its gates (~10 operations) and one 256-bit Hamming
// distance, counted as a +-1 int8 dot product of 512 operations.  Which of
// bytes and operations bounds it depends on how many landmarks pass their
// gates: chip_smoke.k5_case counts both from each input.
//
// Design, one cooperative launch (a grid the card can hold at once; a
// refused launch returns its error and the caller raises):
//   0  grid-stride over the features: col_min = 1e9 and the radius;
//   -- grid barrier --
//   1  every block stages the feature side once (uv, octave, radius,
//      descriptor, free flag: 65 bytes per feature, 66.5 KB at F = 1024)
//      in dynamic shared memory; a feature side larger than a block's
//      shared memory is read where it lies.  Each warp then takes
//      landmarks grid-stride: its lanes compute the landmark's prologue
//      (the same values in every lane) and the warp skips the feature
//      loop when the landmark fails its own gates; otherwise its lanes
//      walk the features (neighbouring lanes, neighbouring features) with a
//      strict '<' over ascending f and a shuffle reduction toward the
//      lower f, so the result is jnp.argmin's.  The Hamming distance is a
//      popcount, equal to the reference's 128 - 0.5 * dot.  Lane 0 takes an
//      atomicMin of the valid score's bits into the feature's column
//      minimum (non-negative floats order as their bits do);
//   -- grid barrier --
//   2  grid-stride over the landmarks: the conflict pass.
// A second entry mode takes the prologue's results (uv, lm_ok, pred,
// has_rng) from the caller, for the camera models the prologue here does
// not cover.
//
// The L2 metric (the metric != "hamming" branch, :116-118, for float (SIFT)
// descriptors) is a second instance of the kernel: (L, 128) and (F, 128)
// float32 descriptors, each a float64 value exactly.  Phase 0 also sums
// each feature's squares; the descriptor distance of a pair inside its
// gates is sqrt(max((aa + bb) - 2 ab, 0)) with aa, bb and ab float64
// running sums over the 128 dimensions in order and ab rounded to float32
// before it is doubled in float32, as the reference's dot_general with
// preferred_element_type=float32 makes it on float64 inputs.  Distances,
// the sentinel 1e9, best_d and the conflict score best_d + l * 1e-7 are
// float64 (the column minimum an atomicMin of the score's 64-bit pattern);
// the feature side (512 descriptor bytes a feature) is read where it lies.
// Bound (L2): per passing landmark x free feature the gates (~10 float64
// operations), and per pair inside them 261 float64 operations for the
// distance; 128 a landmark and a feature for aa and bb.  The float64 arithmetic follows the plain version's
// operation order (geometry.cuh; projmatch._prologue writes every product
// and sum as its own tensor operation), and this source is built with
// --fmad=false, so both round alike and the outputs agree bit for bit.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "coop_launch.cuh"
#include "geometry.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float kBig = 1e9f;
constexpr int kDim = 128;  // L2 descriptor dimensions
constexpr int kFeatureBytes = 32 + 16 + 8 + 8 + 1;  // descriptor, uv, octave, radius, free

struct Args {
  int prologue;  // 1: compute the prologue here; 0: read uv, lm_ok, pred, has_rng
  const double* intr;  // (5,) [fx, fy, cx, cy, xi]
  const double* dist;  // (4,) [k1, k2, p1, p2]
  int dist_model;      // 0 none, 1 radtan
  const double* T_cw;  // (7,)
  const double* p_w;   // (L, 3)
  const double* normal;  // (L, 3)
  const uint8_t* lm_mask;  // (L,)
  const double* rng;       // (L, 2)
  int check_view_angle;
  double img_w, img_h, log_level;
  const double* uv;  // (L, 2), given mode
  const uint8_t* lm_ok;
  const double* pred;
  const uint8_t* has_rng;
  const uint4* lm_desc;  // (L, 32) bytes
  int L;
  const double* kp_uv;  // (F, 2)
  const double* kp_oct;
  const uint8_t* kp_free;
  const uint4* kp_desc;  // (F, 32) bytes
  int F;
  double radius_px, scale_factor;
  float max_dist;
  int stage;  // the feature side fits in shared memory
  double* radius;    // (F,) scratch
  int32_t* col_min;  // (F,) scratch, float bits
  int32_t* best_f;   // (L,) scratch
  float* best_d;     // (L,) scratch
  int32_t* match_feat;
  float* match_dist;
  // the L2 metric: float32 descriptors, float64 distances
  const float* lm_f;  // (L, 128)
  const float* kp_f;  // (F, 128)
  double max_dist64;
  double* kp_bb;                  // (F,) scratch: each feature's squares
  unsigned long long* col_min64;  // (F,) scratch, float64 bits
  double* best_d64;               // (L,) scratch
  double* match_dist64;
};

struct Landmark {
  double u, v, pred;
  bool ok, rng;
};

struct Features {
  const uint4* desc;
  const double* uv;  // (F, 2)
  const double* oct;
  const double* rad;
  const uint8_t* free;
};

// projmatch._prologue for landmark l, every gate in its order
__device__ inline Landmark landmark(const Args& a, int l) {
  Landmark m;
  if (!a.prologue) {
    m.u = a.uv[2 * (int64_t)l];
    m.v = a.uv[2 * (int64_t)l + 1];
    m.pred = a.pred[l];
    m.ok = a.lm_ok[l] != 0;
    m.rng = a.has_rng[l] != 0;
    return m;
  }
  const double* T = a.T_cw;
  const double q[4] = {T[0], T[1], T[2], T[3]};
  const double* P = a.p_w + 3 * (int64_t)l;
  const V3 X{P[0], P[1], P[2]};
  const V3 r = qrot(q, X);
  const V3 pc{r.x + T[4], r.y + T[5], r.z + T[6]};
  // cameras.project3, pinhole
  const bool proj_ok = pc.z > 1e-6;
  const double zs = proj_ok ? pc.z : 1.0;
  const double xn = pc.x / zs, yn = pc.y / zs;
  double x = xn, y = yn;
  if (a.dist_model == 1) distort_radtan(a.dist, xn, yn, x, y);
  m.u = a.intr[0] * x + a.intr[2];
  m.v = a.intr[1] * y + a.intr[3];
  const bool in_img = m.u >= 0.0 && m.u < a.img_w && m.v >= 0.0 && m.v < a.img_h;
  bool ok = a.lm_mask[l] != 0 && pc.z > 0.0 && proj_ok && in_img;
  const V3 O = pose_inverse_t(T);
  const V3 PO{X.x - O.x, X.y - O.y, X.z - O.z};
  const double dist3 = sqrt((PO.x * PO.x + PO.y * PO.y) + PO.z * PO.z);
  if (a.check_view_angle) {
    const double* n = a.normal + 3 * (int64_t)l;
    const double cosv = (PO.x * n[0] + PO.y * n[1]) + PO.z * n[2];
    const bool has_normal = sqrt((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2]) > 1e-6;
    ok = ok && (!has_normal || cosv >= 0.5 * dist3);
  }
  const double r0 = a.rng[2 * (int64_t)l], r1 = a.rng[2 * (int64_t)l + 1];
  m.rng = r1 > 0.0;
  m.ok = ok && (!m.rng || (dist3 >= 0.8 * r0 && dist3 <= 1.2 * r1));
  const double level = ceil(log(fmax(r1, 1e-9) / fmax(dist3, 1e-9)) / a.log_level);
  m.pred = fmin(fmax(level, 0.0), 16.0);
  return m;
}

__device__ __forceinline__ int popc_desc(uint4 a0, uint4 a1, const uint4* __restrict__ b) {
  const uint4 b0 = b[0], b1 = b[1];
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__device__ __forceinline__ float landmark_score(float best_d, int l) {
  return __fadd_rn(best_d, __fmul_rn(static_cast<float>(l), 1e-7f));
}

__device__ __forceinline__ double landmark_score(double best_d, int l) {
  return __dadd_rn(best_d, __dmul_rn(static_cast<double>(l), 1e-7));
}

// the sum of squares of a float32 descriptor in float64, in order
__device__ __forceinline__ double sum_squares(const float* x) {
  double s = 0.0;
  for (int k = 0; k < kDim; ++k) {
    const double v = x[k];
    s = __dadd_rn(s, __dmul_rn(v, v));
  }
  return s;
}

// the reference's L2 descriptor distance of a pair (float64 inputs, the
// cross term rounded to float32 and doubled there)
__device__ __forceinline__ double l2_distance(const float* x, const float* y, double aa,
                                              double bb) {
  double ab = 0.0;
  for (int k = 0; k < kDim; ++k)
    ab = __dadd_rn(ab, __dmul_rn(static_cast<double>(x[k]), static_cast<double>(y[k])));
  const float two_ab = __fmul_rn(2.f, __double2float_rn(ab));
  double d = __dsub_rn(__dadd_rn(aa, bb), static_cast<double>(two_ab));
  d = d < 0.0 ? 0.0 : d;  // keeps NaN, as jnp.maximum
  return __dsqrt_rn(d);
}

template <bool kL2>
__global__ void __launch_bounds__(THREADS) project_match_kernel(Args a) {
  typedef typename std::conditional<kL2, double, float>::type Dist;
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  // phase 0
  for (int f = tid; f < a.F; f += nthreads) {
    if (kL2) {
      a.col_min64[f] = static_cast<unsigned long long>(__double_as_longlong(1e9));
      a.kp_bb[f] = sum_squares(a.kp_f + (int64_t)f * kDim);
    } else {
      a.col_min[f] = __float_as_int(kBig);
    }
    a.radius[f] = a.radius_px * pow(a.scale_factor, a.kp_oct[f]);
  }
  grid.sync();

  // phase 1: the feature side, staged once per block
  extern __shared__ uint4 smem[];
  Features ft{a.kp_desc, a.kp_uv, a.kp_oct, a.radius, a.kp_free};
  if (!kL2 && a.stage) {
    uint4* s_desc = smem;
    double* s_uv = reinterpret_cast<double*>(s_desc + 2 * a.F);
    double* s_oct = s_uv + 2 * a.F;
    double* s_rad = s_oct + a.F;
    uint8_t* s_free = reinterpret_cast<uint8_t*>(s_rad + a.F);
    for (int i = threadIdx.x; i < 2 * a.F; i += blockDim.x) s_desc[i] = a.kp_desc[i];
    for (int f = threadIdx.x; f < a.F; f += blockDim.x) {
      s_uv[2 * f] = a.kp_uv[2 * f];
      s_uv[2 * f + 1] = a.kp_uv[2 * f + 1];
      s_oct[f] = a.kp_oct[f];
      s_rad[f] = a.radius[f];
      s_free[f] = a.kp_free[f];
    }
    __syncthreads();
    ft = Features{s_desc, s_uv, s_oct, s_rad, s_free};
  }
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * WARPS;
  for (int l = blockIdx.x * WARPS + (threadIdx.x >> 5); l < a.L; l += nwarps) {
    const Landmark m = landmark(a, l);  // the same in every lane
    const Dist big = static_cast<Dist>(kL2 ? 1e9 : kBig);
    Dist best = big;  // a landmark that fails its gates: every entry 1e9, feature 0
    int bf = 0;
    if (m.ok) {
      const uint4 d0 = kL2 ? uint4{} : a.lm_desc[2 * (int64_t)l];
      const uint4 d1 = kL2 ? uint4{} : a.lm_desc[2 * (int64_t)l + 1];
      const float* lf = kL2 ? a.lm_f + (int64_t)l * kDim : nullptr;
      const double aa = kL2 ? sum_squares(lf) : 0.0;
      best = static_cast<Dist>(__longlong_as_double(0x7ff0000000000000LL));  // +inf
      bf = a.F;
      for (int f = lane; f < a.F; f += 32) {
        Dist d = big;
        if (ft.free[f]) {
          const double dx = m.u - ft.uv[2 * f];
          const double dy = m.v - ft.uv[2 * f + 1];
          const double dpx = sqrt(dx * dx + dy * dy);
          const bool oct_ok = !m.rng || fabs(ft.oct[f] - m.pred) <= 1.0;
          if (dpx <= ft.rad[f] && oct_ok) {
            if (kL2)
              d = static_cast<Dist>(l2_distance(lf, a.kp_f + (int64_t)f * kDim, aa, a.kp_bb[f]));
            else
              d = static_cast<Dist>(popc_desc(d0, d1, ft.desc + 2 * f));
          }
        }
        if (d < best) {
          best = d;
          bf = f;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const Dist ob = __shfl_down_sync(FULL, best, off);
        const int of = __shfl_down_sync(FULL, bf, off);
        if (ob < best || (ob == best && of < bf)) {
          best = ob;
          bf = of;
        }
      }
    }
    if (lane == 0) {
      a.best_f[l] = bf;
      if (kL2) {
        a.best_d64[l] = best;
        if (best <= a.max_dist64)
          atomicMin(a.col_min64 + bf, static_cast<unsigned long long>(__double_as_longlong(
                                          landmark_score(static_cast<double>(best), l))));
      } else {
        a.best_d[l] = best;
        if (best <= a.max_dist)
          atomicMin(a.col_min + bf, __float_as_int(landmark_score(static_cast<float>(best), l)));
      }
    }
  }
  grid.sync();

  // phase 2: the conflict pass
  for (int l = tid; l < a.L; l += nthreads) {
    const int f = a.best_f[l];
    if (kL2) {
      const double d = a.best_d64[l];
      const bool win = d <= a.max_dist64 &&
                       landmark_score(d, l) <= __longlong_as_double(
                                                   static_cast<long long>(a.col_min64[f]));
      a.match_feat[l] = win ? f : -1;
      a.match_dist64[l] = win ? d : 1e9;
    } else {
      const float d = a.best_d[l];
      const bool win = d <= a.max_dist && landmark_score(d, l) <= __int_as_float(a.col_min[f]);
      a.match_feat[l] = win ? f : -1;
      a.match_dist[l] = win ? d : kBig;
    }
  }
}

}  // namespace

// prologue 1: intr (5,), dist (4,) f64 with dist_model 0 (none) or 1
// (radtan), T_cw (7,), p_w (L, 3), lm_normal (L, 3) f64, lm_mask (L,)
// bool, lm_rng (L, 2) f64, check_view_angle, img_w, img_h, log_level =
// log 1.2; uv, lm_ok, pred, has_rng unused.  prologue 0: uv (L, 2) f64,
// lm_ok (L,) bool, pred (L,) f64, has_rng (L,) bool, the others unused.
// l2 0: lm_desc (L, 32) u8, kp_desc (F, 32) u8, 16-byte aligned, scratch
// 12 F + 8 L bytes, match_dist (L,) f32; l2 1: lm_desc (L, 128) and
// kp_desc (F, 128) f32, scratch 24 F + 12 L bytes, match_dist (L,) f64.
// kp_uv (F, 2), kp_oct (F,) f64, kp_free (F,) bool; scratch 8-byte
// aligned.  Outputs match_feat (L,) int32 and match_dist.  Returns 0 or
// the CUDA error; launches nothing when L is 0.
extern "C" int covins_project_match(
    int prologue, const void* intr, const void* dist, int dist_model, const void* T_cw,
    const void* p_w, const void* lm_normal, const void* lm_mask, const void* lm_rng,
    int check_view_angle, double img_w, double img_h, double log_level, const void* uv,
    const void* lm_ok, const void* pred, const void* has_rng, const void* lm_desc, int L,
    const void* kp_uv, const void* kp_oct, const void* kp_free, const void* kp_desc, int F,
    double radius_px, double scale_factor, double max_dist, int l2, void* scratch,
    void* match_feat, void* match_dist, void* stream) {
  if (L <= 0) return 0;
  const void* kernel = l2 ? reinterpret_cast<const void*>(project_match_kernel<true>)
                          : reinterpret_cast<const void*>(project_match_kernel<false>);
  int room = 0;
  const cudaError_t err = coop::smem_room(kernel, &room);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t stage_bytes = (int64_t)F * kFeatureBytes;
  const int stage = !l2 && stage_bytes <= room;
  const size_t smem = stage ? static_cast<size_t>(stage_bytes) : 0;
  char* s = static_cast<char*>(scratch);
  Args a{prologue,
         static_cast<const double*>(intr),
         static_cast<const double*>(dist),
         dist_model,
         static_cast<const double*>(T_cw),
         static_cast<const double*>(p_w),
         static_cast<const double*>(lm_normal),
         static_cast<const uint8_t*>(lm_mask),
         static_cast<const double*>(lm_rng),
         check_view_angle,
         img_w,
         img_h,
         log_level,
         static_cast<const double*>(uv),
         static_cast<const uint8_t*>(lm_ok),
         static_cast<const double*>(pred),
         static_cast<const uint8_t*>(has_rng),
         static_cast<const uint4*>(lm_desc),
         L,
         static_cast<const double*>(kp_uv),
         static_cast<const double*>(kp_oct),
         static_cast<const uint8_t*>(kp_free),
         static_cast<const uint4*>(kp_desc),
         F,
         radius_px,
         scale_factor,
         static_cast<float>(max_dist),
         stage,
         reinterpret_cast<double*>(s),
         reinterpret_cast<int32_t*>(s + 8 * (int64_t)F),
         reinterpret_cast<int32_t*>(s + 12 * (int64_t)F),
         reinterpret_cast<float*>(s + 12 * (int64_t)F + 4 * (int64_t)L),
         static_cast<int32_t*>(match_feat),
         static_cast<float*>(match_dist)};
  if (l2) {
    // radius (F) f64, col_min (F) u64, the squares (F) f64, best_d (L) f64,
    // best_f (L) int32
    a.lm_f = static_cast<const float*>(lm_desc);
    a.kp_f = static_cast<const float*>(kp_desc);
    a.max_dist64 = max_dist;
    a.col_min64 = reinterpret_cast<unsigned long long*>(s + 8 * (int64_t)F);
    a.kp_bb = reinterpret_cast<double*>(s + 16 * (int64_t)F);
    a.best_d64 = reinterpret_cast<double*>(s + 24 * (int64_t)F);
    a.best_f = reinterpret_cast<int32_t*>(s + 24 * (int64_t)F + 8 * (int64_t)L);
    a.match_dist64 = static_cast<double*>(match_dist);
  }
  void* args[] = {&a};
  // one warp per landmark
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l2)
    return coop::launch(project_match_kernel<true>, THREADS, smem, 32LL * L, 1 << 30,
                        coop::Slots::kRefuse, args, st);
  return coop::launch(project_match_kernel<false>, THREADS, smem, 32LL * L, 1 << 30,
                      coop::Slots::kRefuse, args, st);
}
