// Scoring of batched relative-pose hypotheses by triangulated ray angular
// error: inlier counts, the first best hypothesis and its inlier mask, in
// one cooperative launch.
//
// Replaces: the scoring of every RANSAC of covins_tpu/ops/epipolar.py:
// :68 ray_angular_error (with :46 triangulate_midpoint), the inlier mask
// err < threshold & mask (& valid), the counts, the first argmax and the
// best row's inliers of :131 relative_pose_ransac_central, :327
// relative_pose_ransac_central_5pt, :413 relative_pose_ransac_noncentral
// (its hypotheses and its weighted re-solve) and the counts of :453
// sampling_covariance; on the COVINS-G path, loopverify.py:458
// _covinsg_verify_impl.
//
// Bound on the H100: per (valid hypothesis, masked-in ray) 164 float64
// operations non-central and 122 central (chip_smoke.RAY_SCORE_OPS: the
// rotations, the midpoint triangulation, two angles with their square
// roots, divisions and acos, each counted one) against 7 doubles a
// hypothesis and 6 or 12 doubles a ray read once, so operations at the
// float64 rate.
//
// Design: one cooperative launch (coop_launch.cuh).  Phase 1: a warp per
// hypothesis (b, h) of the B x H batch, its lanes over the batch's N rays
// (masked rays skipped), the count a ballot sum; a hypothesis marked
// invalid counts 0.  Grid barrier, only when the inlier mask is asked for.
// Phase 2: a block per (b, chunk of rays) takes the first maximum of b's
// counts (a 64-bit (count << 32 | ~h) max over the block), and recomputes
// that hypothesis's inlier test on its chunk with the same code.  Float64
// without FMA contraction (--fmad=false), every sum in one written order,
// the clamps and the maximum written as comparisons that keep NaN, as
// jnp.clip / jnp.maximum do (CUDA's fmin / fmax drop it): a degenerate
// sample's NaN pose counts 0, as in the reference.  The plain version,
// epipolar.ray_ransac_score_plain, writes the same arithmetic as tensor
// operations, so the two agree bit for bit.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr double kPi = 3.141592653589793;

struct Args {
  const double* T;       // (B, H, 7)
  const double* va;      // (B, N, 3) or null (origins 0)
  const double* fa;      // (B, N, 3)
  const double* vb;      // (B, N, 3) or null
  const double* fb;      // (B, N, 3)
  const uint8_t* mask;   // (B, N)
  const uint8_t* valid;  // (B, H) or null
  int B, H, N;
  double thr;
  int32_t* counts;   // (B, H)
  int32_t* best;     // (B,) or null
  uint8_t* inliers;  // (B, N) or null
};

__device__ __forceinline__ double dot3(const double (&p)[3], const double (&q)[3]) {
  return (p[0] * q[0] + p[1] * q[1]) + p[2] * q[2];
}

// quat_rotate(q, v) + t as covins_tpu/utils/geometry.py writes it:
// v + 2 (w (u x v) + u x (u x v)) + t
__device__ __forceinline__ void rotate(const double* T, const double (&v)[3], bool translate,
                                       double (&out)[3]) {
  const double w = T[0], x = T[1], y = T[2], z = T[3];
  const double uv0 = y * v[2] - z * v[1];
  const double uv1 = z * v[0] - x * v[2];
  const double uv2 = x * v[1] - y * v[0];
  const double c0 = y * uv2 - z * uv1;
  const double c1 = z * uv0 - x * uv2;
  const double c2 = x * uv1 - y * uv0;
  out[0] = v[0] + 2.0 * (w * uv0 + c0);
  out[1] = v[1] + 2.0 * (w * uv1 + c1);
  out[2] = v[2] + 2.0 * (w * uv2 + c2);
  if (translate) {
    out[0] = out[0] + T[4];
    out[1] = out[1] + T[5];
    out[2] = out[2] + T[6];
  }
}

// arccos(clip(dot(X - o, d) / max(|X - o|, 1e-12), -1, 1)), NaN kept
__device__ __forceinline__ double angle(const double (&o)[3], const double (&d)[3],
                                        const double (&X)[3]) {
  const double v[3] = {X[0] - o[0], X[1] - o[1], X[2] - o[2]};
  const double n = sqrt(dot3(v, v));
  const double c = dot3(v, d) / (n < 1e-12 ? 1e-12 : n);
  return acos(c < -1.0 ? -1.0 : (c > 1.0 ? 1.0 : c));
}

// ray n of batch b an inlier of pose T: the reference's
// where(ok, maximum(angle_a, angle_b), pi) < thr
__device__ bool ray_inlier(const Args& a, const double* T, int64_t r) {
  double va[3] = {0.0, 0.0, 0.0}, vb[3] = {0.0, 0.0, 0.0}, fa[3], fb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    fa[k] = a.fa[3 * r + k];
    fb[k] = a.fb[3 * r + k];
    if (a.va != nullptr) va[k] = a.va[3 * r + k];
    if (a.vb != nullptr) vb[k] = a.vb[3 * r + k];
  }
  double ob[3], db[3];
  rotate(T, vb, true, ob);
  rotate(T, fb, false, db);
  // triangulate_midpoint(va, fa, ob, db)
  const double w0[3] = {va[0] - ob[0], va[1] - ob[1], va[2] - ob[2]};
  const double A = dot3(fa, fa), Bd = dot3(fa, db), C = dot3(db, db);
  const double D = dot3(fa, w0), E = dot3(db, w0);
  const double denom = A * C - Bd * Bd;
  bool ok = fabs(denom) > 1e-12;
  const double ds = ok ? denom : 1.0;
  const double s = (Bd * E - C * D) / ds;
  const double t = (A * E - Bd * D) / ds;
  double X[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) X[k] = 0.5 * ((va[k] + s * fa[k]) + (ob[k] + t * db[k]));
  ok = ok && (s > 0.0) && (t > 0.0);
  const double ea = angle(va, fa, X), eb = angle(ob, db, X);
  // jnp.maximum: NaN if either is NaN
  const double err = (isnan(ea) || isnan(eb)) ? ea + eb : (ea > eb ? ea : eb);
  return (ok ? err : kPi) < a.thr;
}

__global__ void __launch_bounds__(THREADS) score_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * (THREADS / 32);
  const int gwarp = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);

  // phase 1: a warp per hypothesis
  for (int64_t j = gwarp; j < (int64_t)a.B * a.H; j += nwarps) {
    const int b = static_cast<int>(j / a.H);
    int cnt = 0;
    if (a.valid == nullptr || a.valid[j] != 0) {
      const double* T = a.T + 7 * j;
      for (int base = 0; base < a.N; base += 32) {
        const int n = base + lane;
        const int64_t r = (int64_t)b * a.N + n;
        const bool in = n < a.N && a.mask[r] != 0 && ray_inlier(a, T, r);
        cnt += __popc(__ballot_sync(FULL, in));
      }
    }
    if (lane == 0) a.counts[j] = cnt;
  }
  if (a.inliers == nullptr) return;
  grid.sync();

  // phase 2: the first best hypothesis of each batch and its inliers
  __shared__ unsigned long long warp_best[THREADS / 32];
  const int chunks = (a.N + THREADS - 1) / THREADS;
  for (int item = blockIdx.x; item < a.B * chunks; item += gridDim.x) {
    const int b = item / chunks, ch = item % chunks;
    unsigned long long key = 0ull;
    for (int h = threadIdx.x; h < a.H; h += THREADS) {
      const unsigned c = static_cast<unsigned>(__ldcg(a.counts + (int64_t)b * a.H + h));
      const unsigned long long k =
          (static_cast<unsigned long long>(c) << 32) | (0xffffffffu - static_cast<unsigned>(h));
      key = k > key ? k : key;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL, key, off);
      key = o > key ? o : key;
    }
    if (lane == 0) warp_best[threadIdx.x >> 5] = key;
    __syncthreads();
    key = warp_best[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) key = warp_best[w] > key ? warp_best[w] : key;
    const int hb = static_cast<int>(0xffffffffu - static_cast<unsigned>(key & 0xffffffffu));
    const int64_t jb = (int64_t)b * a.H + hb;
    if (ch == 0 && threadIdx.x == 0 && a.best != nullptr) a.best[b] = hb;
    const int n = ch * THREADS + threadIdx.x;
    if (n < a.N) {
      const int64_t r = (int64_t)b * a.N + n;
      a.inliers[r] = a.mask[r] != 0 && (a.valid == nullptr || a.valid[jb] != 0) &&
                     ray_inlier(a, a.T + 7 * jb, r);
    }
    __syncthreads();  // warp_best is read before the next item writes it
  }
}

}  // namespace

// T (B, H, 7) f64; va, vb (B, N, 3) f64 or null (zero origins); fa, fb
// (B, N, 3) f64; mask (B, N) bool; valid (B, H) bool or null.  Outputs:
// counts (B, H) int32; best (B,) int32 and inliers (B, N) bool, or both
// null for the counts alone.  Returns 0 or the CUDA error.
extern "C" int covins_ray_ransac_score(const void* T, const void* va, const void* fa,
                                       const void* vb, const void* fb, const void* mask,
                                       const void* valid, int B, int H, int N, double thr,
                                       void* counts, void* best, void* inliers, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  Args a{static_cast<const double*>(T),     static_cast<const double*>(va),
         static_cast<const double*>(fa),    static_cast<const double*>(vb),
         static_cast<const double*>(fb),    static_cast<const uint8_t*>(mask),
         static_cast<const uint8_t*>(valid), B, H, N, thr,
         static_cast<int32_t*>(counts),     static_cast<int32_t*>(best),
         static_cast<uint8_t*>(inliers)};
  void* args[] = {&a};
  // a warp per hypothesis in phase 1
  return coop::launch(score_kernel, THREADS, 0, 32LL * B * H, 1 << 30, coop::Slots::kRefuse,
                      args, static_cast<cudaStream_t>(stream));
}
