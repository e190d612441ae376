// Relative-pose RANSAC on the card: the central 5-point RANSAC whole, and
// the scoring of any batch of relative-pose hypotheses, each in one
// cooperative launch.
//
// Replaces: covins_tpu/ops/epipolar.py:327 relative_pose_ransac_central_5pt
// whole (with covins_tpu/ops/ransac.py:18 sample_minimal_sets, :216
// essential_5pt, :113 decompose_essential, linalg.py:191 jacobi_eigh and
// :269 svd3x3, polynomial.py:159 solve_poly_real): the six central
// RANSACs of the COVINS-G verification, loopverify.py:509-511.  And the
// scoring of every other RANSAC of epipolar.py: :68 ray_angular_error
// (with :46 triangulate_midpoint), the inlier mask err < threshold & mask
// (& valid), the counts, the first argmax and the best row's inliers of
// :131 relative_pose_ransac_central, :413 relative_pose_ransac_noncentral
// (its hypotheses and its weighted re-solve) and the counts of :453
// sampling_covariance; on the COVINS-G path, loopverify.py:458
// _covinsg_verify_impl.
//
// Bound on the H100: the scoring does per (valid hypothesis, masked-in
// ray) 164 float64 operations non-central and 122 central
// (chip_smoke.RAY_SCORE_OPS: the rotations, the midpoint triangulation,
// two angles with their square roots, divisions and acos, each counted
// one) against 7 doubles a hypothesis and 6 or 12 doubles a ray read
// once; the 5-point solve adds a counted float64 budget per sample
// (chip_smoke.FIVE_POINT_OPS), so operations at the float64 rate.  Each
// sample's solve is one dependent chain of tens of thousands of
// instructions (288 Jacobi rotations of atan2, cos and sin), so the
// latency of one warp is what the launch waits for.
//
// Design.  Phase 0: block b compacts batch entry b's masked-in rays, in
// index order, into global scratch, and the grid zeroes the counts.
// -- grid barrier --.  Phase A (5-point only): a warp per sample (warps
// numbered across the blocks first, so samples spread over the SMs), with
// a workspace in shared memory: the top 5 of the sample's noise row over
// the compacted rays (ties to the lowest index; fewer than five masked-in
// rays: the whole row, the masked ones -inf) or its row of idx; A^T A as
// chains of emulated fused multiply-adds; the 9 x 9 cyclic Jacobi, the
// lanes over the rows and columns of each rotation; the trivariate
// polynomial products, the lanes over output coefficients; the 10 x 20
// Gauss-Jordan, the lanes over columns; the degree-10 polynomial; the
// 256-point bracket grid, the lanes over points, and a warp scan of its
// sign changes; then lane r < 10 takes root r: bisection, Newton polish,
// back-substitution, normalisation, the 3 x 3 SVD and the 4 poses.
// -- grid barrier --.  Phase B: a work item is (batch entry, hypothesis,
// chunk of compacted rays), chunks sized so that the items outnumber the
// warps fourfold; a warp counts its chunk's inliers by ballots and adds
// them to the hypothesis's count by one int32 atomicAdd (order-free, so
// exact).  -- grid barrier, when the inliers are asked for --.  Phase C:
// a block per (batch entry, chunk of rays) takes the first maximum of the
// entry's counts (a 64-bit (count << 32 | ~h) max over the block) and
// recomputes that hypothesis's inlier test on its chunk; the 5-point
// launch also writes the best pose and its count.
//
// Float64 without FMA contraction (--fmad=false), every sum in one written
// order, the clamps and maxima written as comparisons that keep NaN, as
// torch.clamp / torch.amax / jnp.maximum do (CUDA's fmin / fmax drop it),
// sign as (0 < x) - (x < 0), argmax and the stable argsort with NaN above
// every number, and the same CUDA math functions (sqrt, pow, atan2, cos,
// sin, tan, acos) as PyTorch's kernels call.  The plain versions,
// epipolar.relative_pose_ransac_central_5pt_plain and
// epipolar.ray_ransac_score_plain, write the same arithmetic as tensor
// operations, so they agree bit for bit on the card.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr double kPi = 3.141592653589793;

// the 5-point solve's constants (epipolar.py essential_5pt, polynomial.py)
constexpr int kGrid = 256;     // solve_poly_real n_grid
constexpr int kBisect = 44;    // bisect_iters
constexpr int kNewton = 3;     // newton_iters
constexpr int kDeg = 10;       // the degree-10 polynomial
constexpr int kPoses = 40;     // 10 roots x 4 decompositions a sample

// one warp's shared workspace, in doubles
constexpr int W_BASIS = 0;          // (4, 9) nullspace basis E1..E4
constexpr int W_BX = 36;            // Bx (3, 4), By (3, 4), Bz (3, 5)
constexpr int W_BY = 48;
constexpr int W_BZ = 60;
constexpr int W_P10 = 75;           // (11,)
constexpr int W_INT = 86;           // 10 ints: sort order, then brackets
constexpr int W_TMP = 96;
constexpr int T_M = W_TMP;          // Jacobi (18, 9): A^T A over V
constexpr int T_LIN = W_TMP;        // (3, 3, 8) linear trivariates
constexpr int T_MIN = W_TMP + 72;   // 3 minors (27 each)
constexpr int T_EET = W_TMP + 153;  // (3, 3, 27)
constexpr int T_TR = W_TMP + 396;   // (27,)
constexpr int T_ROW = W_TMP + 423;  // (10, 20) Nister matrix
constexpr int T_F = W_TMP;          // (256,) the bracket grid's values
constexpr int W_SIZE = W_TMP + 624;

// Nister's 20 monomials (epipolar._NISTER_MONOMIALS) as indices of the
// (4, 4, 4) coefficient grid
__constant__ int kMono[20] = {48, 12, 36, 24, 33, 32, 9, 8, 21, 20,
                              18, 17, 16, 6, 5, 4, 3, 2, 1, 0};

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
  int32_t* order;    // (B, N) scratch: compacted masked-in rays
  int32_t* nv;       // (B,) scratch: their number
  double* T_best;    // (B, 7) or null
  int32_t* n_inl;    // (B,) or null
  // the 5-point RANSAC: S samples a batch entry from noise (B, Hn, N) or
  // idx (B, S, 5); its poses and validity are T and valid
  const double* noise;
  int Hn;
  const int64_t* idx;
  int S;
  double* poses;
  uint8_t* pvalid;
};

// ------------------------------------------------------------ arithmetic
__device__ __forceinline__ double clamp_min(double x, double lo) {
  return isnan(x) ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ double clamp2(double x, double lo, double hi) {
  return isnan(x) ? x : (x < lo ? lo : (x > hi ? hi : x));
}
// torch.amax / jnp.maximum: NaN if either is
__device__ __forceinline__ double nanmax(double x, double y) {
  return (isnan(x) || isnan(y)) ? x + y : (x > y ? x : y);
}
__device__ __forceinline__ double sgn(double x) {
  return static_cast<double>(static_cast<int>(0.0 < x) - static_cast<int>(x < 0.0));
}
// epipolar._psafe
__device__ __forceinline__ double psafe(double x) {
  return fabs(x) < 1e-20 ? (x < 0 ? -1e-20 : 1e-20) : x;
}
// the stable ascending order of torch.argsort: NaN above every number
__device__ __forceinline__ bool sorts_before(double x, int i, double y, int j) {
  const bool xn = isnan(x), yn = isnan(y);
  if (xn || yn) return !xn || (yn && i < j);
  return x < y || (x == y && i < j);
}
// epipolar._split / _fma: Veltkamp's split, Dekker's exact product and a
// two-sum; a * b + c rounded once
__device__ __forceinline__ void split(double x, double& hi, double& lo) {
  const double t = 134217729.0 * x;
  hi = t - (t - x);
  lo = x - hi;
}
__device__ __forceinline__ double fma_emu(double a, double b, double c) {
  const double p = a * b;
  double ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  const double e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
  const double s = p + c;
  const double bb = s - p;
  const double t = (p - (s - bb)) + (c - bb);
  return s + (t + e);
}

__device__ __forceinline__ double dot3(const double (&p)[3], const double (&q)[3]) {
  return (p[0] * q[0] + p[1] * q[1]) + p[2] * q[2];
}
__device__ __forceinline__ void cross3(const double (&a)[3], const double (&b)[3],
                                       double (&c)[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}
// epipolar._norm: the squares summed in order
__device__ __forceinline__ double norm3(const double (&v)[3]) { return sqrt(dot3(v, v)); }

// ------------------------------------------------------------ scoring
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

// ray r (a global ray index) an inlier of pose T: the reference's
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
  const double err = nanmax(angle(va, fa, X), angle(ob, db, X));
  return (ok ? err : kPi) < a.thr;
}

// phase 0: the compacted masked-in rays of each batch entry (a block an
// entry), the counts zeroed
__device__ void compact(const Args& a) {
  __shared__ int warp_total[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n_counts = (int64_t)a.B * a.H;
  for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < n_counts;
       j += (int64_t)gridDim.x * THREADS)
    a.counts[j] = 0;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const uint8_t* m = a.mask + (int64_t)b * a.N;
    const int per = (a.N + THREADS - 1) / THREADS;
    const int n0 = min(a.N, threadIdx.x * per), n1 = min(a.N, n0 + per);
    int cnt = 0;
    for (int n = n0; n < n1; ++n) cnt += m[n] != 0;
    int incl = cnt;  // inclusive scan over the warp, then the warps
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int base = incl - cnt;
    for (int w = 0; w < warp; ++w) base += warp_total[w];
    if (threadIdx.x == THREADS - 1) a.nv[b] = base + cnt;
    int32_t* ord = a.order + (int64_t)b * a.N;
    for (int n = n0; n < n1; ++n)
      if (m[n] != 0) ord[base++] = n;
    __syncthreads();  // warp_total is read before the next entry writes it
  }
}

// phase B: (batch entry, hypothesis, chunk of compacted rays) items
__device__ void score(const Args& a, int gwarp, int nwarps, int lane) {
  long long work = 0;
  for (int b = 0; b < a.B; ++b) work += (long long)a.H * __ldcg(a.nv + b);
  // rays a lane takes per item: the items outnumber the warps fourfold
  const int m = static_cast<int>(max(1LL, work / (32LL * 4 * nwarps)));
  const int chunk = 32 * m;
  int total = 0;
  for (int b = 0; b < a.B; ++b) total += a.H * ((__ldcg(a.nv + b) + chunk - 1) / chunk);
  for (int it = gwarp; it < total; it += nwarps) {
    int local = it, b = 0, nvb = 0, nch = 0;
    for (;; ++b) {
      nvb = __ldcg(a.nv + b);
      nch = (nvb + chunk - 1) / chunk;
      if (local < a.H * nch) break;
      local -= a.H * nch;
    }
    const int h = local / nch;
    const int k0 = (local % nch) * chunk;
    const int64_t j = (int64_t)b * a.H + h;
    if (a.valid != nullptr && a.valid[j] == 0) continue;
    double T[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) T[i] = a.T[7 * j + i];
    const int32_t* ord = a.order + (int64_t)b * a.N;
    const int k1 = min(nvb, k0 + chunk);
    // two rays a lane at a time, each test computed whole (a lane past the
    // chunk tests its last ray and drops it), so that the two chains overlap
    int cnt = 0;
    for (int k = k0 + lane; k - lane < k1; k += 64) {
      const int64_t r0 = (int64_t)b * a.N + ord[min(k, k1 - 1)];
      const int64_t r1 = (int64_t)b * a.N + ord[min(k + 32, k1 - 1)];
      const bool in0 = ray_inlier(a, T, r0) && k < k1;
      const bool in1 = ray_inlier(a, T, r1) && k + 32 < k1;
      cnt += __popc(__ballot_sync(FULL, in0)) + __popc(__ballot_sync(FULL, in1));
    }
    if (lane == 0 && cnt > 0) atomicAdd(a.counts + j, cnt);
  }
}

// phase C: the first best hypothesis of each batch entry and its inliers
__device__ void best_and_inliers(const Args& a) {
  __shared__ unsigned long long warp_best[WARPS];
  const int lane = threadIdx.x & 31;
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
    for (int w = 1; w < WARPS; ++w) key = warp_best[w] > key ? warp_best[w] : key;
    const int hb = static_cast<int>(0xffffffffu - static_cast<unsigned>(key & 0xffffffffu));
    const int64_t jb = (int64_t)b * a.H + hb;
    if (ch == 0) {
      if (threadIdx.x == 0 && a.best != nullptr) a.best[b] = hb;
      if (threadIdx.x == 0 && a.n_inl != nullptr) a.n_inl[b] = static_cast<int32_t>(key >> 32);
      if (threadIdx.x < 7 && a.T_best != nullptr) a.T_best[7 * b + threadIdx.x] = a.T[7 * jb + threadIdx.x];
    }
    const int n = ch * THREADS + threadIdx.x;
    if (n < a.N) {
      const int64_t r = (int64_t)b * a.N + n;
      a.inliers[r] = a.mask[r] != 0 && (a.valid == nullptr || a.valid[jb] != 0) &&
                     ray_inlier(a, a.T + 7 * jb, r);
    }
    __syncthreads();  // warp_best is read before the next item writes it
  }
}

__global__ void __launch_bounds__(THREADS) score_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  compact(a);
  grid.sync();
  score(a, warp * gridDim.x + blockIdx.x, WARPS * gridDim.x, lane);
  if (a.inliers == nullptr) return;
  grid.sync();
  best_and_inliers(a);
}

// ------------------------------------------------------ the 5-point solve
// a candidate of a minimal set: larger noise first, then the lower index
struct Cand {
  double v;
  int i;
};
__device__ __forceinline__ bool before(const Cand& a, const Cand& b) {
  return a.v > b.v || (a.v == b.v && a.i < b.i);
}

// the top five of `row` over the `count` rays order[0..count) (order null:
// over 0..count, masked ones -inf), for the whole warp (every lane returns
// them); returns the fifth
__device__ Cand top5_scan(const double* row, const int32_t* order, const uint8_t* mask,
                          int count, int lane, int out[5]) {
  Cand c[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) c[k] = Cand{-INFINITY, 0x7fffffff};
  for (int k = lane; k < count; k += 32) {
    const int i = order != nullptr ? order[k] : k;
    const Cand x{order != nullptr || mask[k] != 0 ? row[i] : -INFINITY, i};
    if (!before(x, c[4])) continue;
    c[4] = x;
#pragma unroll
    for (int s = 4; s > 0; --s)
      if (before(c[s], c[s - 1])) {
        const Cand t = c[s];
        c[s] = c[s - 1];
        c[s - 1] = t;
      }
  }
  // five rounds of a warp-wide first: the lane whose head wins pops it
  Cand b;
  for (int r = 0; r < 5; ++r) {
    b = c[0];
    for (int off = 16; off > 0; off >>= 1) {
      const Cand o{__shfl_xor_sync(FULL, b.v, off), __shfl_xor_sync(FULL, b.i, off)};
      if (before(o, b)) b = o;
    }
    out[r] = b.i;
    if (c[0].i == b.i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) c[k] = c[k + 1];
      c[4] = Cand{-INFINITY, 0x7fffffff};
    }
  }
  return b;
}

// coefficient o of the product of two cubic coefficient grids P (dp^3)
// and Q (dq^3): polynomial.convolve, summed over the smaller grid (P on a
// tie) in index order from zero
__device__ double pmul_at(const double* P, int dp, const double* Q, int dq, int o0, int o1,
                          int o2) {
  const double* S = P;
  const double* L = Q;
  int ds = dp, dl = dq;
  if (dp > dq) {
    S = Q;
    L = P;
    ds = dq;
    dl = dp;
  }
  double acc = 0.0;
  for (int i0 = 0; i0 < ds; ++i0) {
    const int j0 = o0 - i0;
    if (j0 < 0 || j0 >= dl) continue;
    for (int i1 = 0; i1 < ds; ++i1) {
      const int j1 = o1 - i1;
      if (j1 < 0 || j1 >= dl) continue;
      for (int i2 = 0; i2 < ds; ++i2) {
        const int j2 = o2 - i2;
        if (j2 < 0 || j2 >= dl) continue;
        acc = acc + S[(i0 * ds + i1) * ds + i2] * L[(j0 * dl + j1) * dl + j2];
      }
    }
  }
  return acc;
}

// coefficient o of the 1-D convolution of u (nu) and v (nv), in
// polynomial.convolve's order
__device__ double conv1_at(const double* u, int nu, const double* v, int nv, int o) {
  const double* S = u;
  const double* L = v;
  int ns = nu, nl = nv;
  if (nu > nv) {
    S = v;
    L = u;
    ns = nv;
    nl = nu;
  }
  double acc = 0.0;
  for (int i = 0; i < ns; ++i) {
    const int j = o - i;
    if (j >= 0 && j < nl) acc = acc + S[i] * L[j];
  }
  return acc;
}

__device__ __forceinline__ const double* lin(const double* w, int i, int j) {
  return w + T_LIN + 8 * (3 * i + j);
}

// solve_poly_real's homogenised form at theta: sum_k c[k] sin^(D-k) cos^k,
// the powers as product chains, the terms summed from the left
__device__ double homog(const double (&c)[kDeg + 1], double th) {
  const double sn = sin(th), cs = cos(th);
  double sp[kDeg + 1], cp[kDeg + 1];
  sp[0] = 1.0;
  cp[0] = 1.0;
#pragma unroll
  for (int m = 1; m <= kDeg; ++m) {
    sp[m] = sp[m - 1] * sn;
    cp[m] = cp[m - 1] * cs;
  }
  double acc = (c[0] * sp[kDeg]) * cp[0];
#pragma unroll
  for (int k = 1; k <= kDeg; ++k) acc = acc + (c[k] * sp[kDeg - k]) * cp[k];
  return acc;
}

// polynomial._linspace's grid point g
__device__ __forceinline__ double theta_at(int g) {
  const double start = -kPi / 2 + 1e-4, stop = kPi / 2 - 1e-4;
  const double delta = (stop - start) / (kGrid - 1);
  return g == kGrid - 1 ? stop : start + static_cast<double>(g) * delta;
}

// linalg.jacobi_eigh of a 3 x 3 (8 sweeps) in registers: M rows 0-2 the
// matrix, rows 3-5 the eigenvectors
__device__ void jacobi3(double (&M)[6][3]) {
#pragma unroll 1
  for (int sweep = 0; sweep < 8; ++sweep) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int q = p + 1; q < 3; ++q) {
        const double app = M[p][p], aqq = M[q][q], apq = M[p][q];
        const bool small = fabs(apq) <= 1e-14 * (fabs(app) + fabs(aqq));
        double c = 1.0, s = 0.0;
        if (!small) {
          const double phi = 0.5 * atan2(2.0 * apq, aqq - app);
          c = cos(phi);
          s = sin(phi);
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const double rp = c * M[p][j] - s * M[q][j];
          const double rq = s * M[p][j] + c * M[q][j];
          M[p][j] = rp;
          M[q][j] = rq;
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const double cp = c * M[i][p] - s * M[i][q];
          const double cq = s * M[i][p] + c * M[i][q];
          M[i][p] = cp;
          M[i][q] = cq;
        }
      }
    }
  }
}

// epipolar._orthogonal_unit
__device__ void orthogonal_unit(const double (&u)[3], double (&out)[3]) {
  const double ex[3] = {1.0, 0.0, 0.0}, ey[3] = {0.0, 1.0, 0.0};
  double c[3], alt[3];
  cross3(u, ex, c);
  cross3(u, ey, alt);
  if (norm3(c) < 1e-6)
    for (int k = 0; k < 3; ++k) c[k] = alt[k];
  const double n = clamp_min(norm3(c), 1e-30);
  for (int k = 0; k < 3; ++k) out[k] = c[k] / n;
}

// epipolar._svd3x3: (U, Vt) of E
__device__ void svd3x3(const double (&E)[3][3], double (&U)[3][3], double (&Vt)[3][3]) {
  double M[6][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double acc = E[0][i] * E[0][j];
      for (int k = 1; k < 3; ++k) acc = acc + E[k][i] * E[k][j];
      M[i][j] = acc;
      M[3 + i][j] = i == j ? 1.0 : 0.0;
    }
  jacobi3(M);
  // the ascending stable order, flipped: column k of V is eigenvector ord[2 - k]
  int rank[3];
  for (int k = 0; k < 3; ++k) {
    rank[k] = 0;
    for (int m = 0; m < 3; ++m) rank[k] += sorts_before(M[m][m], m, M[k][k], k);
  }
  double V[3][3], S0 = 0.0;
  for (int k = 0; k < 3; ++k) {
    const int col = 2 - rank[k];  // descending position of eigenvalue k
    for (int i = 0; i < 3; ++i) V[i][col] = M[3 + i][k];
    if (col == 0) S0 = sqrt(clamp_min(M[k][k], 0.0));
  }
  double AV[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double acc = E[i][0] * V[0][j];
      for (int k = 1; k < 3; ++k) acc = acc + E[i][k] * V[k][j];
      AV[i][j] = acc;
    }
  const double eps = 1e-12 * (1.0 + S0);
  double u0[3] = {AV[0][0], AV[1][0], AV[2][0]};
  const double n0 = norm3(u0);
  {
    const double d = clamp_min(n0, 1e-30);
    const bool keep = n0 > eps;
    for (int k = 0; k < 3; ++k) u0[k] = keep ? u0[k] / d : (k == 0 ? 1.0 : 0.0);
  }
  double u1[3] = {AV[0][1], AV[1][1], AV[2][1]};
  const double d01 = dot3(u1, u0);
  for (int k = 0; k < 3; ++k) u1[k] = u1[k] - d01 * u0[k];
  const double n1 = norm3(u1);
  if (n1 > eps) {
    const double d = clamp_min(n1, 1e-30);
    for (int k = 0; k < 3; ++k) u1[k] = u1[k] / d;
  } else {
    orthogonal_unit(u0, u1);
  }
  double u2[3];
  cross3(u0, u1, u2);
  const double a2[3] = {AV[0][2], AV[1][2], AV[2][2]};
  const double d2 = dot3(a2, u2);
  const double f = fabs(d2) > eps ? sgn(d2) : 1.0;
  for (int k = 0; k < 3; ++k) u2[k] = u2[k] * f;
  for (int i = 0; i < 3; ++i) {
    U[i][0] = u0[i];
    U[i][1] = u1[i];
    U[i][2] = u2[i];
    for (int j = 0; j < 3; ++j) Vt[j][i] = V[i][j];
  }
}

// linalg.det33
__device__ __forceinline__ double det33(const double (&A)[3][3]) {
  return A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1]) -
         A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0]) +
         A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]);
}

// epipolar._mm for 3 x 3
__device__ __forceinline__ void mm3(const double (&A)[3][3], const double (&B)[3][3],
                                    double (&C)[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double acc = A[i][0] * B[0][j];
      for (int k = 1; k < 3; ++k) acc = acc + A[i][k] * B[k][j];
      C[i][j] = acc;
    }
}

// epipolar._quat_normalize
__device__ void quat_normalize(double (&q)[4]) {
  const double n = sqrt(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]);
  const double d = clamp_min(n, 1e-12);
  for (int k = 0; k < 4; ++k) q[k] = q[k] / d;
  if (q[0] < 0)
    for (int k = 0; k < 4; ++k) q[k] = -q[k];
}

// epipolar._matrix_to_quat
__device__ void matrix_to_quat(const double (&R)[3][3], double (&q)[4]) {
  const double m00 = R[0][0], m01 = R[0][1], m02 = R[0][2];
  const double m10 = R[1][0], m11 = R[1][1], m12 = R[1][2];
  const double m20 = R[2][0], m21 = R[2][1], m22 = R[2][2];
  const double tr = (m00 + m11) + m22;
  if (tr > 0.0) {
    const double s = sqrt(clamp_min(tr + 1.0, 1e-24)) * 2.0;
    q[0] = 0.25 * s;
    q[1] = (m21 - m12) / s;
    q[2] = (m02 - m20) / s;
    q[3] = (m10 - m01) / s;
  } else if (m00 > m11 && m00 > m22) {
    const double s = sqrt(clamp_min(((1.0 + m00) - m11) - m22, 1e-24)) * 2.0;
    q[0] = (m21 - m12) / s;
    q[1] = 0.25 * s;
    q[2] = (m01 + m10) / s;
    q[3] = (m02 + m20) / s;
  } else if (m11 > m22) {
    const double s = sqrt(clamp_min(((1.0 + m11) - m00) - m22, 1e-24)) * 2.0;
    q[0] = (m02 - m20) / s;
    q[1] = (m01 + m10) / s;
    q[2] = 0.25 * s;
    q[3] = (m12 + m21) / s;
  } else {
    const double s = sqrt(clamp_min(((1.0 + m22) - m00) - m11, 1e-24)) * 2.0;
    q[0] = (m10 - m01) / s;
    q[1] = (m02 + m20) / s;
    q[2] = (m12 + m21) / s;
    q[3] = 0.25 * s;
  }
  quat_normalize(q);
}

// root r of sample (b, h): lane r's bisection, polish, back-substitution,
// normalisation and the 4 poses of epipolar.decompose_essential
__device__ void solve_root(const Args& a, const double* w, const double (&c)[kDeg + 1],
                           const double (&p)[kDeg + 1], double s, int n_brackets, int r,
                           int64_t pose0) {
  const int* brk = reinterpret_cast<const int*>(w + W_INT);
  const bool valid = r < n_brackets;
  double z = 0.0;
  if (valid) {
    const int g = brk[r];
    double lo = theta_at(g), hi = theta_at(g + 1);
    double f_lo = homog(c, lo);
#pragma unroll 1
    for (int it = 0; it < kBisect; ++it) {
      const double mid = 0.5 * (lo + hi);
      const double f_mid = homog(c, mid);
      const bool left = f_lo * f_mid <= 0;
      hi = left ? mid : hi;
      lo = left ? lo : mid;
      f_lo = left ? f_lo : f_mid;
    }
    double x = tan(0.5 * (lo + hi)) * s;
    // polynomial.polish_real_roots against the unscaled polynomial
    double d[kDeg];
#pragma unroll
    for (int i = 0; i < kDeg; ++i) d[i] = p[i] * static_cast<double>(kDeg - i);
#pragma unroll 1
    for (int it = 0; it < kNewton; ++it) {
      double f = 0.0, fp = 0.0;
#pragma unroll
      for (int i = 0; i <= kDeg; ++i) f = f * x + p[i];
#pragma unroll
      for (int i = 0; i < kDeg; ++i) fp = fp * x + d[i];
      x = x - f / (fabs(fp) < 1e-20 ? 1e-20 : fp);
    }
    z = x;
  }
  // back-substitution: [Bx(z) By(z)] [x y]^T = -Bz(z)
  double ax[3], ay[3], az[3];
  for (int i = 0; i < 3; ++i) {
    double hx = 0.0, hy = 0.0, hz = 0.0;
    for (int m = 0; m < 4; ++m) {
      hx = hx * z + w[W_BX + 4 * i + m];
      hy = hy * z + w[W_BY + 4 * i + m];
    }
    for (int m = 0; m < 5; ++m) hz = hz * z + w[W_BZ + 5 * i + m];
    ax[i] = hx;
    ay[i] = hy;
    az[i] = hz;
  }
  const double N00 = (ax[0] * ax[0] + ax[1] * ax[1]) + ax[2] * ax[2];
  const double N01 = (ax[0] * ay[0] + ax[1] * ay[1]) + ax[2] * ay[2];
  const double N10 = (ay[0] * ax[0] + ay[1] * ax[1]) + ay[2] * ax[2];
  const double N11 = (ay[0] * ay[0] + ay[1] * ay[1]) + ay[2] * ay[2];
  const double r0 = -((ax[0] * az[0] + ax[1] * az[1]) + ax[2] * az[2]);
  const double r1 = -((ay[0] * az[0] + ay[1] * az[1]) + ay[2] * az[2]);
  const double dd = psafe(N00 * N11 - N01 * N10);
  const double x = (r0 * N11 - r1 * N01) / dd;
  const double y = (N00 * r1 - N10 * r0) / dd;
  const double* bs = w + W_BASIS;
  double e[9];
  double sq = 0.0;
  for (int m = 0; m < 9; ++m) {
    e[m] = ((x * bs[m] + y * bs[9 + m]) + z * bs[18 + m]) + bs[27 + m];
    sq = m == 0 ? e[m] * e[m] : sq + e[m] * e[m];
  }
  const double nrm = clamp_min(sqrt(sq), 1e-30);
  double E[3][3];
  for (int m = 0; m < 9; ++m) E[m / 3][m % 3] = e[m] / nrm;

  // decompose_essential
  double U[3][3], Vt[3][3];
  svd3x3(E, U, Vt);
  const double su = sgn(det33(U)), sv = sgn(det33(Vt));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      U[i][j] = U[i][j] * su;
      Vt[i][j] = Vt[i][j] * sv;
    }
  const double t[3] = {U[0][2], U[1][2], U[2][2]};
  const double W[3][3] = {{0.0, -1.0, 0.0}, {1.0, 0.0, 0.0}, {0.0, 0.0, 1.0}};
  const double Wt[3][3] = {{0.0, 1.0, 0.0}, {-1.0, 0.0, 0.0}, {0.0, 0.0, 1.0}};
  for (int k = 0; k < 2; ++k) {
    double UW[3][3], R[3][3], q[4];
    mm3(U, k == 0 ? W : Wt, UW);
    mm3(UW, Vt, R);
    matrix_to_quat(R, q);
    quat_normalize(q);  // pose_from_qt normalises again
    for (int si = 0; si < 2; ++si) {
      const double sign = si == 0 ? 1.0 : -1.0;
      const int64_t j = pose0 + 4 * r + 2 * k + si;
      double* T = a.poses + 7 * j;
      for (int i = 0; i < 4; ++i) T[i] = q[i];
      for (int i = 0; i < 3; ++i) T[4 + i] = sign * t[i];
      a.pvalid[j] = valid;
    }
  }
}

// one sample (b, h) by one warp: its 40 poses and their validity
__device__ void solve_sample(const Args& a, int b, int h, double* w, int lane) {
  // the minimal set
  int set[5];
  if (a.idx != nullptr) {
    for (int r = 0; r < 5; ++r) {  // an index outside [0, N) reads no memory
      const int64_t v = a.idx[((int64_t)b * a.S + h) * 5 + r];
      set[r] = v < 0 ? 0 : (v >= a.N ? a.N - 1 : static_cast<int>(v));
    }
  } else {
    const double* row = a.noise + ((int64_t)b * a.Hn + h) * a.N;
    const int nvb = __ldcg(a.nv + b);
    if (top5_scan(row, a.order + (int64_t)b * a.N, nullptr, nvb, lane, set).v == -INFINITY)
      top5_scan(row, nullptr, a.mask + (int64_t)b * a.N, a.N, lane, set);
  }
  double ra[5][3], rb[5][3];
  for (int k = 0; k < 5; ++k)
    for (int i = 0; i < 3; ++i) {
      const int64_t r = (int64_t)b * a.N + set[k];
      ra[k][i] = a.fa[3 * r + i];
      rb[k][i] = a.fb[3 * r + i];
    }
  // A^T A (epipolar._gram) over the eigenvectors' identity
  double* M = w + T_M;
  for (int e = lane; e < 81; e += 32) {
    const int i = e / 9, j = e % 9;
    double acc = 0.0;
    for (int k = 0; k < 5; ++k)
      acc = fma_emu(ra[k][i / 3] * rb[k][i % 3], ra[k][j / 3] * rb[k][j % 3], acc);
    M[e] = acc;
    M[81 + e] = i == j ? 1.0 : 0.0;
  }
  __syncwarp();
  // linalg.jacobi_eigh: 8 cyclic sweeps, the lanes over each rotation's
  // row (9 columns) and column (18 rows) updates
#pragma unroll 1
  for (int sweep = 0; sweep < 8; ++sweep) {
#pragma unroll 1
    for (int p = 0; p < 8; ++p) {
#pragma unroll 1
      for (int q = p + 1; q < 9; ++q) {
        const double app = M[9 * p + p], aqq = M[9 * q + q], apq = M[9 * p + q];
        const bool small = fabs(apq) <= 1e-14 * (fabs(app) + fabs(aqq));
        double c = 1.0, s = 0.0;
        if (!small) {
          const double phi = 0.5 * atan2(2.0 * apq, aqq - app);
          c = cos(phi);
          s = sin(phi);
        }
        __syncwarp();
        if (lane < 9) {
          const double mp = M[9 * p + lane], mq = M[9 * q + lane];
          M[9 * p + lane] = c * mp - s * mq;
          M[9 * q + lane] = s * mp + c * mq;
        }
        __syncwarp();
        if (lane < 18) {
          const double mp = M[9 * lane + p], mq = M[9 * lane + q];
          M[9 * lane + p] = c * mp - s * mq;
          M[9 * lane + q] = s * mp + c * mq;
        }
        __syncwarp();
      }
    }
  }
  // the eigenvectors of the 4 smallest eigenvalues (stable ascending
  // order), rows of the basis: basis[k][m] = V[m][order[k]]
  int* ord = reinterpret_cast<int*>(w + W_INT);
  if (lane < 9) {
    int rank = 0;
    for (int m = 0; m < 9; ++m) rank += sorts_before(M[10 * m], m, M[10 * lane], lane);
    ord[rank] = lane;
  }
  __syncwarp();
  for (int e = lane; e < 36; e += 32) w[W_BASIS + e] = M[81 + 9 * (e % 9) + ord[e / 9]];
  __syncwarp();
  // E(x, y, z) = x E1 + y E2 + z E3 + E4: (3, 3) linear trivariates on
  // (2, 2, 2) grids
  for (int e = lane; e < 72; e += 32) {
    const int ij = e / 8, g = e % 8;
    const double* bs = w + W_BASIS + ij;
    w[T_LIN + e] = g == 4 ? bs[0] : (g == 2 ? bs[9] : (g == 1 ? bs[18] : (g == 0 ? bs[27] : 0.0)));
  }
  __syncwarp();
  // the minors (1, 2, 1, 2), (1, 2, 0, 2), (1, 2, 0, 1) and E E^T
  for (int e = lane; e < 81 + 243; e += 32) {
    const int o = e % 27, o0 = o / 9, o1 = (o / 3) % 3, o2 = o % 3;
    if (e < 81) {
      const int mi = e / 27;
      const int j0 = mi == 0 ? 1 : 0, j1 = mi == 2 ? 1 : 2;
      w[T_MIN + e] = pmul_at(lin(w, 1, j0), 2, lin(w, 2, j1), 2, o0, o1, o2) -
                     pmul_at(lin(w, 1, j1), 2, lin(w, 2, j0), 2, o0, o1, o2);
    } else {
      const int ij = (e - 81) / 27, i = ij / 3, j = ij % 3;
      w[T_EET + e - 81] = (pmul_at(lin(w, i, 0), 2, lin(w, j, 0), 2, o0, o1, o2) +
                           pmul_at(lin(w, i, 1), 2, lin(w, j, 1), 2, o0, o1, o2)) +
                          pmul_at(lin(w, i, 2), 2, lin(w, j, 2), 2, o0, o1, o2);
    }
  }
  __syncwarp();
  if (lane < 27)
    w[T_TR + lane] = (w[T_EET + lane] + w[T_EET + 4 * 27 + lane]) + w[T_EET + 8 * 27 + lane];
  __syncwarp();
  // the 10 cubic constraints at Nister's 20 monomials: det(E), then
  // 2 E E^T E - tr(E E^T) E
  for (int e = lane; e < 200; e += 32) {
    const int row = e / 20, mono = kMono[e % 20];
    const int o0 = mono / 16, o1 = (mono / 4) % 4, o2 = mono % 4;
    double v;
    if (row == 0) {
      v = (pmul_at(lin(w, 0, 0), 2, w + T_MIN, 3, o0, o1, o2) -
           pmul_at(lin(w, 0, 1), 2, w + T_MIN + 27, 3, o0, o1, o2)) +
          pmul_at(lin(w, 0, 2), 2, w + T_MIN + 54, 3, o0, o1, o2);
    } else {
      const int i = (row - 1) / 3, j = (row - 1) % 3;
      const double* eet = w + T_EET + 27 * 3 * i;
      const double cub = (pmul_at(eet, 3, lin(w, 0, j), 2, o0, o1, o2) +
                          pmul_at(eet + 27, 3, lin(w, 1, j), 2, o0, o1, o2)) +
                         pmul_at(eet + 54, 3, lin(w, 2, j), 2, o0, o1, o2);
      v = 2.0 * cub - pmul_at(w + T_TR, 3, lin(w, i, j), 2, o0, o1, o2);
    }
    w[T_ROW + e] = v;
  }
  __syncwarp();
  // epipolar._gauss_jordan on (10, 20), the lanes over the columns
  double* R = w + T_ROW;
#pragma unroll 1
  for (int col = 0; col < 10; ++col) {
    int piv = col;
    double best = fabs(R[20 * col + col]);
    for (int r = col + 1; r < 10; ++r) {  // torch.argmax: the first largest, NaN first
      const double v = fabs(R[20 * r + col]);
      if (!isnan(best) && (isnan(v) || v > best)) {
        best = v;
        piv = r;
      }
    }
    __syncwarp();
    if (piv != col && lane < 20) {
      const double t = R[20 * col + lane];
      R[20 * col + lane] = R[20 * piv + lane];
      R[20 * piv + lane] = t;
    }
    __syncwarp();
    const double pv = psafe(R[20 * col + col]);
    __syncwarp();
    if (lane < 20) R[20 * col + lane] = R[20 * col + lane] / pv;
    __syncwarp();
    double f[10];
#pragma unroll
    for (int r = 0; r < 10; ++r) f[r] = r == col ? 0.0 : R[20 * r + col];
    __syncwarp();
    if (lane < 20) {
      const double rc = R[20 * col + lane];
#pragma unroll
      for (int r = 0; r < 10; ++r) R[20 * r + lane] = R[20 * r + lane] - f[r] * rc;
    }
    __syncwarp();
  }
  // Bx, By, Bz: row(a) - z row(b) of the pairs (4, 5), (6, 7), (8, 9),
  // then the degree-10 determinant
  if (lane == 0) {
    const int cols[3][3] = {{10, 13, W_BX}, {13, 16, W_BY}, {16, 20, W_BZ}};
    for (int v = 0; v < 3; ++v) {
      const int c0 = cols[v][0], c1 = cols[v][1], L = c1 - c0 + 1;
      for (int i = 0; i < 3; ++i) {
        const int ra = 4 + 2 * i, rb = 5 + 2 * i;
        for (int m = 0; m < L; ++m) {
          const double av = m == 0 ? 0.0 : R[20 * ra + c0 + m - 1];
          const double bv = m == L - 1 ? 0.0 : R[20 * rb + c0 + m];
          w[cols[v][2] + L * i + m] = -(av - bv);
        }
      }
    }
    const double* Bx = w + W_BX;
    const double* By = w + W_BY;
    const double* Bz = w + W_BZ;
    double dyz[8], dxz[8], dxy[7];
    for (int o = 0; o < 8; ++o) {
      dyz[o] = conv1_at(By + 4, 4, Bz + 10, 5, o) - conv1_at(By + 8, 4, Bz + 5, 5, o);
      dxz[o] = conv1_at(Bx + 4, 4, Bz + 10, 5, o) - conv1_at(Bx + 8, 4, Bz + 5, 5, o);
    }
    for (int o = 0; o < 7; ++o)
      dxy[o] = conv1_at(Bx + 4, 4, By + 8, 4, o) - conv1_at(Bx + 8, 4, By + 4, 4, o);
    for (int o = 0; o <= kDeg; ++o)
      w[W_P10 + o] = (conv1_at(Bx, 4, dyz, 8, o) - conv1_at(By, 4, dxz, 8, o)) +
                     conv1_at(Bz, 5, dxy, 7, o);
  }
  __syncwarp();

  // polynomial.solve_poly_real(p10, 256, 44): every lane the Fujiwara
  // scale and the scaled coefficients
  double p[kDeg + 1], c[kDeg + 1];
#pragma unroll
  for (int k = 0; k <= kDeg; ++k) p[k] = w[W_P10 + k];
  const double c0 = clamp_min(fabs(p[0]), 1e-30);
  double mx = 0.0;
#pragma unroll
  for (int k = 1; k <= kDeg; ++k) {
    const double ratio = pow(fabs(p[k]) / c0, 1.0 / static_cast<double>(k));
    mx = k == 1 ? ratio : nanmax(mx, ratio);
  }
  const double s = clamp2(2.0 * mx, 1e-3, 1e3);
  double spow[kDeg + 1];
  spow[0] = 1.0;
#pragma unroll
  for (int m = 1; m <= kDeg; ++m) spow[m] = spow[m - 1] * s;
  double amax = 0.0;
#pragma unroll
  for (int k = 0; k <= kDeg; ++k) {
    c[k] = p[k] * spow[kDeg - k];
    amax = k == 0 ? fabs(c[k]) : nanmax(amax, fabs(c[k]));
  }
  const double den = clamp_min(amax, 1e-30);
#pragma unroll
  for (int k = 0; k <= kDeg; ++k) c[k] = c[k] / den;
  // the grid's values, 8 points a lane
  double* F = w + T_F;
  for (int g = lane; g < kGrid; g += 32) F[g] = homog(c, theta_at(g));
  __syncwarp();
  // sign changes of intervals [8 lane, 8 lane + 8), ranked by a warp scan
  int cnt = 0;
  for (int g = 8 * lane; g < min(8 * lane + 8, kGrid - 1); ++g) {
    const double s0 = sgn(F[g]), s1 = sgn(F[g + 1]);
    cnt += (s0 * s1 < 0) || (s0 == 0);
  }
  int incl = cnt;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  const int n_changes = __shfl_sync(FULL, incl, 31);
  int* brk = reinterpret_cast<int*>(w + W_INT);
  __syncwarp();  // the sort order in W_INT is read
  int rank = incl - cnt;
  for (int g = 8 * lane; g < min(8 * lane + 8, kGrid - 1); ++g) {
    const double s0 = sgn(F[g]), s1 = sgn(F[g + 1]);
    if ((s0 * s1 < 0) || (s0 == 0)) {
      if (rank < kDeg) brk[rank] = g;
      ++rank;
    }
  }
  __syncwarp();
  if (lane < kDeg)
    solve_root(a, w, c, p, s, min(n_changes, kDeg), lane,
               ((int64_t)b * a.S + h) * kPoses);
  __syncwarp();  // the workspace is read before the next sample writes it
}

__global__ void __launch_bounds__(THREADS) ransac5_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double work[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gwarp = warp * gridDim.x + blockIdx.x, nwarps = WARPS * gridDim.x;
  compact(a);
  grid.sync();
  double* w = work + W_SIZE * warp;
  for (int j = gwarp; j < a.B * a.S; j += nwarps) solve_sample(a, j / a.S, j % a.S, w, lane);
  grid.sync();
  score(a, gwarp, nwarps, lane);
  grid.sync();
  best_and_inliers(a);
}

}  // namespace

// T (B, H, 7) f64; va, vb (B, N, 3) f64 or null (zero origins); fa, fb
// (B, N, 3) f64; mask (B, N) bool; valid (B, H) bool or null.  Outputs:
// counts (B, H) int32; best (B,) int32 and inliers (B, N) bool, or both
// null for the counts alone; scratch (B * N + B,) int32.  Returns 0 or the
// CUDA error.
extern "C" int covins_ray_ransac_score(const void* T, const void* va, const void* fa,
                                       const void* vb, const void* fb, const void* mask,
                                       const void* valid, int B, int H, int N, double thr,
                                       void* counts, void* best, void* inliers, void* scratch,
                                       void* stream) {
  if (B <= 0 || H <= 0) return 0;
  int32_t* sc = static_cast<int32_t*>(scratch);
  Args a{};
  a.T = static_cast<const double*>(T);
  a.va = static_cast<const double*>(va);
  a.fa = static_cast<const double*>(fa);
  a.vb = static_cast<const double*>(vb);
  a.fb = static_cast<const double*>(fb);
  a.mask = static_cast<const uint8_t*>(mask);
  a.valid = static_cast<const uint8_t*>(valid);
  a.B = B;
  a.H = H;
  a.N = N;
  a.thr = thr;
  a.counts = static_cast<int32_t*>(counts);
  a.best = static_cast<int32_t*>(best);
  a.inliers = static_cast<uint8_t*>(inliers);
  a.order = sc;
  a.nv = sc + (int64_t)B * N;
  void* args[] = {&a};
  // at least a block a batch entry (phase 0); a warp per 32 x H rays is
  // more than the card holds for every call of the path
  const long long items = std::max(1LL * B * THREADS, 1LL * H * N);
  return coop::launch(score_kernel, THREADS, 0, items, 1 << 30, coop::Slots::kRefuse, args,
                      static_cast<cudaStream_t>(stream));
}

// fa, fb (B, N, 3) f64; mask (B, N) bool; noise (B, Hn, N) f64 (Hn >= H)
// or null, idx (B, H, 5) int64 or null (one of the two).  Outputs in three
// buffers: fbuf f64 the poses (B, 40 H, 7) then the best poses (B, 7);
// ibuf int32 the counts (B, 40 H), best (B,), n_inliers (B,), then scratch
// (B * N + B,); bbuf bool the validity (B, 40 H) then the inliers (B, N).
// Returns 0 or the CUDA error.
extern "C" int covins_relpose_ransac_5pt(const void* fa, const void* fb, const void* mask,
                                         const void* noise, const void* idx, int B, int N,
                                         int Hn, int H, double thr, void* fbuf, void* ibuf,
                                         void* bbuf, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const int64_t P = (int64_t)kPoses * H;
  double* fo = static_cast<double*>(fbuf);
  int32_t* io = static_cast<int32_t*>(ibuf);
  uint8_t* bo = static_cast<uint8_t*>(bbuf);
  Args a{};
  a.T = fo;
  a.fa = static_cast<const double*>(fa);
  a.fb = static_cast<const double*>(fb);
  a.mask = static_cast<const uint8_t*>(mask);
  a.valid = bo;
  a.B = B;
  a.H = static_cast<int>(P);
  a.N = N;
  a.thr = thr;
  a.counts = io;
  a.best = io + B * P;
  a.n_inl = io + B * P + B;
  a.order = io + B * P + 2 * B;
  a.nv = io + B * P + 2 * B + (int64_t)B * N;
  a.T_best = fo + 7 * B * P;
  a.inliers = bo + B * P;
  a.noise = static_cast<const double*>(noise);
  a.Hn = Hn;
  a.idx = static_cast<const int64_t*>(idx);
  a.S = H;
  a.poses = fo;
  a.pvalid = bo;
  void* args[] = {&a};
  const size_t smem = sizeof(double) * W_SIZE * WARPS;
  // as many blocks as phase B's hypotheses and rays can use (the card's
  // co-resident blocks at the drain's sizes; a warp a sample in phase A
  // needs fewer), at least a block a batch entry
  const long long items = std::max(1LL * B * P * N, 1LL * B * THREADS);
  return coop::launch(ransac5_kernel, THREADS, smem, items, 1 << 30, coop::Slots::kRefuse,
                      args, static_cast<cudaStream_t>(stream));
}
