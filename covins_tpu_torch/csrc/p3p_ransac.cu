// P3P RANSAC, whole: the minimal sets, Grunert's solver with Horn's
// alignment for every hypothesis and root, the angular-error inlier
// counts, the first best pose and its inlier mask, in one launch.
//
// Replaces: covins_tpu/ops/pnp.py::absolute_pose_ransac (line 338) with
// covins_tpu/ops/ransac.py:18 sample_minimal_sets, pnp.py:31 p3p_grunert
// and :314 reprojection_angular_error: stage 2 of the COVINS loop
// verification (covins_tpu/ops/loopverify.py:92-96).  The correspondences
// are stage 1's: point n is table[clamp(rows[n], 0, C - 1)] and it is
// valid where mask[n] and rows[n] >= 0 (rows null: point n is table[n]).
// Each hypothesis takes the top three of its row of Gumbel noise over the
// valid correspondences (largest first, ties to the lowest index, as
// jax.lax.top_k), or its row of idx; P3P gives up to four poses T_c_w per
// hypothesis; a valid pose counts the valid correspondences whose angular
// error acos(clip(<R p + t, b> / |R p + t|)) is below the threshold (pi
// where |R p + t| <= 1e-9), an invalid one counts -1; the best pose is
// the first maximum.
//
// Bound on the H100: the inputs are a few tens of KB; the work is about
// 300 float64 operations and a few transcendental functions for a
// hypothesis's quartic, about 2,400 operations and 144 transcendentals for
// each root's alignment (8 Jacobi sweeps of a 4x4 matrix), and about 45
// operations per valid correspondence and pose: bound by float64
// operations (chip_smoke.k6_case counts them from each input), but each
// root's solve is one long dependent chain of some 30,000 instructions,
// so the latency of one thread is what the launch waits for.
//
// Design, one cooperative launch (a grid the card holds at once; a
// refused launch returns its error and the caller raises):
//   A  each block compacts the valid correspondences, in index order, into
//      dynamic shared memory (point, bearing and index, 52 bytes each,
//      52 KB at N = 1024; a larger set is read where it lies).  Each warp
//      takes one hypothesis (warps spread over the blocks, so 300
//      hypotheses are some 300 warps on all the SMs): its minimal set, the
//      warp-wide top-3 of its noise row over the compacted list (the row
//      is read at the valid correspondences only, all of a lane's loads
//      in flight at once; a row with fewer than three finite candidates is
//      scanned whole, so that the masked entries' ties go to the lowest
//      index), then lane r < 4 solves root r: the quartic (each of the four
//      lanes solves it whole), the camera-frame triangle and Horn's
//      alignment by the cyclic Jacobi eigensolver; the pose and its
//      validity go to global scratch;
//   -- grid barrier --
//   C  one warp per pose (spread over the blocks) counts its inliers over
//      the compacted correspondences, a ballot per 32; each warp folds its
//      poses into one 64-bit key ((count + 1) << 32 | ~pose), whose
//      maximum is the largest count at the lowest pose, by atomicMax;
//   -- grid barrier --
//   D  every block reads the key; block 0 writes the pose, its count and
//      index; the grid writes its inlier mask.
// The arithmetic is the plain version's (ops/pnp.py, ops/polynomial.py,
// ops/linalg.py, utils/geometry.py), operation for operation: products,
// sums and quotients in its order, powers written as products, clamps that
// keep NaN as torch.clamp does, maxima that propagate NaN as torch.amax,
// the eigenvalue order of a stable argsort with NaN last; the source is
// built with --fmad=false and calls the same CUDA math functions (sqrt,
// pow, acos, atan2, cos, sin) as PyTorch's kernels, so the card's plain
// run and this kernel round alike.

#include <algorithm>
#include <cmath>
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

struct Args {
  const double* table;  // (C, 3) points
  int C;
  const int32_t* rows;   // (N,) or null
  const uint8_t* mask;   // (N,)
  const double* bear;    // (N, 3) unit bearings
  int N;
  const double* noise;   // (>= H, N) Gumbel noise, or null
  const int64_t* idx;    // (H, 3) minimal sets, or null
  int H;
  double thr;
  int staged;            // the compacted correspondences fit in shared memory
  double* poses;         // (4H, 7) scratch
  uint8_t* pvalid;       // (4H,) scratch
  unsigned long long* key;  // (1,) scratch
  int32_t* counts;       // (4H,)
  double* T;             // (7,)
  uint8_t* inliers;      // (N,)
  int32_t* n_inl;        // (1,)
  int32_t* best;         // (1,)
};

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ bool corr_valid(const Args& a, int n) {
  return a.mask[n] != 0 && (a.rows == nullptr || a.rows[n] >= 0);
}

__device__ __forceinline__ const double* corr_point(const Args& a, int n) {
  int r = n;
  if (a.rows != nullptr) r = min(max(a.rows[n], 0), a.C - 1);
  return a.table + 3 * (int64_t)r;
}

// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ double clamp_min(double x, double lo) {
  return isnan(x) ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ double clamp2(double x, double lo, double hi) {
  return isnan(x) ? x : (x < lo ? lo : (x > hi ? hi : x));
}
// polynomial._safe
__device__ __forceinline__ double safe(double x, double eps = 1e-30) {
  const double tiny = x < 0 ? -eps : eps;
  return fabs(x) < eps ? tiny : x;
}
// polynomial._cbrt: torch.sign(x) * |x| ** (1 / 3)
__device__ __forceinline__ double cbrt_signed(double x) {
  const double sgn = static_cast<double>(static_cast<int>(0.0 < x) - static_cast<int>(x < 0.0));
  return sgn * pow(fabs(x), 1.0 / 3.0);
}
__device__ __forceinline__ double cube(double x) { return (x * x) * x; }

// polynomial.solve_quadratic
__device__ void solve_quadratic(double a, double b, double c, double r[2], bool& real) {
  const double disc = b * b - 4.0 * a * c;
  const double scale = b * b + fabs(4.0 * a * c);
  real = disc >= -1e-9 * scale;
  const double sq = sqrt(clamp_min(disc, 0.0));
  const double sgn = b >= 0 ? 1.0 : -1.0;
  const double q = -0.5 * (b + sgn * sq);
  double r0 = q / safe(a);
  double r1 = c / safe(q);
  const bool lin = fabs(a) < 1e-30;
  const double rl = -c / safe(b);
  if (lin) r0 = r1 = rl;
  const double ctr = -b / (2.0 * safe(a));
  r[0] = real ? r0 : ctr;
  r[1] = real ? r1 : ctr;
}

// polynomial.solve_cubic
__device__ void solve_cubic(double a, double b, double c, double d, double roots[3],
                            bool real[3]) {
  const double a_s = safe(a);
  b = b / a_s;
  c = c / a_s;
  d = d / a_s;
  const double p = c - b * b / 3.0;
  const double q = 2.0 * cube(b) / 27.0 - b * c / 3.0 + d;
  const double half_q = 0.5 * q;
  const double third_p = p / 3.0;
  const double disc = half_q * half_q + cube(third_p);
  const double r = sqrt(clamp_min(-third_p, 0.0));
  const double r3 = clamp_min(cube(r), 1e-30);
  const double cos3phi = clamp2(-half_q / r3, -1.0, 1.0);
  const double phi = acos(cos3phi) / 3.0;
  const double two_pi_3 = 2.0943951023931953;
  const double sq = sqrt(clamp_min(disc, 0.0));
  const double u = cbrt_signed(-half_q + sq);
  const double v = cbrt_signed(-half_q - sq);
  const double t0 = u + v;
  const double pair_re = -0.5 * t0;
  const bool three_real = disc <= 0.0;
  const double shift = b / 3.0;
  for (int k = 0; k < 3; ++k) {
    const double trig = 2.0 * r * cos(phi - two_pi_3 * k);
    const double card = k == 0 ? t0 : pair_re;
    roots[k] = (three_real ? trig : card) - shift;
    real[k] = three_real || k == 0;
  }
}

// polynomial.solve_quartic
__device__ void solve_quartic(double a, double b, double c, double d, double e,
                              double roots[4], bool real[4]) {
  const double a_s = safe(a);
  b = b / a_s;
  c = c / a_s;
  d = d / a_s;
  e = e / a_s;
  const double p = c - 3.0 * b * b / 8.0;
  const double q = d - b * c / 2.0 + cube(b) / 8.0;
  const double r = e - b * d / 4.0 + b * b * c / 16.0 - 3.0 * ((b * b) * (b * b)) / 256.0;
  double mr[3];
  bool mreal[3];
  solve_cubic(8.0, 8.0 * p, 2.0 * p * p - 8.0 * r, -q * q, mr, mreal);
  double m = -INFINITY;  // torch.amax: NaN propagates
  for (int k = 0; k < 3; ++k) {
    const double v = mreal[k] ? mr[k] : -INFINITY;
    if (isnan(v) || v > m) m = isnan(m) ? m : v;
  }
  const double two_m = clamp_min(2.0 * m, 0.0);
  const double s = sqrt(two_m);
  const double t = q / safe(2.0 * s, 1e-30);
  const double c1 = p / 2.0 + m + t;
  const double c2 = p / 2.0 + m - t;
  const double d1 = s * s - 4.0 * c1;
  const double d2 = s * s - 4.0 * c2;
  const double sc1 = s * s + fabs(4.0 * c1);
  const double sc2 = s * s + fabs(4.0 * c2);
  const bool real1 = d1 >= -1e-9 * (1.0 + sc1);
  const bool real2 = d2 >= -1e-9 * (1.0 + sc2);
  const double sq1 = sqrt(clamp_min(d1, 0.0));
  const double sq2 = sqrt(clamp_min(d2, 0.0));
  const double f[4] = {0.5 * (s + sq1), 0.5 * (s - sq1), 0.5 * (-s + sq2), 0.5 * (-s - sq2)};
  const bool freal[4] = {real1, real1, real2, real2};
  double z[2];
  bool z_real;
  solve_quadratic(1.0, p, r, z, z_real);
  const bool z_ok[2] = {z_real && z[0] >= 0.0, z_real && z[1] >= 0.0};
  const double zs[2] = {sqrt(clamp_min(z[0], 0.0)), sqrt(clamp_min(z[1], 0.0))};
  const double broots[4] = {zs[0], zs[1], -zs[0], -zs[1]};
  const bool breal[4] = {z_ok[0], z_ok[1], z_ok[0], z_ok[1]};
  const bool biquad = two_m < 1e-12 * (1.0 + fabs(p) + fabs(r));
  const double shift = b / 4.0;
  for (int k = 0; k < 4; ++k) {
    roots[k] = (biquad ? broots[k] : f[k]) - shift;
    real[k] = biquad ? breal[k] : freal[k];
  }
}

// polynomial.polish_real_roots: three Newton steps of one root
__device__ double polish(const double A[5], double x) {
  const double D[4] = {A[0] * 4.0, A[1] * 3.0, A[2] * 2.0, A[3] * 1.0};
  for (int it = 0; it < 3; ++it) {
    double f = 0.0;
    for (int i = 0; i < 5; ++i) f = f * x + A[i];
    double fp = 0.0;
    for (int i = 0; i < 4; ++i) fp = fp * x + D[i];
    x = x - f / (fabs(fp) < 1e-20 ? 1e-20 : fp);
  }
  return x;
}

// the order of torch.argsort(stable=True): NaN above every number
__device__ __forceinline__ bool at_least(double x, double y) {
  if (isnan(x)) return true;
  if (isnan(y)) return false;
  return x >= y;
}

// geometry.umeyama_alignment(src, dst, with_scale=False)[:7] for three
// points, with linalg.jacobi_eigh's eight unrolled cyclic sweeps
__device__ void horn(const double src[3][3], const double dst[3][3], double T[7]) {
  const double w = 1.0 / 3.0;  // ones / sum(ones)
  double mu_s[3], mu_d[3];
  for (int i = 0; i < 3; ++i) {
    mu_s[i] = (w * src[0][i] + w * src[1][i]) + w * src[2][i];
    mu_d[i] = (w * dst[0][i] + w * dst[1][i]) + w * dst[2][i];
  }
  double S[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double acc = (w * (src[0][i] - mu_s[i])) * (dst[0][j] - mu_d[j]);
      for (int k = 1; k < 3; ++k) acc = acc + (w * (src[k][i] - mu_s[i])) * (dst[k][j] - mu_d[j]);
      S[i][j] = acc;
    }
  const double Sxx = S[0][0], Sxy = S[0][1], Sxz = S[0][2];
  const double Syx = S[1][0], Syy = S[1][1], Syz = S[1][2];
  const double Szx = S[2][0], Szy = S[2][1], Szz = S[2][2];
  // rows 0-3: the 4x4 N-matrix; rows 4-7: the eigenvectors, as jacobi_eigh
  double M[8][4] = {{Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx},
                    {Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz},
                    {Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy},
                    {Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz},
                    {1.0, 0.0, 0.0, 0.0},
                    {0.0, 1.0, 0.0, 0.0},
                    {0.0, 0.0, 1.0, 0.0},
                    {0.0, 0.0, 0.0, 1.0}};
#pragma unroll 1
  for (int sweep = 0; sweep < 8; ++sweep) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int q = p + 1; q < 4; ++q) {
        const double app = M[p][p], aqq = M[q][q], apq = M[p][q];
        const bool small = fabs(apq) <= 1e-14 * (fabs(app) + fabs(aqq));
        const double phi = 0.5 * atan2(2.0 * apq, aqq - app);
        const double c = small ? 1.0 : cos(phi);
        const double s = small ? 0.0 : sin(phi);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const double rp = c * M[p][j] - s * M[q][j];
          const double rq = s * M[p][j] + c * M[q][j];
          M[p][j] = rp;
          M[q][j] = rq;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const double cp = c * M[i][p] - s * M[i][q];
          const double cq = s * M[i][p] + c * M[i][q];
          M[i][p] = cp;
          M[i][q] = cq;
        }
      }
    }
  }
  // the eigenvector of the last eigenvalue in ascending stable order
  int top = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (at_least(M[k][k], M[top][top])) top = k;
  double q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k == top) q[i] = M[4 + i][k];
  }
  const bool keep = q[0] >= 0;
  for (int i = 0; i < 4; ++i) q[i] = keep ? q[i] : -q[i];
  const double nrm = sqrt(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]);
  const double den = clamp_min(nrm, 1e-30);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / den;
  // geometry.quat_to_matrix, then t = mu_d - 1 * R mu_s
  const double x = q[1], y = q[2], z = q[3], qw = q[0];
  const double xx = x * x, yy = y * y, zz = z * z;
  const double wx = qw * x, wy = qw * y, wz = qw * z;
  const double xy = x * y, xz = x * z, yz = y * z;
  const double R[9] = {1 - 2 * (yy + zz), 2 * (xy - wz),     2 * (xz + wy),
                       2 * (xy + wz),     1 - 2 * (xx + zz), 2 * (yz - wx),
                       2 * (xz - wy),     2 * (yz + wx),     1 - 2 * (xx + yy)};
  for (int i = 0; i < 4; ++i) T[i] = q[i];
  for (int i = 0; i < 3; ++i) {
    const double Rmu = (R[3 * i] * mu_s[0] + R[3 * i + 1] * mu_s[1]) + R[3 * i + 2] * mu_s[2];
    T[4 + i] = mu_d[i] - 1.0 * Rmu;
  }
}

__device__ __forceinline__ double dot3(const double* a, const double* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// pnp.p3p_grunert for one root: the pose T_c_w and its validity
__device__ bool p3p_root(const double P[3][3], const double F[3][3], int root, double T[7]) {
  double d23[3], d13[3], d12[3];
  for (int i = 0; i < 3; ++i) {
    d23[i] = P[1][i] - P[2][i];
    d13[i] = P[0][i] - P[2][i];
    d12[i] = P[0][i] - P[1][i];
  }
  const double a2 = dot3(d23, d23), b2 = dot3(d13, d13), c2 = dot3(d12, d12);
  const double ca = clamp2(dot3(F[1], F[2]), -1.0, 1.0);
  const double cb = clamp2(dot3(F[0], F[2]), -1.0, 1.0);
  const double cg = clamp2(dot3(F[0], F[1]), -1.0, 1.0);
  const double eps = 1e-12;
  const double b2e = clamp_min(b2, eps);
  const double q = (a2 - c2) / b2e;
  const double p = (a2 + c2) / b2e;
  double A[5];
  A[0] = (q - 1.0) * (q - 1.0) - 4.0 * c2 / b2e * ca * ca;
  A[1] = 4.0 * (q * (1.0 - q) * cb - (1.0 - p) * ca * cg + 2.0 * c2 / b2e * ca * ca * cb);
  A[2] = 2.0 * (q * q - 1.0 + 2.0 * q * q * cb * cb + 2.0 * (b2 - c2) / b2e * ca * ca -
                4.0 * p * ca * cb * cg + 2.0 * (b2 - a2) / b2e * cg * cg);
  A[3] = 4.0 * (-q * (1.0 + q) * cb + 2.0 * a2 / b2e * cg * cg * cb - (1.0 - p) * ca * cg);
  A[4] = (1.0 + q) * (1.0 + q) - 4.0 * a2 / b2e * cg * cg;
  double roots[4];
  bool real[4];
  solve_quartic(A[0], A[1], A[2], A[3], A[4], roots, real);
  double v = 0.0;
  bool is_real = false;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k == root) {
      v = roots[k];
      is_real = real[k];
    }
  v = polish(A, v);
  const double denom1 = 1.0 + v * v - 2.0 * v * cb;
  const double s1 = sqrt(b2 / clamp_min(denom1, eps));
  const double s3 = v * s1;
  const double den_u = 2.0 * (v * ca - cg);
  const double num_u = v * v - 1.0 - (a2 - c2) * denom1 / b2e;
  const double u = num_u / (fabs(den_u) < 1e-12 ? 1e-12 : den_u);
  const double s2 = u * s1;
  const bool valid = is_real && s1 > 0 && s2 > 0 && s3 > 0 && denom1 > eps &&
                     fabs(den_u) > 1e-12;
  const double sc[3] = {s1, s2, s3};
  double X[3][3];
  for (int k = 0; k < 3; ++k)
    for (int i = 0; i < 3; ++i) X[k][i] = sc[k] * F[k][i];
  horn(P, X, T);
  return valid;
}

// pnp.reprojection_angular_error(T, p, b) < thr, in its operation order
__device__ __forceinline__ bool is_inlier(const double* T, const double* P, const double* B,
                                          double thr) {
  const double w = T[0], x = T[1], y = T[2], z = T[3];
  const double v0 = P[0], v1 = P[1], v2 = P[2];
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
  const double den = clamp_min(nrm, 1e-12);
  const double cosang = ((p0 / den) * B[0] + (p1 / den) * B[1]) + (p2 / den) * B[2];
  const double err = nrm > 1e-9 ? acos(clamp2(cosang, -1.0, 1.0)) : kPi;
  return err < thr;
}

// a candidate of a minimal set: larger noise first, then the lower index
struct Cand {
  double v;
  int i;
};
__device__ __forceinline__ bool before(const Cand& a, const Cand& b) {
  return a.v > b.v || (a.v == b.v && a.i < b.i);
}

// the top three of `row` over the `count` correspondences order[0..count)
// (order null: over 0..count, masked ones -inf), for the whole warp (every
// lane returns them); returns the third
__device__ Cand top3_scan(const Args& a, const double* row, const int* order, int count,
                          int lane, int out[3]) {
  Cand c[3] = {{-INFINITY, 0x7fffffff}, {-INFINITY, 0x7fffffff}, {-INFINITY, 0x7fffffff}};
  // each lane's entries, UNROLL loads in flight at a time
  constexpr int UNROLL = 8;
  for (int base = lane; base < count; base += 32 * UNROLL) {
    double v[UNROLL];
    int id[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = base + 32 * u;
      id[u] = k < count ? (order != nullptr ? order[k] : k) : 0x7fffffff;
      v[u] = k < count && (order != nullptr || corr_valid(a, k)) ? row[id[u]] : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const Cand x{v[u], id[u]};
      if (base + 32 * u >= count || !before(x, c[2])) continue;
      if (before(x, c[1])) {
        c[2] = c[1];
        if (before(x, c[0])) {
          c[1] = c[0];
          c[0] = x;
        } else {
          c[1] = x;
        }
      } else {
        c[2] = x;
      }
    }
  }
  // three rounds of a warp-wide first: the lane whose head wins pops it
  Cand b;
  for (int r = 0; r < 3; ++r) {
    b = c[0];
    for (int off = 16; off > 0; off >>= 1) {
      const Cand o{__shfl_xor_sync(FULL, b.v, off), __shfl_xor_sync(FULL, b.i, off)};
      if (before(o, b)) b = o;
    }
    out[r] = b.i;
    if (c[0].i == b.i) {
      c[0] = c[1];
      c[1] = c[2];
      c[2] = Cand{-INFINITY, 0x7fffffff};
    }
  }
  return b;
}

// the top three of noise row h over the valid correspondences (ties to the
// lowest index, masked ones -inf), over the block's compacted list `order`
// (nv entries, null when not staged) where its third is finite
__device__ void top3(const Args& a, int h, const int* order, int nv, int lane, int out[3]) {
  const double* row = a.noise + (int64_t)h * a.N;
  if (order != nullptr && top3_scan(a, row, order, nv, lane, out).v > -INFINITY) return;
  top3_scan(a, row, nullptr, a.N, lane, out);
}

__global__ void __launch_bounds__(THREADS, 1) ransac_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  // points (3 N doubles), bearings (3 N), then indices (N ints), of the
  // first Nv entries
  extern __shared__ double stage[];
  __shared__ int warp_total[WARPS];
  __shared__ int n_staged;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // warps numbered across the blocks first, so that work spreads over SMs
  const int gwarp = warp * gridDim.x + blockIdx.x;
  const int nwarps = WARPS * gridDim.x;

  // phase A: the compacted correspondences, in index order
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.key = 0ull;
  if (a.staged) {
    const int per = (a.N + THREADS - 1) / THREADS;
    const int n0 = min(a.N, threadIdx.x * per), n1 = min(a.N, n0 + per);
    int cnt = 0;
    for (int n = n0; n < n1; ++n) cnt += corr_valid(a, n);
    int incl = cnt;  // inclusive scan over the warp, then the warps
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int base = incl - cnt;
    for (int w = 0; w < warp; ++w) base += warp_total[w];
    if (threadIdx.x == THREADS - 1) n_staged = base + cnt;
    double* sp = stage;
    double* sb = stage + 3 * (int64_t)a.N;
    int* si = reinterpret_cast<int*>(stage + 6 * (int64_t)a.N);
    for (int n = n0; n < n1; ++n) {
      if (!corr_valid(a, n)) continue;
      const double* pt = corr_point(a, n);
      for (int i = 0; i < 3; ++i) {
        sp[3 * base + i] = pt[i];
        sb[3 * base + i] = a.bear[3 * (int64_t)n + i];
      }
      si[base] = n;
      ++base;
    }
  }
  __syncthreads();  // the block's compacted list
  const int* order = a.staged ? reinterpret_cast<const int*>(stage + 6 * (int64_t)a.N) : nullptr;
  const int nv = a.staged ? n_staged : a.N;
  // phase B: one hypothesis a warp, its four roots on lanes 0-3
  for (int h = gwarp; h < a.H; h += nwarps) {
    int set[3];
    if (a.idx != nullptr) {
      for (int r = 0; r < 3; ++r) {  // an index outside [0, N) reads no memory
        const int64_t v = a.idx[3 * (int64_t)h + r];
        set[r] = v < 0 ? 0 : (v >= a.N ? a.N - 1 : static_cast<int>(v));
      }
    } else {
      top3(a, h, order, nv, lane, set);
    }
    if (lane < 4) {
      double P[3][3], F[3][3];
      for (int k = 0; k < 3; ++k) {
        const double* pt = corr_point(a, set[k]);
        for (int i = 0; i < 3; ++i) {
          P[k][i] = pt[i];
          F[k][i] = a.bear[3 * (int64_t)set[k] + i];
        }
      }
      double T[7];
      const int j = 4 * h + lane;
      a.pvalid[j] = p3p_root(P, F, lane, T);
      for (int i = 0; i < 7; ++i) a.poses[7 * (int64_t)j + i] = T[i];
    }
  }
  grid.sync();

  // phase C: one warp per pose
  unsigned long long mine = 0ull;
  for (int j = gwarp; j < 4 * a.H; j += nwarps) {
    int cnt = -1;
    if (a.pvalid[j]) {
      const double* T = a.poses + 7 * (int64_t)j;
      cnt = 0;
      for (int base = 0; base < nv; base += 32) {
        const int n = base + lane;
        bool in = false;
        if (a.staged) {
          if (n < nv) in = is_inlier(T, stage + 3 * n, stage + 3 * (int64_t)a.N + 3 * n, a.thr);
        } else if (n < nv && corr_valid(a, n)) {
          in = is_inlier(T, corr_point(a, n), a.bear + 3 * (int64_t)n, a.thr);
        }
        cnt += __popc(__ballot_sync(FULL, in));
      }
    }
    if (lane == 0) a.counts[j] = cnt;
    const unsigned long long k =
        (static_cast<unsigned long long>(cnt + 1) << 32) | (0xffffffffu - static_cast<unsigned>(j));
    mine = k > mine ? k : mine;
  }
  if (lane == 0 && mine != 0ull) atomicMax(a.key, mine);
  grid.sync();

  // phase D: the first best pose, its count and its inlier mask
  const unsigned long long k = __ldcg(a.key);  // the atomics' value, from L2
  const int b = static_cast<int>(0xffffffffu - static_cast<unsigned>(k & 0xffffffffu));
  const double* Tb = a.poses + 7 * (int64_t)b;
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) {
      a.best[0] = b;
      a.n_inl[0] = max(static_cast<int>(k >> 32) - 1, 0);
    }
    if (threadIdx.x < 7) a.T[threadIdx.x] = Tb[threadIdx.x];
  }
  for (int n = blockIdx.x * THREADS + threadIdx.x; n < a.N; n += gridDim.x * THREADS)
    a.inliers[n] = corr_valid(a, n) && is_inlier(Tb, corr_point(a, n), a.bear + 3 * (int64_t)n,
                                                 a.thr);
}

}  // namespace

// table (C, 3) f64; rows (N,) int32 or null; mask (N,) bool; bear (N, 3)
// f64; noise (>= H, N) f64 or null, idx (H, 3) int64 or null (one of the
// two); scratch: poses (4H, 7) f64, pvalid (4H,) u8, key (1,) u64.
// Outputs: counts (4H,) int32, T (7,) f64, inliers (N,) bool, n_inl (1,)
// and best (1,) int32.  Returns 0 or the CUDA error.
extern "C" int covins_p3p_ransac(const void* table, int C, const void* rows, const void* mask,
                                 const void* bear, int N, const void* noise, const void* idx,
                                 int H, double thr, void* poses, void* pvalid, void* key,
                                 void* counts, void* T, void* inliers, void* n_inl, void* best,
                                 void* stream) {
  if (H <= 0) return 0;
  int room = 0;
  const cudaError_t err = coop::smem_room(reinterpret_cast<const void*>(ransac_kernel), &room);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long stage_bytes = 52LL * N;
  const int staged = stage_bytes <= room;
  Args a{static_cast<const double*>(table),
         C,
         static_cast<const int32_t*>(rows),
         static_cast<const uint8_t*>(mask),
         static_cast<const double*>(bear),
         N,
         static_cast<const double*>(noise),
         static_cast<const int64_t*>(idx),
         H,
         thr,
         staged,
         static_cast<double*>(poses),
         static_cast<uint8_t*>(pvalid),
         static_cast<unsigned long long*>(key),
         static_cast<int32_t*>(counts),
         static_cast<double*>(T),
         static_cast<uint8_t*>(inliers),
         static_cast<int32_t*>(n_inl),
         static_cast<int32_t*>(best)};
  void* args[] = {&a};
  // one warp per pose in phase C
  return coop::launch(ransac_kernel, THREADS, staged ? static_cast<size_t>(stage_bytes) : 0,
                      std::max(32LL * 4 * H, static_cast<long long>(N)), 1 << 30,
                      coop::Slots::kRefuse, args, static_cast<cudaStream_t>(stream));
}
