// IMU preintegration of F factors: deltas, covariance and bias Jacobians.
//
// Replaces: covins_tpu/ops/imu.py::preintegrate (line 137) and its
// `_propagate` scan (:82-134), run per factor under jax.vmap, with the
// (9, 6) bias Jacobian of [phi, dv, dp] taken by jax.jacfwd through the
// scan (:152-158).
//
// Bound on the H100: each factor reads S samples of 7 float64 values and
// does about 4300 float64 operations per valid sample (the covariance's two
// 9x9 products and the six tangents of the deltas); at the main path's 255
// factors x 50 to 256 samples that is 0.03 to 0.2 GFLOP, bound by
// operations at about a microsecond.  The recurrence is sequential in the
// samples, so a call takes the latency of one factor's chain of dependent
// float64 operations, not the card's rate.
//
// Design: one warp per factor, two warps a block, so that 255 factors
// spread over the 132 SMs.  Every lane computes the primal values; lane
// k < 6 also carries tangent k (d/d bg for k < 3, d/d ba for k >= 3), so a
// dual number is two doubles a lane, and every operation applies its
// derivative rule as forward-mode AD does: the Jacobian is the same
// computation as jacfwd, with the same branches (small-angle series, the
// clamps).  What does not depend on the recurrence (each sample's two
// quaternion exponentials with all six tangents, its right Jacobian and
// its rotation increment) is computed ahead of it, 32 samples at a time,
// one sample a lane, into the warp's shared memory; the recurrence then
// walks the samples in order, padding included (a masked sample still
// renormalises dq).  The 9x9 covariance lives in the warp's shared memory:
// the 81 entries of F.C, then of (F.C).F^T + (G.Q).G^T, are spread over the
// 32 lanes with __syncwarp between the two products.  Every primal,
// tangent and covariance entry keeps the operation order of the plain
// version (ops/imu.py); the build keeps FMA contraction off so products
// round as its separate operations.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 2;  // factors per block
constexpr unsigned kFull = 0xffffffffu;
// per sample, ahead of the recurrence: m, dt, acc (3), dq_inc and the
// half-step exponential (4 components x (value + 6 tangents) each), the
// right Jacobian (9) and the increment's rotation, transposed (9)
constexpr int kAcc = 2, kInc = 5, kHalf = 33, kJr = 61, kRinc = 70, kPre = 79;

template <int N>
struct D {
  double v;
  double d[N];
};

template <int N>
__device__ inline D<N> dconst(double v) {
  D<N> r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = 0.0;
  return r;
}
template <int N>
__device__ inline D<N> operator+(const D<N>& a, const D<N>& b) {
  D<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
template <int N>
__device__ inline D<N> operator-(const D<N>& a, const D<N>& b) {
  D<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
template <int N>
__device__ inline D<N> operator-(const D<N>& a) {
  D<N> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}
template <int N>
__device__ inline D<N> operator*(const D<N>& a, const D<N>& b) {
  D<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
template <int N>
__device__ inline D<N> operator*(const D<N>& a, double s) {
  D<N> r;
  r.v = a.v * s;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * s;
  return r;
}
template <int N>
__device__ inline D<N> operator*(double s, const D<N>& a) {
  return a * s;
}
template <int N>
__device__ inline D<N> operator/(const D<N>& a, const D<N>& b) {
  D<N> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] * b.v - a.v * b.d[k]) / (b.v * b.v);
  return r;
}
template <int N>
__device__ inline D<N> operator/(double s, const D<N>& b) {
  return dconst<N>(s) / b;
}
template <int N>
__device__ inline D<N> dsqrt(const D<N>& a) {
  D<N> r;
  r.v = sqrt(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / (2.0 * r.v);
  return r;
}
template <int N>
__device__ inline D<N> dsin(const D<N>& a) {
  D<N> r;
  r.v = sin(a.v);
  const double c = cos(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * c;
  return r;
}
template <int N>
__device__ inline D<N> dcos(const D<N>& a) {
  D<N> r;
  r.v = cos(a.v);
  const double s = -sin(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * s;
  return r;
}
template <int N>
__device__ inline D<N> datan2(const D<N>& y, const D<N>& x) {
  D<N> r;
  r.v = atan2(y.v, x.v);
  const double den = x.v * x.v + y.v * y.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (x.v * y.d[k] - y.v * x.d[k]) / den;
  return r;
}
// max(a, c) with a constant c: the derivative passes where a >= c
template <int N>
__device__ inline D<N> dclamp_min(const D<N>& a, double c) {
  if (a.v >= c) return a;
  return dconst<N>(c);
}

template <int N>
struct Q {
  D<N> w, x, y, z;
};

template <int N>
__device__ inline Q<N> qmul(const Q<N>& a, const Q<N>& b) {
  Q<N> r;
  r.w = ((a.w * b.w - a.x * b.x) - a.y * b.y) - a.z * b.z;
  r.x = ((a.w * b.x + a.x * b.w) + a.y * b.z) - a.z * b.y;
  r.y = ((a.w * b.y - a.x * b.z) + a.y * b.w) + a.z * b.x;
  r.z = ((a.w * b.z + a.x * b.y) - a.y * b.x) + a.z * b.w;
  return r;
}

template <int N>
__device__ inline Q<N> qnormalize(const Q<N>& q) {
  const D<N> n = dsqrt(((q.w * q.w + q.x * q.x) + q.y * q.y) + q.z * q.z);
  const D<N> nc = dclamp_min(n, 1e-12);
  Q<N> r{q.w / nc, q.x / nc, q.y / nc, q.z / nc};
  if (r.w.v < 0.0) r = Q<N>{-r.w, -r.x, -r.y, -r.z};
  return r;
}

// so(3) tangent -> unit quaternion (geometry.quat_exp)
template <int N>
__device__ inline Q<N> qexp(const D<N>& w0, const D<N>& w1, const D<N>& w2) {
  const D<N> n2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const D<N> theta = dsqrt(dclamp_min(n2, 1e-24));
  const D<N> half = theta * 0.5;
  D<N> sinc;
  if (theta.v < 1e-6) {
    sinc = dconst<N>(0.5) - (theta * theta) / dconst<N>(48.0);
  } else {
    sinc = dsin(half) / dclamp_min(theta, 1e-24);
  }
  return qnormalize(Q<N>{dcos(half), sinc * w0, sinc * w1, sinc * w2});
}

// unit quaternion -> so(3) tangent (geometry.quat_log)
template <int N>
__device__ inline void qlog(const Q<N>& q_in, D<N> out[3]) {
  const Q<N> q = qnormalize(q_in);
  const D<N> vn2 = (q.x * q.x + q.y * q.y) + q.z * q.z;
  const D<N> vn = dsqrt(dclamp_min(vn2, 1e-24));
  D<N> scale;
  if (vn.v < 1e-9) {
    scale = 2.0 / dclamp_min(q.w, 1e-12);
  } else {
    scale = (2.0 * datan2(vn, q.w)) / dclamp_min(vn, 1e-24);
  }
  out[0] = scale * q.x;
  out[1] = scale * q.y;
  out[2] = scale * q.z;
}

template <int N>
__device__ inline void qmat(const Q<N>& q, D<N> R[9]) {
  const D<N> xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const D<N> wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  const D<N> xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  const D<N> one = dconst<N>(1.0);
  R[0] = one - 2.0 * (yy + zz);
  R[1] = 2.0 * (xy - wz);
  R[2] = 2.0 * (xz + wy);
  R[3] = 2.0 * (xy + wz);
  R[4] = one - 2.0 * (xx + zz);
  R[5] = 2.0 * (yz - wx);
  R[6] = 2.0 * (xz - wy);
  R[7] = 2.0 * (yz + wx);
  R[8] = one - 2.0 * (xx + yy);
}

// right Jacobian of SO(3) on primal values (imu._right_jacobian)
__device__ inline void right_jacobian(const double th[3], double Jr[9]) {
  const double n2 = (th[0] * th[0] + th[1] * th[1]) + th[2] * th[2];
  const double t = sqrt(fmax(n2, 1e-24));
  const double W[9] = {0.0, -th[2], th[1], th[2], 0.0, -th[0], -th[1], th[0], 0.0};
  double W2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = (W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j]) + W[3 * i + 2] * W[6 + j];
  const double t2 = t * t;
  double a, b;
  if (t < 1e-5) {
    a = 0.5 - t2 / 24.0;
    b = 1.0 / 6.0 - t2 / 120.0;
  } else {
    a = (1.0 - cos(t)) / fmax(t2, 1e-24);
    b = (t - sin(t)) / fmax(t2 * t, 1e-24);
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) Jr[i] = (((i % 4) == 0 ? 1.0 : 0.0) - a * W[i]) + b * W2[i];
}

__device__ inline void store_dual(const D<6>& x, double* out) {
  out[0] = x.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[1 + k] = x.d[k];
}

__device__ inline void store_quat(const Q<6>& q, double* out) {
  store_dual(q.w, out);
  store_dual(q.x, out + 7);
  store_dual(q.y, out + 14);
  store_dual(q.z, out + 21);
}

// lane k's share of a dual number stored by store_dual: value and tangent k
__device__ inline D<1> load_dual(const double* in, int lane) {
  D<1> r;
  r.v = in[0];
  r.d[0] = lane < 6 ? in[1 + lane] : 0.0;
  return r;
}

__device__ inline Q<1> load_quat(const double* in, int lane) {
  return Q<1>{load_dual(in, lane), load_dual(in + 7, lane), load_dual(in + 14, lane),
              load_dual(in + 21, lane)};
}

// The terms of one sample that do not depend on the recurrence, with all
// six tangents, into its row of the warp's table.
__device__ __forceinline__ void sample_terms(const double* __restrict__ acc, const double* __restrict__ gyro,
                             const double* __restrict__ dts, const double* __restrict__ mask,
                             const D<6> bgd[3], int64_t fs, double* row) {
  const double m = mask[fs];
  const double dt = dts[fs] * m;  // masked samples integrate for 0 seconds
  row[0] = m;
  row[1] = dt;
  D<6> dth[3], dth_half[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    row[kAcc + i] = acc[3 * fs + i];
    dth[i] = (dconst<6>(gyro[3 * fs + i]) - bgd[i]) * dt;
    dth_half[i] = dth[i] * 0.5;
  }
  const Q<6> inc = qexp(dth[0], dth[1], dth[2]);
  store_quat(inc, row + kInc);
  // the increment's rotation on primal values, transposed
  const Q<1> p{dconst<1>(inc.w.v), dconst<1>(inc.x.v), dconst<1>(inc.y.v), dconst<1>(inc.z.v)};
  D<1> Rinc[9];
  qmat(p, Rinc);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) row[kRinc + 3 * i + j] = Rinc[3 * j + i].v;
  store_quat(qexp(dth_half[0], dth_half[1], dth_half[2]), row + kHalf);
  const double th[3] = {dth[0].v, dth[1].v, dth[2].v};
  right_jacobian(th, row + kJr);
}

__global__ void __launch_bounds__(32 * kWarps)
imu_preintegrate_kernel(const double* __restrict__ acc, const double* __restrict__ gyro,
                        const double* __restrict__ dts, const double* __restrict__ mask,
                        const double* __restrict__ bg, const double* __restrict__ ba, int F,
                        int S, double gyro_noise, double acc_noise,
                        double* __restrict__ dq_out, double* __restrict__ dv_out,
                        double* __restrict__ dp_out, double* __restrict__ J_out,
                        double* __restrict__ cov_out, double* __restrict__ T_out) {
  __shared__ double pre_sh[kWarps][32 * kPre];
  __shared__ double cov_sh[kWarps][81], fc_sh[kWarps][81], fm_sh[kWarps][81],
      g_sh[kWarps][54];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int f = blockIdx.x * kWarps + w;
  if (f >= F) return;  // the whole warp leaves together
  double* pre = pre_sh[w];
  double* cov = cov_sh[w];
  double* fc = fc_sh[w];
  double* fm = fm_sh[w];
  double* g = g_sh[w];

  // the six tangents for the terms ahead of the recurrence
  D<6> bgd[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bgd[i] = dconst<6>(bg[3 * f + i]);
    bgd[i].d[i] = 1.0;
  }
  // lane k's tangent of ba: d/d ba_i is tangent 3 + i
  D<1> bad[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bad[i].v = ba[3 * f + i];
    bad[i].d[0] = lane == 3 + i ? 1.0 : 0.0;
  }
  Q<1> dq{dconst<1>(1.0), dconst<1>(0.0), dconst<1>(0.0), dconst<1>(0.0)};
  D<1> dv[3] = {dconst<1>(0.0), dconst<1>(0.0), dconst<1>(0.0)};
  D<1> dp[3] = {dconst<1>(0.0), dconst<1>(0.0), dconst<1>(0.0)};
  for (int e = lane; e < 81; e += 32) cov[e] = 0.0;
  double T = 0.0;
  const double gn2 = gyro_noise * gyro_noise;
  const double an2 = acc_noise * acc_noise;

  for (int s0 = 0; s0 < S; s0 += 32) {
    __syncwarp();  // the previous chunk's rows are read
    if (s0 + lane < S)
      sample_terms(acc, gyro, dts, mask, bgd, (int64_t)f * S + s0 + lane, pre + lane * kPre);
    __syncwarp();
    const int n = min(32, S - s0);
    for (int sl = 0; sl < n; ++sl) {
      const double* row = pre + sl * kPre;
      const double m = row[0];
      const double dt = row[1];
      D<1> a_hat[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) a_hat[i] = dconst<1>(row[kAcc + i]) - bad[i];
      const Q<1> dq_inc = load_quat(row + kInc, lane);
      D<1> R[9];
      qmat(qmul(dq, load_quat(row + kHalf, lane)), R);
      D<1> Ra[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        Ra[i] = (R[3 * i] * a_hat[0] + R[3 * i + 1] * a_hat[1]) + R[3 * i + 2] * a_hat[2];

      if (m > 0.0) {  // the same for every lane
        // covariance of [phi, dv, dp] on the primal values: F and G into
        // shared memory, entry e by lane e % 32
        const double ra0 = Ra[0].v, ra1 = Ra[1].v, ra2 = Ra[2].v;
        const double A[9] = {0.0, -ra2, ra1, ra2, 0.0, -ra0, -ra1, ra0, 0.0};
#pragma unroll
        for (int i = 0; i < 9; ++i)
#pragma unroll
          for (int j = 0; j < 9; ++j) {
            const int e = 9 * i + j;
            if ((e & 31) != lane) continue;
            const int bi = i / 3, bj = j / 3, ii = i % 3, jj = j % 3;
            double v = 0.0;
            if (bi == 0 && bj == 0) v = row[kRinc + 3 * ii + jj];
            if (bi == 1 && bj == 0) v = -A[3 * ii + jj] * dt;
            if (bi == 2 && bj == 0) v = ((-0.5 * A[3 * ii + jj]) * dt) * dt;
            if (bi == 1 && bj == 1 && ii == jj) v = 1.0;
            if (bi == 2 && bj == 1 && ii == jj) v = dt;
            if (bi == 2 && bj == 2 && ii == jj) v = 1.0;
            fm[e] = v;
          }
#pragma unroll
        for (int i = 0; i < 9; ++i)
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            const int e = 6 * i + j;
            if ((e & 31) != lane) continue;
            const int bi = i / 3, bj = j / 3, ii = i % 3, jj = j % 3;
            double v = 0.0;
            if (bi == 0 && bj == 0) v = row[kJr + 3 * ii + jj] * dt;
            if (bi == 1 && bj == 1) v = R[3 * ii + jj].v * dt;
            if (bi == 2 && bj == 1) v = ((0.5 * R[3 * ii + jj].v) * dt) * dt;
            g[e] = v;
          }
        __syncwarp();
        for (int e = lane; e < 81; e += 32) {
          const int i = e / 9, j = e % 9;
          double acc_ = 0.0;
#pragma unroll
          for (int k = 0; k < 9; ++k) acc_ += fm[9 * i + k] * cov[9 * k + j];
          fc[e] = acc_;
        }
        __syncwarp();
        const double dt_safe = fmax(dt, 1e-9);
        const double qg = gn2 / dt_safe, qa = an2 / dt_safe;
        for (int e = lane; e < 81; e += 32) {
          const int i = e / 9, j = e % 9;
          double a1 = 0.0, a2 = 0.0;
#pragma unroll
          for (int k = 0; k < 9; ++k) a1 += fc[9 * i + k] * fm[9 * j + k];
#pragma unroll
          for (int k = 0; k < 6; ++k) a2 += (g[6 * i + k] * (k < 3 ? qg : qa)) * g[6 * j + k];
          cov[e] = a1 + a2;
        }
        __syncwarp();
      }

#pragma unroll
      for (int i = 0; i < 3; ++i) {
        dp[i] = (dp[i] + dv[i] * dt) + ((Ra[i] * 0.5) * dt) * dt;
        dv[i] = dv[i] + Ra[i] * dt;
      }
      dq = qnormalize(qmul(dq, dq_inc));
      T += dt;
    }
  }

  // Jacobian rows: phi = Log(dq_ref^-1 dq(b)) at the primal dq_ref = dq
  const Q<1> ref_conj{dconst<1>(dq.w.v), dconst<1>(-dq.x.v), dconst<1>(-dq.y.v),
                      dconst<1>(-dq.z.v)};
  D<1> phi[3];
  qlog(qmul(ref_conj, dq), phi);
  if (lane < 6) {
    double* J = J_out + 54 * (int64_t)f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      J[6 * i + lane] = phi[i].d[0];
      J[6 * (3 + i) + lane] = dv[i].d[0];
      J[6 * (6 + i) + lane] = dp[i].d[0];
    }
  }
  if (lane == 0) {
    dq_out[4 * f] = dq.w.v;
    dq_out[4 * f + 1] = dq.x.v;
    dq_out[4 * f + 2] = dq.y.v;
    dq_out[4 * f + 3] = dq.z.v;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dv_out[3 * f + i] = dv[i].v;
      dp_out[3 * f + i] = dp[i].v;
    }
    T_out[f] = T;
  }
  __syncwarp();
  for (int e = lane; e < 81; e += 32) cov_out[81 * (int64_t)f + e] = cov[e];
}

}  // namespace

// acc, gyro (F, S, 3), dts, mask (F, S), bg, ba (F, 3) float64; outputs
// dq (F, 4), dv, dp (F, 3), J (F, 9, 6), cov (F, 9, 9), T (F,) float64.
extern "C" int covins_imu_preintegrate(const void* acc, const void* gyro, const void* dts,
                                       const void* mask, const void* bg, const void* ba,
                                       int F, int S, double gyro_noise, double acc_noise,
                                       void* dq, void* dv, void* dp, void* J, void* cov,
                                       void* T, void* stream) {
  if (F <= 0) return 0;
  imu_preintegrate_kernel<<<(F + kWarps - 1) / kWarps, 32 * kWarps, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(acc), static_cast<const double*>(gyro),
      static_cast<const double*>(dts), static_cast<const double*>(mask),
      static_cast<const double*>(bg), static_cast<const double*>(ba), F, S, gyro_noise,
      acc_noise, static_cast<double*>(dq), static_cast<double*>(dv),
      static_cast<double*>(dp), static_cast<double*>(J), static_cast<double*>(cov),
      static_cast<double*>(T));
  return static_cast<int>(cudaGetLastError());
}
