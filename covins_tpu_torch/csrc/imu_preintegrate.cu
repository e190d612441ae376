// IMU preintegration of F factors: deltas, covariance and bias Jacobians.
//
// Replaces: covins_tpu/ops/imu.py::preintegrate (line 137) and its
// `_propagate` scan (:82-134), run per factor under jax.vmap, with the
// (9, 6) bias Jacobian of [phi, dv, dp] taken by jax.jacfwd through the
// scan (:152-158).
//
// Bound on the H100: each factor reads S samples of 7 float64 values and
// does about 3000 float64 operations per sample (the covariance's two 9x9
// products and the six tangents of the deltas); at the main path's 255
// factors x 50 to 256 samples that is 0.04 to 0.2 GFLOP, bound by
// operations at a few microseconds.  With one thread per factor only 255
// threads run, so the kernel takes the samples' sequential latency, not
// the card's rate: a simple kernel that is right.
//
// Design: the recurrence is sequential in the samples, so one thread owns
// one factor and walks its samples in order.  The deltas are dual numbers
// with six tangents (d/d bg, d/d ba): every operation applies its
// derivative rule as forward-mode AD does, so the Jacobian is the same
// computation as jacfwd, with the same branches (small-angle series, the
// clamps), not a hand-derived recursion.  The covariance is propagated on
// the primal values only.  The operation order follows the plain version
// (ops/imu.py); the build keeps FMA contraction off so products round as
// its separate operations.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct D {
  double v;
  double d[6];
};

__device__ inline D dconst(double v) {
  D r;
  r.v = v;
  for (int k = 0; k < 6; ++k) r.d[k] = 0.0;
  return r;
}
__device__ inline D operator+(const D& a, const D& b) {
  D r;
  r.v = a.v + b.v;
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
__device__ inline D operator-(const D& a, const D& b) {
  D r;
  r.v = a.v - b.v;
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
__device__ inline D operator-(const D& a) {
  D r;
  r.v = -a.v;
  for (int k = 0; k < 6; ++k) r.d[k] = -a.d[k];
  return r;
}
__device__ inline D operator*(const D& a, const D& b) {
  D r;
  r.v = a.v * b.v;
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
__device__ inline D operator*(const D& a, double s) {
  D r;
  r.v = a.v * s;
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] * s;
  return r;
}
__device__ inline D operator*(double s, const D& a) { return a * s; }
__device__ inline D operator/(const D& a, const D& b) {
  D r;
  r.v = a.v / b.v;
  for (int k = 0; k < 6; ++k) r.d[k] = (a.d[k] * b.v - a.v * b.d[k]) / (b.v * b.v);
  return r;
}
__device__ inline D operator/(double s, const D& b) { return dconst(s) / b; }
__device__ inline D dsqrt(const D& a) {
  D r;
  r.v = sqrt(a.v);
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] / (2.0 * r.v);
  return r;
}
__device__ inline D dsin(const D& a) {
  D r;
  r.v = sin(a.v);
  const double c = cos(a.v);
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] * c;
  return r;
}
__device__ inline D dcos(const D& a) {
  D r;
  r.v = cos(a.v);
  const double s = -sin(a.v);
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] * s;
  return r;
}
__device__ inline D datan2(const D& y, const D& x) {
  D r;
  r.v = atan2(y.v, x.v);
  const double den = x.v * x.v + y.v * y.v;
  for (int k = 0; k < 6; ++k) r.d[k] = (x.v * y.d[k] - y.v * x.d[k]) / den;
  return r;
}
// max(a, c) with a constant c: the derivative passes where a >= c
__device__ inline D dclamp_min(const D& a, double c) {
  if (a.v >= c) return a;
  return dconst(c);
}

struct Q {
  D w, x, y, z;
};

__device__ inline Q qmul(const Q& a, const Q& b) {
  Q r;
  r.w = ((a.w * b.w - a.x * b.x) - a.y * b.y) - a.z * b.z;
  r.x = ((a.w * b.x + a.x * b.w) + a.y * b.z) - a.z * b.y;
  r.y = ((a.w * b.y - a.x * b.z) + a.y * b.w) + a.z * b.x;
  r.z = ((a.w * b.z + a.x * b.y) - a.y * b.x) + a.z * b.w;
  return r;
}

__device__ inline Q qnormalize(const Q& q) {
  const D n = dsqrt(((q.w * q.w + q.x * q.x) + q.y * q.y) + q.z * q.z);
  const D nc = dclamp_min(n, 1e-12);
  Q r{q.w / nc, q.x / nc, q.y / nc, q.z / nc};
  if (r.w.v < 0.0) r = Q{-r.w, -r.x, -r.y, -r.z};
  return r;
}

// so(3) tangent -> unit quaternion (geometry.quat_exp)
__device__ inline Q qexp(const D& w0, const D& w1, const D& w2) {
  const D n2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const D theta = dsqrt(dclamp_min(n2, 1e-24));
  const D half = theta * 0.5;
  D sinc;
  if (theta.v < 1e-6) {
    sinc = dconst(0.5) - (theta * theta) / dconst(48.0);
  } else {
    sinc = dsin(half) / dclamp_min(theta, 1e-24);
  }
  return qnormalize(Q{dcos(half), sinc * w0, sinc * w1, sinc * w2});
}

// unit quaternion -> so(3) tangent (geometry.quat_log)
__device__ inline void qlog(const Q& q_in, D out[3]) {
  const Q q = qnormalize(q_in);
  const D vn2 = (q.x * q.x + q.y * q.y) + q.z * q.z;
  const D vn = dsqrt(dclamp_min(vn2, 1e-24));
  D scale;
  if (vn.v < 1e-9) {
    scale = 2.0 / dclamp_min(q.w, 1e-12);
  } else {
    scale = (2.0 * datan2(vn, q.w)) / dclamp_min(vn, 1e-24);
  }
  out[0] = scale * q.x;
  out[1] = scale * q.y;
  out[2] = scale * q.z;
}

__device__ inline void qmat(const Q& q, D R[9]) {
  const D xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const D wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  const D xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  const D one = dconst(1.0);
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
  for (int i = 0; i < 3; ++i)
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
  for (int i = 0; i < 9; ++i) Jr[i] = (((i % 4) == 0 ? 1.0 : 0.0) - a * W[i]) + b * W2[i];
}

__global__ void imu_preintegrate_kernel(const double* __restrict__ acc,
                                        const double* __restrict__ gyro,
                                        const double* __restrict__ dts,
                                        const double* __restrict__ mask,
                                        const double* __restrict__ bg,
                                        const double* __restrict__ ba, int F, int S,
                                        double gyro_noise, double acc_noise,
                                        double* __restrict__ dq_out,
                                        double* __restrict__ dv_out,
                                        double* __restrict__ dp_out,
                                        double* __restrict__ J_out,
                                        double* __restrict__ cov_out,
                                        double* __restrict__ T_out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  // the six tangents: d/d bg (0..2), d/d ba (3..5)
  D bgd[3], bad[3];
  for (int i = 0; i < 3; ++i) {
    bgd[i] = dconst(bg[3 * f + i]);
    bgd[i].d[i] = 1.0;
    bad[i] = dconst(ba[3 * f + i]);
    bad[i].d[3 + i] = 1.0;
  }
  Q dq{dconst(1.0), dconst(0.0), dconst(0.0), dconst(0.0)};
  D dv[3] = {dconst(0.0), dconst(0.0), dconst(0.0)};
  D dp[3] = {dconst(0.0), dconst(0.0), dconst(0.0)};
  double cov[81];
  for (int i = 0; i < 81; ++i) cov[i] = 0.0;
  double T = 0.0;
  const double gn2 = gyro_noise * gyro_noise;
  const double an2 = acc_noise * acc_noise;

  for (int s = 0; s < S; ++s) {
    const int64_t fs = (int64_t)f * S + s;
    const double m = mask[fs];
    const double dt = dts[fs] * m;  // masked samples integrate for 0 seconds
    D a_hat[3], dth[3], dth_half[3];
    for (int i = 0; i < 3; ++i) {
      a_hat[i] = dconst(acc[3 * fs + i]) - bad[i];
      dth[i] = (dconst(gyro[3 * fs + i]) - bgd[i]) * dt;
      dth_half[i] = dth[i] * 0.5;
    }
    const Q dq_inc = qexp(dth[0], dth[1], dth[2]);
    D R[9];
    qmat(qmul(dq, qexp(dth_half[0], dth_half[1], dth_half[2])), R);
    D Ra[3];
    for (int i = 0; i < 3; ++i)
      Ra[i] = (R[3 * i] * a_hat[0] + R[3 * i + 1] * a_hat[1]) + R[3 * i + 2] * a_hat[2];

    if (m > 0.0) {
      // covariance of [phi, dv, dp] on the primal values
      double Rinc_d[9], A[9], Jr[9], Rv[9], th[3];
      D Rinc[9];
      qmat(dq_inc, Rinc);
      for (int i = 0; i < 9; ++i) Rv[i] = R[i].v;
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) Rinc_d[3 * i + j] = Rinc[3 * j + i].v;  // transposed
      const double ra0 = Ra[0].v, ra1 = Ra[1].v, ra2 = Ra[2].v;
      const double Am[9] = {0.0, -ra2, ra1, ra2, 0.0, -ra0, -ra1, ra0, 0.0};
      for (int i = 0; i < 9; ++i) A[i] = Am[i];
      for (int i = 0; i < 3; ++i) th[i] = dth[i].v;
      right_jacobian(th, Jr);
      double Fm[81], G[54];
      for (int i = 0; i < 81; ++i) Fm[i] = 0.0;
      for (int i = 0; i < 54; ++i) G[i] = 0.0;
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
          Fm[9 * i + j] = Rinc_d[3 * i + j];
          Fm[9 * (3 + i) + j] = -A[3 * i + j] * dt;
          Fm[9 * (6 + i) + j] = ((-0.5 * A[3 * i + j]) * dt) * dt;
          G[6 * i + j] = Jr[3 * i + j] * dt;
          G[6 * (3 + i) + 3 + j] = Rv[3 * i + j] * dt;
          G[6 * (6 + i) + 3 + j] = ((0.5 * Rv[3 * i + j]) * dt) * dt;
        }
        Fm[9 * (3 + i) + 3 + i] = 1.0;
        Fm[9 * (6 + i) + 3 + i] = dt;
        Fm[9 * (6 + i) + 6 + i] = 1.0;
      }
      const double dt_safe = fmax(dt, 1e-9);
      const double qd[6] = {gn2 / dt_safe, gn2 / dt_safe, gn2 / dt_safe,
                            an2 / dt_safe, an2 / dt_safe, an2 / dt_safe};
      double FC[81];
      for (int i = 0; i < 9; ++i)
        for (int j = 0; j < 9; ++j) {
          double acc_ = 0.0;
          for (int k = 0; k < 9; ++k) acc_ += Fm[9 * i + k] * cov[9 * k + j];
          FC[9 * i + j] = acc_;
        }
      for (int i = 0; i < 9; ++i)
        for (int j = 0; j < 9; ++j) {
          double a1 = 0.0, a2 = 0.0;
          for (int k = 0; k < 9; ++k) a1 += FC[9 * i + k] * Fm[9 * j + k];
          for (int k = 0; k < 6; ++k) a2 += (G[6 * i + k] * qd[k]) * G[6 * j + k];
          cov[9 * i + j] = a1 + a2;
        }
    }

    for (int i = 0; i < 3; ++i) {
      dp[i] = (dp[i] + dv[i] * dt) + ((Ra[i] * 0.5) * dt) * dt;
      dv[i] = dv[i] + Ra[i] * dt;
    }
    dq = qnormalize(qmul(dq, dq_inc));
    T += dt;
  }

  // Jacobian rows: phi = Log(dq_ref^-1 dq(b)) at the primal dq_ref = dq
  const Q ref_conj{dconst(dq.w.v), dconst(-dq.x.v), dconst(-dq.y.v), dconst(-dq.z.v)};
  D phi[3];
  qlog(qmul(ref_conj, dq), phi);
  double* J = J_out + 54 * (int64_t)f;
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 6; ++k) {
      J[6 * i + k] = phi[i].d[k];
      J[6 * (3 + i) + k] = dv[i].d[k];
      J[6 * (6 + i) + k] = dp[i].d[k];
    }
  dq_out[4 * f] = dq.w.v;
  dq_out[4 * f + 1] = dq.x.v;
  dq_out[4 * f + 2] = dq.y.v;
  dq_out[4 * f + 3] = dq.z.v;
  for (int i = 0; i < 3; ++i) {
    dv_out[3 * f + i] = dv[i].v;
    dp_out[3 * f + i] = dp[i].v;
  }
  for (int i = 0; i < 81; ++i) cov_out[81 * (int64_t)f + i] = cov[i];
  T_out[f] = T;
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
  const int threads = 64;
  imu_preintegrate_kernel<<<(F + threads - 1) / threads, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(acc), static_cast<const double*>(gyro),
      static_cast<const double*>(dts), static_cast<const double*>(mask),
      static_cast<const double*>(bg), static_cast<const double*>(ba), F, S, gyro_noise,
      acc_noise, static_cast<double*>(dq), static_cast<double*>(dv),
      static_cast<double*>(dp), static_cast<double*>(J), static_cast<double*>(cov),
      static_cast<double*>(T));
  return static_cast<int>(cudaGetLastError());
}
