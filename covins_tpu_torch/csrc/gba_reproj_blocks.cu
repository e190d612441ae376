// GBA reprojection factors: residuals, Jacobians and their per-keyframe and
// per-landmark normal-equation blocks, or the residual alone.
//
// Replaces: covins_tpu/ops/gba.py::_reproj_r_J (line 115, jax.jacfwd of
// the reprojection residual per observation under jax.vmap) with the
// observation scatter-adds of _gn_schur_step (:255-275 for b and the 6x6
// blocks, :317-322 for the landmark side), the reprojection part of
// total_cost (:406-415), and _reproj_outlier_mask (:470-482).
//
// Bound on the H100: per observation it reads 7 + 3 + 2 + 3 float64 values
// and writes 2 + 12 + 6 (linearise mode); at the main path's 52.6k
// observations that is about 14 MB, 4 us at 3.35 TB/s, and about 600
// float64 operations per observation (0.03 GFLOP, 1 us at 34 TFLOP/s):
// bound by bytes.
//
// Design, in three launches of one call:
// 1. one thread per observation computes the residual in the plain
//    version's operation order (ops/residuals.py, the port's quaternion
//    geometry) and, in linearise mode, the written-out Jacobians
//    d uv / d p_c * R_c_s * [[p_s]x | -I] and ... * R_w_s^T; it applies
//    the reference's weights (1/sigma, validity, landmark and keyframe
//    masks, Huber sqrt(min(1, k / |r w|))) and stores r, J_pose, J_lm;
// 2. one warp per keyframe (b and the 6x6 block) and
// 3. one warp per landmark (b and the 3x3 block) sum their observations
//    from a CSR built once per problem: the lanes compute 32
//    observations' terms at once and add them in ascending order, the
//    order of the plain version's sequential scatter-add.  No atomics, so
//    two launches give the same bits.
// The norms use IEEE sqrt, as the plain version's correctly rounded
// square root, and the source is built without FMA contraction, so an
// observation falls on the same side of th_gba_outlier_global.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct V3 {
  double x, y, z;
};

__device__ inline V3 cross(const V3& a, const V3& b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// geometry.quat_rotate: v + 2 (w (u x v) + u x (u x v))
__device__ inline V3 qrot(const double q[4], const V3& v) {
  const V3 u{q[1], q[2], q[3]};
  const V3 uv = cross(u, v);
  const V3 uuv = cross(u, uv);
  return V3{v.x + 2.0 * (q[0] * uv.x + uuv.x), v.y + 2.0 * (q[0] * uv.y + uuv.y),
            v.z + 2.0 * (q[0] * uv.z + uuv.z)};
}

// geometry.pose_inverse: conj(q), -rotate(conj(q), t), then the quaternion
// normalised with w >= 0 (pose_from_qt)
__device__ inline void pose_inverse(const double* T, double qo[4], V3& to) {
  const double qi[4] = {T[0], -T[1], -T[2], -T[3]};
  const V3 r = qrot(qi, V3{T[4], T[5], T[6]});
  to = V3{-r.x, -r.y, -r.z};
  const double n = sqrt(((qi[0] * qi[0] + qi[1] * qi[1]) + qi[2] * qi[2]) + qi[3] * qi[3]);
  const double nc = fmax(n, 1e-12);
  const double s = (qi[0] / nc < 0.0) ? -1.0 : 1.0;
  for (int i = 0; i < 4; ++i) qo[i] = s * (qi[i] / nc);
}

// geometry.quat_to_matrix
__device__ inline void qmat(const double* q, double R[9]) {
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  const double xx = x * x, yy = y * y, zz = z * z;
  const double wx = w * x, wy = w * y, wz = w * z;
  const double xy = x * y, xz = x * z, yz = y * z;
  R[0] = 1 - 2 * (yy + zz);
  R[1] = 2 * (xy - wz);
  R[2] = 2 * (xz + wy);
  R[3] = 2 * (xy + wz);
  R[4] = 1 - 2 * (xx + zz);
  R[5] = 2 * (yz - wx);
  R[6] = 2 * (xz - wy);
  R[7] = 2 * (yz + wx);
  R[8] = 1 - 2 * (xx + yy);
}

__global__ void reproj_obs_kernel(int mode, const double* __restrict__ poses,
                                  const double* __restrict__ lms,
                                  const double* __restrict__ cam, int dist_model,
                                  const double* __restrict__ uv_obs,
                                  const double* __restrict__ w_obs,
                                  const double* __restrict__ kf_m,
                                  const double* __restrict__ lm_m,
                                  const int32_t* __restrict__ obs_kf,
                                  const int32_t* __restrict__ obs_lm, int O,
                                  double huber_k, double* __restrict__ r_out,
                                  double* __restrict__ Jp_out, double* __restrict__ Jl_out,
                                  double* __restrict__ val, uint8_t* __restrict__ valid_out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= O) return;
  const int kf = obs_kf[o];
  const int lm = obs_lm[o];
  const double* T = poses + 7 * (int64_t)kf;
  const double fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3];
  const double k1 = cam[4], k2 = cam[5], p1 = cam[6], p2 = cam[7];
  // p_s = T_w_s^-1 X, p_c = T_s_c^-1 p_s
  double qsw[4], qcs[4];
  V3 tsw, tcs;
  pose_inverse(T, qsw, tsw);
  pose_inverse(cam + 8, qcs, tcs);
  const V3 X{lms[3 * (int64_t)lm], lms[3 * (int64_t)lm + 1], lms[3 * (int64_t)lm + 2]};
  const V3 rs = qrot(qsw, X);
  const V3 ps{rs.x + tsw.x, rs.y + tsw.y, rs.z + tsw.z};
  const V3 rc = qrot(qcs, ps);
  const V3 pc{rc.x + tcs.x, rc.y + tcs.y, rc.z + tcs.z};
  // pinhole projection
  const bool valid = pc.z > 1e-6;
  const double zs = valid ? pc.z : 1.0;
  const double xn = pc.x / zs, yn = pc.y / zs;
  double xd, yd, dxx = 1.0, dxy = 0.0, dyx = 0.0, dyy = 1.0;
  if (dist_model == 0) {
    xd = xn;
    yd = yn;
  } else if (mode != 0) {
    // cameras.distort_radtan
    const double r2 = xn * xn + yn * yn;
    const double radial = (1.0 + k1 * r2) + (k2 * r2) * r2;
    xd = (xn * radial + ((2.0 * p1) * xn) * yn) + p2 * (r2 + (2.0 * xn) * xn);
    yd = (yn * radial + ((2.0 * p2) * xn) * yn) + p1 * (r2 + (2.0 * yn) * yn);
  } else {
    // cameras._radtan_with_jacobian
    const double xx = xn * xn, yy = yn * yn, xy = xn * yn;
    const double r2 = xx + yy;
    const double radial = (1.0 + k1 * r2) + (k2 * r2) * r2;
    xd = (xn * radial + (2.0 * p1) * xy) + p2 * (r2 + 2.0 * xx);
    yd = (yn * radial + (2.0 * p2) * xy) + p1 * (r2 + 2.0 * yy);
    const double g = 2.0 * (k1 + (2.0 * k2) * r2);
    const double gxy = g * xy;
    dxx = ((radial + g * xx) + (2.0 * p1) * yn) + (6.0 * p2) * xn;
    dxy = (gxy + (2.0 * p1) * xn) + (2.0 * p2) * yn;
    dyx = (gxy + (2.0 * p2) * yn) + (2.0 * p1) * xn;
    dyy = ((radial + g * yy) + (2.0 * p2) * xn) + (6.0 * p1) * yn;
  }
  const double r0 = (fx * xd + cx) - uv_obs[2 * (int64_t)o];
  const double r1 = (fy * yd + cy) - uv_obs[2 * (int64_t)o + 1];
  if (mode == 2) {  // outlier norm: ||r|| / sigma
    val[o] = sqrt(r0 * r0 + r1 * r1) * w_obs[o];
    valid_out[o] = valid;
    return;
  }
  double ww = ((w_obs[o] * (valid ? 1.0 : 0.0)) * lm_m[lm]) * kf_m[kf];
  if (huber_k > 0.0) {
    const double a = r0 * ww, b = r1 * ww;
    const double rn = sqrt(a * a + b * b);
    ww = ww * sqrt(fmin(huber_k / fmax(rn, 1e-12), 1.0));
  }
  const double rw0 = r0 * ww, rw1 = r1 * ww;
  if (mode == 1) {  // cost term
    val[o] = rw0 * rw0 + rw1 * rw1;
    valid_out[o] = valid;
    return;
  }
  valid_out[o] = valid;
  r_out[2 * (int64_t)o] = rw0;
  r_out[2 * (int64_t)o + 1] = rw1;
  // d uv / d p_c (project3_jacobian), then through R_c_s
  const double iz = 1.0 / zs;
  const double vz = valid ? iz : 0.0;
  const double P[6] = {fx * (dxx * iz), fx * (dxy * iz), fx * (-(dxx * xn + dxy * yn) * vz),
                       fy * (dyx * iz), fy * (dyy * iz), fy * (-(dyx * xn + dyy * yn) * vz)};
  double Rcs[9], Rws[9];
  qmat(qcs, Rcs);
  qmat(T, Rws);
  double PR[6];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 3; ++j)
      PR[3 * i + j] = (P[3 * i] * Rcs[j] + P[3 * i + 1] * Rcs[3 + j]) + P[3 * i + 2] * Rcs[6 + j];
  // [[p_s]x | -I] and R_w_s^T
  const double H[9] = {0.0, -ps.z, ps.y, ps.z, 0.0, -ps.x, -ps.y, ps.x, 0.0};
  double* Jp = Jp_out + 12 * (int64_t)o;
  double* Jl = Jl_out + 6 * (int64_t)o;
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 3; ++j) {
      Jp[6 * i + j] =
          ((PR[3 * i] * H[j] + PR[3 * i + 1] * H[3 + j]) + PR[3 * i + 2] * H[6 + j]) * ww;
      Jp[6 * i + 3 + j] = -PR[3 * i + j] * ww;
      Jl[3 * i + j] =
          ((PR[3 * i] * Rws[3 * j] + PR[3 * i + 1] * Rws[3 * j + 1]) + PR[3 * i + 2] * Rws[3 * j + 2]) * ww;
    }
  }
}

// One warp per row of a CSR over the observations (a keyframe or a
// landmark): b = -sum J^T r (DOF entries) and the block sum J^T J
// (DOF x DOF).  Each lane computes the terms of one of 32 consecutive
// observations, then every lane adds the 32 terms in ascending order
// (broadcast by shuffles): the sums run over the observations in
// sequence, as the plain version's scatter-add does.
template <int DOF>
__global__ void reduce_kernel(const double* __restrict__ r, const double* __restrict__ J,
                              const int32_t* __restrict__ rowptr,
                              const int32_t* __restrict__ obs, int n_rows,
                              double* __restrict__ b_out, double* __restrict__ H_out) {
  constexpr int E = DOF + DOF * DOF;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // uniform across the warp
  double acc[E];
  for (int e = 0; e < E; ++e) acc[e] = 0.0;
  const int end = rowptr[row + 1];
  for (int base = rowptr[row]; base < end; base += 32) {
    double t[E];
    for (int e = 0; e < E; ++e) t[e] = 0.0;
    if (base + lane < end) {
      const int64_t o = obs[base + lane];
      const double* Jo = J + 2 * DOF * o;
      const double r0 = r[2 * o], r1 = r[2 * o + 1];
      for (int i = 0; i < DOF; ++i) {
        t[i] = -(Jo[i] * r0 + Jo[DOF + i] * r1);
        for (int j = 0; j < DOF; ++j)
          t[DOF + DOF * i + j] = Jo[i] * Jo[j] + Jo[DOF + i] * Jo[DOF + j];
      }
    }
    const int n = min(32, end - base);
    for (int k = 0; k < n; ++k)
      for (int e = 0; e < E; ++e) acc[e] += __shfl_sync(0xffffffffu, t[e], k);
  }
  for (int e = lane; e < E; e += 32) {
    double v = acc[0];
    for (int f = 1; f < E; ++f)
      if (f == e) v = acc[f];
    if (e < DOF)
      b_out[(int64_t)row * DOF + e] = v;
    else
      H_out[(int64_t)row * DOF * DOF + (e - DOF)] = v;
  }
}

}  // namespace

// mode 0 (linearise): r (O, 2), Jp (O, 2, 6), Jl (O, 2, 3), b6 (N, 6),
// M6 (N, 6, 6), bl (M, 3), Hll (M, 3, 3); mode 1 (cost) and 2 (outlier):
// val (O,).  valid (O,) uint8 in every mode.  cam = [fx, fy, cx, cy, k1,
// k2, p1, p2, T_s_c(7)]; w = obs_w * obs_mask (obs_w alone in mode 2);
// kf_m (N,), lm_m (M,) the masks as float64; the CSRs list each keyframe's
// and each landmark's observations in ascending order.
extern "C" int covins_gba_reproj_blocks(
    int mode, const void* poses, const void* lms, const void* cam, int dist_model,
    const void* uv, const void* w, const void* kf_m, const void* lm_m, const void* obs_kf,
    const void* obs_lm, int O, const void* kf_rowptr, const void* kf_obs, int N,
    const void* lm_rowptr, const void* lm_obs, int M, double huber_k, void* r, void* Jp,
    void* Jl, void* b6, void* M6, void* bl, void* Hll, void* val, void* valid,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  if (O > 0) {
    reproj_obs_kernel<<<(O + threads - 1) / threads, threads, 0, st>>>(
        mode, static_cast<const double*>(poses), static_cast<const double*>(lms),
        static_cast<const double*>(cam), dist_model, static_cast<const double*>(uv),
        static_cast<const double*>(w), static_cast<const double*>(kf_m),
        static_cast<const double*>(lm_m), static_cast<const int32_t*>(obs_kf),
        static_cast<const int32_t*>(obs_lm), O, huber_k, static_cast<double*>(r),
        static_cast<double*>(Jp), static_cast<double*>(Jl), static_cast<double*>(val),
        static_cast<uint8_t*>(valid));
  }
  if (mode != 0) return static_cast<int>(cudaGetLastError());
  if (N > 0) {
    reduce_kernel<6><<<(32 * N + threads - 1) / threads, threads, 0, st>>>(
        static_cast<const double*>(r), static_cast<const double*>(Jp),
        static_cast<const int32_t*>(kf_rowptr), static_cast<const int32_t*>(kf_obs), N,
        static_cast<double*>(b6), static_cast<double*>(M6));
  }
  if (M > 0) {
    reduce_kernel<3><<<(32 * M + threads - 1) / threads, threads, 0, st>>>(
        static_cast<const double*>(r), static_cast<const double*>(Jl),
        static_cast<const int32_t*>(lm_rowptr), static_cast<const int32_t*>(lm_obs), M,
        static_cast<double*>(bl), static_cast<double*>(Hll));
  }
  return static_cast<int>(cudaGetLastError());
}
