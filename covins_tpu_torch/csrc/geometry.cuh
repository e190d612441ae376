// Device geometry shared by the kernels that project points (K5
// project_match.cu, K8 gba_reproj_blocks.cu): the port's quaternion helpers
// (covins_tpu_torch/utils/geometry.py) and the radtan distortion
// (covins_tpu_torch/utils/cameras.py), each written in the operation order
// of its PyTorch version.  The sources that include it are built without
// FMA contraction, so every product and sum rounds on its own, as the
// plain versions' separate tensor operations do.
#pragma once

struct V3 {
  double x, y, z;
};

// torch.linalg.cross's formula
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

// the translation of geometry.pose_inverse: -rotate(conj(q), t)
__device__ inline V3 pose_inverse_t(const double* T) {
  const double qi[4] = {T[0], -T[1], -T[2], -T[3]};
  const V3 r = qrot(qi, V3{T[4], T[5], T[6]});
  return V3{-r.x, -r.y, -r.z};
}

// geometry.pose_inverse: conj(q), -rotate(conj(q), t), then the quaternion
// normalised with w >= 0 (pose_from_qt)
__device__ inline void pose_inverse(const double* T, double qo[4], V3& to) {
  const double qi[4] = {T[0], -T[1], -T[2], -T[3]};
  to = pose_inverse_t(T);
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

// cameras.distort_radtan with dist = [k1, k2, p1, p2]
__device__ inline void distort_radtan(const double* dist, double x, double y, double& xd,
                                      double& yd) {
  const double k1 = dist[0], k2 = dist[1], p1 = dist[2], p2 = dist[3];
  const double r2 = x * x + y * y;
  const double radial = (1.0 + k1 * r2) + (k2 * r2) * r2;
  xd = (x * radial + ((2.0 * p1) * x) * y) + p2 * (r2 + (2.0 * x) * x);
  yd = (y * radial + ((2.0 * p2) * x) * y) + p1 * (r2 + (2.0 * y) * y);
}

// cameras._radtan_with_jacobian: the distortion in that function's order
// and its four partial derivatives
__device__ inline void radtan_with_jacobian(const double* dist, double x, double y,
                                            double& xd, double& yd, double& dxx,
                                            double& dxy, double& dyx, double& dyy) {
  const double k1 = dist[0], k2 = dist[1], p1 = dist[2], p2 = dist[3];
  const double xx = x * x, yy = y * y, xy = x * y;
  const double r2 = xx + yy;
  const double radial = (1.0 + k1 * r2) + (k2 * r2) * r2;
  xd = (x * radial + (2.0 * p1) * xy) + p2 * (r2 + 2.0 * xx);
  yd = (y * radial + (2.0 * p2) * xy) + p1 * (r2 + 2.0 * yy);
  const double g = 2.0 * (k1 + (2.0 * k2) * r2);
  const double gxy = g * xy;
  dxx = ((radial + g * xx) + (2.0 * p1) * y) + (6.0 * p2) * x;
  dxy = (gxy + (2.0 * p1) * x) + (2.0 * p2) * y;
  dyx = (gxy + (2.0 * p2) * y) + (2.0 * p1) * x;
  dyy = ((radial + g * yy) + (2.0 * p2) * x) + (6.0 * p1) * y;
}
