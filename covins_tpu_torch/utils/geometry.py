"""SO(3) / SE(3) / Sim(3) operations on torch tensors, batched.

Counterpart of `covins_tpu/utils/geometry.py`.  Every
function is elementwise over arbitrary leading batch dimensions, keeps the
input dtype (float64 on the main path), and is functional (no in-place
writes), so ``torch.func.jacfwd`` and ``torch.func.vmap`` differentiate and
batch it as ``jax.jacfwd`` / ``jax.vmap`` do the reference.

Conventions (as in the reference):
* quaternions ``(..., 4)`` ``[w, x, y, z]`` (Hamilton);
* a pose ``(..., 7)`` ``[qw, qx, qy, qz, tx, ty, tz]`` is ``T_a_b``;
* a Sim(3) element ``(..., 8)`` is ``[qw, qx, qy, qz, tx, ty, tz, s]``.
"""

from __future__ import annotations

import math

import torch

from covins_tpu_torch.ops import linalg


# --------------------------------------------------------------- quaternions
def quat_identity(dtype=torch.float64, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q):
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=1e-12)
    # canonical sign (w >= 0) so compositions are deterministic
    return torch.where(q[..., :1] < 0, -q, q)


def quat_multiply(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _lib_cross(a, b):
    """``torch.linalg.cross``: one operation (against about twenty for
    :func:`linalg.cross3`), rounding on the CPU as the JAX package's
    ``jnp.cross`` does; on the card it may round otherwise, so paths held
    bit for bit to a kernel or across devices take ``linalg.cross3``."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vectors ``v`` (..., 3) by quaternions ``q`` (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _lib_cross(u, v)
    return v + 2.0 * (w * uv + _lib_cross(u, uv))


def quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R):
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), branch-free:
    Shepperd's four candidates, one selected (as the reference)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-24))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], -1)
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return quat_normalize(q)


def _safe_norm(x):
    """Norm with a finite derivative at x == 0 (as the reference's)."""
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    return torch.sqrt(torch.clamp(n2, min=1e-24))


def quat_exp(w):
    """so(3) tangent (..., 3) -> unit quaternion (..., 4)."""
    theta = _safe_norm(w)
    half = 0.5 * theta
    sinc = torch.where(theta < 1e-6, 0.5 - theta ** 2 / 48.0,
                       torch.sin(half) / torch.clamp(theta, min=1e-24))
    return quat_normalize(torch.cat([torch.cos(half), sinc * w], dim=-1))


def quat_log(q):
    """Unit quaternion (..., 4) -> so(3) tangent (..., 3)."""
    q = quat_normalize(q)
    w = q[..., :1]
    v = q[..., 1:]
    vn = _safe_norm(v)
    theta = 2.0 * torch.atan2(vn, w)
    scale = torch.where(vn < 1e-9, 2.0 / torch.clamp(w, min=1e-12),
                        theta / torch.clamp(vn, min=1e-24))
    return scale * v


def so3_hat(w):
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_exp_matrix(w):
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    return quat_to_matrix(quat_exp(w))


def so3_log_matrix(R):
    return quat_log(matrix_to_quat(R))


def so3_left_jacobian(w):
    """Left Jacobian of SO(3), (..., 3, 3)."""
    theta = _safe_norm(w)[..., None]
    W = so3_hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    t2 = theta * theta
    small = theta < 1e-5
    a = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(t2, min=1e-24))
    b = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(t2 * theta, min=1e-24))
    return eye + a * W + b * W2


# ----------------------------------------------------------------- SE(3)
def pose_from_qt(q, t):
    return torch.cat([quat_normalize(q), t], dim=-1)


def pose_identity(dtype=torch.float64, device=None):
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device)


def pose_q(p):
    return p[..., :4]


def pose_t(p):
    return p[..., 4:7]


def pose_from_matrix(T):
    return pose_from_qt(matrix_to_quat(T[..., :3, :3]), T[..., :3, 3])


def pose_to_matrix(p):
    R = quat_to_matrix(pose_q(p))
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=p.dtype,
                          device=p.device).expand(p.shape[:-1] + (4,))
    top = torch.cat([R, pose_t(p)[..., :, None]], dim=-1)
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def pose_compose(p1, p2):
    """T_a_c = T_a_b o T_b_c."""
    q1, t1 = pose_q(p1), pose_t(p1)
    q2, t2 = pose_q(p2), pose_t(p2)
    return pose_from_qt(quat_multiply(q1, q2), quat_rotate(q1, t2) + t1)


def pose_inverse(p):
    qi = quat_conjugate(pose_q(p))
    return pose_from_qt(qi, -quat_rotate(qi, pose_t(p)))


def pose_apply(p, x):
    """Transform points ``x`` (..., 3) by pose ``p``."""
    return quat_rotate(pose_q(p), x) + pose_t(p)


def pose_relative(p_a, p_b):
    """T_a_b given T_w_a, T_w_b."""
    return pose_compose(pose_inverse(p_a), p_b)


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def se3_exp(xi):
    """se(3) tangent (..., 6) [rot, trans] -> pose (..., 7)."""
    w, v = xi[..., :3], xi[..., 3:]
    return pose_from_qt(quat_exp(w), _matvec(so3_left_jacobian(w), v))


def se3_log(p):
    """pose (..., 7) -> se(3) tangent (..., 6) [rot, trans]."""
    w = quat_log(pose_q(p))
    v = _matvec(linalg.inv33(so3_left_jacobian(w)), pose_t(p))
    return torch.cat([w, v], dim=-1)


def pose_boxplus(p, xi):
    """Right-perturbation retraction: p (+) xi = p o Exp(xi)."""
    return pose_compose(p, se3_exp(xi))


def pose_boxminus(p1, p2):
    """Inverse retraction: Log(p2^-1 o p1)."""
    return se3_log(pose_compose(pose_inverse(p2), p1))


# ----------------------------------------------------------------- Sim(3)
def sim3_from_pose_scale(p, s):
    s = torch.as_tensor(s, dtype=p.dtype, device=p.device)
    return torch.cat([p, s[..., None]], dim=-1)


def sim3_apply(g, x):
    return g[..., 7:8] * quat_rotate(g[..., :4], x) + g[..., 4:7]


def sim3_compose(g1, g2):
    q = quat_multiply(g1[..., :4], g2[..., :4])
    t = g1[..., 7:8] * quat_rotate(g1[..., :4], g2[..., 4:7]) + g1[..., 4:7]
    s = g1[..., 7:8] * g2[..., 7:8]
    return torch.cat([quat_normalize(q), t, s], dim=-1)


def sim3_inverse(g):
    qi = quat_conjugate(g[..., :4])
    si = 1.0 / g[..., 7:8]
    ti = -si * quat_rotate(qi, g[..., 4:7])
    return torch.cat([qi, ti, si], dim=-1)


# ---------------------------------------------------------- Euler helpers
# (`utils_base.hpp:65-135` R2ypr / normalizeAngle)
def rotation_to_ypr(R):
    """Rotation matrix -> [yaw, pitch, roll] in radians (ZYX convention)."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.atan2(-R[..., 2, 0],
                        torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


def normalize_angle(a):
    """Wrap angle to (-pi, pi]."""
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))


# ------------------------------------------------------------- alignment
def umeyama_alignment(src, dst, weights=None, with_scale=True):
    """Least-squares similarity aligning ``src`` (..., N, 3) onto ``dst``.

    Horn's closed-form quaternion method: the rotation is the top
    eigenvector of the 4x4 N-matrix, found by the same cyclic Jacobi
    solver as the reference (`ops/linalg.jacobi_eigh`), so eigenvector
    signs and rounding follow it.  Batched over leading dims.  Returns the
    Sim(3) element (..., 8) with ``dst ~ sim3_apply(g, src)``.

    The sums over the points, the 3x3 correlation, the quaternion's norm
    and the rotation of the source centroid are written out in one fixed
    order (the P3P kernel, `csrc/p3p_ransac.cu`, repeats them and is held
    to them bit for bit; a reduction or a batched product on the card sums
    in its own order).
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-12)
    w = (weights / wsum)[..., None]
    mu_s = _sum_points(w * src)
    mu_d = _sum_points(w * dst)
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    a = w * xs
    S = a[..., 0, :, None] * xd[..., 0, None, :]  # (..., 3, 3)
    for k in range(1, src.shape[-2]):
        S = S + a[..., k, :, None] * xd[..., k, None, :]
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    evals, evecs = linalg.jacobi_eigh(N)  # ascending
    q = evecs[..., :, -1]
    q = torch.where(q[..., :1] >= 0, q, -q)
    q0, q1, q2, q3 = q.unbind(-1)
    nrm = linalg.sqrt_rn(((q0 * q0 + q1 * q1) + q2 * q2) + q3 * q3)
    q = q / torch.clamp(nrm, min=1e-30)[..., None]
    R = quat_to_matrix(q)
    if with_scale:
        var_s = torch.sum(w * xs * xs, dim=(-2, -1))
        scale = evals[..., -1] / torch.clamp(var_s, min=1e-12)
    else:
        scale = torch.ones(src.shape[:-2], dtype=src.dtype, device=src.device)
    Rmu = (R[..., :, 0] * mu_s[..., 0:1] + R[..., :, 1] * mu_s[..., 1:2]) \
        + R[..., :, 2] * mu_s[..., 2:3]
    t = mu_d - scale[..., None] * Rmu
    return torch.cat([q, t, scale[..., None]], dim=-1)


def ate_rmse(est, gt, weights=None, align_scale=True):
    """Absolute trajectory error RMSE after Sim(3) (or SE(3)) alignment
    (the `evo_ape ... -vas` protocol).  Returns (rmse, aligned_est)."""
    g = umeyama_alignment(est, gt, weights, with_scale=align_scale)
    aligned = sim3_apply(g, est)
    err2 = torch.sum((aligned - gt) ** 2, dim=-1)
    if weights is None:
        rmse = torch.sqrt(torch.mean(err2))
    else:
        rmse = torch.sqrt(torch.sum(err2 * weights)
                          / torch.clamp(torch.sum(weights), min=1e-12))
    return rmse, aligned


def _sum_points(x):
    """Sum of (..., N, 3) over the points, in their order."""
    acc = x[..., 0, :]
    for k in range(1, x.shape[-2]):
        acc = acc + x[..., k, :]
    return acc
