"""SO(3) / SE(3) / Sim(3) operations on torch tensors, batched.

Counterpart of the subset of `covins_tpu/utils/geometry.py` that place
recognition, loop verification and pose-graph optimisation call.  Every
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

import torch

from covins_tpu_torch.ops import linalg


# --------------------------------------------------------------- quaternions
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


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vectors ``v`` (..., 3) by quaternions ``q`` (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


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


def sim3_apply(g, x):
    return g[..., 7:8] * quat_rotate(g[..., :4], x) + g[..., 4:7]


# ------------------------------------------------------------- alignment
def umeyama_alignment(src, dst, weights=None, with_scale=True):
    """Least-squares similarity aligning ``src`` (..., N, 3) onto ``dst``.

    Horn's closed-form quaternion method: the rotation is the top
    eigenvector of the 4x4 N-matrix, found by the same cyclic Jacobi
    solver as the reference (`ops/linalg.jacobi_eigh`), so eigenvector
    signs and rounding follow it.  Batched over leading dims.  Returns the
    Sim(3) element (..., 8) with ``dst ~ sim3_apply(g, src)``.
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-12)
    w = (weights / wsum)[..., None]
    mu_s = torch.sum(w * src, dim=-2)
    mu_d = torch.sum(w * dst, dim=-2)
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    S = (w * xs).transpose(-1, -2) @ xd  # (..., 3, 3)
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
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-30)
    R = quat_to_matrix(q)
    if with_scale:
        var_s = torch.sum(w * xs * xs, dim=(-2, -1))
        scale = evals[..., -1] / torch.clamp(var_s, min=1e-12)
    else:
        scale = torch.ones(src.shape[:-2], dtype=src.dtype, device=src.device)
    t = mu_d - scale[..., None] * _matvec(R, mu_s)
    return torch.cat([q, t, scale[..., None]], dim=-1)
