"""Pose and quaternion arithmetic in numpy, float64.

Poses are (..., 7) arrays [qw qx qy qz tx ty tz], T_a_b maps points of
frame b into frame a.  A frozen copy of the program's conventions, so the
traffic generator and the reference share one geometry that no change to
the program moves.
"""

from __future__ import annotations

import numpy as np


def quat_normalize(q):
    q = np.asarray(q, np.float64)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


def quat_multiply(q1, q2):
    w1, x1, y1, z1 = np.moveaxis(np.asarray(q1, np.float64), -1, 0)
    w2, x2, y2, z2 = np.moveaxis(np.asarray(q2, np.float64), -1, 0)
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], axis=-1)


def quat_rotate(q, v):
    q = np.asarray(q, np.float64)
    v = np.asarray(v, np.float64)
    w, u = q[..., :1], q[..., 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_exp(w):
    """so(3) tangent (..., 3) -> unit quaternion (..., 4)."""
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    sinc = np.where(theta < 1e-8, 0.5 - theta**2 / 48.0,
                    np.sin(0.5 * theta) / np.maximum(theta, 1e-24))
    return quat_normalize(np.concatenate([np.cos(0.5 * theta), sinc * w], axis=-1))


def pose_identity():
    return np.array([1.0, 0, 0, 0, 0, 0, 0])


def pose_compose(p1, p2):
    p1, p2 = np.asarray(p1, np.float64), np.asarray(p2, np.float64)
    q = quat_normalize(quat_multiply(p1[..., :4], p2[..., :4]))
    return np.concatenate([q, quat_rotate(p1[..., :4], p2[..., 4:7]) + p1[..., 4:7]],
                          axis=-1)


def pose_inverse(p):
    p = np.asarray(p, np.float64)
    qi = p[..., :4] * np.asarray([1.0, -1.0, -1.0, -1.0])
    return np.concatenate([quat_normalize(qi), -quat_rotate(qi, p[..., 4:7])], axis=-1)


def pose_apply(p, x):
    p = np.asarray(p, np.float64)
    return quat_rotate(p[..., :4], x) + p[..., 4:7]


def pose_relative(p_a, p_b):
    """T_a_b from T_w_a and T_w_b."""
    return pose_compose(pose_inverse(p_a), p_b)


def se3_exp(xi):
    """se(3) tangent [rot, trans] -> pose, with the SO(3) left Jacobian."""
    w, v = xi[:3], xi[3:]
    theta = np.sqrt(max(float(w @ w), 1e-24))
    W = np.asarray([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if theta < 1e-5:
        a, b = 0.5 - theta**2 / 24.0, 1.0 / 6.0 - theta**2 / 120.0
    else:
        a = (1.0 - np.cos(theta)) / theta**2
        b = (theta - np.sin(theta)) / theta**3
    return np.concatenate([quat_exp(w), (np.eye(3) + a * W + b * (W @ W)) @ v])


def project_radtan(intr, dist, p_c):
    """Pinhole projection with radial-tangential distortion of camera-frame
    points (N, 3): (uv (N, 2), valid (N,)), valid where z > 1e-6."""
    fx, fy, cx, cy = (float(v) for v in intr[:4])
    k1, k2, p1, p2 = (float(v) for v in dist[:4])
    z = p_c[:, 2]
    valid = z > 1e-6
    zs = np.where(valid, z, 1.0)
    x, y = p_c[:, 0] / zs, p_c[:, 1] / zs
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([fx * xd + cx, fy * yd + cy], axis=-1), valid
