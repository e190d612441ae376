"""Numpy SE(3)/quaternion helpers for the HOST shell.

The server's per-message bookkeeping (pose composition onto a reference
keyframe, landmark lifting, trajectory deltas) operates on single
7-vectors; dispatching those to the device costs far more than the
arithmetic in launch latency and transfers, so the imperative shell
does scalar-sized math in numpy (`communicator_be.cpp:107-179`
equivalents).  A copy of the JAX package's `utils/npgeo.py`.

Pose layout matches `utils/geometry.py`: (..., 7) = [qw qx qy qz tx ty tz].
"""

from __future__ import annotations

import numpy as np


def quat_normalize(q):
    q = np.asarray(q, np.float64)
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    q = q / np.maximum(n, 1e-12)
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


def quat_multiply(q1, q2):
    q1 = np.asarray(q1, np.float64)
    q2 = np.asarray(q2, np.float64)
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conjugate(q):
    return np.asarray(q, np.float64) * np.asarray([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q, v):
    q = np.asarray(q, np.float64)
    v = np.asarray(v, np.float64)
    w = q[..., :1]
    u = q[..., 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_exp(w):
    """so(3) tangent (..., 3) -> unit quaternion (..., 4)."""
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    half = 0.5 * theta
    sinc = np.where(theta < 1e-8, 0.5 - theta**2 / 48.0,
                    np.sin(half) / np.maximum(theta, 1e-24))
    return quat_normalize(np.concatenate([np.cos(half), sinc * w], axis=-1))


def quat_to_matrix(q):
    q = np.asarray(q, np.float64)
    w, x, y, z = np.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = np.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def pose_identity():
    return np.array([1.0, 0, 0, 0, 0, 0, 0], np.float64)


def pose_compose(p1, p2):
    """T_a_c = T_a_b ∘ T_b_c."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    q = quat_normalize(quat_multiply(p1[..., :4], p2[..., :4]))
    t = quat_rotate(p1[..., :4], p2[..., 4:7]) + p1[..., 4:7]
    return np.concatenate([q, t], axis=-1)


def pose_inverse(p):
    p = np.asarray(p, np.float64)
    qi = quat_conjugate(p[..., :4])
    t = -quat_rotate(qi, p[..., 4:7])
    return np.concatenate([quat_normalize(qi), t], axis=-1)


def pose_apply(p, x):
    p = np.asarray(p, np.float64)
    return quat_rotate(p[..., :4], x) + p[..., 4:7]


def pose_relative(p_a, p_b):
    """T_a_b given T_w_a, T_w_b."""
    return pose_compose(pose_inverse(p_a), p_b)
