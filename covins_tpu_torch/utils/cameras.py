"""Camera models: pinhole or unified projection, with radtan, equidistant
or FOV distortion.

Counterpart of `covins_tpu/utils/cameras.py`.  Every function is batched
over leading dims and functional, so ``torch.func`` differentiates it.

* ``intrinsics``: ``(5,)`` ``[fx, fy, cx, cy, xi]`` (``xi`` is the unified
  projection's mirror parameter, unused for pinhole);
* ``dist``: ``(4,)`` — radtan ``[k1, k2, p1, p2]``, equidistant
  ``[k1, k2, k3, k4]``, FOV ``[w, 0, 0, 0]``;
* model codes mirror the reference enums (`typedefs_base.hpp:247-262`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Camera model codes (reference: eCamModel, typedefs_base.hpp:255)
PINHOLE = 0
OMNI = 1
# Distortion model codes (reference: eDistortionModel, typedefs_base.hpp:247)
DIST_NONE = 0
RADTAN = 1
EQUIDISTANT = 2
FISHEYE = 3


@dataclasses.dataclass(frozen=True)
class Camera:
    intrinsics: torch.Tensor  # (5,) [fx, fy, cx, cy, xi]
    dist: torch.Tensor  # (4,)
    T_s_c: torch.Tensor  # (7,) IMU -> camera pose
    cam_model: int = PINHOLE
    dist_model: int = RADTAN


def make_pinhole_radtan(fx, fy, cx, cy, dist, T_s_c=None, dtype=torch.float64,
                        device=None) -> Camera:
    """A pinhole camera with radtan distortion (``dist`` up to 4 values,
    zero-padded); ``T_s_c`` defaults to the identity."""
    f = dict(dtype=dtype, device=device)
    if T_s_c is None:
        T_s_c = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], **f)
    d = torch.zeros(4, **f)
    d[:len(dist)] = torch.as_tensor(dist, **f)
    return Camera(torch.tensor([fx, fy, cx, cy, 0.0], **f), d,
                  torch.as_tensor(T_s_c, **f), PINHOLE, RADTAN)


def camera_from_calibration(calib, device) -> Camera:
    """Device-resident float64 camera of a `VICalibration` message."""
    f64 = dict(dtype=torch.float64, device=device)
    return Camera(
        intrinsics=torch.as_tensor(np.asarray(calib.intrinsics, np.float64), **f64),
        dist=torch.as_tensor(np.asarray(calib.dist, np.float64), **f64),
        T_s_c=torch.as_tensor(np.asarray(calib.T_s_c, np.float64), **f64),
        cam_model=int(calib.cam_model), dist_model=int(calib.dist_model))


# ------------------------------------------- distortion (normalised coords)
def distort_radtan(dist, xy):
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return torch.stack([xd, yd], dim=-1)


def _distort_equidistant(dist, xy):
    k1, k2, k3, k4 = dist[0], dist[1], dist[2], dist[3]
    r = torch.linalg.vector_norm(xy, dim=-1, keepdim=True)
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1 + k1 * t2 + k2 * t2 ** 2 + k3 * t2 ** 3 + k4 * t2 ** 4)
    scale = torch.where(r > 1e-8, theta_d / torch.clamp(r, min=1e-12), 1.0)
    return xy * scale


def _distort_fisheye_fov(dist, xy):
    w = dist[0]
    r = torch.linalg.vector_norm(xy, dim=-1, keepdim=True)
    rd = torch.atan(2.0 * r * torch.tan(w / 2.0)) / torch.clamp(w, min=1e-12)
    scale = torch.where(r > 1e-8, rd / torch.clamp(r, min=1e-12), 1.0)
    return xy * scale


def distort(dist_model: int, dist, xy):
    if dist_model == DIST_NONE:
        return xy
    if dist_model == RADTAN:
        return distort_radtan(dist, xy)
    if dist_model == EQUIDISTANT:
        return _distort_equidistant(dist, xy)
    if dist_model == FISHEYE:
        return _distort_fisheye_fov(dist, xy)
    raise ValueError(f"unknown distortion model {dist_model}")


def _radtan_with_jacobian(dist, x, y):
    """Radtan distortion of (x, y) and its four partial derivatives, with
    the shared subexpressions computed once."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    xx, yy, xy = x * x, y * y, x * y
    r2 = xx + yy
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * xx)
    yd = y * radial + 2.0 * p2 * xy + p1 * (r2 + 2.0 * yy)
    g = 2.0 * (k1 + 2.0 * k2 * r2)  # 2 d radial / d r2
    gxy = g * xy
    dxx = radial + g * xx + 2.0 * p1 * y + 6.0 * p2 * x
    dxy = gxy + 2.0 * p1 * x + 2.0 * p2 * y
    dyx = gxy + 2.0 * p2 * y + 2.0 * p1 * x
    dyy = radial + g * yy + 2.0 * p2 * x + 6.0 * p1 * y
    return xd, yd, dxx, dxy, dyx, dyy


def distort_with_jacobian(dist_model: int, dist, x, y):
    """(xd, yd, dxx, dxy, dyx, dyy): :func:`distort` of (x, y) and its
    Jacobian.  Written out for no and radtan distortion (the models of the
    main path): forward-mode AD through torch.func costs many times the
    arithmetic here, because every operation that mixes a dual tensor with
    a constant takes a Python path.  The other models use
    ``torch.func.jacfwd``, as the reference uses ``jax.jacfwd``; both forms
    give the same derivative up to rounding."""
    if dist_model == DIST_NONE:
        one, zero = torch.ones_like(x), torch.zeros_like(x)
        return x, y, one, zero, zero, one
    if dist_model == RADTAN:
        return _radtan_with_jacobian(dist, x, y)
    xy = torch.stack([x, y], dim=-1)
    d = distort(dist_model, dist, xy)
    J = torch.func.vmap(torch.func.jacfwd(
        lambda p: distort(dist_model, dist, p)))(xy.reshape(-1, 2))
    J = J.reshape(xy.shape[:-1] + (2, 2))
    return d[..., 0], d[..., 1], J[..., 0, 0], J[..., 0, 1], J[..., 1, 0], J[..., 1, 1]


def undistort(dist_model: int, dist, xy_d, iters: int = 20):
    """Invert :func:`distort` by fixed-iteration Newton with the closed-form
    2x2 solve, as the reference."""
    if dist_model == DIST_NONE:
        return xy_d
    xd0, yd0 = xy_d[..., 0], xy_d[..., 1]
    x, y = xd0, yd0
    for _ in range(iters):
        xd, yd, a, b, c, d = distort_with_jacobian(dist_model, dist, x, y)
        fx, fy = xd - xd0, yd - yd0
        det = a * d - b * c
        det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
        x = x - (d * fx - b * fy) / det
        y = y - (a * fy - c * fx) / det
    return torch.stack([x, y], dim=-1)


# --------------------------------------------------------------- projection
def project3(cam: Camera, p_c):
    """Camera-frame points (..., 3) -> (uv (..., 2), valid (...,) bool)."""
    fx, fy, cx, cy, xi = (cam.intrinsics[i] for i in range(5))
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    if cam.cam_model == PINHOLE:
        valid = z > 1e-6
        zs = torch.where(valid, z, 1.0)
        xy = torch.stack([x / zs, y / zs], dim=-1)
    elif cam.cam_model == OMNI:
        d = torch.sqrt(x * x + y * y + z * z)
        denom = z + xi * d
        valid = denom > 1e-6
        denom = torch.where(valid, denom, 1.0)
        xy = torch.stack([x / denom, y / denom], dim=-1)
    else:
        raise ValueError(f"unknown camera model {cam.cam_model}")
    xy = distort(cam.dist_model, cam.dist, xy)
    uv = torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], dim=-1)
    return uv, valid


def project3_jacobian(cam: Camera, p_c):
    """(uv, valid, d uv / d p_c (..., 2, 3)): :func:`project3` with the
    derivative it has under forward-mode AD, as the reference takes it with
    ``jax.jacfwd``.  Where the point is invalid the reference divides by a
    constant 1, so there d (xn, yn) / d p_c is [[1, 0, 0], [0, 1, 0]]
    before distortion."""
    fx, fy, cx, cy, xi = (cam.intrinsics[i] for i in range(5))
    x, y, z = p_c.unbind(-1)
    if cam.cam_model == PINHOLE:
        valid = z > 1e-6
        den = torch.where(valid, z, 1.0)
    elif cam.cam_model == OMNI:
        d = torch.sqrt(x * x + y * y + z * z)
        den = z + xi * d
        valid = den > 1e-6
        den = torch.where(valid, den, 1.0)
    else:
        raise ValueError(f"unknown camera model {cam.cam_model}")
    xn, yn = x / den, y / den
    xd, yd, dxx, dxy, dyx, dyy = distort_with_jacobian(cam.dist_model, cam.dist,
                                                       xn, yn)
    uv = torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)
    iz = 1.0 / den
    vz = torch.where(valid, iz, 0.0)
    if cam.cam_model == PINHOLE:
        # d (xn, yn) / d p_c = [[1/z, 0, -xn/z], [0, 1/z, -yn/z]] (z column
        # 0 where invalid), premultiplied by the distortion Jacobian and K
        row_u = torch.stack([dxx * iz, dxy * iz, -(dxx * xn + dxy * yn) * vz], dim=-1)
        row_v = torch.stack([dyx * iz, dyy * iz, -(dyx * xn + dyy * yn) * vz], dim=-1)
        return uv, valid, torch.stack([fx * row_u, fy * row_v], dim=-2)
    # unified: with den = z + xi |p|, d den / d p = [xi x, xi y, |p| + xi z]
    # / |p| (0 where invalid), and d xn / d p = [1, 0, 0] / den - xn / den *
    # d den / d p, likewise yn
    ds = torch.where(valid, d, 1.0)
    g = torch.stack([xi * x / ds, xi * y / ds, 1.0 + xi * z / ds], dim=-1) * vz[..., None]
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=p_c.dtype, device=p_c.device)
    e1 = torch.tensor([0.0, 1.0, 0.0], dtype=p_c.dtype, device=p_c.device)
    dxn = e0 * iz[..., None] - xn[..., None] * g
    dyn = e1 * iz[..., None] - yn[..., None] * g
    row_u = dxx[..., None] * dxn + dxy[..., None] * dyn
    row_v = dyx[..., None] * dxn + dyy[..., None] * dyn
    return uv, valid, torch.stack([fx * row_u, fy * row_v], dim=-2)


def back_project3(cam: Camera, uv):
    """Pixel (..., 2) -> unit bearing (..., 3) in the camera frame
    (`keyframe_be.cpp:209-225`)."""
    fx, fy, cx, cy, xi = (cam.intrinsics[i] for i in range(5))
    xy_d = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    xy = undistort(cam.dist_model, cam.dist, xy_d)
    if cam.cam_model == PINHOLE:
        b = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    elif cam.cam_model == OMNI:
        r2 = torch.sum(xy * xy, dim=-1, keepdim=True)
        beta = 1.0 + (1.0 - xi * xi) * r2
        eta = (xi + torch.sqrt(torch.clamp(beta, min=0.0))) / (1.0 + r2)
        b = torch.cat([eta * xy, eta - xi * torch.ones_like(r2)], dim=-1)
    else:
        raise ValueError(f"unknown camera model {cam.cam_model}")
    return b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)


def undistort_keypoints(cam: Camera, uv):
    """Distorted pixel keypoints -> undistorted pixel keypoints under the
    same K (`keyframe_be.cpp:101-140`)."""
    fx, fy, cx, cy, _ = (cam.intrinsics[i] for i in range(5))
    xy_d = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    xy = undistort(cam.dist_model, cam.dist, xy_d)
    return torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], dim=-1)


def project_world(cam: Camera, T_w_s, p_w):
    """World point -> (pixel, valid) through body pose ``T_w_s`` and the
    extrinsic ``T_s_c`` (`optimization_be.cpp:178-235`)."""
    from covins_tpu_torch.utils import geometry as geo

    T_w_c = geo.pose_compose(T_w_s, cam.T_s_c)
    return project3(cam, geo.pose_apply(geo.pose_inverse(T_w_c), p_w))
