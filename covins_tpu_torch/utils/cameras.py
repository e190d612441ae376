"""Camera projection: pinhole with radial-tangential distortion.

Counterpart of the `project3` part of `covins_tpu/utils/cameras.py` (the
model the synthetic and EuRoC agents use).  The other camera and
distortion models, back-projection and undistortion belong to the
loop-verification part of the port.

* ``intrinsics``: ``(5,)`` ``[fx, fy, cx, cy, xi]`` (``xi`` unused here);
* ``dist``: ``(4,)`` radtan ``[k1, k2, p1, p2]``;
* model codes mirror the reference enums (`typedefs_base.hpp:247-262`).
"""

from __future__ import annotations

import dataclasses

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


def distort_radtan(dist: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return torch.stack([xd, yd], dim=-1)


def project3(cam: Camera, p_c: torch.Tensor):
    """Camera-frame points (..., 3) -> (uv (..., 2), valid (...,) bool)."""
    if cam.cam_model != PINHOLE or cam.dist_model not in (DIST_NONE, RADTAN):
        raise NotImplementedError(
            "only pinhole cameras with no or radtan distortion are ported")
    fx, fy, cx, cy = (cam.intrinsics[i] for i in range(4))
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    valid = z > 1e-6
    zs = torch.where(valid, z, torch.ones_like(z))
    xy = torch.stack([x / zs, y / zs], dim=-1)
    if cam.dist_model == RADTAN:
        xy = distort_radtan(cam.dist, xy)
    uv = torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], dim=-1)
    return uv, valid
