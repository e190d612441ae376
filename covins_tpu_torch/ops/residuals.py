"""Factor residuals of the relative-pose and pose-graph solves.

Counterpart of the COVINS-path part of `covins_tpu/ops/residuals.py`:
`SixDofBetweenError` for loop and odometry edges, the paired relative
reprojection residual of `OptimizeRelativePose` (kNormal / kInverse,
`optimization_be.cpp:620-831`), the sqrt-information of a covariance and
the Cauchy IRLS weight.  The pose-graph Jacobians come from
``torch.func.jacfwd`` on a right-tangent perturbation, as the reference's
from ``jax.jacfwd``; the relative-pose residual, evaluated on every match
sixteen times per verification, has its Jacobian written out
(:func:`relative_reprojection_jacobian`).
"""

from __future__ import annotations

import torch

from covins_tpu_torch.ops import linalg
from covins_tpu_torch.utils import cameras as cam_mod
from covins_tpu_torch.utils import geometry as geo


def six_dof_between_residual(T_w_i, T_w_j, T_ij_meas):
    """6-vector Log(T_ij_meas^-1 * (T_w_i^-1 * T_w_j))."""
    T_ij = geo.pose_compose(geo.pose_inverse(T_w_i), T_w_j)
    return geo.pose_boxminus(T_ij, T_ij_meas)


def sqrt_info_from_covariance(cov, jitter: float = 1e-12):
    """Upper-triangular sqrt-information of a covariance (COVINS-G loop
    edges carry the sampling covariance, `optimization_be.cpp:889-944`)."""
    n = cov.shape[-1]
    info = linalg.inv_psd_small(
        cov + jitter * torch.eye(n, dtype=cov.dtype, device=cov.device))
    return linalg.cholesky_small(info).transpose(-1, -2)


def cauchy_weight(r2, scale: float):
    """IRLS weight sqrt(rho'(r^2)) of the Cauchy loss on PGO loop edges
    (`optimization_be.cpp:905-914`)."""
    return 1.0 / torch.sqrt(1.0 + r2 / (scale * scale))


def relative_measurements(cam1: cam_mod.Camera, cam2: cam_mod.Camera, p1, p2):
    """Each camera's projection of its own point, the measurements of the
    paired residual: (uv1, uv2, valid).  They do not depend on T_12, so a
    solve computes them once."""
    uv1, v1 = cam_mod.project3(cam1, geo.pose_apply(geo.pose_inverse(cam1.T_s_c), p1))
    uv2, v2 = cam_mod.project3(cam2, geo.pose_apply(geo.pose_inverse(cam2.T_s_c), p2))
    return uv1, uv2, v1 & v2


def relative_reprojection_residual(cam1: cam_mod.Camera, cam2: cam_mod.Camera,
                                   T_12, p1, p2):
    """Paired residual of `OptimizeRelativePose`: p2 (KF2 body frame)
    projected into KF1 through T_12, and p1 projected into KF2 through
    T_12^-1, each against the camera's projection of its own point.
    Returns ((N, 4) [r_normal(2), r_inverse(2)], (N,) valid)."""
    return RelativeProblem(cam1, cam2, p1, p2).residual(T_12)


def _hat(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


class RelativeProblem:
    """The paired residual of `OptimizeRelativePose` for fixed matches,
    with everything that does not depend on T_12 computed once: the
    measurements, each camera's extrinsic rotation, and the constant block
    of the Jacobian.  Poses are applied as rotation matrices, where the
    reference rotates by quaternions (the two round differently only in
    the last bits).

    :meth:`residual` returns (r (N, 4), valid (N,)) and, with ``jac``, the
    Jacobian w.r.t. the right tangent xi = [w, v] of T_12 at 0
    (``T_12 (+) xi``, the reference's `pose_boxplus`), written out by the
    chain rule: ``Exp(xi) p = p + w x p + v`` to first order, so
    d(T_12 (+) xi) p2 / d xi = R_12 [-[p2]x | I] and, with q = T_12^-1 p1,
    d((T_12 (+) xi)^-1 p1) / d xi = [[q]x | -I]; then each camera's
    extrinsic rotation and `cameras.project3_jacobian`.  It equals the
    forward-mode AD the reference uses up to rounding, at a small fraction
    of torch.func's cost here (every operation that mixes a dual tensor
    with a constant takes a Python path there).
    """

    def __init__(self, cam1: cam_mod.Camera, cam2: cam_mod.Camera, p1, p2):
        self.cam1, self.cam2, self.p1, self.p2 = cam1, cam2, p1, p2
        inv_c1 = geo.pose_inverse(cam1.T_s_c)
        inv_c2 = geo.pose_inverse(cam2.T_s_c)
        self.Rc1, self.tc1 = geo.quat_to_matrix(inv_c1[:4]), inv_c1[4:7]
        self.Rc2, self.tc2 = geo.quat_to_matrix(inv_c2[:4]), inv_c2[4:7]
        uv1, uv2, self.v12 = relative_measurements(cam1, cam2, p1, p2)
        self.meas = torch.cat([uv1, uv2], dim=-1)
        eye = torch.eye(3, dtype=p1.dtype, device=p1.device).expand(p1.shape[:-1] + (3, 3))
        self.neg_eye = -eye
        self.D2 = torch.cat([-_hat(p2), eye], dim=-1)  # (N, 3, 6)

    def residual(self, T_12, jac: bool = False):
        R12, t12 = geo.quat_to_matrix(T_12[:4]), T_12[4:7]
        A1 = self.Rc1 @ R12  # camera 1 <- KF1 <- KF2
        pc1 = self.p2 @ A1.T + (self.Rc1 @ t12 + self.tc1)
        q = (self.p1 - t12) @ R12  # T_12^-1 p1
        pc2 = q @ self.Rc2.T + self.tc2
        if not jac:
            uv1, v3 = cam_mod.project3(self.cam1, pc1)
            uv2, v4 = cam_mod.project3(self.cam2, pc2)
            return torch.cat([uv1, uv2], dim=-1) - self.meas, self.v12 & v3 & v4
        uv1, v3, P1 = cam_mod.project3_jacobian(self.cam1, pc1)
        uv2, v4, P2 = cam_mod.project3_jacobian(self.cam2, pc2)
        r = torch.cat([uv1, uv2], dim=-1) - self.meas
        d2 = self.Rc2 @ torch.cat([_hat(q), self.neg_eye], dim=-1)
        J = torch.cat([P1 @ (A1 @ self.D2), P2 @ d2], dim=-2)  # (N, 4, 6)
        return r, self.v12 & v3 & v4, J
