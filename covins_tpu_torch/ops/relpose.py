"""Relative-pose Gauss-Newton refinement (`Optimization::
OptimizeRelativePose`, `optimization_be.cpp:620-831`), stage 4 of the
COVINS loop verification.

Counterpart of `covins_tpu/ops/relpose.py`: one 6-dof right-tangent update
of ``T_12`` per step from the paired residuals of all matches, a Huber
round, outlier pruning at ``th_outlier`` px, then a clean round.  The
(N, 4, 6) Jacobian is written out
(`residuals.RelativeProblem`; the reference takes it with
``jax.jacfwd``, which ``torch.func.jacfwd`` would follow at many times the
cost, since every operation mixing a dual tensor with a constant takes a
Python path there), the 6x6 normal equations go
through the unrolled Cholesky, and a step is kept only where the cost
falls — a ``torch.where`` on device values, so the loop never waits for
the card.
"""

from __future__ import annotations

import torch

from covins_tpu_torch.ops import linalg
from covins_tpu_torch.ops import residuals as res
from covins_tpu_torch.utils import geometry as geo


def _gn_rounds(prob: res.RelativeProblem, T12, w, n_iters, damping,
               huber_delta=0.0):
    """``n_iters`` damped GN steps on the tangent of T12; w (N,) weights."""

    def robust_cost(r, valid):
        rn2 = torch.sum(r * r, dim=-1)
        if huber_delta > 0:
            rn = torch.sqrt(torch.clamp(rn2, min=1e-24))
            rho = torch.where(rn <= huber_delta, rn2,
                              huber_delta * (2.0 * rn - huber_delta))
        else:
            rho = rn2
        return torch.sum(w * valid.to(r.dtype) * rho)

    eye = torch.eye(6, dtype=T12.dtype, device=T12.device)
    T = T12
    for _ in range(n_iters):
        r, valid, J = prob.residual(T, jac=True)
        ww = w * valid.to(T.dtype)
        if huber_delta > 0:
            rn = torch.linalg.vector_norm(r, dim=-1)
            ww = ww * torch.clamp(huber_delta / torch.clamp(rn, min=1e-12),
                                  max=1.0)
        Jw = J * ww[:, None, None]
        H = torch.einsum("nri,nrj->ij", Jw, J)
        b = -torch.einsum("nri,nr->i", Jw, r)
        xi = linalg.solve_psd_small(H + damping * eye, b)
        T_new = geo.pose_boxplus(T, xi)
        r_new, valid_new = prob.residual(T_new)
        T = torch.where(robust_cost(r_new, valid_new) < robust_cost(r, valid),
                        T_new, T)
    return T


def optimize_relative_pose(cam1, cam2, T12_init, p1, p2, mask,
                           th_outlier: float = 4.0, n_iters: int = 8):
    """Refine ``T_12`` from paired 3D-3D correspondences.

    p1: (N, 3) matched landmarks in KF1's body frame, p2: (N, 3) the same
    in KF2's; mask: (N,) valid matches; th_outlier: px pruning threshold.
    Returns (T12 (7,), inliers (N,) bool, n_inliers ()).
    """
    dtype = T12_init.dtype
    prob = res.RelativeProblem(cam1, cam2, p1, p2)
    T1 = _gn_rounds(prob, T12_init, mask.to(dtype), n_iters, damping=1e-6,
                    huber_delta=th_outlier)

    def inliers(T):
        r, valid = prob.residual(T)
        n1 = torch.linalg.vector_norm(r[:, :2], dim=-1)
        n2 = torch.linalg.vector_norm(r[:, 2:], dim=-1)
        return mask & valid & (n1 < th_outlier) & (n2 < th_outlier)

    T2 = _gn_rounds(prob, T1, inliers(T1).to(dtype), n_iters, damping=1e-6)
    inl2 = inliers(T2)
    return T2, inl2, torch.sum(inl2)
