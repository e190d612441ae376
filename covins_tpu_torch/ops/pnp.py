"""Absolute pose: batched P3P and fixed-iteration RANSAC.

Counterpart of the central-camera part of `covins_tpu/ops/pnp.py`
(`p3p_grunert`, `reprojection_angular_error`, `absolute_pose_ransac`), the
`Se3Solver::projectiveAlignment` role of stage 2 of the COVINS loop
verification (`Se3Solver.cpp:59-110`).  All hypotheses are solved at once
as batched float64 torch (Grunert's quartic, Newton polish, Horn
alignment); scoring every candidate pose against every correspondence,
counting inliers and taking the first best runs in one CUDA kernel on the
card (K6, `csrc/p3p_score.cu`), behind :func:`p3p_score`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, is_cpu
from covins_tpu_torch.ops import linalg
from covins_tpu_torch.ops import polynomial as poly
from covins_tpu_torch.ops import ransac
from covins_tpu_torch.utils import geometry as geo


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def p3p_grunert(points_w, bearings):
    """Central P3P (Grunert / Haralick et al. 1994), batched.

    points_w: (..., 3, 3) world points; bearings: (..., 3, 3) unit camera
    bearings.  Returns (T_c_w (..., 4, 7), valid (..., 4)), up to four
    camera-from-world poses per triple.
    """
    P1, P2, P3 = points_w[..., 0, :], points_w[..., 1, :], points_w[..., 2, :]
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]

    a2 = torch.sum((P2 - P3) ** 2, dim=-1)
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)
    ca = torch.clamp(_dot(f2, f3), -1.0, 1.0)
    cb = torch.clamp(_dot(f1, f3), -1.0, 1.0)
    cg = torch.clamp(_dot(f1, f2), -1.0, 1.0)

    eps = 1e-12
    b2e = torch.clamp(b2, min=eps)
    q = (a2 - c2) / b2e
    p = (a2 + c2) / b2e

    A4 = (q - 1.0) ** 2 - 4.0 * c2 / b2e * ca * ca
    A3 = 4.0 * (q * (1.0 - q) * cb - (1.0 - p) * ca * cg + 2.0 * c2 / b2e * ca * ca * cb)
    A2 = 2.0 * (q * q - 1.0 + 2.0 * q * q * cb * cb + 2.0 * (b2 - c2) / b2e * ca * ca
                - 4.0 * p * ca * cb * cg + 2.0 * (b2 - a2) / b2e * cg * cg)
    A1 = 4.0 * (-q * (1.0 + q) * cb + 2.0 * a2 / b2e * cg * cg * cb - (1.0 - p) * ca * cg)
    A0 = (1.0 + q) ** 2 - 4.0 * a2 / b2e * cg * cg

    roots, is_real = poly.solve_quartic(A4, A3, A2, A1, A0)
    coeffs = torch.stack([A4, A3, A2, A1, A0], dim=-1)
    v = poly.polish_real_roots(coeffs, roots)  # (..., 4)

    cb_, ca_, cg_, b2_, a2_, c2_, b2e_ = (x[..., None] for x in
                                          (cb, ca, cg, b2, a2, c2, b2e))
    denom1 = 1.0 + v * v - 2.0 * v * cb_
    s1 = torch.sqrt(b2_ / torch.clamp(denom1, min=eps))
    s3 = v * s1
    den_u = 2.0 * (v * ca_ - cg_)
    num_u = v * v - 1.0 - (a2_ - c2_) * denom1 / b2e_
    u = num_u / torch.where(torch.abs(den_u) < 1e-12, 1e-12, den_u)
    s2 = u * s1

    valid = (is_real & (s1 > 0) & (s2 > 0) & (s3 > 0)
             & (denom1 > eps) & (torch.abs(den_u) > 1e-12))

    # camera-frame triangles of the four roots, then rigid alignment
    Xc = torch.stack([s1[..., None] * f1[..., None, :],
                      s2[..., None] * f2[..., None, :],
                      s3[..., None] * f3[..., None, :]], dim=-2)  # (..., 4, 3, 3)
    src = points_w[..., None, :, :].expand(Xc.shape)
    T = geo.umeyama_alignment(src, Xc, with_scale=False)[..., :7]
    return T, valid


def reprojection_angular_error(T_c_w, points_w, bearings):
    """Angular error (radians) between predicted and observed bearings,
    pi where the point sits at the camera centre.  T_c_w: (..., 7);
    points_w, bearings: (N, 3).  Returns (..., N).

    The quaternion rotation and the norm are written out as separate
    operations in K6's order, so the card's plain run and its kernel round
    alike."""
    w, x, y, z = (T_c_w[..., i:i + 1] for i in range(4))
    v0, v1, v2 = points_w[:, 0], points_w[:, 1], points_w[:, 2]
    uv0 = y * v2 - z * v1
    uv1 = z * v0 - x * v2
    uv2 = x * v1 - y * v0
    c0 = y * uv2 - z * uv1
    c1 = z * uv0 - x * uv2
    c2 = x * uv1 - y * uv0
    p0 = (v0 + 2.0 * (w * uv0 + c0)) + T_c_w[..., 4:5]
    p1 = (v1 + 2.0 * (w * uv1 + c1)) + T_c_w[..., 5:6]
    p2 = (v2 + 2.0 * (w * uv2 + c2)) + T_c_w[..., 6:7]
    nrm = linalg.sqrt_rn((p0 * p0 + p1 * p1) + p2 * p2)
    den = torch.clamp(nrm, min=1e-12)
    cosang = ((p0 / den) * bearings[:, 0] + (p1 / den) * bearings[:, 1]) \
        + (p2 / den) * bearings[:, 2]
    return torch.where(nrm > 1e-9, torch.arccos(torch.clamp(cosang, -1.0, 1.0)),
                       math.pi)


# ------------------------------------------------------------------- K6
def p3p_score_plain(T, points_w, bearings, mask, valid, thr: float):
    """Plain version of :func:`p3p_score` (any device).  Only valid
    correspondences can be inliers, so the (H, N) test runs over those
    columns alone."""
    cols = torch.nonzero(mask).flatten()
    inl_c = reprojection_angular_error(T, points_w[cols], bearings[cols]) < thr
    counts = torch.where(valid, inl_c.sum(dim=-1, dtype=torch.int32), -1)
    best = torch.argmax(counts)
    inl = torch.zeros(points_w.shape[0], dtype=torch.bool, device=T.device)
    inl[cols] = inl_c[best]
    return (counts.to(torch.int32), best, inl,
            torch.clamp(counts[best], min=0).to(torch.int32))


def p3p_score(T: torch.Tensor, points_w: torch.Tensor, bearings: torch.Tensor,
              mask: torch.Tensor, valid: torch.Tensor, thr: float):
    """Score every candidate pose ``T`` (H, 7) float64 against the (N, 3)
    correspondences: inliers are valid correspondences with angular
    error < ``thr``; invalid poses count -1.  Returns ``(counts (H,)
    int32, best () int64 — the first maximum, inliers (N,) bool of the
    best pose, n_inliers () int32 = max(count, 0))``.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (K6) or raise."""
    ts = (T, points_w, bearings, mask, valid)
    if all(is_cpu(t) for t in ts):
        return p3p_score_plain(T, points_w, bearings, mask, valid, thr)
    dev = check_cuda("p3p_score", *ts)
    h, n = T.shape[0], points_w.shape[0]
    for name, t, shape, dtype in (
            ("T", T, (h, 7), torch.float64),
            ("points_w", points_w, (n, 3), torch.float64),
            ("bearings", bearings, (n, 3), torch.float64),
            ("mask", mask, (n,), torch.bool), ("valid", valid, (h,), torch.bool)):
        if t.shape != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"p3p_score: {name} must be a contiguous {shape} "
                             f"{dtype} tensor, got {tuple(t.shape)} {t.dtype}")
    if h == 0:
        raise ValueError("p3p_score: no hypotheses")
    counts = torch.empty(h, dtype=torch.int32, device=dev)
    best = torch.empty(1, dtype=torch.int64, device=dev)
    inliers = torch.empty(n, dtype=torch.bool, device=dev)
    n_inl = torch.empty(1, dtype=torch.int32, device=dev)
    lib = cuda_build.library("p3p_score")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_p3p_score(
            T.data_ptr(), points_w.data_ptr(), bearings.data_ptr(),
            mask.data_ptr(), valid.data_ptr(), h, n, float(thr),
            counts.data_ptr(), best.data_ptr(), inliers.data_ptr(),
            n_inl.data_ptr(), stream)
    cuda_build.check(rc, "p3p_score")
    p3p_score.launches += 1
    return counts, best[0], inliers, n_inl[0]


p3p_score.launches = 0


def absolute_pose_ransac(points_w, bearings, mask, n_hypotheses: int = 256,
                         threshold_rad: float = 0.006,
                         noise: Optional[torch.Tensor] = None,
                         idx: Optional[torch.Tensor] = None):
    """Fixed-iteration P3P RANSAC (`Se3Solver::projectiveAlignment`).

    points_w: (N, 3) landmark positions; bearings: (N, 3) unit bearings of
    the observing camera; mask: (N,) valid correspondences.  The minimal
    sets are the top three of each row of ``noise`` (n_hypotheses, N)
    Gumbel noise under the mask (:func:`ransac.sample_minimal_sets`), or
    the (n_hypotheses, 3) index sets ``idx`` given directly.

    Returns dict with ``T_c_w`` (7,), ``inliers`` (N,) bool, ``n_inliers``.
    """
    if idx is None:
        if noise is None:
            raise ValueError("absolute_pose_ransac: pass noise or idx")
        idx = ransac.sample_minimal_sets(noise[:n_hypotheses], mask, 3)
    T, valid = p3p_grunert(points_w[idx], bearings[idx])  # (H, 4, 7), (H, 4)
    T = T.reshape(-1, 7).contiguous()
    valid = valid.reshape(-1).contiguous()
    _, best, inliers, n_inl = p3p_score(T, points_w.contiguous(),
                                        bearings.contiguous(), mask.contiguous(),
                                        valid, threshold_rad)
    return {"T_c_w": T[best], "inliers": inliers, "n_inliers": n_inl}
