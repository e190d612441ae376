"""Absolute pose: batched P3P and fixed-iteration RANSAC.

Counterpart of `covins_tpu/ops/pnp.py`: the central P3P
(`p3p_grunert`, `reprojection_angular_error`, `absolute_pose_ransac`), the
`Se3Solver::projectiveAlignment` role of stage 2 of the COVINS loop
verification (`Se3Solver.cpp:59-110`), and the generalized (multi-camera)
P3P with its RANSAC (`gp3p_kneip`, `generalized_absolute_pose_ransac`,
plain PyTorch: no path of the port calls them yet).  On the card the whole RANSAC is
one kernel launch (K6, `csrc/p3p_ransac.cu`): the minimal sets, every
hypothesis's Grunert quartic, Newton polish and Horn alignment, the
scoring of every pose against every correspondence, the first best pose
and its inliers.  Its plain version, :func:`absolute_pose_ransac_plain`,
solves all hypotheses at once as batched float64 torch and scores them;
every sum of it that the kernel repeats is written out in one order, so
that the card's plain run and the kernel round alike.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, check_tensor, is_cpu
from covins_tpu_torch.ops import linalg
from covins_tpu_torch.ops import polynomial as poly
from covins_tpu_torch.ops import ransac
from covins_tpu_torch.utils import geometry as geo


_dot = linalg.dot3

def p3p_grunert(points_w, bearings):
    """Central P3P (Grunert / Haralick et al. 1994), batched.

    points_w: (..., 3, 3) world points; bearings: (..., 3, 3) unit camera
    bearings.  Returns (T_c_w (..., 4, 7), valid (..., 4)), up to four
    camera-from-world poses per triple.
    """
    P1, P2, P3 = points_w[..., 0, :], points_w[..., 1, :], points_w[..., 2, :]
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]

    a2 = _dot(P2 - P3, P2 - P3)
    b2 = _dot(P1 - P3, P1 - P3)
    c2 = _dot(P1 - P2, P1 - P2)
    ca = torch.clamp(_dot(f2, f3), -1.0, 1.0)
    cb = torch.clamp(_dot(f1, f3), -1.0, 1.0)
    cg = torch.clamp(_dot(f1, f2), -1.0, 1.0)

    eps = 1e-12
    b2e = torch.clamp(b2, min=eps)
    q = (a2 - c2) / b2e
    p = (a2 + c2) / b2e

    A4 = (q - 1.0) * (q - 1.0) - 4.0 * c2 / b2e * ca * ca
    A3 = 4.0 * (q * (1.0 - q) * cb - (1.0 - p) * ca * cg + 2.0 * c2 / b2e * ca * ca * cb)
    A2 = 2.0 * (q * q - 1.0 + 2.0 * q * q * cb * cb + 2.0 * (b2 - c2) / b2e * ca * ca
                - 4.0 * p * ca * cb * cg + 2.0 * (b2 - a2) / b2e * cg * cg)
    A1 = 4.0 * (-q * (1.0 + q) * cb + 2.0 * a2 / b2e * cg * cg * cb - (1.0 - p) * ca * cg)
    A0 = (1.0 + q) * (1.0 + q) - 4.0 * a2 / b2e * cg * cg

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


def _padd(a, b):
    """Sum of two lowest-first coefficient vectors (..., n) of different
    lengths."""
    n = max(a.shape[-1], b.shape[-1])
    pad = lambda x: torch.nn.functional.pad(x, (0, n - x.shape[-1]))  # noqa: E731
    return pad(a) + pad(b)


def gp3p_kneip(points_w, origins, bearings):
    """Generalized (non-central) P3P: three rays with distinct origins.

    points_w, origins, bearings: (..., 3, 3).  Returns ``(T_rig_w (..., 8,
    7), valid (..., 8))``, up to 8 poses (the Bezout bound of the three
    pairwise-distance quadrics), as the reference solves it: eliminate
    lambda_1 and lambda_2 by products over conjugate roots (univariate and
    bivariate polynomial arithmetic in lambda_3), real roots by
    `polynomial.solve_poly_real`, lambda_1/2 back from the quadratics
    (the branch pair that best satisfies the third constraint), Horn
    alignment of each rig-frame triangle."""
    conv = poly.convolve
    P0, P1, P2 = points_w[..., 0, :], points_w[..., 1, :], points_w[..., 2, :]
    d2 = torch.stack([_dot(P0 - P1, P0 - P1), _dot(P0 - P2, P0 - P2),
                      _dot(P1 - P2, P1 - P2)], dim=-1)
    # normalise the metric scale so the lambdas are O(1) for the root finder
    scale = torch.sqrt(torch.clamp(torch.amax(d2, dim=-1), min=1e-24))
    v = origins / scale[..., None, None]
    d2 = d2 / (scale * scale)[..., None]
    f = bearings
    w13, w23, w12 = v[..., 0, :] - v[..., 2, :], v[..., 1, :] - v[..., 2, :], \
        v[..., 0, :] - v[..., 1, :]
    c13, c23, c12 = _dot(f[..., 0, :], f[..., 2, :]), _dot(f[..., 1, :], f[..., 2, :]), \
        _dot(f[..., 0, :], f[..., 1, :])
    one, zero = torch.ones_like(c13), torch.zeros_like(c13)
    # E13: lam1^2 + 2 b1(lam3) lam1 + c1(lam3) = 0 (coefficients lowest first)
    b1 = torch.stack([_dot(f[..., 0, :], w13), -c13], dim=-1)
    c1 = torch.stack([_dot(w13, w13) - d2[..., 1], -2.0 * _dot(f[..., 2, :], w13), one], -1)
    b2 = torch.stack([_dot(f[..., 1, :], w23), -c23], dim=-1)
    c2 = torch.stack([_dot(w23, w23) - d2[..., 2], -2.0 * _dot(f[..., 2, :], w23), one], -1)
    k12 = _dot(w12, w12) - d2[..., 0]
    # E12(l1) == 2 (beta - b1) l1 + (gamma - c1) (mod E13); the product over
    # E13's two roots is a bivariate R1[lam2 degree, lam3 degree]
    bmb = torch.stack([-b1 + torch.stack([_dot(f[..., 0, :], w12), zero], -1),
                       torch.stack([-c12, zero], -1)], dim=-2)  # (..., 2, 2)
    gmc = torch.stack([-c1 + torch.stack([k12, zero, zero], -1),
                       torch.stack([-2.0 * _dot(f[..., 1, :], w12), zero, zero], -1),
                       torch.stack([one, zero, zero], -1)], dim=-2)  # (..., 3, 3)
    t1 = 4.0 * conv(conv(bmb, bmb, 2), c1[..., None, :], 2)
    t2 = -4.0 * conv(conv(b1[..., None, :], bmb, 2), gmc, 2)
    t3 = conv(gmc, gmc, 2)
    H = max(t.shape[-2] for t in (t1, t2, t3))
    W = max(t.shape[-1] for t in (t1, t2, t3))

    def pad2(M):
        return torch.nn.functional.pad(M, (0, W - M.shape[-1], 0, H - M.shape[-2]))

    R1 = pad2(t1) + pad2(t2) + pad2(t3)
    # reduce R1 modulo E23 (lam2^2 = -2 b2 lam2 - c2): lam2^k == u_k lam2
    # + w_k, then R1 == p lam2 + q
    u_k = [zero[..., None], one[..., None]]
    w_k = [one[..., None], zero[..., None]]
    for _ in range(2, H):
        u_k, w_k = (u_k + [_padd(w_k[-1], -2.0 * conv(b2, u_k[-1]))],
                    w_k + [-conv(c2, u_k[-1])])
    p = q = zero[..., None]
    for k in range(H):
        p = _padd(p, conv(R1[..., k, :], u_k[k]))
        q = _padd(q, conv(R1[..., k, :], w_k[k]))
    # the product over E23's two roots: the univariate resultant in lam3,
    # true degree 8 (higher entries are cancellation noise)
    F = _padd(_padd(conv(conv(p, p), c2), -2.0 * conv(conv(b2, p), q)), conv(q, q))
    F = F[..., :9]
    lam3, ok = poly.solve_poly_real(F.flip(-1))  # (..., 8)

    db1 = b1[..., 0:1] + b1[..., 1:2] * lam3
    dc1 = c1[..., 0:1] + c1[..., 1:2] * lam3 + c1[..., 2:3] * lam3 * lam3
    db2 = b2[..., 0:1] + b2[..., 1:2] * lam3
    dc2 = c2[..., 0:1] + c2[..., 1:2] * lam3 + c2[..., 2:3] * lam3 * lam3
    s1 = torch.sqrt(torch.clamp(db1 * db1 - dc1, min=0.0))
    s2 = torch.sqrt(torch.clamp(db2 * db2 - dc2, min=0.0))
    l1s = torch.stack([-db1 + s1, -db1 - s1], dim=-1)  # (..., 8, 2)
    l2s = torch.stack([-db2 + s2, -db2 - s2], dim=-1)
    v0, v1 = v[..., None, None, None, 0, :], v[..., None, None, None, 1, :]
    f0, f1 = f[..., None, None, None, 0, :], f[..., None, None, None, 1, :]
    x1 = v0 + l1s[..., :, None, None] * f0  # (..., 8, 2, 1, 3)
    x2 = v1 + l2s[..., None, :, None] * f1  # (..., 8, 1, 2, 3)
    dx = x1 - x2
    r = torch.abs(torch.sum(dx * dx, dim=-1) - d2[..., None, None, None, 0])  # (..., 8, 2, 2)
    flat = torch.argmin(r.reshape(r.shape[:-2] + (4,)), dim=-1)
    l1 = torch.gather(l1s, -1, (flat // 2)[..., None])[..., 0]
    l2 = torch.gather(l2s, -1, (flat % 2)[..., None])[..., 0]
    resid = torch.gather(r.reshape(r.shape[:-2] + (4,)), -1, flat[..., None])[..., 0]
    good = (ok & (resid < 1e-4) & (l1 > 0) & (l2 > 0) & (lam3 > 0)
            & (db1 * db1 - dc1 >= -1e-9) & (db2 * db2 - dc2 >= -1e-9))
    lam = torch.stack([l1, l2, lam3], dim=-1)  # (..., 8, 3)
    X = v[..., None, :, :] + lam[..., :, None] * f[..., None, :, :]  # (..., 8, 3, 3)
    src = points_w[..., None, :, :].expand(X.shape)
    T = geo.umeyama_alignment(src, X * scale[..., None, None, None], with_scale=False)
    return T[..., :7], good


def generalized_reprojection_angular_error(T_rig_w, points_w, origins, bearings):
    """Angle between each non-central ray and the direction from its
    origin to its world point mapped into the rig frame, pi where the two
    coincide.  T_rig_w: (..., 7); points_w, origins, bearings: (N, 3).
    Returns (..., N)."""
    p_r = geo.pose_apply(T_rig_w[..., None, :], points_w)
    d = p_r - origins
    n = torch.linalg.vector_norm(d, dim=-1)
    pred = d / torch.clamp(n, min=1e-12)[..., None]
    cosang = torch.clamp(torch.sum(pred * bearings, dim=-1), -1.0, 1.0)
    return torch.where(n > 1e-9, torch.arccos(cosang), math.pi)


def generalized_absolute_pose_ransac(points_w, origins, bearings, mask,
                                     n_hypotheses: int = 256,
                                     threshold_rad: float = 0.006,
                                     noise: Optional[torch.Tensor] = None,
                                     idx: Optional[torch.Tensor] = None):
    """GP3P RANSAC over a non-central rig (the OpenGV GP3P role of
    `Se3Solver.cpp:59-110`): :func:`absolute_pose_ransac`'s contract with
    per-ray ``origins``; minimal sets from ``noise`` (>= H, N) or ``idx``
    (H, 3).  Returns ``T_rig_w`` (7,), ``inliers`` (N,), ``n_inliers``."""
    if idx is None:
        idx = ransac.sample_minimal_sets(noise[:n_hypotheses], mask, 3)
    T, valid = gp3p_kneip(points_w[idx], origins[idx], bearings[idx])  # (H, 8, ...)
    T, valid = T.reshape(-1, 7), valid.reshape(-1)
    err = generalized_reprojection_angular_error(T, points_w, origins, bearings)
    inl = (err < threshold_rad) & mask[None, :]
    counts = torch.where(valid, inl.sum(dim=-1), -1)
    best = torch.argmax(counts)
    return {"T_rig_w": T[best], "inliers": inl[best],
            "n_inliers": torch.clamp(counts[best], min=0)}


def px_threshold_to_angular(threshold_px, focal):
    """A pixel threshold as the angle it subtends: atan2(px, focal)
    (`RelNonCentralPosSolver.cpp:49`)."""
    f64 = torch.float64
    return torch.atan2(torch.as_tensor(threshold_px, dtype=f64),
                       torch.as_tensor(focal, dtype=f64))


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
    """Score every candidate pose ``T`` (H, 7) against the (N, 3)
    correspondences: inliers are valid correspondences with angular error
    < ``thr``; invalid poses count -1.  Returns ``(counts (H,) int32, best
    () int32 (the first maximum), inliers (N,) bool of the best pose,
    n_inliers () int32 = max(count, 0))``.  Only valid correspondences can
    be inliers, so the (H, N) test runs over those columns alone."""
    cols = torch.nonzero(mask).flatten()
    inl_c = reprojection_angular_error(T, points_w[cols], bearings[cols]) < thr
    counts = torch.where(valid, inl_c.sum(dim=-1, dtype=torch.int32), -1)
    best = torch.argmax(counts)
    inl = torch.zeros(points_w.shape[0], dtype=torch.bool, device=T.device)
    inl[cols] = inl_c[best]
    return (counts.to(torch.int32), best.to(torch.int32), inl,
            torch.clamp(counts[best], min=0).to(torch.int32))


def _correspondences(points_w, mask, rows):
    """The (N, 3) points and (N,) validity of the correspondences: with
    stage 1's ``rows`` (N,) the points are ``points_w[clamp(rows)]`` and a
    correspondence is valid where ``mask`` and ``rows >= 0``."""
    if rows is None:
        return points_w, mask
    c = points_w.shape[0]
    return points_w[torch.clamp(rows, 0, c - 1).long()], mask & (rows >= 0)


def absolute_pose_ransac_plain(points_w, bearings, mask, n_hypotheses: int = 256,
                               threshold_rad: float = 0.006,
                               noise: Optional[torch.Tensor] = None,
                               idx: Optional[torch.Tensor] = None,
                               rows: Optional[torch.Tensor] = None):
    """Plain version of :func:`absolute_pose_ransac` (any device): the
    batched solves of every hypothesis, then the scoring."""
    points, valid_c = _correspondences(points_w, mask, rows)
    if idx is None:
        if noise is None:
            raise ValueError("absolute_pose_ransac: pass noise or idx")
        idx = ransac.sample_minimal_sets(noise[:n_hypotheses], valid_c, 3)
    T, valid = p3p_grunert(points[idx], bearings[idx])  # (H, 4, 7), (H, 4)
    T, valid = T.reshape(-1, 7), valid.reshape(-1)
    counts, best, inliers, n_inl = p3p_score_plain(T, points, bearings, valid_c, valid,
                                                   threshold_rad)
    return {"T_c_w": T[best], "inliers": inliers, "n_inliers": n_inl,
            "counts": counts, "best": best, "poses": T}


def _checked(*a):
    return check_tensor("absolute_pose_ransac", *a)


def absolute_pose_ransac(points_w, bearings, mask, n_hypotheses: int = 256,
                         threshold_rad: float = 0.006,
                         noise: Optional[torch.Tensor] = None,
                         idx: Optional[torch.Tensor] = None,
                         rows: Optional[torch.Tensor] = None):
    """Fixed-iteration P3P RANSAC (`Se3Solver::projectiveAlignment`).

    points_w: (N, 3) landmark positions; bearings: (N, 3) unit bearings of
    the observing camera; mask: (N,) valid correspondences.  With stage 1's
    matches ``rows`` (N,) int32 (-1 = none), ``points_w`` is the (C, 3)
    table they index: correspondence n is ``points_w[clamp(rows[n])]``,
    valid where ``mask`` and ``rows >= 0``.  The minimal sets are the top
    three of each row of ``noise`` (n_hypotheses, N) Gumbel noise under the
    validity (:func:`ransac.sample_minimal_sets`), or the (H, 3) index sets
    ``idx`` given directly (indices in [0, N); the kernel clamps one
    outside, where the plain version's indexing raises).

    Returns dict with ``T_c_w`` (7,), ``inliers`` (N,) bool, ``n_inliers``,
    every root's pose ``poses`` (4H, 7) and ``counts`` (4H,) int32 (-1 for
    an invalid root), and the ``best`` pose's index.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (K6: the whole function,
    one cooperative launch) or raise.
    """
    ts = (points_w, bearings, mask, noise, idx, rows)
    if all(t is None or is_cpu(t) for t in ts):
        return absolute_pose_ransac_plain(points_w, bearings, mask, n_hypotheses,
                                          threshold_rad, noise, idx, rows)
    dev = check_cuda("absolute_pose_ransac", *ts)
    n, c = bearings.shape[0], points_w.shape[0]
    f64 = torch.float64
    ptrs = [_checked(*a) for a in (("points_w", points_w, (n if rows is None else c, 3), f64),
                                   ("bearings", bearings, (n, 3), f64),
                                   ("mask", mask, (n,), torch.bool))]
    rows_p = 0 if rows is None else _checked("rows", rows, (n,), torch.int32)
    if idx is not None:
        h = idx.shape[0]
        sets_p, noise_p = _checked("idx", idx, (h, 3), torch.int64), 0
    elif noise is not None:
        h = min(n_hypotheses, noise.shape[0])
        noise_p = _checked("noise", noise, (noise.shape[0], n), f64)
        sets_p = 0
        if n < 3:
            raise ValueError("absolute_pose_ransac: fewer than 3 correspondences")
    else:
        raise ValueError("absolute_pose_ransac: pass noise or idx")
    if h == 0 or c == 0:
        raise ValueError("absolute_pose_ransac: no hypotheses or no points")
    # outputs and scratch: T (7,); every root's pose (4H, 7); counts (4H,),
    # n_inliers, best, then the 64-bit best key; inliers (N,), then the
    # roots' validity (4H,)
    T = torch.empty(7, dtype=f64, device=dev)
    poses = torch.empty((4 * h, 7), dtype=f64, device=dev)
    i = torch.empty(4 * h + 4, dtype=torch.int32, device=dev)
    b = torch.empty(n + 4 * h, dtype=torch.bool, device=dev)
    lib = cuda_build.library("p3p_ransac")
    with torch.cuda.device(dev):
        rc = lib.covins_p3p_ransac(
            ptrs[0], c, rows_p, ptrs[2], ptrs[1], n, noise_p, sets_p, h,
            float(threshold_rad), poses.data_ptr(), b.data_ptr() + n,
            i.data_ptr() + 4 * (4 * h + 2), i.data_ptr(), T.data_ptr(), b.data_ptr(),
            i.data_ptr() + 4 * 4 * h, i.data_ptr() + 4 * (4 * h + 1),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "absolute_pose_ransac")
    absolute_pose_ransac.launches += 1
    return {"T_c_w": T, "inliers": b[:n], "n_inliers": i[4 * h],
            "counts": i[:4 * h], "best": i[4 * h + 1], "poses": poses}


absolute_pose_ransac.launches = 0
