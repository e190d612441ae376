"""Relative pose from bearing correspondences: the central essential
matrix (linear 8-point and Nister's 5-point), the non-central 17-point
solver over the generalized epipolar constraint, their fixed-iteration
RANSACs and the sampling covariance of COVINS-G.

Counterpart of `covins_tpu/ops/epipolar.py` (`RelNonCentralPosSolver.cpp`).
Rays are (origin v, unit direction f) pairs in their rig frame; a central
camera has v = 0.  The minimal solvers are batched PyTorch over every
sample at once, written as the reference writes them (its unrolled
Cholesky, Jacobi eigensolver and bracketing root finder, `ops/linalg.py`,
`ops/polynomial.py`).  The scoring of every RANSAC, the triangulated ray
angular error against the threshold with the inlier counts, the first
best hypothesis and its inlier mask, is :func:`ray_ransac_score`: on the
card one kernel launch (K12, `csrc/relpose_ransac.cu`) for a whole batch
of RANSACs.  The central 5-point RANSAC is whole on the card, sampling,
Nister's solve, decompositions and scoring in one launch of the same
kernel source (:func:`relpose_ransac_5pt`).  The plain versions
(:func:`ray_ransac_score_plain`, :func:`relative_pose_ransac_central_5pt_plain`)
write the kernel's arithmetic as tensor operations, every sum in the
kernel's order.

The central RANSACs take a leading batch dimension (one RANSAC per pair
of keyframes, all scored in one call); the minimal sets are the top k of
each row of Gumbel ``noise`` under the mask (`ops/ransac.py`), or given
``idx``, so tests can hand in the reference's draws.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, check_tensor, is_cpu
from covins_tpu_torch.ops import linalg as la
from covins_tpu_torch.ops import polynomial as poly
from covins_tpu_torch.ops import ransac
from covins_tpu_torch.utils import geometry as geo


# ---------------------------------------------------------------- scoring
def triangulate_midpoint(o1, d1, o2, d2):
    """Midpoint of the common perpendicular of two 3D lines: o*, d* (..., 3)
    origins and unit directions.  Returns (point (..., 3), valid (...,))."""
    w0 = o1 - o2
    a, b, c = la.dot3(d1, d1), la.dot3(d1, d2), la.dot3(d2, d2)
    d, e = la.dot3(d1, w0), la.dot3(d2, w0)
    denom = a * c - b * b
    ok = torch.abs(denom) > 1e-12
    denom_s = torch.where(ok, denom, 1.0)
    s = (b * e - c * d) / denom_s
    t = (a * e - b * d) / denom_s
    X = 0.5 * ((o1 + s[..., None] * d1) + (o2 + t[..., None] * d2))
    return X, ok & (s > 0) & (t > 0)


def _rotate(T, v, translate: bool):
    """quat_rotate(q, v) (+ t), written out in K12's order; T (..., 7)
    broadcast against v (..., 3)."""
    w, x, y, z = T[..., 0:1], T[..., 1:2], T[..., 2:3], T[..., 3:4]
    v0, v1, v2 = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    uv0 = y * v2 - z * v1
    uv1 = z * v0 - x * v2
    uv2 = x * v1 - y * v0
    c0 = y * uv2 - z * uv1
    c1 = z * uv0 - x * uv2
    c2 = x * uv1 - y * uv0
    out = torch.cat([v0 + 2.0 * (w * uv0 + c0), v1 + 2.0 * (w * uv1 + c1),
                     v2 + 2.0 * (w * uv2 + c2)], dim=-1)
    return out + T[..., 4:7] if translate else out


def _angle(origin, direction, X):
    v = X - origin
    n = la.sqrt_rn(la.dot3(v, v))
    cosang = la.dot3(v, direction) / torch.clamp(n, min=1e-12)
    return torch.arccos(torch.clamp(cosang, -1.0, 1.0))


def ray_angular_error(T_a_b, va, fa, vb, fb):
    """Larger angular error (radians) of the two rays against their
    midpoint-triangulated point, pi where the triangulation fails.
    T_a_b: (..., 7); rays (..., N, 3) broadcast against T_a_b[..., None, :].
    Returns (..., N).  NaN poses give NaN (never an inlier)."""
    T = T_a_b[..., None, :]
    ob = _rotate(T, vb, True)
    db = _rotate(T, fb, False)
    va_b, fa_b = torch.broadcast_tensors(va, fa, ob)[:2]
    X, ok = triangulate_midpoint(va_b, fa_b, ob, db)
    err = torch.maximum(_angle(va_b, fa_b, X), _angle(ob, db, X))
    return torch.where(ok, err, math.pi)


def _zeros_if_none(v, like):
    return torch.zeros_like(like) if v is None else v


# rows of the (hypotheses x rays) error block the plain version forms at once
_PLAIN_BLOCK = 1 << 20


def ray_ransac_score_plain(T, va, fa, vb, fb, mask, threshold_rad: float,
                           valid=None, want_inliers: bool = True):
    """Plain version of :func:`ray_ransac_score` (any device): per batch
    the error of every hypothesis on the valid rays only, in blocks of
    hypotheses, then the counts, the first maximum and its inliers
    recomputed."""
    B, H, _ = T.shape
    va, vb = _zeros_if_none(va, fa), _zeros_if_none(vb, fb)
    counts = torch.zeros((B, H), dtype=torch.int32, device=T.device)
    best = torch.zeros(B, dtype=torch.int32, device=T.device)
    inliers = torch.zeros(mask.shape, dtype=torch.bool, device=T.device)
    for b in range(B):
        cols = torch.nonzero(mask[b]).flatten()
        rays = [x[b, cols] for x in (va, fa, vb, fb)]
        step = max(1, _PLAIN_BLOCK // max(len(cols), 1))
        for h0 in range(0, H, step):
            err = ray_angular_error(T[b, h0:h0 + step], *rays)
            counts[b, h0:h0 + step] = (err < threshold_rad).sum(-1, dtype=torch.int32)
        if valid is not None:
            counts[b] = torch.where(valid[b], counts[b], 0)
        if want_inliers:
            best[b] = torch.argmax(counts[b])
            inl = ray_angular_error(T[b, best[b]], *rays) < threshold_rad
            if valid is not None:
                inl = inl & valid[b, best[b]]
            inliers[b, cols] = inl
    return (counts, best, inliers) if want_inliers else (counts, None, None)


def ray_ransac_score(T, va, fa, vb, fb, mask, threshold_rad: float, valid=None,
                     want_inliers: bool = True):
    """Score a batch of RANSACs' hypotheses by :func:`ray_angular_error`.

    T: (B, H, 7) float64 poses T_a_b; va, fa, vb, fb: (B, N, 3) float64
    rays (an origin None means zero: a central camera); mask (B, N) bool;
    valid (B, H) bool or None.  A ray is an inlier of a hypothesis where it
    is masked in, the hypothesis is valid and the error is below
    ``threshold_rad``.  Returns ``(counts (B, H) int32, best (B,) int32 the
    first maximum, inliers (B, N) bool of the best)``, or ``(counts, None,
    None)`` without ``want_inliers``.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (K12, one cooperative launch: work items
    of (batch entry, hypothesis, chunk of masked-in rays), so that a call
    of one hypothesis spreads its rays over the card) or raise.
    """
    ts = (T, va, fa, vb, fb, mask, valid)
    if all(t is None or is_cpu(t) for t in ts):
        return ray_ransac_score_plain(T, va, fa, vb, fb, mask, threshold_rad,
                                      valid, want_inliers)
    dev = check_cuda("ray_ransac_score", *ts)
    B, H = T.shape[:2]
    N = fa.shape[1]
    f64 = torch.float64

    def ptr(what, t, shape, dtype):
        return 0 if t is None else check_tensor("ray_ransac_score", what, t, shape, dtype)

    ptrs = [ptr("T", T, (B, H, 7), f64), ptr("va", va, (B, N, 3), f64),
            ptr("fa", fa, (B, N, 3), f64), ptr("vb", vb, (B, N, 3), f64),
            ptr("fb", fb, (B, N, 3), f64), ptr("mask", mask, (B, N), torch.bool),
            ptr("valid", valid, (B, H), torch.bool)]
    # counts, best, then the kernel's scratch (compacted rays and their number)
    ibuf = torch.empty(B * H + B + B * N + B, dtype=torch.int32, device=dev)
    counts = ibuf[:B * H].view(B, H)
    best = inliers = None
    if want_inliers:
        best = ibuf[B * H:B * H + B]
        inliers = torch.empty((B, N), dtype=torch.bool, device=dev)
    lib = cuda_build.library("relpose_ransac")
    with torch.cuda.device(dev):
        rc = lib.covins_ray_ransac_score(
            *ptrs, B, H, N, float(threshold_rad), counts.data_ptr(),
            0 if best is None else best.data_ptr(),
            0 if inliers is None else inliers.data_ptr(),
            ibuf.data_ptr() + 4 * (B * H + B), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "ray_ransac_score")
    ray_ransac_score.launches += 1
    return counts, best, inliers


ray_ransac_score.launches = 0


# ------------------------------------------------------------ helpers
def _minimal_sets(noise, idx, mask, n_sets: int, k: int):
    if idx is not None:
        return idx
    if noise is None:
        raise ValueError("pass noise or idx")
    return ransac.sample_minimal_sets(noise[..., :n_sets, :], mask, k)


def _take(x, idx):
    """x (B, N, d) rows at idx (B, ...) -> (B, ..., d)."""
    b = torch.arange(x.shape[0], device=x.device).view((-1,) + (1,) * (idx.dim() - 1))
    return x[b, idx]


def _batched(fn):
    """Run a batched RANSAC on unbatched (N, 3) inputs as a batch of one."""
    def run(fa, fb, mask, *args, noise=None, idx=None, **kw):
        if fa.dim() == 3:
            return fn(fa, fb, mask, *args, noise=noise, idx=idx, **kw)
        out = fn(fa[None], fb[None], mask[None], *args,
                 noise=None if noise is None else noise[None],
                 idx=None if idx is None else idx[None], **kw)
        return {k: v[0] for k, v in out.items()}
    run.__doc__ = fn.__doc__
    run.__name__ = fn.__name__
    return run


def _best_of(T, counts, best, inliers):
    b = torch.arange(T.shape[0], device=T.device)
    bl = best.long()
    return {"T_a_b": T[b, bl], "inliers": inliers, "n_inliers": counts[b, bl]}


# ----------------------------------------------------- central 8-point
_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


@lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    """The solvers' constant tensors, made on ``device`` once (a tensor
    copied from the host on every call would make the host wait for the
    card)."""
    return {"W": torch.tensor(_W, dtype=torch.float64, device=device),
            "D": torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64, device=device),
            "monomials": torch.tensor([16 * i + 4 * j + k for (i, j, k) in _NISTER_MONOMIALS],
                                      device=device)}


def essential_8pt(fa, fb, weights=None):
    """Linear essential matrix from (..., N, 3) bearing pairs (N >= 8),
    constraint fa^T E fb = 0, singular values projected to (1, 1, 0)."""
    A = (fa[..., :, :, None] * fb[..., :, None, :]).reshape(fa.shape[:-1] + (9,))
    if weights is not None:
        A = A * weights[..., None]
    x = la.min_eigvec_psd(A.transpose(-1, -2) @ A)
    E = x.reshape(x.shape[:-1] + (3, 3))
    U, _, Vt2 = la.svd3x3(E)
    return (U * _consts(E.device)["D"]) @ Vt2


@_batched
def relative_pose_ransac_central(fa, fb, mask, n_hypotheses: int = 128,
                                 threshold_rad: float = 0.004, noise=None, idx=None):
    """8-point essential RANSAC over central bearings (B, N, 3) with mask
    (B, N): `RelNonCentralPosSolver::computePose` (:343-377).  Minimal sets
    from ``noise`` (B, >= H, N) or ``idx`` (B, H, 8).  Returns ``T_a_b``
    (B, 7) (unit translation), ``inliers`` (B, N), ``n_inliers`` (B,);
    unbatched inputs give unbatched results."""
    idx = _minimal_sets(noise, idx, mask, n_hypotheses, 8)
    T = decompose_essential(essential_8pt(_take(fa, idx), _take(fb, idx)))
    T = T.reshape(T.shape[0], -1, 7).contiguous()
    counts, best, inliers = ray_ransac_score(T, None, fa, None, fb, mask, threshold_rad)
    return _best_of(T, counts, best, inliers)


# ----------------------------------------------------- central 5-point
# Nister's 20-monomial order (PAMI'04 3.2): columns 0..9 are eliminated,
# columns 10..19 = [xz^2, xz, x, yz^2, yz, y, z^3, z^2, z, 1]
_NISTER_MONOMIALS = (
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
)


def _pmul(p, q):
    """Product of trivariate polynomials on dense exponent grids (...,
    dx, dy, dz): the full 3-D convolution, in `polynomial.convolve`'s
    order."""
    return poly.convolve(p, q, 3)


def _conv1(u, v):
    return poly.convolve(u, v, 1)


def _cubic_to_row(p):
    """(..., 4, 4, 4) cubic coefficient grid -> (..., 20) in Nister order."""
    return p.reshape(p.shape[:-3] + (64,))[..., _consts(p.device)["monomials"]]


def _psafe(x, eps=1e-20):
    return torch.where(torch.abs(x) < eps, torch.where(x < 0, -eps, eps), x)


def _gauss_jordan(A):
    """Reduced row echelon over the leading n columns of (..., n, 2n),
    partial pivoting (first largest pivot), n static steps."""
    n = A.shape[-2]
    rows = torch.arange(n, device=A.device).expand(A.shape[:-1])
    for col in range(n):
        piv = col + torch.argmax(torch.abs(A[..., col:, col]), dim=-1)
        perm = rows.clone()
        perm[..., col] = piv
        perm = perm.scatter(-1, piv[..., None], col)
        A = torch.gather(A, -2, perm[..., None].expand(A.shape))
        A = A.clone()
        A[..., col, :] = A[..., col, :] / _psafe(A[..., col, col])[..., None]
        factors = A[..., :, col].clone()
        factors[..., col] = 0.0
        A = A - factors[..., :, None] * A[..., col, None, :]
    return A


def _horner(coeffs, z):
    """coeffs (..., D+1) highest first at z (..., R) -> (..., R, ...)."""
    out = torch.zeros(z.shape + coeffs.shape[-2:-1], dtype=z.dtype, device=z.device)
    for i in range(coeffs.shape[-1]):
        out = out * z[..., None] + coeffs[..., None, :, i]
    return out


# The 5-point path's products, norms and 3x3 SVD with every sum in index
# order (the kernel, `csrc/relpose_ransac.cu`, repeats each operation; a
# library product or norm sums another way on the card)
def _mm(A, B):
    """A (..., n, k) @ B (..., k, m), each entry's k products summed in
    index order."""
    acc = A[..., :, 0:1] * B[..., 0:1, :]
    for k in range(1, A.shape[-1]):
        acc = acc + A[..., :, k:k + 1] * B[..., k:k + 1, :]
    return acc


def _split(x):
    """Veltkamp's split of x into two halves of 26 bits (x = hi + lo)."""
    t = 134217729.0 * x
    hi = t - (t - x)
    return hi, x - hi


def _fma(a, b, c):
    """a * b + c rounded once, as a fused multiply-add rounds it: Dekker's
    exact product p + e = a * b and a two-sum s + t = p + c, then s + (t +
    e), in elementwise operations that round alike on every device (no
    case in 200,000 random draws rounds apart from an exact FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def _gram(A):
    """A^T A of (..., k, n) as the CPU's BLAS product forms it: each entry
    a chain of fused multiply-adds over the k rows in order, from zero.
    The 5-point nullspace basis turns within itself under one ulp of A^T
    A, and which true roots the bracketing finds turns with it; this order
    keeps the basis of the CPU's library product."""
    acc = torch.zeros(A.shape[:-2] + A.shape[-1:] * 2, dtype=A.dtype, device=A.device)
    for k in range(A.shape[-2]):
        acc = _fma(A[..., k, :, None], A[..., k, None, :], acc)
    return acc


def _norm(x):
    """Euclidean norm over the last axis, the squares summed in order."""
    return la.sqrt_rn(poly.sum_seq(x * x))


def _orthogonal_unit(u):
    """`linalg._orthogonal_unit` with :func:`_norm`."""
    c = la.cross3(u, la._unit_axis(u, 0))
    alt = la.cross3(u, la._unit_axis(u, 1))
    c = torch.where(_norm(c)[..., None] < 1e-6, alt, c)
    return c / torch.clamp(_norm(c), min=1e-30)[..., None]


def _svd3x3(A):
    """`linalg.svd3x3`'s (U, Vt) with its products and norms in order."""
    w, V = la.jacobi_eigh(_mm(A.transpose(-1, -2), A))
    w, V = w.flip(-1), V.flip(-1)
    S = la.sqrt_rn(torch.clamp(w, min=0.0))
    AV = _mm(A, V)
    eps = 1e-12 * (1.0 + S[..., :1])
    u0 = AV[..., :, 0]
    n0 = _norm(u0)[..., None]
    u0 = torch.where(n0 > eps, u0 / torch.clamp(n0, min=1e-30), la._unit_axis(u0, 0))
    u1 = AV[..., :, 1]
    u1 = u1 - la.dot3(u1, u0)[..., None] * u0
    n1 = _norm(u1)[..., None]
    u1 = torch.where(n1 > eps, u1 / torch.clamp(n1, min=1e-30), _orthogonal_unit(u0))
    u2 = la.cross3(u0, u1)
    d2 = la.dot3(AV[..., :, 2], u2)[..., None]
    u2 = u2 * torch.where(torch.abs(d2) > eps, torch.sign(d2), 1.0)
    return torch.stack([u0, u1, u2], dim=-1), V.transpose(-1, -2)


def _quat_normalize(q):
    """`geometry.quat_normalize` with :func:`_norm`."""
    q = q / torch.clamp(_norm(q), min=1e-12)[..., None]
    return torch.where(q[..., :1] < 0, -q, q)


def _matrix_to_quat(R):
    """`geometry.matrix_to_quat` with its square roots rounded to nearest
    and :func:`_quat_normalize`."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root2(x):
        return la.sqrt_rn(torch.clamp(x, min=1e-24)) * 2.0

    s0 = root2(tr + 1.0)
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = root2(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = root2(1.0 + m11 - m00 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = root2(1.0 + m22 - m00 - m11)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return _quat_normalize(q)


def decompose_essential(E):
    """E (..., 3, 3) -> the 4 candidate T_a_b (R, unit t): (..., 4, 7),
    every sum in a written order (the 5-point kernel repeats it)."""
    U, Vt = _svd3x3(E)
    U = U * torch.sign(la.det33(U))[..., None, None]
    Vt = Vt * torch.sign(la.det33(Vt))[..., None, None]
    W = _consts(E.device)["W"]
    t = U[..., :, 2]
    poses = []
    for R in (_mm(_mm(U, W), Vt), _mm(_mm(U, W.T), Vt)):
        q = _matrix_to_quat(R)
        for s in (1.0, -1.0):
            poses.append(torch.cat([_quat_normalize(q), s * t], dim=-1))
    return torch.stack(poses, dim=-2)


def essential_5pt(fa, fb):
    """Nister 5-point: (..., 5, 3) bearing pairs -> up to 10 essential
    matrices ``(E (..., 10, 3, 3), valid (..., 10))``, one per real root of
    the degree-10 polynomial (built by polynomial arithmetic on dense
    exponent grids, roots by `polynomial.solve_poly_real`).  Every sum in
    one written order, as the kernel repeats it."""
    lead = fa.shape[:-2]
    A = (fa[..., :, :, None] * fb[..., :, None, :]).reshape(lead + (5, 9))
    _, V = la.jacobi_eigh(_gram(A))
    return essential_5pt_from_basis(V[..., :, :4].transpose(-1, -2).reshape(lead + (4, 3, 3)))


def essential_5pt_from_basis(basis):
    """The rest of :func:`essential_5pt` on a nullspace basis (..., 4, 3,
    3) of the five epipolar constraints: E = x E1 + y E2 + z E3 + E4."""
    lead = basis.shape[:-3]
    dtype, dev = basis.dtype, basis.device
    # E(x, y, z) = x E1 + y E2 + z E3 + E4: a (3, 3) grid of linear trivariates
    E_lin = torch.zeros(lead + (3, 3, 2, 2, 2), dtype=dtype, device=dev)
    E_lin[..., 1, 0, 0] = basis[..., 0, :, :]
    E_lin[..., 0, 1, 0] = basis[..., 1, :, :]
    E_lin[..., 0, 0, 1] = basis[..., 2, :, :]
    E_lin[..., 0, 0, 0] = basis[..., 3, :, :]

    def lin(i, j):
        return E_lin[..., i, j, :, :, :]

    def minor(i0, i1, j0, j1):
        return _pmul(lin(i0, j0), lin(i1, j1)) - _pmul(lin(i0, j1), lin(i1, j0))

    det = (_pmul(lin(0, 0), minor(1, 2, 1, 2)) - _pmul(lin(0, 1), minor(1, 2, 0, 2))
           + _pmul(lin(0, 2), minor(1, 2, 0, 1)))
    # trace constraint 2 E E^T E - tr(E E^T) E = 0 (9 cubics)
    EEt = [[_pmul(lin(i, 0), lin(j, 0)) + _pmul(lin(i, 1), lin(j, 1))
            + _pmul(lin(i, 2), lin(j, 2)) for j in range(3)] for i in range(3)]
    tr = EEt[0][0] + EEt[1][1] + EEt[2][2]
    rows = [det]
    for i in range(3):
        for j in range(3):
            cub = (_pmul(EEt[i][0], lin(0, j)) + _pmul(EEt[i][1], lin(1, j))
                   + _pmul(EEt[i][2], lin(2, j)))
            rows.append(2.0 * cub - _pmul(tr, lin(i, j)))
    R = _gauss_jordan(torch.stack([_cubic_to_row(r) for r in rows], dim=-2))

    # rows 4..9 lead with [x^2 z, x^2, y^2 z, y^2, xyz, xy]: row(a) - z
    # row(b) for (4, 5), (6, 7), (8, 9) leaves 3 equations linear in (x, y)
    # with coefficients polynomial in z (highest power first)
    zero = torch.zeros(lead + (1,), dtype=dtype, device=dev)

    def poly_pair(ra, rb, c0, c1):
        a = torch.cat([zero, R[..., ra, c0:c1]], dim=-1)
        b = torch.cat([R[..., rb, c0:c1], zero], dim=-1)
        return -(a - b)

    pairs = ((4, 5), (6, 7), (8, 9))
    Bx = torch.stack([poly_pair(a, b, 10, 13) for a, b in pairs], dim=-2)
    By = torch.stack([poly_pair(a, b, 13, 16) for a, b in pairs], dim=-2)
    Bz = torch.stack([poly_pair(a, b, 16, 20) for a, b in pairs], dim=-2)

    def det2(c1, c2, r0, r1):
        return _conv1(c1[..., r0, :], c2[..., r1, :]) - _conv1(c1[..., r1, :], c2[..., r0, :])

    p10 = (_conv1(Bx[..., 0, :], det2(By, Bz, 1, 2))
           - _conv1(By[..., 0, :], det2(Bx, Bz, 1, 2))
           + _conv1(Bz[..., 0, :], det2(Bx, By, 1, 2)))
    z, valid = poly.solve_poly_real(p10, n_grid=256, bisect_iters=44)

    # back-substitute each root: [Bx(z) By(z)] [x y]^T = -Bz(z), 3x2 lsq
    ax, ay, az = _horner(Bx, z), _horner(By, z), _horner(Bz, z)  # (..., 10, 3)
    Mz = torch.stack([ax, ay], dim=-1)  # (..., 10, 3, 2)
    MzT = Mz.transpose(-1, -2)
    N = _mm(MzT, Mz)
    rhs = -_mm(MzT, az[..., None])[..., 0]
    d = _psafe(N[..., 0, 0] * N[..., 1, 1] - N[..., 0, 1] * N[..., 1, 0])
    x = (rhs[..., 0] * N[..., 1, 1] - rhs[..., 1] * N[..., 0, 1]) / d
    y = (N[..., 0, 0] * rhs[..., 1] - N[..., 1, 0] * rhs[..., 0]) / d
    b = basis[..., None, :, :, :]
    E = (x[..., None, None] * b[..., 0, :, :] + y[..., None, None] * b[..., 1, :, :]
         + z[..., None, None] * b[..., 2, :, :] + b[..., 3, :, :])
    nrm = _norm(E.flatten(-2))
    return E / torch.clamp(nrm, min=1e-30)[..., None, None], valid


def relative_pose_ransac_central_5pt_plain(fa, fb, mask, n_hypotheses: int = 64,
                                           threshold_rad: float = 0.004, noise=None,
                                           idx=None):
    """Plain version of :func:`relpose_ransac_5pt` (any device): the
    minimal sets, :func:`essential_5pt`, :func:`decompose_essential` and
    :func:`ray_ransac_score_plain`."""
    idx = _minimal_sets(noise, idx, mask, n_hypotheses, 5)
    E, valid = essential_5pt(_take(fa, idx), _take(fb, idx))  # (B, H, 10, ...)
    B = fa.shape[0]
    T = decompose_essential(E).reshape(B, -1, 7).contiguous()  # (B, 40 H, 7)
    valid = torch.repeat_interleave(valid.reshape(B, -1), 4, dim=-1)
    counts, best, inliers = ray_ransac_score_plain(T, None, fa, None, fb, mask,
                                                   threshold_rad, valid=valid)
    return {**_best_of(T, counts, best, inliers), "T": T, "valid": valid,
            "counts": counts, "best": best}


def relpose_ransac_5pt(fa, fb, mask, n_hypotheses: int = 64, threshold_rad: float = 0.004,
                       noise=None, idx=None):
    """The whole central 5-point RANSAC of a batch of keyframe pairs:
    central bearings ``fa``, ``fb`` (B, N, 3) float64 with ``mask`` (B, N)
    bool, minimal sets the top 5 of each row of ``noise`` (B, >= H, N)
    float64 over the masked-in rays (largest first, ties to the lowest
    index) or given ``idx`` (B, H, 5) int64; Nister's solve of every
    sample, the 4 decompositions of each of its 10 roots, the scoring of
    the (B, 40 H) poses, the first best and its inliers.  Returns
    ``T_a_b`` (B, 7), ``inliers`` (B, N), ``n_inliers`` (B,) and every
    pose ``T`` (B, 40 H, 7), its validity ``valid``, the ``counts`` and
    ``best``.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (K12, one cooperative launch: a warp a sample, then the scoring)
    or raise."""
    ts = (fa, fb, mask, noise, idx)
    if all(t is None or is_cpu(t) for t in ts):
        return relative_pose_ransac_central_5pt_plain(fa, fb, mask, n_hypotheses,
                                                      threshold_rad, noise, idx)
    dev = check_cuda("relpose_ransac_5pt", *ts)
    B, N = mask.shape
    H = n_hypotheses
    name = "relpose_ransac_5pt"
    if (noise is None) == (idx is None):
        raise ValueError(f"{name}: pass noise or idx")
    if noise is not None and (noise.dim() != 3 or noise.shape[1] < H or N < 5):
        raise ValueError(f"{name}: noise must be (B, >= {H}, N >= 5), got "
                         f"{tuple(noise.shape)}")
    f64 = torch.float64
    ptrs = [check_tensor(name, "fa", fa, (B, N, 3), f64),
            check_tensor(name, "fb", fb, (B, N, 3), f64),
            check_tensor(name, "mask", mask, (B, N), torch.bool),
            0 if noise is None else check_tensor(name, "noise", noise,
                                                 (B, noise.shape[1], N), f64),
            0 if idx is None else check_tensor(name, "idx", idx, (B, H, 5), torch.int64)]
    P = 40 * H
    # outputs and scratch in one buffer per dtype: poses, the best poses;
    # counts, best, n_inliers, compacted ray order, ray counts; validity, inliers
    fbuf = torch.empty(B * P * 7 + B * 7, dtype=f64, device=dev)
    ibuf = torch.empty(B * P + 2 * B + B * N + B, dtype=torch.int32, device=dev)
    bbuf = torch.empty(B * P + B * N, dtype=torch.bool, device=dev)
    lib = cuda_build.library("relpose_ransac")
    with torch.cuda.device(dev):
        rc = lib.covins_relpose_ransac_5pt(
            *ptrs, B, N, 0 if noise is None else noise.shape[1], H, float(threshold_rad),
            fbuf.data_ptr(), ibuf.data_ptr(), bbuf.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, name)
    relpose_ransac_5pt.launches += 1
    T = fbuf[:B * P * 7].view(B, P, 7)
    counts = ibuf[:B * P].view(B, P)
    return {"T_a_b": fbuf[B * P * 7:].view(B, 7), "inliers": bbuf[B * P:].view(B, N),
            "n_inliers": ibuf[B * P + B:B * P + 2 * B], "T": T,
            "valid": bbuf[:B * P].view(B, P), "counts": counts,
            "best": ibuf[B * P:B * P + B]}


relpose_ransac_5pt.launches = 0


@_batched
def relative_pose_ransac_central_5pt(fa, fb, mask, n_hypotheses: int = 64,
                                     threshold_rad: float = 0.004, noise=None,
                                     idx=None):
    """5-point essential RANSAC over central bearings, the reference's
    STEWENIUS prefilter (`RelNonCentralPosSolver.cpp:343-377`): each sample
    gives up to 10 essentials x 4 decompositions, all scored in one batch
    (B, 40 H).  Same arguments and results as
    :func:`relative_pose_ransac_central` (idx (B, H, 5)); on the card one
    launch (:func:`relpose_ransac_5pt`)."""
    out = relpose_ransac_5pt(fa, fb, mask, n_hypotheses, threshold_rad, noise=noise, idx=idx)
    return {k: out[k] for k in ("T_a_b", "inliers", "n_inliers")}


# ------------------------------------------------- non-central 17-point
def _gec_rows(va, fa, vb, fb):
    """Rows of the linear system in [vec(E); vec(R)] (row-major), one per
    correspondence: sum fa_i fb_j E_ij + [fa_i (vb x fb)_j + (va x fa)_i
    fb_j] R_ij."""
    mE = fa[..., :, None] * fb[..., None, :]
    mR = (fa[..., :, None] * la.cross3(vb, fb)[..., None, :]
          + la.cross3(va, fa)[..., :, None] * fb[..., None, :])
    shape = fa.shape[:-1] + (9,)
    return torch.cat([mE.reshape(shape), mR.reshape(shape)], dim=-1)


def _skew_vee(M):
    return 0.5 * torch.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                              M[..., 1, 0] - M[..., 0, 1]], dim=-1)


def gep_17pt(va, fa, vb, fb, weights=None):
    """Linear 17-point non-central relative pose (Li et al. 2008): rays
    (..., N, 3) of rigs a and b (N >= 17) -> T_a_b (..., 7) with metric
    translation."""
    A = _gec_rows(va, fa, vb, fb)
    if weights is not None:
        A = A * weights[..., None]
    x = la.min_eigvec_psd(A.transpose(-1, -2) @ A)  # 18-dim nullspace vector
    Rpart = x[..., 9:].reshape(x.shape[:-1] + (3, 3))
    # fix the nullvector's scale: ||R||_F = sqrt(3), det(R) > 0 (the norm
    # in a fixed order: one ulp of it can turn a degenerate sample's
    # projection to SO(3) by 1e-4, scripts/port_covg_cov_probe.py)
    lam = math.sqrt(3.0) / torch.clamp(la.norm_last(x[..., 9:]), min=1e-12)
    sign = torch.sign(la.det33(Rpart))
    sign = torch.where(sign == 0, 1.0, sign)
    x = x * (lam * sign)[..., None]
    Epart = x[..., :9].reshape(x.shape[:-1] + (3, 3))
    Rpart = x[..., 9:].reshape(x.shape[:-1] + (3, 3))
    U, _, Vt2 = la.svd3x3(Rpart)  # project R to SO(3)
    d = torch.sign(la.det33(U @ Vt2))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (U * D[..., None, :]) @ Vt2
    t = _skew_vee(Epart @ R.transpose(-1, -2))  # E = [t]x R
    return geo.pose_from_qt(geo.matrix_to_quat(R), t)


def _score1(T, va, fa, vb, fb, mask, thr, want_inliers=True):
    """:func:`ray_ransac_score` of one RANSAC's (H, 7) poses on (N, 3) rays."""
    counts, best, inl = ray_ransac_score(T[None], va[None], fa[None], vb[None],
                                         fb[None], mask[None], thr,
                                         want_inliers=want_inliers)
    return (counts[0], best[0], inl[0]) if want_inliers else (counts[0], None, None)


def relative_pose_ransac_noncentral(va, fa, vb, fb, mask, n_hypotheses: int = 64,
                                    threshold_rad: float = 0.004,
                                    refine_top: bool = True, noise=None, idx=None):
    """17-point generalized-epipolar RANSAC (the SEVENTEENPT stage,
    `RelNonCentralPosSolver.cpp:146-176`) over (N, 3) rays with mask (N,),
    then one weighted re-solve on the best hypothesis's inliers, kept when
    it has at least as many.  Minimal sets from ``noise`` (>= H, N) or
    ``idx`` (H, 17).  Returns ``T_a_b`` (7,), ``inliers`` (N,),
    ``n_inliers``; nothing waits for the card."""
    idx = _minimal_sets(noise, idx, mask, n_hypotheses, 17)
    T = gep_17pt(va[idx], fa[idx], vb[idx], fb[idx])  # (H, 7)
    counts, best, inl_best = _score1(T, va, fa, vb, fb, mask, threshold_rad)
    best = best.long().view(1)  # index_select: a 0-d index would sync
    T_best = T.index_select(0, best)[0]
    if refine_top:
        T_ref = gep_17pt(va, fa, vb, fb, weights=inl_best.to(fa.dtype))
        count_r, _, inl_r = _score1(T_ref[None], va, fa, vb, fb, mask, threshold_rad)
        better = count_r[0] >= counts.index_select(0, best)[0]
        T_best = torch.where(better, T_ref, T_best)
        inl_best = torch.where(better, inl_r, inl_best)
    return {"T_a_b": T_best, "inliers": inl_best, "n_inliers": inl_best.sum()}


def sampling_covariance(T_best, va, fa, vb, fb, inliers, n_samples: int = 64,
                        sample_size: int = 17, threshold_rad: float = 0.004,
                        min_inlier_ratio: float = 0.8, noise=None, idx=None):
    """Empirical 6-DoF covariance of the non-central relative pose
    (`RelNonCentralPosSolver.cpp:187-296`): re-solve on random inlier
    subsets, keep the re-solves whose inlier ratio (float32) exceeds
    ``min_inlier_ratio``, covariance of [quat-log rotation, translation]
    deviations.  Returns (cov (6, 6), n_used ())."""
    idx = _minimal_sets(noise, idx, inliers, n_samples, sample_size)
    T = gep_17pt(va[idx], fa[idx], vb[idx], fb[idx])  # (S, 7)
    counts, _, _ = _score1(T, va, fa, vb, fb, inliers, threshold_rad,
                           want_inliers=False)
    f32 = torch.float32
    ratio = counts.to(f32) / torch.clamp(inliers.sum(), min=1).to(f32)
    keep = ratio > min_inlier_ratio  # in float32, as the reference's weak type
    dq = geo.quat_multiply(geo.quat_conjugate(geo.pose_q(T_best))[None], geo.pose_q(T))
    dev = torch.cat([geo.quat_log(dq), geo.pose_t(T) - geo.pose_t(T_best)[None]], dim=-1)
    w = keep.to(dev.dtype)[:, None]
    n_used = keep.sum()
    denom = torch.clamp(n_used - 1, min=1).to(dev.dtype)
    return (w * dev).T @ (w * dev) / denom, n_used
