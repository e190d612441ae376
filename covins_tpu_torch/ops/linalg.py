"""Small batched linear algebra, written out as the reference writes it.

Counterpart of `covins_tpu/ops/linalg.py`: the closed-form 3x3 inverse
and determinant, the unrolled Cholesky with its two triangular solves
(6x6 normal equations of the relative-pose and pose-graph solves), the
cyclic Jacobi eigensolver of Horn's alignment, and what the epipolar
solvers build on it: the nullspace vector by shifted inverse iteration
(:func:`min_eigvec_psd`) and the 3x3 SVD (:func:`svd3x3`).  The port keeps the reference's
algorithms instead of calling LAPACK's factorisations
(`torch.linalg.eigh`, `torch.linalg.cholesky`): eigenvector signs and
rounding would differ, and P3P poses feed inlier counts.  The Cholesky
updates the trailing block once per column and the two substitutions are
`torch.linalg.solve_triangular`: the same arithmetic as the reference's
element-by-element loops, in a few operations instead of hundreds of
tiny ones (sums round in another order).  None of these functions is
differentiated, so they write into their scratch tensors in place.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt_rn(x):
    """Square root rounded to nearest, as IEEE 754 asks and as the card's
    ``sqrt`` and the JAX package's compute it.  PyTorch's vectorised CPU
    ``sqrt`` is not correctly rounded on every host (off by one ulp in
    about one float32 result in five on an AVX512 host), so a CPU tensor
    goes through numpy's ``sqrt``, which is; a CUDA tensor keeps
    ``torch.sqrt``.  Plain versions whose square root feeds an exact
    comparison with a kernel or the reference take it (not differentiable
    on the CPU)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))


def inv33(A):
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    adj = torch.stack([
        torch.stack([A00, A01, A02], -1),
        torch.stack([A10, A11, A12], -1),
        torch.stack([A20, A21, A22], -1),
    ], -2)
    return adj / det[..., None, None]


def cholesky_small(A, eps: float = 1e-18, sqrt=torch.sqrt):
    """Lower Cholesky factor of small batched SPD matrices, unrolled over
    the columns (each pivot clamped to ``eps`` as the reference does); the
    trailing block is updated once per column.  ``sqrt``: the square root
    of the pivots (:func:`sqrt_rn` where the card and the CPU must agree)."""
    n = A.shape[-1]
    W = A.clone()
    L = torch.zeros_like(A)
    for j in range(n):
        ljj = sqrt(torch.clamp(W[..., j, j], min=eps))
        col = W[..., j:, j] / ljj[..., None]
        L[..., j:, j] = col
        if j + 1 < n:
            c = col[..., 1:]
            W[..., j + 1:, j + 1:] -= c[..., :, None] * c[..., None, :]
    return L


def _solve_tril(L, b):
    """L y = b, L lower-triangular, batched (forward substitution)."""
    return torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]


def _solve_triu_t(L, y):
    """L^T x = y, batched (back substitution)."""
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y[..., None],
                                         upper=True)[..., 0]


def solve_psd_small(A, b):
    """Solve A x = b for small symmetric positive-(semi)definite A."""
    L = cholesky_small(A)
    return _solve_triu_t(L, _solve_tril(L, b))


def inv_psd_small(A):
    """Inverse of small batched SPD matrices through one Cholesky factor
    (the reference solves each unit column against the same factor)."""
    n = A.shape[-1]
    L = cholesky_small(A)
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    cols = [_solve_triu_t(L, _solve_tril(L, eye[..., i])) for i in range(n)]
    return torch.stack(cols, dim=-1)


def jacobi_eigh(A, sweeps: int = 8):
    """Batched symmetric eigendecomposition by unrolled cyclic Jacobi.

    A: (..., n, n) symmetric, n small.  Returns ``(eigvals (..., n)
    ascending, eigvecs (..., n, n) columns)``.  The rotations are the
    reference's, element for element; the eigenvector matrix is kept as
    extra rows under A, so one column update rotates both.
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    M = torch.cat([A, eye], dim=-2).clone()  # rows [0, n): A, [n, 2n): V
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app = M[..., p, p]
                aqq = M[..., q, q]
                apq = M[..., p, q]
                small = torch.abs(apq) <= 1e-14 * (torch.abs(app) + torch.abs(aqq))
                phi = 0.5 * torch.atan2(2.0 * apq, aqq - app)
                c = torch.where(small, 1.0, torch.cos(phi))[..., None]
                s = torch.where(small, 0.0, torch.sin(phi))[..., None]
                rp = c * M[..., p, :] - s * M[..., q, :]
                rq = s * M[..., p, :] + c * M[..., q, :]
                M[..., p, :] = rp
                M[..., q, :] = rq
                cp = c * M[..., :, p] - s * M[..., :, q]
                cq = s * M[..., :, p] + c * M[..., :, q]
                M[..., :, p] = cp
                M[..., :, q] = cq
    w = torch.diagonal(M[..., :n, :], dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    V = torch.gather(M[..., n:, :], -1,
                     order[..., None, :].expand(M.shape[:-2] + (n, n)))
    return w, V


class _Factor:
    """The views of a lower Cholesky factor L (..., n, n) that the
    substitutions below take, made once for repeated solves: each
    diagonal entry, the column under it and the row left of it, each
    keeping a trailing axis."""

    def __init__(self, L):
        n = L.shape[-1]
        self.diag = [L[..., j, j:j + 1] for j in range(n)]
        self.below = [L[..., j + 1:, j] for j in range(n)]
        self.left = [L[..., i, :i] for i in range(n)]


def _forward_subst(f: _Factor, b):
    """L y = b by forward substitution, each row's sum over the columns in
    order, elementwise operations only (a library solve sums in another
    order on the card than on the CPU)."""
    ys = []
    r = b
    for j, d in enumerate(f.diag):
        y = r[..., :1] / d
        ys.append(y)
        r = r[..., 1:] - f.below[j] * y
    return torch.cat(ys, dim=-1)


def _back_subst_t(f: _Factor, y):
    """L^T x = y by back substitution, as :func:`_forward_subst`."""
    n = len(f.diag)
    xs = [None] * n
    r = y
    for i in reversed(range(n)):
        xs[i] = r[..., i:] / f.diag[i]
        r = r[..., :i] - f.left[i] * xs[i]
    return torch.cat(xs, dim=-1)


def _sum_last(x):
    """Sum over the last axis in a fixed order (halves added pairwise, an
    odd element carried), the same on every device."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        s = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([s, x[..., 2 * h:]], dim=-1) if x.shape[-1] % 2 else s
    return x[..., 0]


def norm_last(x):
    """Euclidean norm over the last axis: the squares summed in
    :func:`_sum_last`'s order, the root by :func:`sqrt_rn`; the same on
    the card and the CPU, where ``vector_norm`` is not."""
    return sqrt_rn(_sum_last(x * x))


def min_eigvec_psd(M, iters: int = 4):
    """Eigenvector of the smallest eigenvalue of symmetric PSD matrices
    (..., n, n) by shifted inverse iteration through the Cholesky factor
    (nullspace extraction: A^T A with lambda_min ~ 0).  Unit (..., n).
    Every sum in a fixed order and every square root rounded to nearest,
    so the card and the CPU agree bit for bit: the iteration turns a
    rounding difference of library solves into 4e-9 of the vector on a
    17-ray sample (`scripts/port_covg_cov_probe.py`)."""
    n = M.shape[-1]
    tr = _sum_last(torch.diagonal(M, dim1=-2, dim2=-1))
    shift = (1e-10 * tr + 1e-30)[..., None, None]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    f = _Factor(cholesky_small(M + shift * eye, eps=1e-30, sqrt=sqrt_rn))
    x = (torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device)
         + 1e-3 * torch.arange(n, dtype=M.dtype, device=M.device))
    for _ in range(iters):
        x = _back_subst_t(f, _forward_subst(f, x))
        x = x / torch.clamp(norm_last(x), min=1e-30)[..., None]
    return x


def dot3(a, b):
    """Dot product over the last axis of 3, summed in index order (as the
    kernels that repeat it sum)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross3(a, b):
    """Cross product over the last axis of 3, each component's two products
    and their difference as separate operations (a library kernel may fuse
    them into a multiply-add, and then rounds apart on the card and the
    CPU)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _unit_axis(like, k: int):
    """The k-th unit vector, shaped and placed like ``like`` (..., 3)
    (made by fills: writing one element of an unbatched card tensor would
    copy from the host and wait for the card)."""
    one, zero = torch.ones_like(like[..., :1]), torch.zeros_like(like[..., :1])
    return torch.cat([one if i == k else zero for i in range(3)], dim=-1)


def _orthogonal_unit(u):
    """Some unit vector orthogonal to unit vectors u (..., 3)."""
    ex = _unit_axis(u, 0)
    ey = _unit_axis(u, 1)
    c = cross3(u, ex)
    alt = cross3(u, ey)
    n1 = torch.linalg.vector_norm(c, dim=-1, keepdim=True)
    c = torch.where(n1 < 1e-6, alt, c)
    return c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True),
                           min=1e-30)


def svd3x3(A, sweeps: int = 8):
    """Batched 3x3 SVD as the reference builds it: Jacobi on A^T A, the
    left basis from A V completed by cross products.  Returns (U, S
    descending >= 0, Vt); A = U diag(S') Vt with S' = S up to the sign of
    the smallest value when det(A) < 0."""
    w, V = jacobi_eigh(A.transpose(-1, -2) @ A, sweeps=sweeps)
    w = w.flip(-1)  # descending
    V = V.flip(-1)
    S = torch.sqrt(torch.clamp(w, min=0.0))
    AV = A @ V  # columns s_i u_i
    eps = 1e-12 * (1.0 + S[..., :1])
    u0 = AV[..., :, 0]
    e0 = _unit_axis(u0, 0)
    n0 = torch.linalg.vector_norm(u0, dim=-1, keepdim=True)
    u0 = torch.where(n0 > eps, u0 / torch.clamp(n0, min=1e-30), e0)
    u1 = AV[..., :, 1]
    u1 = u1 - torch.sum(u1 * u0, -1, keepdim=True) * u0
    n1 = torch.linalg.vector_norm(u1, dim=-1, keepdim=True)
    u1 = torch.where(n1 > eps, u1 / torch.clamp(n1, min=1e-30), _orthogonal_unit(u0))
    u2 = cross3(u0, u1)
    d2 = torch.sum(AV[..., :, 2] * u2, -1, keepdim=True)
    u2 = u2 * torch.where(torch.abs(d2) > eps, torch.sign(d2), 1.0)
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, S, V.transpose(-1, -2)


def det33(A):
    """Closed-form batched 3x3 determinant."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
