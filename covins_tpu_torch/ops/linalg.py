"""Small batched linear algebra, written out as the reference writes it.

Counterpart of the helpers of `covins_tpu/ops/linalg.py` that the
place-recognition path calls: the closed-form 3x3 inverse, the unrolled
Cholesky with its two triangular solves (6x6 normal equations of the
relative-pose and pose-graph solves), and the cyclic Jacobi
eigensolver of Horn's alignment.  The port keeps the reference's
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


def cholesky_small(A, eps: float = 1e-18):
    """Lower Cholesky factor of small batched SPD matrices, unrolled over
    the columns (each pivot clamped to ``eps`` as the reference does); the
    trailing block is updated once per column."""
    n = A.shape[-1]
    W = A.clone()
    L = torch.zeros_like(A)
    for j in range(n):
        ljj = torch.sqrt(torch.clamp(W[..., j, j], min=eps))
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
