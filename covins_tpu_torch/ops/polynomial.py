"""Batched closed-form polynomial roots in real arithmetic.

Counterpart of `covins_tpu/ops/polynomial.py`: quadratic, cubic, quartic
and the Newton polish the P3P solver uses, and the bracketing real-root
solver of the five-point and generalized P3P solvers
(:func:`solve_poly_real`, batched over leading dims), with the dense
polynomial products they build their polynomials with (:func:`convolve`).  Every formula is the
reference's: both branches of each case split are evaluated and one is
selected, so the results round as the reference's do.  The solvers return
``(roots, is_real)``: real roots with a trailing root axis, and for a
complex-conjugate pair the pair's real part with ``is_real = False``.

The P3P kernel (`csrc/p3p_ransac.cu`) and the 5-point kernel
(`csrc/relpose_ransac.cu`) repeat this arithmetic and are held to it bit
for bit on the card, so every operation here is one that rounds
alike in both: powers are written as products (``x ** 3`` as ``(x * x) *
x``, the JAX package's integer power, where PyTorch would call ``pow``),
and a division by 3 or 27 divides by a device tensor (PyTorch's CUDA
division by a Python number multiplies by its rounded reciprocal).
"""

from __future__ import annotations

import itertools
import math

import torch

_REAL_TOL = 1e-9


def _safe(x, eps=1e-30):
    tiny = torch.where(x < 0, torch.full_like(x, -eps), torch.full_like(x, eps))
    return torch.where(torch.abs(x) < eps, tiny, x)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _const(v, like):
    """``v`` as a 0-d tensor beside ``like``: a true divisor on the card."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _cube(x):
    return (x * x) * x


def solve_quadratic(a, b, c):
    """a x^2 + b x + c = 0 -> (roots (..., 2), is_real (..., 2))."""
    disc = b * b - 4.0 * a * c
    scale = b * b + torch.abs(4.0 * a * c)
    real = disc >= -_REAL_TOL * scale
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    sgn = torch.where(b >= 0, 1.0, -1.0)
    q = -0.5 * (b + sgn * sq)
    r0 = q / _safe(a)
    r1 = c / _safe(q)
    lin = torch.abs(a) < 1e-30
    rl = -c / _safe(b)
    r0 = torch.where(lin, rl, r0)
    r1 = torch.where(lin, rl, r1)
    ctr = -b / (2.0 * _safe(a))
    r0 = torch.where(real, r0, ctr)
    r1 = torch.where(real, r1, ctr)
    roots = torch.stack([r0, r1], dim=-1)
    return roots, real[..., None].expand(roots.shape)


def solve_cubic(a, b, c, d):
    """a x^3 + b x^2 + c x + d = 0 -> (roots (..., 3), is_real (..., 3)):
    trigonometric branch for three real roots, Cardano for one."""
    a_s = _safe(a)
    b, c, d = b / a_s, c / a_s, d / a_s
    three, c27 = _const(3.0, b), _const(27.0, b)
    p = c - b * b / three
    q = 2.0 * _cube(b) / c27 - b * c / three + d
    half_q = 0.5 * q
    third_p = p / three
    disc = half_q * half_q + _cube(third_p)

    r = torch.sqrt(torch.clamp(-third_p, min=0.0))
    r3 = torch.clamp(_cube(r), min=1e-30)
    cos3phi = torch.clamp(-half_q / r3, -1.0, 1.0)
    phi = torch.arccos(cos3phi) / three
    two_pi_3 = 2.0943951023931953
    t_trig = torch.stack(
        [2.0 * r * torch.cos(phi - two_pi_3 * k) for k in range(3)], dim=-1)

    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    u = _cbrt(-half_q + sq)
    v = _cbrt(-half_q - sq)
    t0 = u + v
    pair_re = -0.5 * t0
    t_card = torch.stack([t0, pair_re, pair_re], dim=-1)

    three_real = (disc <= 0.0)[..., None]
    roots = torch.where(three_real, t_trig, t_card) - (b / three)[..., None]
    first = torch.arange(3, device=roots.device) == 0
    is_real = three_real | first
    return roots, is_real.expand(roots.shape)


def solve_quartic(a, b, c, d, e):
    """a x^4 + b x^3 + c x^2 + d x + e = 0 -> (roots (..., 4), is_real
    (..., 4)): Ferrari's method through the resolvent cubic, with the
    biquadratic case when the resolvent root vanishes."""
    a_s = _safe(a)
    b, c, d, e = b / a_s, c / a_s, d / a_s, e / a_s
    p = c - 3.0 * b * b / 8.0
    q = d - b * c / 2.0 + _cube(b) / 8.0
    r = e - b * d / 4.0 + b * b * c / 16.0 - 3.0 * ((b * b) * (b * b)) / 256.0

    m_roots, m_real = solve_cubic(torch.full_like(p, 8.0), 8.0 * p,
                                  2.0 * p * p - 8.0 * r, -q * q)
    m = torch.amax(torch.where(m_real, m_roots, -torch.inf), dim=-1)
    two_m = torch.clamp(2.0 * m, min=0.0)
    s = torch.sqrt(two_m)

    t = q / _safe(2.0 * s, 1e-30)
    c1 = p / 2.0 + m + t
    c2 = p / 2.0 + m - t
    d1 = s * s - 4.0 * c1
    d2 = s * s - 4.0 * c2
    sc1 = s * s + torch.abs(4.0 * c1)
    sc2 = s * s + torch.abs(4.0 * c2)
    real1 = d1 >= -_REAL_TOL * (1.0 + sc1)
    real2 = d2 >= -_REAL_TOL * (1.0 + sc2)
    sq1 = torch.sqrt(torch.clamp(d1, min=0.0))
    sq2 = torch.sqrt(torch.clamp(d2, min=0.0))
    f_roots = torch.stack([0.5 * (s + sq1), 0.5 * (s - sq1),
                           0.5 * (-s + sq2), 0.5 * (-s - sq2)], dim=-1)
    f_real = torch.stack([real1, real1, real2, real2], dim=-1)

    z, z_real = solve_quadratic(torch.ones_like(p), p, r)
    z_ok = z_real & (z >= 0.0)
    zs = torch.sqrt(torch.clamp(z, min=0.0))
    b_roots = torch.cat([zs, -zs], dim=-1)
    b_real = torch.cat([z_ok, z_ok], dim=-1)

    use_biquad = (two_m < 1e-12 * (1.0 + torch.abs(p) + torch.abs(r)))[..., None]
    roots = torch.where(use_biquad, b_roots, f_roots) - (b / 4.0)[..., None]
    is_real = torch.where(use_biquad, b_real, f_real)
    return roots, is_real


def polish_real_roots(coeffs, roots, iters: int = 3):
    """Newton-polish real roots against the full polynomial.

    coeffs: (..., D+1) highest degree first; roots: (..., R)."""
    x = roots
    deg = coeffs.shape[-1] - 1
    dcoef = coeffs[..., :-1] * torch.arange(deg, 0, -1, dtype=roots.dtype,
                                            device=roots.device)
    for _ in range(iters):
        f = torch.zeros_like(x)
        for i in range(coeffs.shape[-1]):
            f = f * x + coeffs[..., i:i + 1]
        fp = torch.zeros_like(x)
        for i in range(dcoef.shape[-1]):
            fp = fp * x + dcoef[..., i:i + 1]
        x = x - f / torch.where(torch.abs(fp) < 1e-20, 1e-20, fp)
    return x


def _linspace(start: float, stop: float, n: int, like):
    """``jnp.linspace``'s grid: start + i * (stop - start) / (n - 1), the
    last point ``stop``."""
    delta = (stop - start) / (n - 1)
    i = torch.arange(n - 1, dtype=like.dtype, device=like.device)
    last = torch.full((1,), stop, dtype=like.dtype, device=like.device)
    return torch.cat([start + i * delta, last])


def _powers(x, deg: int):
    """x^0 .. x^deg (..., deg + 1) as a product chain, x^m = x^(m-1) * x."""
    out = [torch.ones_like(x)]
    for _ in range(deg):
        out.append(out[-1] * x)
    return torch.stack(out, dim=-1)


def sum_seq(x):
    """Sum over the last axis from left to right."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def solve_poly_real(coeffs, n_grid: int = 1024, bisect_iters: int = 48,
                    newton_iters: int = 3):
    """All real roots of degree-D polynomials, in real arithmetic.

    ``coeffs``: (..., D+1) highest degree first.  Returns ``(roots (...,
    D), valid (..., D))``.  The reference's method: rescale by the
    Fujiwara bound, substitute z = tan(theta) into the homogenised form
    sum_k c_k sin^(D-k) cos^k, bracket sign changes on an ``n_grid``
    theta grid, bisect each bracket, Newton-polish in z.  Roots of even
    multiplicity, and roots closer than the grid pitch, may be missed.
    Integer powers are product chains and the homogenised form's terms are
    summed from left to right, as the 5-point kernel (`csrc/relpose_ransac.cu`)
    repeats them.
    """
    deg = coeffs.shape[-1] - 1
    like = coeffs
    c0 = torch.clamp(torch.abs(coeffs[..., 0]), min=1e-30)
    k = torch.arange(1, deg + 1, dtype=like.dtype, device=like.device)
    ratios = (torch.abs(coeffs[..., 1:]) / c0[..., None]) ** (1.0 / k)
    s = torch.clamp(2.0 * torch.amax(ratios, dim=-1), 1e-3, 1e3)
    scaled = coeffs * _powers(s, deg).flip(-1)
    scaled = scaled / torch.clamp(torch.amax(torch.abs(scaled), dim=-1,
                                             keepdim=True), min=1e-30)
    eps = 1e-4
    theta = _linspace(-math.pi / 2 + eps, math.pi / 2 - eps, n_grid, like)

    def homog(th, c):
        # sum_k c[k] sin^(D-k) cos^k, th (..., R) against c (..., 1, D+1)
        return sum_seq(c * _powers(torch.sin(th), deg).flip(-1)
                        * _powers(torch.cos(th), deg))

    f = homog(theta.expand(coeffs.shape[:-1] + (n_grid,)), scaled[..., None, :])
    sgn = torch.sign(f)
    change = (sgn[..., :-1] * sgn[..., 1:] < 0) | (sgn[..., :-1] == 0)
    rank = torch.cumsum(change.to(torch.int64), dim=-1)
    # bracket j: the (j + 1)-th sign change, if there is one
    j = torch.arange(1, deg + 1, device=like.device)[:, None]
    hit = change[..., None, :] & (rank[..., None, :] == j)  # (..., D, G-1)
    valid = hit.any(dim=-1)
    idx = torch.argmax(hit.to(torch.int8), dim=-1)
    lo, hi = theta[idx], theta[idx + 1]
    c = scaled[..., None, :]
    f_lo = homog(lo, c)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        f_mid = homog(mid, c)
        left = f_lo * f_mid <= 0
        hi = torch.where(left, mid, hi)
        lo = torch.where(left, lo, mid)
        f_lo = torch.where(left, f_lo, f_mid)
    roots = torch.tan(0.5 * (lo + hi)) * s[..., None]
    roots = polish_real_roots(coeffs, roots, iters=newton_iters)
    return torch.where(valid, roots, 0.0), valid


def convolve(p, q, nd: int = 1):
    """Full convolution of the trailing ``nd``-dim coefficient grids of p
    and q (batched over the leading dims).  Each coefficient sums its
    products over the entries of the smaller grid (p on a tie) in index
    order, starting from zero: the 5-point kernel (`csrc/relpose_ransac.cu`)
    repeats that order, where a library product sums another way on the card."""
    ps, qs = p.shape[-nd:], q.shape[-nd:]
    if math.prod(ps) > math.prod(qs):
        p, q, ps, qs = q, p, qs, ps
    lead = torch.broadcast_shapes(p.shape[:-nd], q.shape[:-nd])
    out = torch.zeros(lead + tuple(a + b - 1 for a, b in zip(ps, qs)),
                      dtype=torch.result_type(p, q), device=p.device)
    for i in itertools.product(*map(range, ps)):
        sl = tuple(slice(a, a + b) for a, b in zip(i, qs))
        out[(...,) + sl] += p[(...,) + i + (None,) * nd] * q
    return out
