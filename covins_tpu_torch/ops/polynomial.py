"""Batched closed-form polynomial roots in real arithmetic.

Counterpart of `covins_tpu/ops/polynomial.py` (quadratic, cubic, quartic
and the Newton polish the P3P solver uses).  Every formula is the
reference's: both branches of each case split are evaluated and one is
selected, so the results round as the reference's do.  The solvers return
``(roots, is_real)``: real roots with a trailing root axis, and for a
complex-conjugate pair the pair's real part with ``is_real = False``.

The P3P kernel (`csrc/p3p_ransac.cu`) repeats this arithmetic and is held
to it bit for bit on the card, so every operation here is one that rounds
alike in both: powers are written as products (``x ** 3`` as ``(x * x) *
x``, the JAX package's integer power, where PyTorch would call ``pow``),
and a division by 3 or 27 divides by a device tensor (PyTorch's CUDA
division by a Python number multiplies by its rounded reciprocal).
"""

from __future__ import annotations

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
