"""The logic of K13's and K14's tensor-core filter, on the CPU.

`csrc/l2_match.cu` forms a filter distance d~ for every pair on the tensor
cores, keeps per row, column part and half of a tile's columns the columns
whose interval [d~ - T, max(d~, 0) + T] (T =
`descriptors.l2_filter_threshold`) can still hold the answer, at most
`L2_FILTER_CANDIDATES` of them (else the row is recomputed exactly over
the whole part), prunes both halves' lists to the part's bound and
recomputes what is left in the plain arithmetic.  `filtered` below models that, tile by tile, with the same
threshold and constant as the wrapper passes the kernel and the exact
distances of `descriptors.l2_distance_sq`; the tests hold it bit for bit
to `l2_argmin_plain` and `l2_ratio_match_plain` with d~ moved by up to T
from the plain distance (adversarially: the answer's columns up, every
other column down; or at random), which is all the kernel's derivation
promises.  The perturbation is T (1 - 2^-20), so that float64 rounding of
the model's own intervals cannot count against it.  (The kernel takes a
row's T at the largest column norm of a warp's 32 columns: a wider
interval, which keeps every candidate this one does.)

A second group emulates the 3xTF32 product in float64 (hi rounded to 10
mantissa bits, ties away; lo = x - hi truncated to 10) on SIFT-like
inputs: the split alone stays within C_TC =
`L2_FILTER_REL_ERR` of the exact product, and so does a pessimistic model
of the tensor core's accumulation (every m16n8k8 step truncating its
addends and its sum toward zero at the largest addend's float32 ulp, the
accumulator restarting every 16 dimensions as in the kernel) within a
quarter of it, the margin the kernel's header derives.
"""

import numpy as np
import pytest
import torch

from covins_tpu_torch.ops import descriptors as d
from covins_tpu_torch.ops import linalg
from covins_tpu_torch.utils.synthetic import l2_match_scene, sift_descriptors

torch.set_num_threads(1)

TILE, WINDOW = 64, 512  # csrc/l2_match.cu kTile, kWindow
HALF = 32  # a warp's columns of a tile
SQRT_SLACK = 1.0 + 2.0 ** -21
SHRINK = 1.0 - 2.0 ** -20
BIG_BITS = int(np.float32(d.BIG).view(np.uint32))


def _fmin2(m1, m2, values):
    """The two smallest of (m1, m2) and ``values``; NaN never taken."""
    for x in values:
        if x < m1:
            m1, m2 = x, m1
        elif x < m2:
            m2 = x
    return m1, m2


def _key(bits, col):
    return (int(bits) << 32) | int(col)


def filtered(a, a_mask, b, b_mask, seg, parts, dt, top2, max_dist=500.0, ratio=0.8):
    """The kernels' selection on the filter distances ``dt`` (M, N) float64,
    then exact keys from `l2_distance_sq`.  K13 (``top2`` False, one
    segment, ``a_mask`` only for -1) returns (idx, dmin); K14 (idx, d1, d2),
    each (M, S).  Also returns the (row, part) lists' candidate counts and
    how many overflowed."""
    m, n = a.shape[0], b.shape[0]
    S = n // seg
    plain = d.l2_distance_sq(a, b)
    bits = (linalg.sqrt_rn(plain) if top2 else plain).numpy().view(np.uint32)
    T = d.l2_filter_threshold(d.sum_squares(a), d.sum_squares(b)).numpy()
    lo = dt - T
    hi = np.where(dt < 0, 0.0, dt) + T
    bm = b_mask.numpy() if top2 else np.ones(n, bool)
    am = a_mask.numpy() if a_mask is not None else np.ones(m, bool)
    parts = max(1, min(parts, seg // (64 if top2 else 256)))  # the kernels' least parts
    chunk = -(-seg // parts)  # K13: columns a part; K14: the segment's valid ones shared
    keys = np.zeros((m, S, 2), dtype=object)
    counts, overflows = [], 0
    for s in range(S):
        s0 = s * seg
        masked = [c for c in range(s0, s0 + seg) if not bm[c]][:2]
        for r in range(m):
            if top2 and not am[r]:
                keys[r, s] = (_key(BIG_BITS, s0), _key(BIG_BITS, s0 + 1))
                continue
            best = []
            valid = [c for c in range(s0, s0 + seg) if bm[c]]
            per = -(-len(valid) // parts)
            for p in range(parts):
                if top2:  # equal shares of the segment's valid columns
                    mine = set(valid[p * per:(p + 1) * per])
                    w_lo, w_hi = s0, s0 + seg
                else:
                    w_lo, w_hi = s0 + min(seg, p * chunk), s0 + min(seg, (p + 1) * chunk)
                    mine = set(range(w_lo, w_hi))
                # per half of a tile's columns (a warp's): bounds and a list
                u = [[np.inf, np.inf], [np.inf, np.inf]]
                cand, over, listed = [[], []], False, []
                for w0 in range(w_lo, w_hi, WINDOW):
                    cols = [c for c in range(w0, min(w0 + WINDOW, w_hi)) if c in mine]
                    listed += cols
                    for t0 in range(0, len(cols), TILE):
                        for half in (0, 1):
                            tile = cols[t0 + HALF * half:t0 + HALF * (half + 1)]
                            u[half] = list(_fmin2(*u[half], sorted(
                                x for x in hi[r, tile] if not np.isnan(x))[:2]))
                            bound = u[half][1] * SQRT_SLACK if top2 else u[half][0]
                            kept = [c for c in cand[half] if not lo[r, c] > bound]
                            cand[half] = kept + [c for c in tile if not lo[r, c] > bound]
                            over = over or len(cand[half]) > d.L2_FILTER_CANDIDATES
                u1, u2 = _fmin2(*u[0], u[1])
                bound = u2 * SQRT_SLACK if top2 else u1
                cand = [c for c in cand[0] + cand[1] if not lo[r, c] > bound]
                if over:
                    overflows += 1
                else:
                    counts.append(len(cand))
                best += [_key(bits[r, c], c) for c in (listed if over else cand)]
            best = sorted(best + [_key(BIG_BITS, c) for c in masked])[:2]  # part 0 adds them
            keys[r, s] = (best + [~0 & (2**64 - 1)] * 2)[:2]
    k1 = keys[..., 0].astype(np.uint64)
    k2 = keys[..., 1].astype(np.uint64)
    col1 = torch.from_numpy((k1 & 0xffffffff).astype(np.int64))
    f1 = torch.from_numpy((k1 >> 32).astype(np.uint32).view(np.float32))
    f2 = torch.from_numpy((k2 >> 32).astype(np.uint32).view(np.float32))
    if not top2:
        idx = torch.where(torch.from_numpy(am), col1[:, 0], -1).to(torch.int32)
        return (idx, f1[:, 0]), counts, overflows
    seg_at = torch.arange(S)[None, :] * seg
    idx = torch.where(d._ratio_gate(f1, f2, max_dist, ratio), col1 - seg_at, -1)
    return (idx.to(torch.int32), f1, f2), counts, overflows


def perturbed(a, b, a_mask, b_mask, seg, top2, how, rng):
    """The plain distances moved by up to T (1 - 2^-20): "adversarial", the
    answer's columns (K13 every column at the minimum, K14 the top 2 of
    each row and segment by exact key) up, all others down; "random",
    uniform in the interval."""
    plain = d.l2_distance_sq(a, b)
    T = d.l2_filter_threshold(d.sum_squares(a), d.sum_squares(b)).numpy() * SHRINK
    dp = plain.numpy().astype(np.float64)
    if how == "random":
        return dp + T * rng.uniform(-1.0, 1.0, dp.shape)
    up = np.zeros(dp.shape, bool)
    if not top2:
        up = dp == dp.min(axis=1, keepdims=True)
    else:
        bits = linalg.sqrt_rn(plain).numpy().view(np.uint32).astype(np.uint64)
        cols = np.arange(dp.shape[1], dtype=np.uint64)
        keys = (bits << np.uint64(32)) | cols
        bm = b_mask.numpy()
        keys[:, ~bm] = np.uint64(2**64 - 1)
        for s in range(dp.shape[1] // seg):
            blk = keys[:, s * seg:(s + 1) * seg]
            top = np.argsort(blk, axis=1, kind="stable")[:, :2]
            np.put_along_axis(up[:, s * seg:(s + 1) * seg], top, True, axis=1)
    return dp + np.where(up, T, -T)


K13_CASES = [(None, 70, 300), ("ties", 130, 700), ("extremes", 50, 300),
             ("overflow", 20, 512), ("ulp", 12, 700), ("all_masked", 65, 200)]
K14_CASES = [(None, 70, 300, 2, 0.8), ("ties", 100, 600, 2, 1.5),
             ("extremes", 20, 100, 2, 0.8), ("all_masked", 50, 40, 3, 0.8),
             ("one_valid", 33, 300, 2, 0.8), ("overflow", 20, 300, 2, 1.5),
             ("ulp", 12, 700, 2, 1.5), ("mask_patterns", 150, 100, 4, 0.8)]


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("how", ["adversarial", "random"])
@pytest.mark.parametrize("case,M,N", K13_CASES)
def test_k13_filter_reproduces_the_plain_argmin(case, M, N, how, parts):
    rng = np.random.default_rng(M + N)
    a, am, b, _ = (torch.from_numpy(x) for x in l2_match_scene(rng, M, N, 1, case))
    dt = perturbed(a, b, am, None, N, False, how, rng)
    (idx, dmin), counts, overflows = filtered(a, am, b, None, N, parts, dt, False)
    ridx, rdmin = d.l2_argmin_plain(a, b, am)
    assert torch.equal(idx, ridx) and torch.equal(dmin.view(torch.int32),
                                                  rdmin.view(torch.int32))
    if case == "overflow":
        assert overflows > 0  # the 12 near-equidistant words of part 0
    elif case != "extremes":  # (the zero query's distances are the words'
        # norms, all 512^2 but for rounding: it may overflow too)
        assert overflows == 0 and max(counts) <= d.L2_FILTER_CANDIDATES
    if case == "ulp":
        assert (idx[:8] == 600).all()  # the nearest, at the highest column


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("how", ["adversarial", "random"])
@pytest.mark.parametrize("case,M,seg,n_seg,ratio", K14_CASES)
def test_k14_filter_reproduces_the_plain_ratio_match(case, M, seg, n_seg, ratio, how, parts):
    rng = np.random.default_rng(M + seg)
    a, am, b, bm = (torch.from_numpy(x) for x in l2_match_scene(rng, M, seg, n_seg, case))
    dt = perturbed(a, b, am, bm, seg, True, how, rng)
    got, counts, overflows = filtered(a, am, b, bm, seg, parts, dt, True, ratio=ratio)
    ref = d.l2_ratio_match_plain(a, am, b, bm, seg, 500.0, ratio)
    assert torch.equal(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
    if case == "overflow":
        assert overflows > 0
    if case == "ulp":
        assert np.isin(got[0][:8, 0].numpy(), (2, 70, 300, 600)).all()
    if case == "mask_patterns":
        assert (got[0][:64] == -1).all() and (got[1][:64] == d.BIG).all()
        assert (got[1][:, 0] == d.BIG).all() and (got[2][:, 1] == d.BIG).all()


def test_threshold_is_the_kernels_formula():
    """T at SIFT's norms (512 a descriptor) is about 36 squared-distance
    units, against distances of order 1e5; zero rows leave 4u bb."""
    aa = torch.tensor([512.0**2, 0.0])
    bb = torch.tensor([512.0**2])
    T = d.l2_filter_threshold(aa, bb)
    u = 2.0 ** -24
    g = 128 * u / (1 - 128 * u)
    assert T.dtype == torch.float64
    assert float(T[0, 0]) == pytest.approx(2 * (2.0**-14 + g) * 512.0**2 + 8 * u * 512.0**2)
    assert 30.0 < float(T[0, 0]) < 40.0
    assert float(T[1, 0]) == 4 * u * 512.0**2


# ------------------------------------------------------------ 3xTF32 error
def rna_tf32(x):
    """float32 -> TF32 (10 mantissa bits), rounded to nearest with ties
    away from zero, as cvt.rna.tf32.f32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def trunc_tf32(x):
    """float32 -> TF32, truncated (the low 13 bits cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split_products(a, b):
    """Per dimension, the three products the kernel gives the tensor cores
    (lo.hi', hi.lo', hi.hi'), exact in float64: (3, M, N, 128)."""
    ah = rna_tf32(a)
    al = trunc_tf32(a - ah)
    bh = rna_tf32(b)
    bl = trunc_tf32(b - bh)
    f = lambda x, y: x.astype(np.float64)[:, None, :] * y.astype(np.float64)[None, :, :]
    return np.stack([f(al, bh), f(ah, bl), f(ah, bh)])


def _trunc(x, e):
    """x truncated toward zero to a multiple of 2^e."""
    q = np.ldexp(1.0, e)
    return np.trunc(x / q) * q


def truncating_accumulation(prods):
    """ab~ under a pessimistic tensor core: each m16n8k8 step adds its 8
    products to the accumulator after truncating every addend, and then
    the sum, toward zero at the float32 ulp of the step's largest addend;
    the accumulator restarts every 16 dimensions and its chunk sums are
    added in float32 (csrc/l2_match.cu)."""
    total = np.zeros(prods.shape[1:3], np.float32)
    for kc in range(0, 128, 16):
        acc = np.zeros(prods.shape[1:3])
        for kk in (kc, kc + 8):
            for p in prods[:, :, :, kk:kk + 8]:
                terms = np.concatenate([acc[..., None], p], axis=-1)
                big = np.abs(terms).max(axis=-1, keepdims=True)
                e = np.frexp(np.where(big > 0, big, 1.0))[1] - 24
                acc = _trunc(_trunc(terms, e).sum(-1), e[..., 0])
        total = (total + acc.astype(np.float32)).astype(np.float32)
    return total.astype(np.float64)


@pytest.mark.parametrize("scene", ["sift", "observations", "flat", "mixed_scale"])
def test_3xtf32_product_stays_within_c_tc(scene):
    rng = np.random.default_rng(7)
    b = sift_descriptors(rng, 48).astype(np.float32)
    if scene == "sift":
        a = sift_descriptors(rng, 40).astype(np.float32)
    elif scene == "observations":
        a = np.abs(b[rng.integers(0, 48, 40)] + rng.normal(0.0, 8.0, (40, 128)))
    elif scene == "flat":
        a = np.abs(40.0 + rng.normal(0.0, 3.0, (40, 128)))
    else:
        a = sift_descriptors(rng, 40) * np.exp(rng.uniform(-8, 8, (40, 1)))
        a[:, ::3] *= 1e-3
    a = a.astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    norms = np.linalg.norm(a.astype(np.float64), axis=1)[:, None] * \
        np.linalg.norm(b.astype(np.float64), axis=1)[None, :]
    prods = split_products(a, b)
    split_err = float((np.abs(prods.sum(axis=(0, 3)) - exact) / norms).max())
    model_err = float((np.abs(truncating_accumulation(prods) - exact) / norms).max())
    print(f"{scene}: split {split_err:.3g}, truncating model {model_err:.3g}, "
          f"C_TC {d.L2_FILTER_REL_ERR:.3g}")
    assert split_err <= 5.01 * 2.0 ** -22  # lo.lo' and the remainders
    assert model_err <= d.L2_FILTER_REL_ERR / 4
