"""Descriptor distances and the matching kernels: Hamming (ORB) and L2
(SIFT).

Counterpart of `covins_tpu/ops/descriptors.py`.  The JAX package computes
Hamming distance as an unpack-to-±1 matmul (`hamming_distance`), exact
because the products are ±1 and the sums stay far below 2^24.  The port
keeps that as its plain version and adds three CUDA kernels: the fused
distance + row argmin that retrieval needs, :func:`hamming_argmin` (K1,
`csrc/hamming_argmin.cu`), the masked mutual-nearest-neighbour match of
loop verification's stage 1, :func:`hamming_mutual_nn` (K4,
`csrc/hamming_mutual_nn.cu`), and the masked top-2 ratio match of the
COVINS-G verification per column segment, :func:`hamming_ratio_match`
(K11, `csrc/hamming_ratio_match.cu`).  The matchers on a distance matrix
(`knn2`, `match_ratio`, `match_mutual_nn`, `match_mutual_nn_ratio`) are
the reference's.

For 128-dimensional float32 (SIFT) descriptors, :func:`l2_distance_sq`
writes the reference's squared L2 distance in one summation order, and two
CUDA kernels give that arithmetic's answers: the word assignment's row
argmin, :func:`l2_argmin` (K13), and the COVINS-G verification's masked
top-2 ratio match per column segment, :func:`l2_ratio_match` (K14), both
in `csrc/l2_match.cu`.  They filter on the tensor cores (3xTF32 products,
within :func:`l2_filter_threshold` of the plain distance) and recompute
the few columns that can still be the answer in the plain order, so they
agree with the plain versions bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, is_cpu
from covins_tpu_torch.ops import linalg

ORB_BYTES = 32  # 256-bit ORB/BRIEF descriptors (config: feat.desc_length)
SIFT_DIMS = 128  # float32 SIFT descriptors (config: feat.desc_length)

_POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)],
                          dtype=torch.int32)


def unpack_to_pm1(desc_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, B) uint8 -> (N, 8B) in {-1, +1}; byte-major, LSB-first bits."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc_u8.device)
    bits = (desc_u8[..., :, None] >> shifts) & 1
    bits = bits.reshape(desc_u8.shape[:-1] + (desc_u8.shape[-1] * 8,))
    return bits.to(dtype) * 2 - 1


def hamming_distance(a_u8: torch.Tensor, b_u8: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """(..., M, B) x (..., N, B) uint8 -> (..., M, N) int32 exact Hamming
    distance through the ±1 product (float32 sums of ±1 are exact)."""
    nbits = a_u8.shape[-1] * 8
    dot = torch.matmul(unpack_to_pm1(a_u8, dtype),
                       unpack_to_pm1(b_u8, dtype).transpose(-1, -2))
    return ((nbits - dot.float()) * 0.5).to(torch.int32)


def hamming_distance_best(a_u8: torch.Tensor, b_u8: torch.Tensor) -> torch.Tensor:
    """The reference's distance of its product paths: the +-1 product in
    bfloat16 (exact: +-1 products summed in float32)."""
    return hamming_distance(a_u8, b_u8, dtype=torch.bfloat16)


def hamming_distance_xor(a_u8: torch.Tensor, b_u8: torch.Tensor,
                         chunk: int = 1024) -> torch.Tensor:
    """Popcount oracle: XOR + per-byte popcount table, in row chunks."""
    table = _POPCOUNT8.to(a_u8.device)
    out = []
    for i in range(0, a_u8.shape[0], chunk):
        x = a_u8[i:i + chunk, None, :] ^ b_u8[None, :, :]
        out.append(table[x.long()].sum(-1, dtype=torch.int32))
    if not out:
        return torch.zeros((0, b_u8.shape[0]), dtype=torch.int32,
                           device=a_u8.device)
    return torch.cat(out)


def hamming_argmin_plain(a_u8: torch.Tensor, b_u8: torch.Tensor,
                         row_mask: Optional[torch.Tensor] = None,
                         want_dist: bool = False):
    """Plain version of :func:`hamming_argmin` (any device)."""
    dist = hamming_distance(a_u8, b_u8)
    dmin, idx = torch.min(dist, dim=1)  # first minimum: lowest index
    idx = idx.to(torch.int32)
    if row_mask is not None:
        idx = torch.where(row_mask, idx, torch.full_like(idx, -1))
    return (idx, dmin, dist) if want_dist else (idx, dmin)


def _check_desc(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.uint8 or t.dim() != ndim or t.shape[-1] != ORB_BYTES:
        raise ValueError(f"{name}: expected (..., {ORB_BYTES}) uint8 with "
                         f"{ndim} dims, got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: needs a contiguous 16-byte aligned tensor")


# the kernel packs (distance << 22 | column) into 32 bits
ARGMIN_MAX_COLUMNS = (1 << 22) - 1


def hamming_argmin(a_u8: torch.Tensor, b_u8: torch.Tensor,
                   row_mask: Optional[torch.Tensor] = None,
                   want_dist: bool = False
                   ) -> Tuple[torch.Tensor, ...]:
    """Row argmin of the Hamming distance between (M, 32) and (N, 32)
    uint8 descriptors.

    Returns ``idx (M,) int32`` (lowest index on ties, -1 where ``row_mask``
    is False), ``dmin (M,) int32`` and, with ``want_dist``, the full
    ``(M, N) int32`` distance matrix.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (K1, binary tensor-core products) or
    raise.
    """
    if is_cpu(a_u8) and is_cpu(b_u8):
        return hamming_argmin_plain(a_u8, b_u8, row_mask, want_dist)
    dev = check_cuda("hamming_argmin", a_u8, b_u8, row_mask)
    _check_desc("hamming_argmin a", a_u8, 2)
    _check_desc("hamming_argmin b", b_u8, 2)
    m, n = a_u8.shape[0], b_u8.shape[0]
    if n == 0:
        raise ValueError("hamming_argmin: empty database")
    if row_mask is not None and (row_mask.dtype != torch.bool
                                 or row_mask.shape != (m,)
                                 or not row_mask.is_contiguous()):
        raise ValueError("hamming_argmin: row_mask must be a contiguous "
                         f"({m},) bool tensor")
    if n > ARGMIN_MAX_COLUMNS or m >= 2**30:
        raise ValueError("hamming_argmin: shape too large")
    idx = torch.empty(m, dtype=torch.int32, device=dev)
    dmin = torch.empty(m, dtype=torch.int32, device=dev)
    dist = (torch.empty((m, n), dtype=torch.int32, device=dev)
            if want_dist else None)
    launch_argmin(dev, a_u8.data_ptr(), b_u8.data_ptr(),
                  None if row_mask is None else row_mask.data_ptr(), m, n,
                  idx.data_ptr(), dmin.data_ptr(),
                  None if dist is None else dist.data_ptr())
    return (idx, dmin, dist) if want_dist else (idx, dmin)


def launch_argmin(dev: torch.device, a: int, b: int, row_mask: Optional[int],
                  m: int, n: int, idx: int, dmin: int,
                  dist: Optional[int] = None) -> None:
    """Launch K1 on device addresses, counted on :func:`hamming_argmin`:
    ``a`` (m, 32) and ``b`` (n, 32) uint8 descriptors (4-byte aligned),
    ``row_mask`` (m,) bool or None, outputs ``idx`` and ``dmin`` (m,)
    int32 and ``dist`` (m, n) int32 or None; 0 < n <= ARGMIN_MAX_COLUMNS.
    For callers that hold their inputs in a packed buffer; the checks of
    :func:`hamming_argmin` are theirs to make."""
    lib = cuda_build.library("hamming_argmin")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_hamming_argmin(a, b, row_mask, m, n, idx, dmin, dist, stream)
    cuda_build.check(rc, "hamming_argmin")
    hamming_argmin.launches += 1


hamming_argmin.launches = 0


BIG = 2**30  # masked entries of the distance matrix (descriptors.py:100)


def masked_dist(dist: torch.Tensor, row_mask=None, col_mask=None,
                big: int = BIG) -> torch.Tensor:
    """Fill masked rows/cols with a large sentinel so argmin ignores them."""
    big = torch.tensor(big, dtype=dist.dtype, device=dist.device)
    if row_mask is not None:
        dist = torch.where(row_mask[:, None], dist, big)
    if col_mask is not None:
        dist = torch.where(col_mask[None, :], dist, big)
    return dist


def match_mutual_nn(dist: torch.Tensor, max_dist: float) -> torch.Tensor:
    """Mutual nearest neighbours with an absolute gate
    (`DenseMatcher.cpp:62-105`); idx (M,) int32, -1 = no match."""
    fwd = torch.argmin(dist, dim=1)
    bwd = torch.argmin(dist, dim=0)
    m = torch.arange(dist.shape[0], device=dist.device)
    mutual = bwd[fwd] == m
    dbest = dist[m, fwd]
    ok = mutual & (dbest.to(torch.float32) < max_dist)
    return torch.where(ok, fwd, -1).to(torch.int32)


def knn2(dist: torch.Tensor):
    """Best and second-best along axis 1, ties to the lowest index (as
    ``jax.lax.top_k``: a stable sort, where ``torch.topk`` leaves the order
    of ties open).  Returns (idx_best (M,), d_best (M,), d_second (M,))."""
    neg = -dist.to(torch.float32)
    top2, idx2 = torch.sort(neg, dim=1, descending=True, stable=True)
    return (idx2[:, 0].to(torch.int32), (-top2[:, 0]).to(dist.dtype),
            (-top2[:, 1]).to(dist.dtype))


def _ratio_gate(d1, d2, max_dist: float, ratio: float):
    """``d1 < max_dist`` and ``d1 < ratio * d2`` in float32, as the
    reference's weakly typed scalars make it."""
    f32 = dict(dtype=torch.float32, device=d1.device)
    d1f = d1.to(torch.float32)
    return (d1f < torch.tensor(max_dist, **f32)) & (
        d1f < torch.tensor(ratio, **f32) * d2.to(torch.float32))


def match_ratio(dist: torch.Tensor, max_dist: float, ratio: float) -> torch.Tensor:
    """knn2 + Lowe ratio + absolute gate (`placerec_gen_be.cpp:82-126`);
    idx (M,) int32, -1 = no match."""
    idx, d1, d2 = knn2(dist)
    return torch.where(_ratio_gate(d1, d2, max_dist, ratio), idx, -1)


def match_mutual_nn_ratio(dist: torch.Tensor, max_dist: float,
                          ratio: float) -> torch.Tensor:
    """Mutual NN + ratio + absolute gates combined."""
    idx_r = match_ratio(dist, max_dist, ratio)
    idx_m = match_mutual_nn(dist, max_dist)
    return torch.where((idx_r == idx_m) & (idx_r >= 0), idx_r, -1)


def hamming_mutual_nn_plain(a_u8, a_mask, b_u8, b_mask, max_dist: float):
    """Plain version of :func:`hamming_mutual_nn`: the reference's masked
    Hamming matrix, then :func:`match_mutual_nn` (any device)."""
    dist = masked_dist(hamming_distance(a_u8, b_u8), a_mask, b_mask)
    return match_mutual_nn(dist, max_dist)


def _check_mask(name: str, mask: torch.Tensor, n: int) -> None:
    if mask.dtype != torch.bool or mask.shape != (n,) or not mask.is_contiguous():
        raise ValueError(f"{name}: mask must be a contiguous ({n},) bool tensor")


def hamming_mutual_nn(a_u8: torch.Tensor, a_mask: torch.Tensor,
                      b_u8: torch.Tensor, b_mask: torch.Tensor,
                      max_dist: float) -> torch.Tensor:
    """Stage-1 matching of loop verification: for each valid row of the
    (M, 32) descriptors ``a_u8``, the valid column of ``b_u8`` that is its
    nearest neighbour and whose nearest valid row is it, with Hamming
    distance < ``max_dist``.  Ties go to the lowest index on both sides.
    Returns ``idx (M,) int32``, -1 = no match.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (K4, one cooperative launch
    that forms each distance once) or raise."""
    if all(is_cpu(t) for t in (a_u8, a_mask, b_u8, b_mask)):
        return hamming_mutual_nn_plain(a_u8, a_mask, b_u8, b_mask, max_dist)
    dev = check_cuda("hamming_mutual_nn", a_u8, a_mask, b_u8, b_mask)
    _check_desc("hamming_mutual_nn a", a_u8, 2)
    _check_desc("hamming_mutual_nn b", b_u8, 2)
    m, n = a_u8.shape[0], b_u8.shape[0]
    _check_mask("hamming_mutual_nn a", a_mask, m)
    _check_mask("hamming_mutual_nn b", b_mask, n)
    if max(m, n) >= 2**30:
        raise ValueError("hamming_mutual_nn: shape too large")
    # the row and column keys (distance << 32 | index) the kernel folds
    keys = torch.empty(m + n, dtype=torch.int64, device=dev)
    idx = torch.empty(m, dtype=torch.int32, device=dev)
    lib = cuda_build.library("hamming_mutual_nn")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_hamming_mutual_nn(
            a_u8.data_ptr(), a_mask.data_ptr(), m, b_u8.data_ptr(),
            b_mask.data_ptr(), n, float(max_dist), keys.data_ptr(), idx.data_ptr(),
            stream)
    cuda_build.check(rc, "hamming_mutual_nn")
    hamming_mutual_nn.launches += 1
    return idx


hamming_mutual_nn.launches = 0


def hamming_ratio_match_plain(a_u8, a_mask, b_u8, b_mask, seg: int,
                              max_dist: float, ratio: float):
    """Plain version of :func:`hamming_ratio_match` (any device): the
    reference's masked Hamming matrix, then :func:`knn2` and the gates of
    :func:`match_ratio` on each segment of ``seg`` columns."""
    dist = masked_dist(hamming_distance_best(a_u8, b_u8), a_mask, b_mask)
    out = []
    for j in range(b_u8.shape[0] // seg):
        idx, d1, d2 = knn2(dist[:, j * seg:(j + 1) * seg])
        out.append((torch.where(_ratio_gate(d1, d2, max_dist, ratio), idx, -1),
                    d1, d2))
    return tuple(torch.stack(x, dim=1) for x in zip(*out))


def hamming_ratio_match(a_u8: torch.Tensor, a_mask: torch.Tensor,
                        b_u8: torch.Tensor, b_mask: torch.Tensor, seg: int,
                        max_dist: float, ratio: float):
    """COVINS-G image matching of the (M, 32) descriptors ``a_u8`` against
    each of the ``N / seg`` segments of ``seg`` columns of ``b_u8`` (one
    segment a keyframe of the candidate rig): per row and segment the
    nearest and second-nearest valid column (ties to the lowest column; a
    masked row or column, or a missing second neighbour, counts as
    distance 2^30) and the match where ``d1 < max_dist`` and ``d1 < ratio
    * d2``, both in float32.  Returns ``(idx, d1, d2)``, each (M, N / seg)
    int32, idx the column within the segment or -1.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (K11: binary tensor-core
    products, the two smallest keys per row and segment in registers, a
    block a (row tile, segment, column part), no distance matrix) or
    raise."""
    if all(is_cpu(t) for t in (a_u8, a_mask, b_u8, b_mask)):
        return hamming_ratio_match_plain(a_u8, a_mask, b_u8, b_mask, seg,
                                         max_dist, ratio)
    dev = check_cuda("hamming_ratio_match", a_u8, a_mask, b_u8, b_mask)
    _check_desc("hamming_ratio_match a", a_u8, 2)
    _check_desc("hamming_ratio_match b", b_u8, 2)
    m, n = a_u8.shape[0], b_u8.shape[0]
    _check_mask("hamming_ratio_match a", a_mask, m)
    _check_mask("hamming_ratio_match b", b_mask, n)
    if seg < 2 or n % seg or n > ARGMIN_MAX_COLUMNS or m >= 2**30:
        raise ValueError(f"hamming_ratio_match: {n} columns in segments of {seg} "
                         "(a top 2 needs two columns a segment)")
    S = n // seg
    # the outputs, then the kernel's scratch: each column part's two keys
    # (at most 8 parts a segment) and a counter a (row tile, segment)
    buf = torch.empty(3 * m * S + 16 * m * S + -(-m // 32) * S, dtype=torch.int32,
                      device=dev)
    out = buf.as_strided((3, m, S), (m * S, S, 1))
    lib = cuda_build.library("hamming_ratio_match")
    with torch.cuda.device(dev):
        rc = lib.covins_hamming_ratio_match(
            a_u8.data_ptr(), a_mask.data_ptr(), m, b_u8.data_ptr(),
            b_mask.data_ptr(), n, seg, float(max_dist), float(ratio),
            buf.data_ptr(), buf.data_ptr() + 4 * 3 * m * S,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "hamming_ratio_match")
    hamming_ratio_match.launches += 1
    return out[0], out[1], out[2]


hamming_ratio_match.launches = 0


# ---------------------------------------------------------------- L2 (SIFT)
# (rows x columns) of the plain product held at once: small enough on the
# CPU to stay in its caches, large on a card to keep the launches few
_L2_BLOCK = {"cpu": 1 << 18, "cuda": 1 << 24}


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """Each row's sum of squares, a running sum over the columns in order
    (the kernels' order), every product and sum rounded on its own."""
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k] * x[:, k]
    return acc


def l2_distance_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, D) x (N, D) float -> (M, N) squared L2 distance, the
    reference's ``max((aa + bb) - 2 ab, 0)`` (`descriptors.py:89`) in the
    arithmetic of K13 and K14: ``aa``, ``bb`` and ``ab`` each a running sum
    over the D dimensions in order, every product and sum rounded on its
    own, in the inputs' dtype; the clamp keeps NaN.  The plain version of
    both kernels; the reference's product sums in XLA's order, so the two
    agree within rounding."""
    m, n, d = a.shape[0], b.shape[0], a.shape[1]
    aa, bb = sum_squares(a), sum_squares(b)
    bt = b.t().contiguous()
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    step = max(1, _L2_BLOCK[a.device.type] // max(n, 1))
    for r0 in range(0, m, step):
        ar = a[r0:r0 + step]
        ab = torch.zeros((ar.shape[0], n), dtype=a.dtype, device=a.device)
        for k in range(d):
            ab += ar[:, k, None] * bt[k]
        out[r0:r0 + step] = torch.clamp((aa[r0:r0 + step, None] + bb) - 2.0 * ab, min=0.0)
    return out


def l2_argmin_plain(a: torch.Tensor, b: torch.Tensor,
                    row_mask: Optional[torch.Tensor] = None):
    """Plain version of :func:`l2_argmin` (any device)."""
    dmin, idx = torch.min(l2_distance_sq(a, b), dim=1)  # first minimum
    idx = idx.to(torch.int32)
    if row_mask is not None:
        idx = torch.where(row_mask, idx, torch.full_like(idx, -1))
    return idx, dmin


def _check_f32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != SIFT_DIMS:
        raise ValueError(f"{name}: expected (N, {SIFT_DIMS}) float32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: needs a contiguous 16-byte aligned tensor")


L2_MAX_PARTS = 8  # column parts a segment at most (csrc/l2_match.cu)
# The relative error C_TC allowed to the kernels' tensor-core product ab~
# (3xTF32): |ab~ - a.b| <= C_TC |a| |b|.  `csrc/l2_match.cu` derives a
# quarter of it from the split and an assumed 16 ulps a tensor-core step;
# chip_smoke.py checks an eighth of it on the card.
L2_FILTER_REL_ERR = 2.0 ** -14
L2_FILTER_CANDIDATES = 8  # candidates a list: a row, column part and half (csrc/l2_match.cu)


def l2_filter_threshold(aa: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    """The kernels' bound T on |d~ - d| between the filter's distance and
    :func:`l2_distance_sq`'s, from the rows' ``aa`` (M,) and the columns'
    ``bb`` (N,) (:func:`sum_squares`): ``2 (C_TC + g128) sqrt(aa bb) + 4u
    (aa + bb)``, u = 2^-24, g128 = 128u / (1 - 128u), as (M, N) float64
    (the kernels round it up in float32)."""
    u = 2.0 ** -24
    g128 = 128 * u / (1 - 128 * u)
    aa, bb = aa.double()[:, None], bb.double()[None, :]
    return 2 * (L2_FILTER_REL_ERR + g128) * torch.sqrt(aa * bb) + 4 * u * (aa + bb)


_l2_counts = {}


def l2_filter_counts(dev: torch.device) -> torch.Tensor:
    """The (4,) int64 counters that every K13 and K14 launch on ``dev`` adds
    to: (row, column part) lists filtered, their candidates, the most
    candidates of one, and those rescanned exactly for having more than
    :data:`L2_FILTER_CANDIDATES`.  Zero it to start a count."""
    dev = torch.device(dev)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    if dev not in _l2_counts:
        _l2_counts[dev] = torch.zeros(4, dtype=torch.int64, device=dev)
    return _l2_counts[dev]


def l2_filter_values(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The filter's distance d~ (M, N) float32 of (M, 128) and (N, 128)
    float32 CUDA tensors, from the same tile products as K13 and K14, for
    checking :func:`l2_filter_threshold` on the card.  Not a main-path
    kernel: it writes the (M, N) matrix and counts no launch."""
    dev = check_cuda("l2_filter_values", a, b)
    _check_f32("l2_filter_values a", a)
    _check_f32("l2_filter_values b", b)
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32, device=dev)
    lib = cuda_build.library("l2_match")
    with torch.cuda.device(dev):
        rc = lib.covins_l2_filter_debug(a.data_ptr(), a.shape[0], b.data_ptr(), b.shape[0],
                                        out.data_ptr(),
                                        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "l2_filter_values")
    return out


def l2_scratch_bytes(m: int, s: int = 1) -> int:
    """Scratch of one K13 / K14 launch over m rows and s segments: two
    64-bit keys per (row, segment, part), then a counter per (segment,
    64-row tile)."""
    return 16 * L2_MAX_PARTS * m * s + 4 * s * -(-m // 64)


def l2_argmin(a: torch.Tensor, b: torch.Tensor,
              row_mask: Optional[torch.Tensor] = None):
    """Row argmin of the squared L2 distance between (M, 128) and (N, 128)
    float32 descriptors (:func:`l2_distance_sq`).  Returns ``idx (M,)
    int32`` (the first minimum, as ``jnp.argmin``; -1 where ``row_mask`` is
    False) and ``dmin (M,) float32``.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (K13: the tensor-core filter, then its
    candidates in the plain arithmetic; counted on
    :func:`l2_filter_counts`) or raise."""
    if is_cpu(a) and is_cpu(b) and (row_mask is None or is_cpu(row_mask)):
        return l2_argmin_plain(a, b, row_mask)
    dev = check_cuda("l2_argmin", a, b, row_mask)
    _check_f32("l2_argmin a", a)
    _check_f32("l2_argmin b", b)
    m, n = a.shape[0], b.shape[0]
    if n == 0 or m >= 2**30 or n >= 2**31:
        raise ValueError(f"l2_argmin: {m} rows against {n} columns")
    if row_mask is not None:
        _check_mask("l2_argmin", row_mask, m)
    # idx and dmin, then from an 8-byte boundary the kernel's scratch
    out = torch.empty(2 * m + (l2_scratch_bytes(m) + 3) // 4, dtype=torch.int32,
                      device=dev)
    launch_l2_argmin(dev, a.data_ptr(), b.data_ptr(),
                     None if row_mask is None else row_mask.data_ptr(), m, n,
                     out.data_ptr(), out.data_ptr() + 4 * m,
                     out.data_ptr() + 8 * m)
    return out[:m], out[m:2 * m].view(torch.float32)


def launch_l2_argmin(dev: torch.device, a: int, b: int, row_mask: Optional[int],
                     m: int, n: int, idx: int, dmin: int, scratch: int) -> None:
    """Launch K13 on device addresses, counted on :func:`l2_argmin`: ``a``
    (m, 128) and ``b`` (n, 128) float32 (16-byte aligned), ``row_mask``
    (m,) bool or None, outputs ``idx`` (m,) int32 and ``dmin`` (m,)
    float32, ``scratch`` :func:`l2_scratch_bytes` (m) bytes, 8-byte
    aligned.  For callers that hold their inputs in a packed buffer; the
    checks of :func:`l2_argmin` are theirs to make."""
    lib = cuda_build.library("l2_match")
    counts = l2_filter_counts(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_l2_argmin(a, row_mask, m, b, n, L2_FILTER_REL_ERR, idx, dmin, scratch,
                                  counts.data_ptr(), stream)
    cuda_build.check(rc, "l2_argmin")
    l2_argmin.launches += 1


l2_argmin.launches = 0


def l2_ratio_match_plain(a, a_mask, b, b_mask, seg: int, max_dist: float,
                         ratio: float):
    """Plain version of :func:`l2_ratio_match` (any device): the square
    root of :func:`l2_distance_sq`, masked entries 2^30, then :func:`knn2`
    and the gates of :func:`match_ratio` on each segment of ``seg``
    columns."""
    dist = masked_dist(linalg.sqrt_rn(l2_distance_sq(a, b)), a_mask, b_mask)
    out = []
    for j in range(b.shape[0] // seg):
        idx, d1, d2 = knn2(dist[:, j * seg:(j + 1) * seg])
        out.append((torch.where(_ratio_gate(d1, d2, max_dist, ratio), idx, -1),
                    d1, d2))
    return tuple(torch.stack(x, dim=1) for x in zip(*out))


def l2_ratio_match(a: torch.Tensor, a_mask: torch.Tensor, b: torch.Tensor,
                   b_mask: torch.Tensor, seg: int, max_dist: float, ratio: float):
    """COVINS-G image matching of (M, 128) float32 (SIFT) descriptors
    ``a`` against each of the ``N / seg`` segments of ``seg`` columns of
    ``b``, as :func:`hamming_ratio_match` does for ORB: per row and
    segment the nearest and second-nearest valid column by L2 distance
    (the square root of :func:`l2_distance_sq`; ties to the lowest column;
    a masked row or column counts as distance 2^30) and the match where
    ``d1 < max_dist`` and ``d1 < ratio * d2``, both in float32.  Returns
    ``(idx (M, N / seg) int32, -1 = no match; d1, d2 (M, N / seg)
    float32)``.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (K14: K13's filter over valid pairs only, a top 2 of exact
    keys per row and segment, no distance matrix) or raise."""
    if all(is_cpu(t) for t in (a, a_mask, b, b_mask)):
        return l2_ratio_match_plain(a, a_mask, b, b_mask, seg, max_dist, ratio)
    dev = check_cuda("l2_ratio_match", a, a_mask, b, b_mask)
    _check_f32("l2_ratio_match a", a)
    _check_f32("l2_ratio_match b", b)
    m, n = a.shape[0], b.shape[0]
    _check_mask("l2_ratio_match a", a_mask, m)
    _check_mask("l2_ratio_match b", b_mask, n)
    if seg < 2 or n % seg or n >= 2**31 or m >= 2**30:
        raise ValueError(f"l2_ratio_match: {n} columns in segments of {seg} "
                         "(a top 2 needs two columns a segment)")
    S = n // seg
    # the outputs (index, d1 and d2 bits), then from an 8-byte boundary the
    # kernel's scratch
    at = (3 * m * S + 1) // 2 * 2
    buf = torch.empty(at + (l2_scratch_bytes(m, S) + 3) // 4, dtype=torch.int32,
                      device=dev)
    out = buf[:3 * m * S].view(3, m, S)
    lib = cuda_build.library("l2_match")
    counts = l2_filter_counts(dev)
    with torch.cuda.device(dev):
        rc = lib.covins_l2_ratio_match(
            a.data_ptr(), a_mask.data_ptr(), m, b.data_ptr(), b_mask.data_ptr(), n, seg,
            float(max_dist), float(ratio), L2_FILTER_REL_ERR, buf.data_ptr(),
            buf.data_ptr() + 4 * at, counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "l2_ratio_match")
    l2_ratio_match.launches += 1
    return out[0], out[1].view(torch.float32), out[2].view(torch.float32)


l2_ratio_match.launches = 0
