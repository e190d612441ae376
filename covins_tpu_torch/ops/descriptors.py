"""Binary-descriptor Hamming distances and the fused Hamming argmin.

Counterpart of `covins_tpu/ops/descriptors.py`.  The JAX package computes
Hamming distance as an unpack-to-±1 matmul (`hamming_distance`), exact
because the products are ±1 and the sums stay far below 2^24.  The port
keeps that as its plain version and adds two CUDA kernels: the fused
distance + row argmin that retrieval needs, :func:`hamming_argmin` (K1,
`csrc/hamming_argmin.cu`), and the masked mutual-nearest-neighbour match
of loop verification's stage 1, :func:`hamming_mutual_nn` (K4,
`csrc/hamming_mutual_nn.cu`).  The ratio matchers (`knn2`, `match_ratio`,
`match_mutual_nn_ratio`) belong to the COVINS-G part of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, is_cpu

ORB_BYTES = 32  # 256-bit ORB/BRIEF descriptors (config: feat.desc_length)

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


def hamming_argmin(a_u8: torch.Tensor, b_u8: torch.Tensor,
                   row_mask: Optional[torch.Tensor] = None,
                   want_dist: bool = False
                   ) -> Tuple[torch.Tensor, ...]:
    """Row argmin of the Hamming distance between (M, 32) and (N, 32)
    uint8 descriptors.

    Returns ``idx (M,) int32`` (lowest index on ties, -1 where ``row_mask``
    is False), ``dmin (M,) int32`` and, with ``want_dist``, the full
    ``(M, N) int32`` distance matrix.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (K1) or raise.
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
    if m * n >= 2**62 or max(m, n) >= 2**30:
        raise ValueError("hamming_argmin: shape too large")
    idx = torch.empty(m, dtype=torch.int32, device=dev)
    dmin = torch.empty(m, dtype=torch.int32, device=dev)
    dist = (torch.empty((m, n), dtype=torch.int32, device=dev)
            if want_dist else None)
    lib = cuda_build.library("hamming_argmin")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_hamming_argmin(
            a_u8.data_ptr(), b_u8.data_ptr(),
            None if row_mask is None else row_mask.data_ptr(), m, n,
            idx.data_ptr(), dmin.data_ptr(),
            None if dist is None else dist.data_ptr(), stream)
    cuda_build.check(rc, "hamming_argmin")
    hamming_argmin.launches += 1
    return (idx, dmin, dist) if want_dist else (idx, dmin)


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
    version; CUDA tensors launch the kernel (K4) or raise."""
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
    i32 = dict(dtype=torch.int32, device=dev)
    fwd, dfwd, idx = (torch.empty(m, **i32) for _ in range(3))
    bwd, dbwd = torch.empty(n, **i32), torch.empty(n, **i32)
    lib = cuda_build.library("hamming_mutual_nn")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_hamming_mutual_nn(
            a_u8.data_ptr(), a_mask.data_ptr(), m, b_u8.data_ptr(),
            b_mask.data_ptr(), n, float(max_dist), fwd.data_ptr(),
            dfwd.data_ptr(), bwd.data_ptr(), dbwd.data_ptr(), idx.data_ptr(),
            stream)
    cuda_build.check(rc, "hamming_mutual_nn")
    hamming_mutual_nn.launches += 1
    return idx


hamming_mutual_nn.launches = 0
