"""Place-recognition retrieval: binary vocabulary + BoW vectors + scoring.

Counterpart of `covins_tpu/ops/bow.py`: a flat vocabulary of K binary word
centres (Hamming k-medians), word assignment as a Hamming argmin (the K1
kernel, `ops/descriptors.hamming_argmin`), L2-normalised term-frequency
vectors, cosine scores as one product against the database matrix, and a
binarised product for the common-words gate.

:func:`bow_insert` is the K3 kernel (`csrc/bow_insert.cu`): the window's
BoW vectors, written into the database rows in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, is_cpu
from covins_tpu_torch.ops import descriptors as desc
from covins_tpu_torch.ops import linalg


def train_vocabulary(descs_u8: torch.Tensor, k: int = 1024, iters: int = 8,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Hamming k-medians over (n, B) uint8 descriptors -> (k, B) words.

    The centre update is a bitwise majority vote; empty clusters keep their
    old centre.  The initial centres are drawn with ``generator`` (on the
    descriptors' device); the draws differ from the JAX package's, so tests
    hand the reference's vocabulary in instead of comparing draws.
    """
    n = descs_u8.shape[0]
    dev = descs_u8.device
    if n >= k:
        init = torch.randperm(n, generator=generator, device=dev)[:k]
    else:
        init = torch.randint(0, n, (k,), generator=generator, device=dev)
    return kmedians(descs_u8, descs_u8[init], iters)


def kmedians(descs_u8: torch.Tensor, centers: torch.Tensor,
             iters: int) -> torch.Tensor:
    """``iters`` Hamming k-medians steps from the given (k, B) centres."""
    n, k, dev = descs_u8.shape[0], centers.shape[0], descs_u8.device
    descs_u8 = descs_u8.contiguous()
    centers = centers.contiguous()
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)  # MSB first
    bits = ((descs_u8[..., None] >> shifts) & 1).reshape(n, -1).float()
    weights = (2 ** torch.arange(7, -1, -1, device=dev)).to(torch.int32)
    for _ in range(iters):
        assign, _ = desc.hamming_argmin(descs_u8, centers)
        assign = assign.long()
        counts = torch.zeros(k, device=dev).index_add_(
            0, assign, torch.ones(n, device=dev))
        bit_sums = torch.zeros((k, bits.shape[1]), device=dev).index_add_(
            0, assign, bits)
        maj = (bit_sums > 0.5 * counts[:, None]).to(torch.int32)
        packed = (maj.reshape(k, -1, 8) * weights).sum(-1).to(torch.uint8)
        centers = torch.where(counts[:, None] > 0, packed, centers).contiguous()
    return centers


def assign_words(descs_u8: torch.Tensor, vocab_u8: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, B) descriptors -> (N,) int32 word ids; masked rows get -1."""
    words, _ = desc.hamming_argmin(descs_u8.contiguous(), vocab_u8, mask)
    return words


def bow_vector(word_ids: torch.Tensor, k: int,
               idf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Word ids (N,) (-1 = invalid) -> L2-normalised tf(-idf) vector (k,)."""
    return bow_vectors_batch(word_ids[None], k, idf)[0]


def bow_vectors_batch(word_ids: torch.Tensor, k: int,
                      idf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N) word ids -> (B, k) normalised vectors (plain version of the
    histogram part of K3).  The norm is sqrt of the float32 sum of squares,
    as the reference computes it."""
    valid = word_ids >= 0
    counts = torch.zeros((word_ids.shape[0], k), dtype=torch.float32,
                         device=word_ids.device)
    counts.scatter_add_(1, torch.where(valid, word_ids, 0).long(),
                        valid.float())
    v = counts if idf is None else counts * idf
    n = linalg.sqrt_rn((v * v).sum(-1, keepdim=True))
    return v / torch.clamp(n, min=1e-12)


def bow_insert_plain(words: torch.Tensor, dest: torch.Tensor,
                     db: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bow_insert`: vectors, then the in-place row
    scatter that drops destinations outside [0, cap)."""
    cap, v = db.shape
    valid = (words >= 0) & (words < v)
    vecs = bow_vectors_batch(torch.where(valid, words, -1), v)
    keep = (dest >= 0) & (dest < cap)
    db[dest[keep]] = vecs[keep]
    return vecs


def bow_insert(words: torch.Tensor, dest: torch.Tensor,
               db: torch.Tensor) -> torch.Tensor:
    """(W, F) int32 word ids (-1 = invalid) -> (W, V) float32 BoW vectors,
    each also written in place into ``db[dest[i]]`` (``db`` is (cap, V)
    float32) when ``0 <= dest[i] < cap``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (K3) or raise."""
    if is_cpu(words) and is_cpu(dest) and is_cpu(db):
        return bow_insert_plain(words, dest, db)
    dev = check_cuda("bow_insert", words, dest, db)
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError("bow_insert: words must be (W, F) int32")
    w, f = words.shape
    if dest.dtype != torch.int64 or dest.shape != (w,):
        raise ValueError(f"bow_insert: dest must be ({w},) int64")
    if db.dtype != torch.float32 or db.dim() != 2:
        raise ValueError("bow_insert: db must be (cap, V) float32")
    cap, v = db.shape
    if v * 4 > 200 * 1024:
        raise ValueError(f"bow_insert: vocabulary of {v} words does not fit "
                         "one block's shared memory")
    for name, t in (("words", words), ("dest", dest), ("db", db)):
        if not t.is_contiguous():
            raise ValueError(f"bow_insert: {name} must be contiguous")
    vecs = torch.empty((w, v), dtype=torch.float32, device=dev)
    lib = cuda_build.library("bow_insert")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_bow_insert(words.data_ptr(), dest.data_ptr(),
                                   db.data_ptr(), vecs.data_ptr(), w, f, v,
                                   cap, stream)
    cuda_build.check(rc, "bow_insert")
    bow_insert.launches += 1
    return vecs


bow_insert.launches = 0


def retrieval_scores(query_bow: torch.Tensor, db_bow: torch.Tensor,
                     db_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cosine scores of one (K,) query against (N, K) rows; masked -> -1."""
    s = db_bow @ query_bow
    if db_mask is not None:
        s = torch.where(db_mask, s, torch.full_like(s, -1.0))
    return s


def common_words(query_bow: torch.Tensor, db_bow: torch.Tensor) -> torch.Tensor:
    """Number of vocabulary words shared by the query and each row."""
    return ((db_bow > 0) & (query_bow[None, :] > 0)).sum(-1)


def topk_candidates(scores: torch.Tensor, k: int):
    """Top-k retrieval: (scores_k, idx_k) sorted descending."""
    return torch.topk(scores, k)
