"""Place-recognition retrieval: vocabulary + BoW vectors + scoring.

Counterpart of `covins_tpu/ops/bow.py`: a flat vocabulary of K word
centres, binary for ORB (Hamming k-medians, word assignment as a Hamming
argmin, the K1 kernel `ops/descriptors.hamming_argmin`) or float32 for
SIFT (k-means, word assignment as an L2 argmin, the K13 kernel
`ops/descriptors.l2_argmin`), L2-normalised term-frequency vectors, cosine
scores as one product against the database matrix, and a binarised
product for the common-words gate.

:func:`bow_insert_score` is the K3 kernel (`csrc/bow_insert_score.cu`): a
window's BoW vectors, written into their database rows in place, and each
vector's scores and common-word counts against the database rows after
the insertion, in one launch.  :func:`bow_insert` is its first half.
"""

from __future__ import annotations

from typing import Optional

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, is_cpu
from covins_tpu_torch.ops import descriptors as desc
from covins_tpu_torch.ops import linalg


def _initial_centres(n: int, k: int, generator, idx, dev) -> torch.Tensor:
    if idx is not None:
        return torch.as_tensor(idx, device=dev).long()
    if n >= k:
        return torch.randperm(n, generator=generator, device=dev)[:k]
    return torch.randint(0, n, (k,), generator=generator, device=dev)


def train_vocabulary(descs_u8: torch.Tensor, k: int = 1024, iters: int = 8,
                     generator: Optional[torch.Generator] = None,
                     idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hamming k-medians over (n, B) uint8 descriptors -> (k, B) words.

    The centre update is a bitwise majority vote; empty clusters keep their
    old centre.  The initial centres are ``descs_u8[idx]``, drawn with
    ``generator`` (on the descriptors' device) when ``idx`` is None; the
    draws differ from the JAX package's, so tests hand its draw in as
    ``idx`` or its vocabulary instead.
    """
    init = _initial_centres(descs_u8.shape[0], k, generator, idx, descs_u8.device)
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


def train_vocabulary_l2(descs: torch.Tensor, k: int = 1024, iters: int = 8,
                        generator: Optional[torch.Generator] = None,
                        idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k-means over (n, 128) float32 (SIFT) descriptors -> (k, 128) words
    (`bow.py:68`, feat.type SIFT).  Each step assigns every descriptor to
    its nearest centre (K13 on a card), then a centre becomes the mean of
    its descriptors, summed as the reference sums them (``one_hot.T @
    descs``, no atomics); an empty cluster keeps its centre.  The initial
    centres are ``descs[idx]``, drawn with ``generator`` when ``idx`` is
    None (without replacement when n >= k); the draws differ from the JAX
    package's, so tests hand its draw in as ``idx``."""
    descs = descs.contiguous()
    init = _initial_centres(descs.shape[0], k, generator, idx, descs.device)
    centers = descs[init].contiguous()
    for _ in range(iters):
        assign, _ = desc.l2_argmin(descs, centers)
        one_hot = torch.nn.functional.one_hot(assign.long(), k).to(descs.dtype)
        counts = one_hot.sum(0)
        new = (one_hot.t() @ descs) / torch.clamp(counts[:, None], min=1.0)
        centers = torch.where(counts[:, None] > 0, new, centers).contiguous()
    return centers


def assign_words_l2(descs: torch.Tensor, vocab: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 128) float32 descriptors -> (N,) int32 word ids by L2 argmin
    (K13); masked rows get -1."""
    words, _ = desc.l2_argmin(descs.contiguous(), vocab, mask)
    return words


def compute_idf(db_bow_binary: torch.Tensor, db_mask: torch.Tensor) -> torch.Tensor:
    """idf weights from the database: log(N / (1 + df) + 1), N the live
    rows (at least 1) and df each word's live rows (`bow.py:114`)."""
    n = torch.clamp(db_mask.sum().to(db_bow_binary.dtype), min=1.0)
    df = (db_bow_binary * db_mask[:, None]).sum(0)
    return torch.log(n / (1.0 + df) + 1.0)


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


def ordered_scores(vecs: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(W, V) x (n, V) -> (W, n) float32 dot products summed in K3's order:
    both zero-padded to a multiple of 32, lane l's products over v = l,
    l + 32, ... added chunk after chunk, then the 32 lanes added by an
    xor butterfly 16, 8, 4, 2, 1, each product and sum a separate
    rounding."""
    (w, v), n = vecs.shape, rows.shape[0]
    vp = -(-v // 32) * 32
    q = torch.nn.functional.pad(vecs, (0, vp - v)).reshape(w, 1, vp // 32, 32)
    r = torch.nn.functional.pad(rows, (0, vp - v)).reshape(1, n, vp // 32, 32)
    acc = torch.zeros((w, n, 32), dtype=vecs.dtype, device=vecs.device)
    for c in range(vp // 32):
        acc = acc + q[:, :, c] * r[:, :, c]
    lanes = torch.arange(32, device=vecs.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ off]
    return acc[..., 0]


def bow_insert_score_plain(words: torch.Tensor, dest: torch.Tensor,
                           db: torch.Tensor, n: int):
    """Plain version of :func:`bow_insert_score`: :func:`bow_insert_plain`,
    then the scores in K3's order (:func:`ordered_scores`) and the
    common-word counts against ``db[:n]`` after the insertion."""
    vecs = bow_insert_plain(words, dest, db)
    rows = db[:n]
    out = torch.empty((vecs.shape[0], 2, n), dtype=torch.float32, device=db.device)
    out[:, 0] = ordered_scores(vecs, rows)
    common = ((vecs[:, None] > 0) & (rows[None] > 0)).sum(-1, dtype=torch.int32)
    out[:, 1] = common.view(torch.float32)
    return vecs, out


# shared memory a K3 block gives the window vectors it scores at once: at
# V = 512, 32 window rows a group
GROUP_BYTES = 64 * 1024
MAX_VOCABULARY = 200 * 1024 // 4  # one row's counts in one block's shared memory


def score_group(w: int, v: int) -> int:
    """Window rows K3 holds in shared memory at once (at least one)."""
    return max(1, min(w, GROUP_BYTES // (-(-v // 32) * 32 * 4)))


def _run_insert_score(dev, words, dest, db, vecs, out, w, f, v, cap, n):
    lib = cuda_build.library("bow_insert_score")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_bow_insert_score(words, dest, db, vecs, out, w, f, v, cap, n,
                                         score_group(w, v), stream)
    cuda_build.check(rc, "bow_insert_score")


def launch_insert_score(dev: torch.device, words: int, dest: int, db: int,
                        vecs: int, out: int, w: int, f: int, v: int, cap: int,
                        n: int) -> None:
    """Launch K3 on device addresses, counted on :func:`bow_insert_score`:
    ``words`` (w, f) int32, ``dest`` (w,) int64 with distinct entries
    inside [0, cap), ``db`` (cap, v) float32 updated in place, outputs
    ``vecs`` (w, v) float32 and ``out`` (w, 2, n) float32; n <= cap and
    v <= MAX_VOCABULARY.  For callers that hold their inputs in a packed
    buffer; the checks of :func:`bow_insert_score` are theirs to make."""
    _run_insert_score(dev, words, dest, db, vecs, out, w, f, v, cap, n)
    bow_insert_score.launches += 1


def _check_insert(name, words, dest, db):
    dev = check_cuda(name, words, dest, db)
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"{name}: words must be (W, F) int32")
    w = words.shape[0]
    if dest.dtype != torch.int64 or dest.shape != (w,):
        raise ValueError(f"{name}: dest must be ({w},) int64")
    if db.dtype != torch.float32 or db.dim() != 2:
        raise ValueError(f"{name}: db must be (cap, V) float32")
    if db.shape[1] > MAX_VOCABULARY:
        raise ValueError(f"{name}: vocabulary of {db.shape[1]} words does not fit "
                         "one block's shared memory")
    for what, t in (("words", words), ("dest", dest), ("db", db)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    return dev


def bow_insert(words: torch.Tensor, dest: torch.Tensor,
               db: torch.Tensor) -> torch.Tensor:
    """(W, F) int32 word ids (-1 = invalid) -> (W, V) float32 BoW vectors,
    each also written in place into ``db[dest[i]]`` (``db`` is (cap, V)
    float32) when ``0 <= dest[i] < cap``.  CPU tensors take the plain
    version; CUDA tensors launch K3 with no rows to score, or raise."""
    if is_cpu(words) and is_cpu(dest) and is_cpu(db):
        return bow_insert_plain(words, dest, db)
    dev = _check_insert("bow_insert", words, dest, db)
    (w, f), (cap, v) = words.shape, db.shape
    vecs = torch.empty((w, v), dtype=torch.float32, device=dev)
    _run_insert_score(dev, words.data_ptr(), dest.data_ptr(), db.data_ptr(),
                      vecs.data_ptr(), None, w, f, v, cap, 0)
    bow_insert.launches += 1
    return vecs


bow_insert.launches = 0


def bow_insert_score(words: torch.Tensor, dest: torch.Tensor,
                     db: torch.Tensor, n: int):
    """:func:`bow_insert`, then each window row's cosine scores and
    common-word counts against the database rows [0, n) after the
    insertion.  ``dest``'s entries inside [0, cap) must be distinct.
    Returns ``(vecs (W, V) float32, out (W, 2, n) float32)``: ``out[:, 0]``
    the scores, ``out[:, 1]`` the counts as int32 bit patterns
    (``out[:, 1].view(torch.int32)``).  CPU tensors take the plain version;
    CUDA tensors launch the kernel (K3, one launch) or raise."""
    if is_cpu(words) and is_cpu(dest) and is_cpu(db):
        return bow_insert_score_plain(words, dest, db, n)
    dev = _check_insert("bow_insert_score", words, dest, db)
    (w, f), (cap, v) = words.shape, db.shape
    if not 0 <= n <= cap:
        raise ValueError(f"bow_insert_score: n must lie in [0, {cap}], got {n}")
    vecs = torch.empty((w, v), dtype=torch.float32, device=dev)
    out = torch.empty((w, 2, n), dtype=torch.float32, device=dev)
    launch_insert_score(dev, words.data_ptr(), dest.data_ptr(), db.data_ptr(),
                        vecs.data_ptr(), out.data_ptr(), w, f, v, cap, n)
    return vecs, out


bow_insert_score.launches = 0


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
