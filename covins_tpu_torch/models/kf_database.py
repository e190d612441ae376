"""Keyframe retrieval database: device-resident BoW matrix + batched scoring.

Counterpart of `covins_tpu/models/kf_database.py`.  The database is one
dense (cap, V) float32 matrix of L2-normalised term-frequency rows, kept
on the device and grown by capacity doubling.  The vocabulary's dtype
selects the metric: (V, 32) uint8 words are matched by Hamming distance
(ORB), (V, 128) float32 centres by L2 distance (SIFT).  A window of
keyframes is inserted and scored in one pass (:func:`insert_and_score`):
its descriptors, feature mask and destination rows go to the device in
one packed upload (:func:`window_layout`), then two launches: word
assignment (K1 for Hamming, K13 for L2) and the rest (K3: BoW vectors
written into their rows in place, then cosine scores and common-word
counts against the rows after the insertion, packed into one (W, 2, n)
result).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from covins_tpu_torch.device import (DeviceLike, check_cuda, check_tensor, is_cpu,
                                     resolve_device)
from covins_tpu_torch.ops import bow as bow_ops
from covins_tpu_torch.ops import descriptors as d_ops


# a descriptor's bytes under each metric: 32 uint8 (ORB), 128 float32 (SIFT)
DESC_BYTES = {"hamming": d_ops.ORB_BYTES, "l2": 4 * d_ops.SIFT_DIMS}


def window_layout(w: int, f: int, desc_bytes: int = d_ops.ORB_BYTES):
    """Byte offsets of a window's packed input: the (W, F) descriptors of
    ``desc_bytes`` bytes each (32 uint8 or 128 float32), the (W, F)
    feature mask as bytes, then from an 8-byte boundary the (W,) int64
    destination rows.  Returns (mask's offset, destinations' offset, total
    bytes)."""
    mask_at = w * f * desc_bytes
    dest_at = (mask_at + w * f + 7) // 8 * 8
    return mask_at, dest_at, dest_at + 8 * w


def window_views(buf, w: int, f: int, desc_bytes: int = d_ops.ORB_BYTES):
    """The three inputs as views of a packed input ``buf`` (a 1-D uint8
    numpy array or tensor): descs (W, F, 32) uint8 or, at 512 bytes a
    descriptor, (W, F, 128) float32; feat_mask (W, F) bool and dest (W,)
    int64."""
    mask_at, dest_at, total = window_layout(w, f, desc_bytes)
    if isinstance(buf, np.ndarray):
        f32, b8, i64 = np.float32, np.bool_, np.int64
    else:
        f32, b8, i64 = torch.float32, torch.bool, torch.int64
    descs = buf[:mask_at].reshape(w, f, desc_bytes)
    if desc_bytes == DESC_BYTES["l2"]:
        descs = descs.view(f32)
    return (descs, buf[mask_at:mask_at + w * f].reshape(w, f).view(b8),
            buf[dest_at:total].view(i64))


def insert_and_score(db: torch.Tensor, vocab: torch.Tensor,
                     packed: torch.Tensor, w: int, f: int, n: int) -> torch.Tensor:
    """Insert a WINDOW of keyframes and score each against the database.

    Args:
      db: (cap, V) float32 database, UPDATED IN PLACE (the JAX version
        donates it and returns the new buffer).
      vocab: (V, 32) uint8 words (Hamming) or (V, 128) float32 centres
        (L2).
      packed: the window's packed input on ``db``'s device
        (:func:`window_layout`): (W, F) padded descriptors of the
        vocabulary's kind, the (W, F) feature mask and the (W,) int64
        destination rows; entries outside [0, cap) are dropped, those
        inside are distinct.
      n: the rows [0, n) scored, after the insertion.
    Returns ``out`` (W, 2, n) float32: ``out[:, 0]`` the scores,
    ``out[:, 1]`` the common-word counts as int32 bit patterns; sequential
    query semantics are restored by the caller's ``valid`` masks.  On the
    card: two launches (K1 or K13, then K3) reading the packed input in
    place, and two PyTorch operations (the scratch and the result).
    """
    cap, v = db.shape
    metric = "hamming" if vocab.dtype == torch.uint8 else "l2"
    desc_bytes = DESC_BYTES[metric]
    if is_cpu(packed):
        descs, feat_mask, dest = window_views(packed, w, f, desc_bytes)
        argmin = d_ops.hamming_argmin if metric == "hamming" else d_ops.l2_argmin
        words, _ = argmin(descs.reshape(w * f, -1), vocab, feat_mask.reshape(-1))
        return bow_ops.bow_insert_score(words.reshape(w, f), dest, db, n)[1]
    dev = check_cuda("insert_and_score", db, vocab, packed)
    mask_at, dest_at, total = window_layout(w, f, desc_bytes)
    check_tensor("insert_and_score", "packed", packed, (total,), torch.uint8)
    if metric == "hamming":
        check_tensor("insert_and_score", "vocab", vocab, (v, d_ops.ORB_BYTES), torch.uint8)
    else:
        d_ops._check_f32("insert_and_score vocab", vocab)
    check_tensor("insert_and_score", "db", db, (cap, v), torch.float32)
    if not 0 <= n <= cap:
        raise ValueError(f"insert_and_score: {n} rows to score of {cap}")
    if v > bow_ops.MAX_VOCABULARY:
        raise ValueError(f"insert_and_score: vocabulary of {v} words does not fit "
                         "one block's shared memory")
    base = packed.data_ptr()
    # the word ids and distances, K3's vectors (int32 and float32 share
    # one allocation), then from an 8-byte boundary K13's scratch
    at = (w * (2 * f + v) + 1) // 2 * 2
    extra = (d_ops.l2_scratch_bytes(w * f) + 3) // 4 if metric == "l2" else 0
    scratch = torch.empty(at + extra, dtype=torch.int32, device=dev)
    out = torch.empty((w, 2, n), dtype=torch.float32, device=dev)
    words = scratch.data_ptr()
    if metric == "hamming":
        d_ops.launch_argmin(dev, base, vocab.data_ptr(), base + mask_at, w * f, v,
                            words, words + 4 * w * f)
    else:
        d_ops.launch_l2_argmin(dev, base, vocab.data_ptr(), base + mask_at, w * f, v,
                               words, words + 4 * w * f, words + 4 * at)
    bow_ops.launch_insert_score(dev, words, base + dest_at, db.data_ptr(),
                                words + 8 * w * f, out.data_ptr(), w, f, v, cap, n)
    return out


class KeyframeDatabase:
    """Append-only BoW database over all keyframes of all maps."""

    def __init__(self, vocabulary: np.ndarray, capacity: int = 1024,
                 device: DeviceLike = None):
        """``vocabulary``: (V, 32) uint8 binary words (ORB) or (V, 128)
        float32 centres (SIFT mode, ``feat.type: SIFT``); its dtype selects
        the metric, as the reference's does."""
        vocabulary = np.ascontiguousarray(vocabulary)
        if vocabulary.dtype == np.uint8:
            self.metric = "hamming"
        elif vocabulary.dtype == np.float32 and vocabulary.shape[1:] == (d_ops.SIFT_DIMS,):
            self.metric = "l2"
        else:
            raise ValueError(f"expected a (V, {d_ops.ORB_BYTES}) uint8 or (V, "
                             f"{d_ops.SIFT_DIMS}) float32 vocabulary, got "
                             f"{vocabulary.shape} {vocabulary.dtype}")
        self.device = resolve_device(device)
        self.vocab = torch.tensor(vocabulary, device=self.device)
        self.k_words = vocabulary.shape[0]
        self._db = torch.zeros((capacity, self.k_words), dtype=torch.float32,
                               device=self.device)
        self._mask = np.zeros(capacity, bool)
        self.n = 0
        # row -> (kf_id, client_id), as a dict for id lookups and as flat
        # arrays for vectorised exclusion masks
        self.row_ids: list[tuple[int, int]] = []
        self.row_of: dict[tuple, int] = {}
        self.row_kf = np.full(capacity, -1, np.int64)
        self.row_client = np.full(capacity, -1, np.int64)

    @property
    def db(self) -> torch.Tensor:
        return self._db

    def _ensure(self, n):
        cap = self._db.shape[0]
        if n <= cap:
            return
        new_cap = max(2 * cap, n)
        db = torch.zeros((new_cap, self.k_words), dtype=torch.float32,
                         device=self.device)
        db[:cap] = self._db
        self._db = db
        for name in ("_mask", "row_kf", "row_client"):
            old = getattr(self, name)
            new = np.full(new_cap, -1, old.dtype) if old.dtype == np.int64 \
                else np.zeros(new_cap, old.dtype)
            new[:cap] = old
            setattr(self, name, new)

    def bow_vector(self, descriptors: np.ndarray) -> torch.Tensor:
        if self.metric == "hamming":
            d = torch.from_numpy(np.ascontiguousarray(descriptors)).to(self.device)
            words = bow_ops.assign_words(d, self.vocab)
        else:
            d = torch.from_numpy(np.ascontiguousarray(descriptors, np.float32))
            words = bow_ops.assign_words_l2(d.to(self.device), self.vocab)
        return bow_ops.bow_vector(words, self.k_words)

    def add_keyframe(self, kf_id: tuple, descriptors: np.ndarray) -> int:
        """`MapManager::AddToDatabase` (`map_be.cpp:68-107`)."""
        kf_id = tuple(int(x) for x in kf_id)
        existing = self.row_of.get(kf_id, -1)
        if existing >= 0:
            return existing
        row = self.n
        self._ensure(row + 1)
        self._db[row] = self.bow_vector(descriptors)
        self._mask[row] = True
        self.row_ids.append(kf_id)
        self.row_of[kf_id] = row
        self.row_kf[row] = kf_id[0]
        self.row_client[row] = kf_id[1]
        self.n = row + 1
        return row

    def erase(self, row: int):
        self._mask[row] = False

    def erase_id(self, kf_id: tuple) -> bool:
        """`MapManager::EraseFromDatabase` (`map_be.cpp:169-177`)."""
        row = self.row_of.pop(tuple(int(x) for x in kf_id), -1)
        if row < 0:
            return False
        self._mask[row] = False
        return True

    def add_and_query_batch(self, kf_ids: list, descs_list: list,
                            lazy: bool = False):
        """Insert a window of keyframes in one pass and return per-query RAW
        retrieval data with sequential-query semantics.

        Returns a list of dicts (parallel to inputs): ``row`` (database
        row), ``scores`` (n,) float32, ``common`` (n,) int32 and ``valid``
        (n,) bool (live rows inserted BEFORE this query).  Already-present
        ids are scored in place without re-insertion.  With ``lazy`` the
        scores stay on the device as tensors (no host sync); the caller
        fetches them later.
        """
        w = len(kf_ids)
        if w == 0:
            return []
        kf_ids = [tuple(int(x) for x in k) for k in kf_ids]
        rows = np.full(w, -1, np.int64)
        fresh = []
        for i, kid in enumerate(kf_ids):
            existing = self.row_of.get(kid, -1)
            if existing >= 0:
                rows[i] = existing
            else:
                rows[i] = self.n + len(fresh)
                fresh.append(i)
        n_after = self.n + len(fresh)
        self._ensure(n_after)
        cap = self._db.shape[0]

        f = max(int(d.shape[0]) for d in descs_list)
        dev = self.device
        desc_bytes = DESC_BYTES[self.metric]
        buf = torch.empty(window_layout(w, f, desc_bytes)[2], dtype=torch.uint8,
                          pin_memory=dev.type == "cuda")
        host = buf.numpy()
        host[:] = 0
        descs, feat_mask, dest = window_views(host, w, f, desc_bytes)
        dest[:] = cap  # cap => dropped by the insert
        for i in range(w):
            n = descs_list[i].shape[0]
            descs[i, :n] = descs_list[i]
            feat_mask[i, :n] = True
            if rows[i] >= self.n:  # fresh insertion
                dest[i] = rows[i]
        # one upload (pinned: it does not wait for the card; the caching
        # host allocator keeps the buffer until the copy has run)
        res = insert_and_score(self._db, self.vocab,
                               buf.to(dev, non_blocking=True), w, f, n_after)
        if lazy:
            scores, common = res.unbind(1)
            common = common.view(torch.int32)
        else:
            flat = res.cpu().numpy()  # one fetch
            scores, common = flat[:, 0], flat[:, 1].view(np.int32)

        for i in fresh:
            r = int(rows[i])
            self._mask[r] = True
            self.row_ids.append(kf_ids[i])
            self.row_of[kf_ids[i]] = r
            self.row_kf[r] = kf_ids[i][0]
            self.row_client[r] = kf_ids[i][1]
        self.n = n_after

        out = []
        live = self._mask[:n_after].copy()
        for i in range(w):
            valid = live.copy()
            valid[int(rows[i]):] = False  # sequential: only earlier rows
            out.append({"row": int(rows[i]), "scores": scores[i],
                        "common": common[i], "valid": valid})
        return out

    def query(self, descriptors: np.ndarray,
              exclude_rows: Optional[np.ndarray] = None,
              min_common_words_frac: float = 0.8):
        """Score one query against the whole database (`DetectCandidates`,
        `kf_database.cpp:47-187`): rows sharing fewer than 0.8 * max common
        words get -1.  Returns (scores, common) as numpy over live rows."""
        qv = self.bow_vector(descriptors)
        mask = torch.from_numpy(self._mask.copy())
        if exclude_rows is not None and len(exclude_rows):
            mask[torch.as_tensor(np.asarray(exclude_rows), dtype=torch.long)] = False
        mask = mask.to(self.device)
        scores = bow_ops.retrieval_scores(qv, self._db, mask)
        common = bow_ops.common_words(qv, self._db)
        max_common = torch.where(mask, common, 0).max()
        keep = common >= min_common_words_frac * max_common
        scores = torch.where(keep & mask, scores, torch.full_like(scores, -1.0))
        return (scores[: self.n].cpu().numpy(),
                common[: self.n].cpu().numpy())


def train_vocabulary_from_maps(descriptor_batches, k: int = 512, iters: int = 6,
                               generator: Optional[torch.Generator] = None,
                               idx=None, device: DeviceLike = None) -> np.ndarray:
    """Train a Hamming k-medians vocabulary from uint8 descriptor samples
    (`kf_database.py:267`) on ``device``: the samples concatenated, then
    `bow.train_vocabulary` from the initial words ``idx`` (drawn with
    ``generator`` when None)."""
    width = np.asarray(descriptor_batches[0]).shape[-1]
    descs = np.concatenate([np.asarray(d).reshape(-1, width) for d in descriptor_batches])
    dev = resolve_device(device)
    return bow_ops.train_vocabulary(torch.from_numpy(descs).to(dev), k=k, iters=iters,
                                    generator=generator, idx=idx).cpu().numpy()
