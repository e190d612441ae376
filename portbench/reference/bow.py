"""The retrieval database worked out again: each keyframe's words (the
nearest vocabulary word by Hamming distance, ties to the lowest word), its
L2-normalised term-frequency vector, the cosine scores against the rows
inserted before it and the counts of words in common."""

from __future__ import annotations

import numpy as np
import torch


def _pm1(u8: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(7, -1, -1, device=u8.device, dtype=torch.uint8)
    bits = (u8[:, :, None] >> shifts) & 1
    return bits.reshape(u8.shape[0], -1).to(torch.float32) * 2.0 - 1.0


def words(descs: np.ndarray, vocab: torch.Tensor) -> torch.Tensor:
    """(N,) word ids.  The +-1 products are exact integers in float32 with
    TF32 off."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a = _pm1(torch.from_numpy(np.ascontiguousarray(descs)).to(vocab.device))
        return torch.argmin(-(a @ _pm1(vocab).T), dim=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def vectors(word_lists, n_words: int, dtype, device) -> torch.Tensor:
    """(K, V) normalised term frequencies in ``dtype``."""
    out = torch.zeros((len(word_lists), n_words), dtype=torch.float64, device=device)
    for i, w in enumerate(word_lists):
        out[i].index_add_(0, w, torch.ones(len(w), dtype=torch.float64, device=device))
    out = out.to(dtype)
    norm = torch.sqrt((out * out).sum(1, keepdim=True))
    return out / torch.clamp(norm, min=torch.finfo(dtype).tiny)


def scores(rows: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return rows @ v


def common(rows: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return ((rows > 0) & (v > 0)[None, :]).sum(1)
