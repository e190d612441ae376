"""The retrieval vocabulary, trained from ``--seed`` by the benchmark's
own Hamming k-medians over the world's descriptors.

ORBvoc.txt is not in the repository; what the CLI makes of it is a flat
vocabulary of ``max(vocab_words, 1024)`` words, so the configuration states
the word count and this trains that many words.  Distances are exact
integers from a float32 product of +-1 bits (TF32 off), centres the
bitwise majority of their members (ties to 0), an empty cluster keeps its
centre.
"""

from __future__ import annotations

import numpy as np
import torch


def unpack_pm1(u8: torch.Tensor) -> torch.Tensor:
    """(N, B) uint8 -> (N, 8B) float32 +-1, most significant bit first."""
    shifts = torch.arange(7, -1, -1, device=u8.device, dtype=torch.uint8)
    bits = (u8[:, :, None] >> shifts) & 1
    return bits.reshape(u8.shape[0], -1).to(torch.float32) * 2.0 - 1.0


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 8B) {0, 1} -> (N, B) uint8, most significant bit first."""
    w = (2 ** torch.arange(7, -1, -1, device=bits.device)).to(torch.int32)
    return (bits.reshape(bits.shape[0], -1, 8).to(torch.int32) * w).sum(-1).to(torch.uint8)


def train(signatures: np.ndarray, n_words: int, seed: int, iters: int, device) -> np.ndarray:
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = torch.from_numpy(signatures).to(device)
        pm = unpack_pm1(x)
        g = torch.Generator(device="cpu").manual_seed(int(seed) % (2**63))
        start = torch.randperm(x.shape[0], generator=g)[:n_words].to(device)
        centres = pm[start].clone()
        nbits = pm.shape[1]
        for _ in range(iters):
            assign = torch.argmin(nbits - pm @ centres.T, dim=1)
            votes = torch.zeros_like(centres).index_add_(0, assign, pm)
            count = torch.bincount(assign, minlength=n_words)
            fresh = torch.where(votes > 0, 1.0, -1.0)
            centres = torch.where((count > 0)[:, None], fresh, centres)
        return pack_bits(centres > 0).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
