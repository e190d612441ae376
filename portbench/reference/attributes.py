"""The landmark-attribute refresh worked out again for a cohort, from the
cohort's gathered observation window (positions, observing camera centres,
octaves, descriptors, mask): the representative descriptor (the
observation whose lower-median Hamming distance to the landmark's valid
observations is least, ties to the first), the normal (the normalised mean
of the unit directions from the landmark to the cameras) and the distance
range (the mean of distance x 1.2^octave, and that over 1.2^7)."""

from __future__ import annotations

import numpy as np
import torch

DESC_BYTES = 32


def layout(L: int, P: int):
    """Byte offsets of a packed cohort: float64 positions (L, 3), centres
    (L, P, 3) and octaves (L, P); from a 16-byte boundary the (L, P, 32)
    descriptors; then the (L, P) mask.  Outputs: (L, 5) float64 (normal,
    min, max) then (L, 32) descriptors."""
    n_f64 = L * (3 + 4 * P)
    desc_at = (8 * n_f64 + 15) // 16 * 16
    mask_at = desc_at + DESC_BYTES * L * P
    return n_f64, desc_at, mask_at, mask_at + L * P


def unpack_input(buf: np.ndarray, L: int, P: int):
    n_f64, desc_at, mask_at, total = layout(L, P)
    f64 = buf[: 8 * n_f64].view(np.float64)
    return (f64[: 3 * L].reshape(L, 3), f64[3 * L: 3 * L * (1 + P)].reshape(L, P, 3),
            f64[3 * L * (1 + P):].reshape(L, P),
            buf[desc_at:mask_at].reshape(L, P, DESC_BYTES),
            buf[mask_at:total].reshape(L, P).view(np.bool_))


def unpack_output(out: np.ndarray, L: int):
    f64 = out[: 8 * 5 * L].view(np.float64).reshape(L, 5)
    return out[8 * 5 * L:].reshape(L, DESC_BYTES), f64[:, :3], f64[:, 3:]


_POP = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int64)


def representative(descs: np.ndarray, mask: np.ndarray) -> np.ndarray:
    d = torch.from_numpy(descs)
    m = torch.from_numpy(mask)
    L, P, _ = d.shape
    x = d[:, :, None, :] ^ d[:, None, :, :]
    dist = _POP[x.long()].sum(-1)  # (L, P, P)
    big = 1 << 30
    dist = torch.where(m[:, None, :], dist, big)
    srt, _ = torch.sort(dist, dim=2)
    k = torch.clamp((m.sum(1) - 1) // 2, min=0)
    med = torch.gather(srt, 2, k[:, None, None].expand(L, P, 1))[..., 0]
    med = torch.where(m, med, big)
    best = torch.argmin(med, dim=1)
    return descs[np.arange(L), best.numpy()]


def geometry(pos, centers, octaves, mask, dtype, scale_factor=1.2, n_levels=8):
    """(normals (L, 3), ranges (L, 2)) computed in ``dtype``."""
    p = torch.from_numpy(pos).to(dtype)
    c = torch.from_numpy(centers).to(dtype)
    o = torch.from_numpy(octaves).to(dtype)
    w = torch.from_numpy(mask).to(dtype)
    d = c - p[:, None, :]
    n = torch.sqrt((d * d).sum(-1))
    u = d / torch.clamp(n, min=1e-12)[..., None] * w[..., None]
    cnt = w.sum(1)
    cc = torch.clamp(cnt, min=1.0)
    mean = u.sum(1) / cc[:, None]
    normal = mean / torch.clamp(torch.sqrt((mean * mean).sum(-1)), min=1e-12)[:, None]
    max_d = (n * torch.pow(torch.tensor(scale_factor, dtype=dtype), o) * w).sum(1) / cc
    min_d = max_d / scale_factor ** (n_levels - 1)
    rng = torch.where((cnt > 0)[:, None], torch.stack([min_d, max_d], -1), 0.0)
    return normal.double().numpy(), rng.double().numpy()
