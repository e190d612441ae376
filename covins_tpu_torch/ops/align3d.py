"""3D-3D correspondence alignment with fixed-iteration RANSAC.

Counterpart of `covins_tpu/ops/align3d.py`: the loop transform from
matched landmarks of two keyframes that both carry metric 3D points
(the GP3P role of `Se3Solver.cpp:59-110`): minimal 3-point Horn
alignments of every hypothesis at once, batched scoring, an optional
weighted re-fit on the inliers.  Minimal sets from Gumbel ``noise``
(`ops/ransac.py`) or given ``idx``.
"""

from __future__ import annotations

import torch

from covins_tpu_torch.ops import ransac
from covins_tpu_torch.utils import geometry as geo


def align_ransac_3d3d(p1, p2, mask, n_hypotheses: int = 256,
                      threshold: float = 0.3, refine: bool = True,
                      noise=None, idx=None):
    """T_12 with p1 ~= T_12 * p2 from noisy matched points p1, p2 (N, 3)
    with mask (N,); ``threshold`` is the inlier distance (metres).
    Returns dict with ``T_12`` (7,), ``inliers`` (N,), ``n_inliers``."""
    if idx is None:
        idx = ransac.sample_minimal_sets(noise[:n_hypotheses], mask, 3)
    T = geo.umeyama_alignment(p2[idx], p1[idx], with_scale=False)[..., :7]  # (H, 7)
    pred = geo.pose_apply(T[:, None, :], p2[None, :, :])
    err = torch.linalg.vector_norm(pred - p1[None], dim=-1)
    inl = (err < threshold) & mask[None, :]
    counts = inl.sum(dim=-1)
    best = torch.argmax(counts)
    T_best, inl_best = T[best], inl[best]
    if refine:
        T_ref = geo.umeyama_alignment(p2, p1, weights=inl_best.to(p1.dtype),
                                      with_scale=False)[:7]
        err_r = torch.linalg.vector_norm(geo.pose_apply(T_ref[None], p2) - p1, dim=-1)
        inl_r = (err_r < threshold) & mask
        better = inl_r.sum() >= counts[best]
        T_best = torch.where(better, T_ref, T_best)
        inl_best = torch.where(better, inl_r, inl_best)
    return {"T_12": T_best, "inliers": inl_best, "n_inliers": inl_best.sum()}
