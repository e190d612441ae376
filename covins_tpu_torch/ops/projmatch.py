"""Batched project-and-match (the reference's `SearchByProjection` /
`SearchBySE3` matching, `feature_matcher_be.cpp:168-501`).

Counterpart of `covins_tpu/ops/projmatch.py`.  The per-landmark prologue
(projection, depth / image / view-angle / distance-invariance gates, the
predicted pyramid level) is O(L) batched float64 torch, as in the
reference.  The O(L*F) part — pixel-radius and octave gates, Hamming
distances, the gated row argmin and the scatter-min feature-conflict pass
— is :func:`gated_match`: a CUDA kernel on the card (K5,
`csrc/project_match.cu`), its plain version on the CPU.

Reference quirks kept: the predicted level uses log 1.2 while the radius
scales with 2^octave; two landmarks whose float32 conflict scores round
equal both keep the feature.
"""

from __future__ import annotations

import math

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, is_cpu
from covins_tpu_torch.ops import descriptors as d_ops
from covins_tpu_torch.utils import cameras as cam_mod
from covins_tpu_torch.utils import geometry as geo

BIG = 1e9  # gated distances (float32), as the reference
_ROW_CHUNK = 2048  # rows of the plain (L, F) matrices held at once


def _prologue(cam, T_cw, p_w, lm_normal, lm_mask, lm_dist_rng, img_w, img_h,
              check_view_angle: bool):
    """Per-landmark part of `_project_match_impl` (`projmatch.py:66-103`):
    returns (uv (L, 2), lm_ok (L,), pred (L,) predicted octave,
    has_rng (L,))."""
    p_c = geo.pose_apply(T_cw[None], p_w)
    uv, proj_ok = cam_mod.project3(cam, p_c)
    depth_ok = p_c[:, 2] > 0.0
    in_img = ((uv[:, 0] >= 0.0) & (uv[:, 0] < img_w)
              & (uv[:, 1] >= 0.0) & (uv[:, 1] < img_h))
    lm_ok = lm_mask & depth_ok & proj_ok & in_img

    O_w = geo.pose_t(geo.pose_inverse(T_cw))
    PO = p_w - O_w[None, :]
    dist3 = torch.linalg.vector_norm(PO, dim=-1)
    if check_view_angle:
        cosv = torch.sum(PO * lm_normal, dim=-1)
        has_normal = torch.linalg.vector_norm(lm_normal, dim=-1) > 1e-6
        lm_ok = lm_ok & (~has_normal | (cosv >= 0.5 * dist3))
    has_rng = lm_dist_rng[:, 1] > 0.0
    in_rng = ((dist3 >= 0.8 * lm_dist_rng[:, 0])
              & (dist3 <= 1.2 * lm_dist_rng[:, 1]))
    lm_ok = lm_ok & (~has_rng | in_rng)
    pred = torch.ceil(torch.log(torch.clamp(lm_dist_rng[:, 1], min=1e-9)
                                / torch.clamp(dist3, min=1e-9)) / math.log(1.2))
    pred = torch.clamp(pred, 0.0, 16.0)
    return uv, lm_ok, pred, has_rng


def gated_match_plain(uv, lm_ok, pred, has_rng, lm_desc, kp_uv, kp_oct,
                      radius, kp_free, kp_desc, max_dist: float):
    """Plain version of :func:`gated_match` (any device).  Entries of a
    landmark that failed its own gates, or of a feature that is not free,
    are 1e9 whatever else holds, so the (L, F) matrices are built only
    over the passing rows and free columns, in row chunks; a row whose
    entries are all 1e9 takes feature 0, as `argmin` does."""
    L, F = uv.shape[0], kp_uv.shape[0]
    dev = uv.device
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    best_f = torch.zeros(L, dtype=torch.int64, device=dev)
    best_d = torch.full((L,), BIG, dtype=torch.float32, device=dev)
    rows = torch.nonzero(lm_ok).flatten()
    cols = torch.nonzero(kp_free).flatten()
    if len(rows) and len(cols):
        kx, ky = kp_uv[cols, 0], kp_uv[cols, 1]
        k_oct, k_rad, k_desc = kp_oct[cols], radius[cols], kp_desc[cols]
        for r0 in range(0, len(rows), _ROW_CHUNK):
            r = rows[r0:r0 + _ROW_CHUNK]
            dx = uv[r, None, 0] - kx[None, :]
            dy = uv[r, None, 1] - ky[None, :]
            d_px = torch.sqrt(dx * dx + dy * dy)
            oct_ok = (torch.abs(k_oct[None, :] - pred[r, None]) <= 1.0) \
                | ~has_rng[r, None]
            in_radius = (d_px <= k_rad[None, :]) & oct_ok
            desc = d_ops.hamming_distance(lm_desc[r], k_desc).to(torch.float32)
            d, f = torch.min(torch.where(in_radius, desc, big), dim=1)
            best_f[r] = torch.where(d < big, cols[f], 0)
            best_d[r] = d
    valid = best_d <= max_dist
    lrows = torch.arange(L, dtype=torch.float32, device=dev)
    score = best_d + lrows * torch.tensor(1e-7, dtype=torch.float32, device=dev)
    score = torch.where(valid, score, big)
    col_min = torch.full((F,), BIG, dtype=torch.float32, device=dev)
    col_min = col_min.scatter_reduce(0, best_f, score, reduce="amin")
    winner = valid & (score <= col_min[best_f])
    return (torch.where(winner, best_f, -1).to(torch.int32),
            torch.where(winner, best_d, big))


def gated_match(uv, lm_ok, pred, has_rng, lm_desc, kp_uv, kp_oct, radius,
                kp_free, kp_desc, max_dist: float):
    """The O(L*F) part of project-and-match.

    Landmark side: uv (L, 2) float64 projections, lm_ok (L,) bool, pred
    (L,) float64 predicted octave, has_rng (L,) bool, lm_desc (L, 32)
    uint8.  Feature side: kp_uv (F, 2) float64, kp_oct (F,) float64, radius
    (F,) float64 pixel radius per feature, kp_free (F,) bool, kp_desc
    (F, 32) uint8.  Returns ``(match_feat (L,) int32, -1 = none; dist (L,)
    float32, 1e9 = none)``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (K5) or raise."""
    ts = (uv, lm_ok, pred, has_rng, lm_desc, kp_uv, kp_oct, radius, kp_free,
          kp_desc)
    if all(is_cpu(t) for t in ts):
        return gated_match_plain(*ts, max_dist)
    dev = check_cuda("gated_match", *ts)
    L, F = uv.shape[0], kp_uv.shape[0]
    for name, t, shape, dtype in (
            ("uv", uv, (L, 2), torch.float64), ("lm_ok", lm_ok, (L,), torch.bool),
            ("pred", pred, (L,), torch.float64),
            ("has_rng", has_rng, (L,), torch.bool),
            ("kp_uv", kp_uv, (F, 2), torch.float64),
            ("kp_oct", kp_oct, (F,), torch.float64),
            ("radius", radius, (F,), torch.float64),
            ("kp_free", kp_free, (F,), torch.bool)):
        if t.shape != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"gated_match: {name} must be a contiguous {shape} "
                             f"{dtype} tensor, got {tuple(t.shape)} {t.dtype}")
    d_ops._check_desc("gated_match lm_desc", lm_desc, 2)
    d_ops._check_desc("gated_match kp_desc", kp_desc, 2)
    if lm_desc.shape[0] != L or kp_desc.shape[0] != F or F == 0:
        raise ValueError("gated_match: descriptor rows do not match")
    best_f = torch.empty(L, dtype=torch.int32, device=dev)
    best_d = torch.empty(L, dtype=torch.float32, device=dev)
    col_min = torch.full((F,), BIG, dtype=torch.float32, device=dev)
    match_feat = torch.empty(L, dtype=torch.int32, device=dev)
    match_dist = torch.empty(L, dtype=torch.float32, device=dev)
    lib = cuda_build.library("project_match")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_project_match(
            uv.data_ptr(), lm_ok.data_ptr(), pred.data_ptr(), has_rng.data_ptr(),
            lm_desc.data_ptr(), L, kp_uv.data_ptr(), kp_oct.data_ptr(),
            radius.data_ptr(), kp_free.data_ptr(), kp_desc.data_ptr(), F,
            float(max_dist), best_f.data_ptr(), best_d.data_ptr(),
            col_min.data_ptr(), match_feat.data_ptr(), match_dist.data_ptr(),
            stream)
    cuda_build.check(rc, "gated_match")
    gated_match.launches += 1
    return match_feat, match_dist


gated_match.launches = 0


def project_match_core(cam, T_cw, p_w, lm_desc, lm_normal, lm_mask,
                       lm_dist_rng, kp_uv, kp_desc, kp_octave, kp_free,
                       radius_px: float, max_dist: float, img_w: float,
                       img_h: float, check_view_angle: bool = True,
                       scale_factor: float = 2.0):
    """`_project_match_impl` for uint8 (ORB) descriptors: the float64
    prologue, then :func:`gated_match`."""
    uv, lm_ok, pred, has_rng = _prologue(cam, T_cw, p_w, lm_normal, lm_mask,
                                         lm_dist_rng, img_w, img_h,
                                         check_view_angle)
    radius = radius_px * torch.pow(scale_factor, kp_octave)
    return gated_match(uv.contiguous(), lm_ok, pred, has_rng,
                       lm_desc.contiguous(), kp_uv.contiguous(),
                       kp_octave.contiguous(), radius.contiguous(),
                       kp_free.contiguous(), kp_desc.contiguous(), max_dist)


def project_match(cam, T_cw, p_w, lm_desc, lm_normal, lm_mask, kp_uv,
                  kp_desc, kp_octave, kp_free, radius_px, max_dist, img_w,
                  img_h, check_view_angle=True, lm_dist_rng=None):
    """SearchByProjection: match landmarks to a keyframe's free features.
    Returns (match_feat (L,) int32 with -1 = no match, best_dist (L,))."""
    if lm_desc.dtype != torch.uint8:
        raise NotImplementedError(
            "covins_tpu_torch matches binary (ORB) descriptors only; the "
            "SIFT/L2 path belongs to the COVINS-G slice")
    f64 = dict(dtype=torch.float64, device=p_w.device)
    if lm_dist_rng is None:
        lm_dist_rng = torch.zeros((p_w.shape[0], 2), **f64)
    return project_match_core(
        cam, T_cw.to(**f64), p_w.to(**f64), lm_desc, lm_normal.to(**f64),
        lm_mask, lm_dist_rng.to(**f64), kp_uv.to(**f64), kp_desc,
        kp_octave.to(**f64), kp_free, float(radius_px), float(max_dist),
        float(img_w), float(img_h), check_view_angle=check_view_angle)
