"""Batched project-and-match (the reference's `SearchByProjection` /
`SearchBySE3` matching, `feature_matcher_be.cpp:168-501`).

Counterpart of `covins_tpu/ops/projmatch.py`.  :func:`project_match_core`
is the whole of `_project_match_impl`: the per-landmark prologue
(projection, depth / image / view-angle / distance-invariance gates, the
predicted pyramid level), the per-feature radius, the gated descriptor
row argmin and the scatter-min feature-conflict pass, with the Hamming
metric for uint8 (ORB) descriptors and the L2 metric for float32 (SIFT)
ones (:func:`l2_desc_distance`, float64 distances).
On the card it is one kernel launch (K5, `csrc/project_match.cu`); CPU
tensors take its plain version, :func:`project_match_plain`.  For a
camera model the kernel's prologue does not cover (anything but a pinhole
camera with no or radtan distortion) the prologue runs as PyTorch on the
card and the kernel takes its results.

The plain prologue writes every float64 product and sum of the geometry
as its own tensor operation, in the kernel's order: a library kernel
(``torch.linalg.cross``, ``vector_norm``, ``sum``) may contract a product
into a fused multiply-add or sum in another order on the card, and the
kernel is held to the plain version bit for bit.

Reference quirks kept: the predicted level uses log 1.2 while the radius
scales with 2^octave; two landmarks whose conflict scores (float32 with
the Hamming metric, float64 with L2) round equal both keep the feature;
the L2 metric's cross term is rounded to float32.
"""

from __future__ import annotations

import math

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, check_tensor, is_cpu
from covins_tpu_torch.ops import descriptors as d_ops
from covins_tpu_torch.ops import linalg
from covins_tpu_torch.utils import cameras as cam_mod

BIG = 1e9  # gated distances (float32; float64 with the L2 metric), as the reference
LOG_LEVEL = math.log(1.2)  # the predicted level's log base, as the reference
_ROW_CHUNK = 2048  # rows of the plain (L, F) matrices held at once


def _rotate(q, x, y, z):
    """`geometry.quat_rotate` of the points (x, y, z) by one quaternion q
    (4,), each product and sum its own operation (torch.linalg.cross's
    formula)."""
    w, a, b, c = q[0], q[1], q[2], q[3]
    ux, uy, uz = b * z - c * y, c * x - a * z, a * y - b * x
    vx, vy, vz = b * uz - c * uy, c * ux - a * uz, a * uy - b * ux
    return x + 2.0 * (w * ux + vx), y + 2.0 * (w * uy + vy), z + 2.0 * (w * uz + vz)


def _norm3(x, y, z):
    return linalg.sqrt_rn((x * x + y * y) + z * z)


def _prologue(cam, T_cw, p_w, lm_normal, lm_mask, lm_dist_rng, img_w, img_h,
              check_view_angle: bool):
    """Per-landmark part of `_project_match_impl` (`projmatch.py:66-103`):
    returns (uv (L, 2), lm_ok (L,), pred (L,) predicted octave,
    has_rng (L,))."""
    X, Y, Z = p_w.unbind(-1)
    x, y, z = _rotate(T_cw[:4], X, Y, Z)
    p_c = torch.stack([x + T_cw[4], y + T_cw[5], z + T_cw[6]], dim=-1)
    uv, proj_ok = cam_mod.project3(cam, p_c)
    depth_ok = p_c[:, 2] > 0.0
    in_img = ((uv[:, 0] >= 0.0) & (uv[:, 0] < img_w)
              & (uv[:, 1] >= 0.0) & (uv[:, 1] < img_h))
    lm_ok = lm_mask & depth_ok & proj_ok & in_img

    # the camera centre, -rotate(conj(q), t) (geometry.pose_inverse)
    q_inv = torch.cat([T_cw[:1], -T_cw[1:4]])
    ox, oy, oz = (-v for v in _rotate(q_inv, T_cw[4], T_cw[5], T_cw[6]))
    px, py, pz = X - ox, Y - oy, Z - oz
    dist3 = _norm3(px, py, pz)
    if check_view_angle:
        nx, ny, nz = lm_normal.unbind(-1)
        cosv = (px * nx + py * ny) + pz * nz
        has_normal = _norm3(nx, ny, nz) > 1e-6
        lm_ok = lm_ok & (~has_normal | (cosv >= 0.5 * dist3))
    has_rng = lm_dist_rng[:, 1] > 0.0
    in_rng = ((dist3 >= 0.8 * lm_dist_rng[:, 0])
              & (dist3 <= 1.2 * lm_dist_rng[:, 1]))
    lm_ok = lm_ok & (~has_rng | in_rng)
    # a divisor held in a device tensor: PyTorch's CUDA division by a
    # Python number multiplies by its reciprocal, which rounds otherwise
    log_level = torch.full((), LOG_LEVEL, dtype=dist3.dtype, device=dist3.device)
    pred = torch.ceil(torch.log(torch.clamp(lm_dist_rng[:, 1], min=1e-9)
                                / torch.clamp(dist3, min=1e-9)) / log_level)
    pred = torch.clamp(pred, 0.0, 16.0)
    return uv, lm_ok, pred, has_rng


def l2_desc_distance(lm_f32: torch.Tensor, kp_f32: torch.Tensor) -> torch.Tensor:
    """(L, 128) x (F, 128) float32 -> (L, F) float64: the reference's
    descriptor distance of the L2 metric, ``sqrt(max(l2_distance_sq(a, b),
    0))`` on float64 casts (`projmatch.py:116-118`), whose ``dot_general``
    with ``preferred_element_type=float32`` rounds the cross term to
    float32 and doubles it there.  Here ``aa``, ``bb`` and ``ab`` are
    float64 running sums over the dimensions in K5's order, ``ab`` then
    rounded to float32; the rest in float64, the clamp keeping NaN."""
    a, b = lm_f32.to(torch.float64), kp_f32.to(torch.float64)
    aa, bb = d_ops.sum_squares(a), d_ops.sum_squares(b)
    bt = b.t().contiguous()
    ab = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float64, device=a.device)
    for k in range(a.shape[1]):
        ab += a[:, k, None] * bt[k]
    two_ab = (2.0 * ab.to(torch.float32)).to(torch.float64)
    return linalg.sqrt_rn(torch.clamp((aa[:, None] + bb) - two_ab, min=0.0))


def gated_match_plain(uv, lm_ok, pred, has_rng, lm_desc, kp_uv, kp_oct,
                      radius, kp_free, kp_desc, max_dist: float):
    """The O(L*F) part of project-and-match after the prologue.  Entries
    of a landmark that failed its own gates, or of a feature that is not
    free, are 1e9 whatever else holds, so the (L, F) matrices are built
    only over the passing rows and free columns, in row chunks; a row
    whose entries are all 1e9 takes feature 0, as `argmin` does.  uint8
    descriptors take the Hamming metric in float32, float32 ones the L2
    metric in float64 (:func:`l2_desc_distance`)."""
    L, F = uv.shape[0], kp_uv.shape[0]
    dev = uv.device
    l2 = lm_desc.dtype != torch.uint8
    fdt = torch.float64 if l2 else torch.float32
    big = torch.tensor(BIG, dtype=fdt, device=dev)
    best_f = torch.zeros(L, dtype=torch.int64, device=dev)
    best_d = torch.full((L,), BIG, dtype=fdt, device=dev)
    rows = torch.nonzero(lm_ok).flatten()
    cols = torch.nonzero(kp_free).flatten()
    if len(rows) and len(cols):
        kx, ky = kp_uv[cols, 0], kp_uv[cols, 1]
        k_oct, k_rad, k_desc = kp_oct[cols], radius[cols], kp_desc[cols]
        for r0 in range(0, len(rows), _ROW_CHUNK):
            r = rows[r0:r0 + _ROW_CHUNK]
            dx = uv[r, None, 0] - kx[None, :]
            dy = uv[r, None, 1] - ky[None, :]
            d_px = linalg.sqrt_rn(dx * dx + dy * dy)
            oct_ok = (torch.abs(k_oct[None, :] - pred[r, None]) <= 1.0) \
                | ~has_rng[r, None]
            in_radius = (d_px <= k_rad[None, :]) & oct_ok
            desc = (l2_desc_distance(lm_desc[r], k_desc) if l2
                    else d_ops.hamming_distance(lm_desc[r], k_desc).to(torch.float32))
            d, f = torch.min(torch.where(in_radius, desc, big), dim=1)
            best_f[r] = torch.where(d < big, cols[f], 0)
            best_d[r] = d
    valid = best_d <= max_dist
    lrows = torch.arange(L, dtype=fdt, device=dev)
    score = best_d + lrows * torch.tensor(1e-7, dtype=fdt, device=dev)
    score = torch.where(valid, score, big)
    col_min = torch.full((F,), BIG, dtype=fdt, device=dev)
    col_min = col_min.scatter_reduce(0, best_f, score, reduce="amin")
    winner = valid & (score <= col_min[best_f])
    return (torch.where(winner, best_f, -1).to(torch.int32),
            torch.where(winner, best_d, big))


def project_match_plain(cam, T_cw, p_w, lm_desc, lm_normal, lm_mask,
                        lm_dist_rng, kp_uv, kp_desc, kp_octave, kp_free,
                        radius_px: float, max_dist: float, img_w: float,
                        img_h: float, check_view_angle: bool = True,
                        scale_factor: float = 2.0):
    """Plain version of :func:`project_match_core` (any device)."""
    uv, lm_ok, pred, has_rng = _prologue(cam, T_cw, p_w, lm_normal, lm_mask,
                                         lm_dist_rng, img_w, img_h,
                                         check_view_angle)
    radius = radius_px * torch.pow(scale_factor, kp_octave)
    return gated_match_plain(uv, lm_ok, pred, has_rng, lm_desc, kp_uv,
                             kp_octave, radius, kp_free, kp_desc, max_dist)


def _checked(*a):
    return check_tensor("project_match_core", *a)


def project_match_core(cam, T_cw, p_w, lm_desc, lm_normal, lm_mask,
                       lm_dist_rng, kp_uv, kp_desc, kp_octave, kp_free,
                       radius_px: float, max_dist: float, img_w: float,
                       img_h: float, check_view_angle: bool = True,
                       scale_factor: float = 2.0):
    """`_project_match_impl` (K5), with the Hamming metric for uint8 (ORB)
    descriptors and the L2 metric for float32 (SIFT) ones.

    Landmark side: T_cw (7,) world -> camera, p_w (L, 3), lm_normal (L, 3),
    lm_dist_rng (L, 2) float64, lm_mask (L,) bool, lm_desc (L, 32) uint8
    or (L, 128) float32.  Feature side: kp_uv (F, 2), kp_octave (F,)
    float64, kp_free (F,) bool, kp_desc (F, 32) uint8 or (F, 128) float32.
    Returns ``(match_feat (L,) int32, -1 = none; dist (L,), 1e9 = none)``,
    dist float32 (Hamming) or float64 (L2).  CPU tensors take the plain
    version; CUDA tensors launch the kernel, one launch per call, or
    raise."""
    ts = (T_cw, p_w, lm_desc, lm_normal, lm_mask, lm_dist_rng, kp_uv, kp_desc,
          kp_octave, kp_free, cam.intrinsics, cam.dist)
    if all(is_cpu(t) for t in ts):
        return project_match_plain(cam, T_cw, p_w, lm_desc, lm_normal, lm_mask,
                                   lm_dist_rng, kp_uv, kp_desc, kp_octave, kp_free,
                                   radius_px, max_dist, img_w, img_h,
                                   check_view_angle, scale_factor)
    dev = check_cuda("project_match_core", *ts)
    L, F = p_w.shape[0], kp_uv.shape[0]
    f64, b8 = torch.float64, torch.bool
    l2 = lm_desc.dtype != torch.uint8
    check_desc = d_ops._check_f32 if l2 else (lambda name, t: d_ops._check_desc(name, t, 2))
    check_desc("project_match_core lm_desc", lm_desc)
    check_desc("project_match_core kp_desc", kp_desc)
    if lm_desc.shape[0] != L or kp_desc.shape[0] != F or F == 0:
        raise ValueError("project_match_core: descriptor rows do not match")
    ptrs = [_checked(*a) for a in (
        ("kp_uv", kp_uv, (F, 2), f64), ("kp_octave", kp_octave, (F,), f64),
        ("kp_free", kp_free, (F,), b8))]
    fused = cam.cam_model == cam_mod.PINHOLE and cam.dist_model in (
        cam_mod.DIST_NONE, cam_mod.RADTAN)
    if fused:
        given = [0] * 4
        inputs = [_checked(*a) for a in (
            ("intrinsics", cam.intrinsics, (5,), f64), ("dist", cam.dist, (4,), f64),
            ("T_cw", T_cw, (7,), f64), ("p_w", p_w, (L, 3), f64),
            ("lm_normal", lm_normal, (L, 3), f64), ("lm_mask", lm_mask, (L,), b8),
            ("lm_dist_rng", lm_dist_rng, (L, 2), f64))]
    else:
        pro = _prologue(cam, T_cw, p_w, lm_normal, lm_mask, lm_dist_rng, img_w, img_h,
                        check_view_angle)
        given = [_checked(*a) for a in zip(("uv", "lm_ok", "pred", "has_rng"), pro,
                                           ((L, 2), (L,), (L,), (L,)), (f64, b8, f64, b8))]
        inputs = [0] * 7
    match_feat = torch.empty(L, dtype=torch.int32, device=dev)
    match_dist = torch.empty(L, dtype=f64 if l2 else torch.float32, device=dev)
    if L == 0:
        return match_feat, match_dist
    # scratch: radius (F,) f64, col_min (F,), [each feature's squares (F,)
    # f64,] best_d and best_f (L,)
    scratch = torch.empty(24 * F + 12 * L if l2 else 12 * F + 8 * L, dtype=torch.uint8,
                          device=dev)
    lib = cuda_build.library("project_match")
    with torch.cuda.device(dev):
        rc = lib.covins_project_match(
            int(fused), *inputs[:2], int(cam.dist_model) if fused else 0, *inputs[2:],
            int(bool(check_view_angle)), float(img_w), float(img_h), LOG_LEVEL, *given,
            lm_desc.data_ptr(), L, ptrs[0], ptrs[1], ptrs[2], kp_desc.data_ptr(), F,
            float(radius_px), float(scale_factor), float(max_dist), int(l2),
            scratch.data_ptr(),
            match_feat.data_ptr(), match_dist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "project_match_core")
    project_match_core.launches += 1
    return match_feat, match_dist


project_match_core.launches = 0


def project_match(cam, T_cw, p_w, lm_desc, lm_normal, lm_mask, kp_uv,
                  kp_desc, kp_octave, kp_free, radius_px, max_dist, img_w,
                  img_h, check_view_angle=True, lm_dist_rng=None):
    """SearchByProjection: match landmarks to a keyframe's free features,
    by Hamming distance for uint8 descriptors and by L2 distance for
    float32 ones (SIFT, as the maps store them).  Returns (match_feat (L,)
    int32 with -1 = no match, best_dist (L,))."""
    f64 = dict(dtype=torch.float64, device=p_w.device)
    if lm_dist_rng is None:
        lm_dist_rng = torch.zeros((p_w.shape[0], 2), **f64)
    return project_match_core(
        cam, T_cw.to(**f64), p_w.to(**f64), lm_desc, lm_normal.to(**f64),
        lm_mask, lm_dist_rng.to(**f64), kp_uv.to(**f64), kp_desc,
        kp_octave.to(**f64), kp_free, float(radius_px), float(max_dist),
        float(img_w), float(img_h), check_view_angle=check_view_angle)
