"""Batched landmark maintenance: representative descriptors and normals.

Counterpart of `covins_tpu/ops/landmark_ops.py`.  Whole cohorts of
landmarks are processed at once over a padded (L, P) observation window.
:func:`representative_descriptors` is the K2 kernel
(`csrc/representative_descriptors.cu`); the normals and the
scale-invariance distance range are plain float64 torch.
"""

from __future__ import annotations

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, is_cpu
from covins_tpu_torch.ops import descriptors as desc_ops

_BIG = 1e9


def representative_descriptors_plain(descs_u8: torch.Tensor,
                                     mask: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`representative_descriptors` (any device)."""
    L, P, _ = descs_u8.shape
    dist = desc_ops.hamming_distance(descs_u8, descs_u8).float()  # (L, P, P)
    big = torch.tensor(_BIG, dtype=torch.float32, device=descs_u8.device)
    dist = torch.where(mask[:, None, :], dist, big)
    srt, _ = torch.sort(dist, dim=2)
    n_valid = mask.sum(1)
    med_idx = torch.clamp(torch.div(n_valid - 1, 2, rounding_mode="floor"),
                          min=0)
    med = torch.gather(srt, 2, med_idx[:, None, None].expand(L, P, 1))[..., 0]
    med = torch.where(mask, med, big)
    best = torch.argmin(med, dim=1)  # first minimum: lowest index
    return descs_u8[torch.arange(L, device=descs_u8.device), best]


def representative_descriptors(descs_u8: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """Min-median-Hamming representative descriptor per landmark
    (`Landmark::ComputeDescriptor`).

    descs_u8: (L, P, 32) uint8 padded observation descriptors, P <= 32;
    mask: (L, P) bool.  Returns (L, 32) uint8: the observation whose median
    distance to the landmark's valid observations is smallest (lowest index
    on ties; row 0 when no observation is valid).  CPU tensors take the
    plain version; CUDA tensors launch the kernel (K2) or raise.
    """
    if is_cpu(descs_u8) and is_cpu(mask):
        return representative_descriptors_plain(descs_u8, mask)
    dev = check_cuda("representative_descriptors", descs_u8, mask)
    if descs_u8.dtype != torch.uint8 or descs_u8.dim() != 3 \
            or descs_u8.shape[2] != desc_ops.ORB_BYTES:
        raise ValueError("representative_descriptors: descs must be "
                         f"(L, P, {desc_ops.ORB_BYTES}) uint8")
    L, P, B = descs_u8.shape
    if not 1 <= P <= 32:
        raise ValueError(f"representative_descriptors: P={P} not in [1, 32]")
    if mask.dtype != torch.bool or mask.shape != (L, P):
        raise ValueError(f"representative_descriptors: mask must be ({L}, {P}) bool")
    if not (descs_u8.is_contiguous() and mask.is_contiguous()) \
            or descs_u8.data_ptr() % 16:
        raise ValueError("representative_descriptors: needs contiguous, "
                         "16-byte aligned inputs")
    out = torch.empty((L, B), dtype=torch.uint8, device=dev)
    lib = cuda_build.library("representative_descriptors")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_representative_descriptors(
            descs_u8.data_ptr(), mask.data_ptr(), L, P, out.data_ptr(), stream)
    cuda_build.check(rc, "representative_descriptors")
    representative_descriptors.launches += 1
    return out


representative_descriptors.launches = 0


def distance_invariance(lm_pos: torch.Tensor, obs_cam_centers: torch.Tensor,
                        obs_octaves: torch.Tensor, mask: torch.Tensor,
                        scale_factor: float = 1.2, n_levels: int = 8
                        ) -> torch.Tensor:
    """Scale-invariance distance range per landmark (`Landmark::UpdateNormal`
    distance part), averaged over the padded observation window.

    Returns (L, 2) [min_dist, max_dist]; (0, 0) where no observation is
    valid ("unknown, do not gate")."""
    d = torch.linalg.vector_norm(obs_cam_centers - lm_pos[:, None, :], dim=-1)
    est_max = d * torch.pow(torch.tensor(scale_factor, dtype=d.dtype,
                                         device=d.device), obs_octaves)
    w = mask.to(d.dtype)
    n = w.sum(1)
    max_dist = (est_max * w).sum(1) / torch.clamp(n, min=1.0)
    min_dist = max_dist / scale_factor ** (n_levels - 1)
    out = torch.stack([min_dist, max_dist], dim=-1)
    return torch.where((n > 0)[:, None], out, torch.zeros_like(out))


def landmark_normals(lm_pos: torch.Tensor, obs_cam_centers: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Mean unit viewing direction (landmark -> cameras) per landmark."""
    d = obs_cam_centers - lm_pos[:, None, :]
    n = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d = d / torch.clamp(n, min=1e-12)
    d = d * mask[..., None]
    mean = d.sum(1) / torch.clamp(mask.sum(1)[:, None], min=1.0)
    mn = torch.linalg.vector_norm(mean, dim=-1, keepdim=True)
    return mean / torch.clamp(mn, min=1e-12)
