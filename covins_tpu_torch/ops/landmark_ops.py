"""Batched landmark maintenance: representative descriptors and normals.

Counterpart of `covins_tpu/ops/landmark_ops.py`.  Whole cohorts of
landmarks are processed at once over a padded (L, P) observation window.
:func:`landmark_attributes` is the whole refresh of a cohort (its
representative descriptors, normals and distance ranges) in one launch of
the K2 kernel (`csrc/landmark_attributes.cu`), from one packed input
buffer to one packed output; :func:`representative_descriptors` launches
the kernel's descriptor part alone.  :func:`landmark_normals` and
:func:`distance_invariance` keep the JAX package's signatures as plain
float64 torch.
"""

from __future__ import annotations

import numpy as np
import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, is_cpu
from covins_tpu_torch.ops import descriptors as desc_ops

_BIG = 1e9
OUT_F64 = 5  # per landmark: normal (3), min_dist, max_dist


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
    plain version; CUDA tensors launch the K2 kernel's descriptor part or
    raise.
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
    _launch(dev, None, None, None, descs_u8.data_ptr(), mask.data_ptr(), L, P, 1.0, 1.0,
            None, out.data_ptr(), "representative_descriptors")
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


# ------------------------------------------------- the refresh in one launch
def refresh_layout(L: int, P: int):
    """Byte offsets of the refresh's packed input: float64 landmark
    positions (L, 3), observing camera centres (L, P, 3) and octaves (L, P);
    from a 16-byte boundary the descriptors (L, P, 32) uint8; then the mask
    (L, P) as bytes.  Returns (float64 count, descriptors' offset, mask's
    offset, total bytes)."""
    n_f64 = L * (3 + 4 * P)
    desc_at = (8 * n_f64 + 15) // 16 * 16
    mask_at = desc_at + desc_ops.ORB_BYTES * L * P
    return n_f64, desc_at, mask_at, mask_at + L * P


def refresh_views(buf, L: int, P: int):
    """The five inputs as views of a packed input ``buf`` (a 1-D uint8
    numpy array or tensor): pos, centers, octaves, descs, mask (bool)."""
    n_f64, desc_at, mask_at, total = refresh_layout(L, P)
    if isinstance(buf, np.ndarray):
        f64 = buf[: 8 * n_f64].view(np.float64)
        as_bool = lambda b: b.view(np.bool_)  # noqa: E731
    else:
        f64 = buf[: 8 * n_f64].view(torch.float64)
        as_bool = lambda b: b.view(torch.bool)  # noqa: E731
    return (f64[: 3 * L].reshape(L, 3),
            f64[3 * L: 3 * L * (1 + P)].reshape(L, P, 3),
            f64[3 * L * (1 + P):].reshape(L, P),
            buf[desc_at:mask_at].reshape(L, P, desc_ops.ORB_BYTES),
            as_bool(buf[mask_at:total].reshape(L, P)))


def pack_refresh(pos, centers, octaves, descs, mask) -> torch.Tensor:
    """A packed refresh input (:func:`refresh_layout`) on the CPU holding
    the given numpy arrays."""
    L, P = mask.shape
    buf = torch.empty(refresh_layout(L, P)[3], dtype=torch.uint8)
    arr = buf.numpy()
    arr[:] = 0
    for view, x in zip(refresh_views(arr, L, P), (pos, centers, octaves, descs, mask)):
        view[...] = x
    return buf


def unpack_attributes(out, L: int):
    """(descriptors (L, 32) uint8, normals (L, 3), ranges (L, 2)) as views
    of a packed refresh output (numpy array or tensor)."""
    f64 = out[: 8 * OUT_F64 * L]
    f64 = f64.view(np.float64) if isinstance(out, np.ndarray) else f64.view(torch.float64)
    f64 = f64.reshape(L, OUT_F64)
    return out[8 * OUT_F64 * L:].reshape(L, desc_ops.ORB_BYTES), f64[:, :3], f64[:, 3:]


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 one observation after the other, from 0.0: the
    kernel's order."""
    acc = torch.zeros_like(x[:, 0])
    for p in range(x.shape[1]):
        acc = acc + x[:, p]
    return acc


def _norm3(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    return torch.sqrt((x * x + y * y) + z * z)


def landmark_attributes_plain(packed: torch.Tensor, L: int, P: int,
                              scale_factor: float = 1.2, n_levels: int = 8) -> torch.Tensor:
    """Plain version of :func:`landmark_attributes` (any device): the
    three functions of the JAX package, with the float64 sums and norms
    written in the kernel's order (observations one after the other, x*x +
    y*y then + z*z), where a library reduction would round otherwise."""
    pos, centers, octaves, descs, mask = refresh_views(packed, L, P)
    rep = representative_descriptors_plain(descs, mask)
    d = centers - pos[:, None, :]
    n = _norm3(d)
    w = mask.to(torch.float64)
    u = (d / torch.clamp(n, min=1e-12)[..., None]) * w[..., None]
    cnt = _sum_in_order(w)
    cc = torch.clamp(cnt, min=1.0)
    mean = _sum_in_order(u) / cc[:, None]
    normal = mean / torch.clamp(_norm3(mean), min=1e-12)[:, None]
    est = (n * torch.pow(torch.tensor(scale_factor, dtype=n.dtype, device=n.device),
                         octaves)) * w
    max_dist = _sum_in_order(est) / cc
    # division by a tensor: by a Python number the card multiplies by its
    # reciprocal
    min_dist = max_dist / torch.full_like(max_dist, scale_factor ** (n_levels - 1))
    rng = torch.stack([min_dist, max_dist], dim=-1)
    rng = torch.where((cnt > 0)[:, None], rng, torch.zeros_like(rng))
    out = torch.empty((8 * OUT_F64 + desc_ops.ORB_BYTES) * L, dtype=torch.uint8,
                      device=packed.device)
    out_desc, out_normal, out_rng = unpack_attributes(out, L)
    out_desc.copy_(rep)
    out_normal.copy_(normal)
    out_rng.copy_(rng)
    return out


def landmark_attributes(packed: torch.Tensor, L: int, P: int, scale_factor: float = 1.2,
                        n_levels: int = 8) -> torch.Tensor:
    """The landmark-attribute refresh of a cohort of L landmarks over a
    padded window of P <= 32 observations (`Landmark::ComputeDescriptor`
    and `Landmark::UpdateNormal`): :func:`representative_descriptors`,
    :func:`landmark_normals` and :func:`distance_invariance` at once.

    packed: the 1-D uint8 input of :func:`refresh_layout`
    (:func:`pack_refresh`, or filled through :func:`refresh_views`).
    Returns one 1-D uint8 output that :func:`unpack_attributes` reads:
    descriptors (L, 32), normals (L, 3), ranges (L, 2).  A CPU tensor takes
    the plain version; a CUDA tensor launches the K2 kernel once, or
    raises."""
    if is_cpu(packed):
        return landmark_attributes_plain(packed, L, P, scale_factor, n_levels)
    dev = check_cuda("landmark_attributes", packed)
    if not 1 <= P <= 32:
        raise ValueError(f"landmark_attributes: P={P} not in [1, 32]")
    n_f64, desc_at, mask_at, total = refresh_layout(L, P)
    if packed.dtype != torch.uint8 or packed.shape != (total,) \
            or not packed.is_contiguous() or packed.data_ptr() % 16:
        raise ValueError(f"landmark_attributes: packed must be a contiguous, 16-byte "
                         f"aligned ({total},) uint8 tensor")
    out = torch.empty((8 * OUT_F64 + desc_ops.ORB_BYTES) * L, dtype=torch.uint8, device=dev)
    base, o = packed.data_ptr(), out.data_ptr()
    _launch(dev, base, base + 24 * L, base + 24 * L * (1 + P), base + desc_at,
            base + mask_at, L, P, scale_factor, scale_factor ** (n_levels - 1), o,
            o + 8 * OUT_F64 * L, "landmark_attributes")
    landmark_attributes.launches += 1
    return out


landmark_attributes.launches = 0


def _launch(dev, pos, centers, octaves, descs, mask, L, P, scale_factor, top_scale, out_f,
            out_desc, name):
    lib = cuda_build.library("landmark_attributes")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_landmark_attributes(pos, centers, octaves, descs, mask, L, P,
                                            float(scale_factor), float(top_scale), out_f,
                                            out_desc, stream)
    cuda_build.check(rc, name)
